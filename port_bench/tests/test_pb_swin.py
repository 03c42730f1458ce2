"""The Swin backbone's plain reference (`reference/backbones/swin.py`)
against bm2f_tpu_torch on the CPU, on the benchmark's seeded weights, and
the Swin-L configuration and its cells' files.

A small Swin: embed 32, depths (2, 2, 2, 2), heads (1, 2, 4, 8), window 4,
under the small head of `tiny.json`. The backbone alone takes (2, 3, 100,
140), which pads at every stage (patch grid 25x35 to 28x36, then 13x18 to
16x20, 7x9 to 8x12, 4x5 to 4x8) and shifts over more than one window in
every odd block; the whole model takes the cells' small traffic.

On the card (`-m cuda`; skipped without one): the controls of the two
cells against their limits, as `test_pb_cuda.py` holds the other cells'.

Error model, as `test_pb_reference.py`'s: both sides compute in f32 on the
CPU, the same mathematics in another order (the port's attention adds the
shift mask per window in a reshaped layout, its mask is built from zone ids,
its deformable core is a row gather), so gaps of 1e-6 relative are expected;
FWD_REL and STEP_REL of 1e-4 leave two decades of room, while a wrong term
(a missing bias table or mask, a shift the wrong way, a swapped strided view
in the merging) moves these numbers by 1e-2 or more.
"""

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import bounds, harness, manifest
from port_bench.generator import draw_points, train_pool
from port_bench.reference.criterion import LossWeights
from port_bench.reference.model import Arch, forward, param_specs
from port_bench.reference.optim import AdamWConfig
from port_bench.reference.train import train_steps
from port_bench.tests.tiny import TINY, TRAFFIC_OF, cpu_threads
from port_bench.weights import make_weights

FWD_REL = 1e-4
STEP_REL = 1e-4
SEED = 2 ** 40 + 18
ROOT = Path(__file__).resolve().parents[2]
CONFIG = "coco_instance_swin_l"
SMALL = {"embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": 4}
# Swin-L's window attention at B=1 1024x1024: stages of 264^2, 132^2, 72^2 and
# 36^2 padded tokens, 2, 2, 18 and 2 blocks
SWIN_L_ATTN_FLOPS_1024 = 66_694_938_624


def setup_module(module):
    cpu_threads()


def conf_file():
    return manifest.load_json(manifest.HERE / "configs" / f"{CONFIG}.json")


def small_cell(workload: str) -> manifest.Cell:
    """A Swin-L cell of BENCHMARK.json with the small Swin and `tiny.json`'s
    small head and traffic."""
    c = manifest.cell(workload)
    conf = copy.deepcopy(c.config)
    swin = {f"model.backbone.swin.{k}": tuple(v) if isinstance(v, list) else v
            for k, v in SMALL.items()}
    conf["overrides"] = {**conf["overrides"], **swin,
                         **{k: v for k, v in TINY["overrides"].items() if ".resnet." not in k}}
    conf["arch"].update({k: v for k, v in TINY["arch"].items() if k != "depth"})
    conf["arch"]["backbone"].update(SMALL)
    conf["loss"].update(TINY["loss"])
    conf["max_instances"] = TINY["max_instances"]
    c.config = conf
    c.mix = {**c.mix, **TINY["traffic"][TRAFFIC_OF[c.traffic_name]]}
    return c


def f32_train_cfg(c):
    conf = copy.deepcopy(c.config)
    conf["train_overrides"]["model.dtype"] = "float32"
    return harness.port_config(conf, "train")


def port_backbone(arch: Arch, device="cpu"):
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models.swin import SwinTransformer

    over = {path: arch.backbone[k] for k, path in arch.net.PORT_KEYS.items()}
    return SwinTransformer.from_config(get_config(CONFIG, over).model.backbone.swin)


def strip(P):
    return {k[len("backbone."):]: v for k, v in P.items() if k.startswith("backbone.")}


@pytest.mark.parametrize("size", ["small", "swin_l"])
def test_weights_are_named_and_shaped_as_the_ports_state_dict(size):
    arch = conf_file()["arch"]
    if size == "small":
        arch = {**arch, "backbone": {**arch["backbone"], **SMALL}}
    a = Arch.from_dict(arch)
    with torch.device("meta"):
        port = port_backbone(a)
    ref = {n: s for n, s, _ in a.net.param_specs(a.backbone)}
    have = {f"backbone.{k}": tuple(v.shape) for k, v in port.state_dict().items()}
    assert ref == have
    kinds = {k for n, _, k in a.net.param_specs(a.backbone) if "bias_table" in n}
    assert kinds == {"swin_rel_bias"} and a.net.KINDS == {"swin_rel_bias": 0.02}
    assert a.net.channels(a.backbone) == {f"res{s + 2}": a.backbone["embed_dim"] * 2 ** s
                                          for s in range(4)}


def test_bias_tables_are_drawn_at_their_std():
    a = small_cell("swinl_train").config["arch"]
    P = make_weights(Arch.from_dict(a), SEED, "cpu")
    tables = torch.cat([v.flatten() for k, v in P.items() if k.endswith("bias_table")])
    assert tables.numel() == sum(2 * 7 ** 2 * h for h in (1, 2, 4, 8))  # 2 blocks a stage
    assert 0.018 < float(tables.std()) < 0.022 and abs(float(tables.mean())) < 0.003


def test_backbone_matches_port():
    a = Arch.from_dict(small_cell("swinl_train").config["arch"])
    P = make_weights(a, SEED, "cpu")
    m = port_backbone(a).eval()
    m.load_state_dict(strip(P), strict=True)
    x = torch.randn(2, 3, 100, 140, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = m(x)
        ref = a.net.forward(x, P, a.backbone)
    for key, r in ref.items():
        assert out[key].shape == r.shape, key
        gap = (out[key] - r).abs().max() / r.abs().max()
        assert gap < FWD_REL, (key, float(gap))


def test_forward_matches_port():
    from bm2f_tpu_torch.models.maskformer import MaskFormer, normalize_images

    c = small_cell("swinl_train")
    cfg = f32_train_cfg(c)
    a = Arch.from_dict(c.config["arch"])
    P = make_weights(a, SEED, "cpu")
    m = MaskFormer(cfg.model).eval()
    m.load_state_dict(P, strict=True)
    img = torch.rand(2, 96, 160, 3, generator=torch.Generator().manual_seed(3)) * 255
    with torch.no_grad():
        out = m(normalize_images(img, cfg.model))
        ref = forward(P, img, a)
    for key in ("pred_logits", "pred_masks"):
        gap = (out[key] - ref[key]).abs().max() / ref[key].abs().max()
        assert gap < FWD_REL, (key, float(gap))
    for i, r in enumerate(ref["aux_masks"]):
        gap = (out["aux_masks"][i] - r).abs().max() / r.abs().max()
        assert gap < FWD_REL, ("aux_masks", i, float(gap))


def test_train_step_matches_port():
    """One f32 step of the small cell: losses, gradient norm, each weight's
    first gradient and change against `reference/train.py`."""
    from bm2f_tpu_torch.train.trainer import Trainer

    c = small_cell("swinl_train")
    cfg = f32_train_cfg(c)
    a = Arch.from_dict(c.config["arch"])
    lw = LossWeights(**c.config["loss"])
    opt = AdamWConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in c.config["optimizer"].items()})
    P = make_weights(a, SEED, "cpu")
    batch = train_pool(c.mix, SEED, "cpu", c.config["max_instances"], a.num_classes)[0]
    pts = draw_points(torch.Generator().manual_seed(5), a.dec_layers + 1,
                      batch["images"].shape[0], lw.num_points, lw.oversample_ratio,
                      lw.importance_sample_ratio)
    tr = Trainer(cfg, device="cpu", seed=0)
    tr.model.load_state_dict(P, strict=True)
    m = {k: float(v) for k, v in tr.step(batch, pts).items()}
    ref = train_steps(P, [batch], [pts], a, lw, opt)
    assert abs(m["total_loss"] - ref.total[0]) <= STEP_REL * abs(ref.total[0])
    assert abs(m["grad_norm"] - ref.grad_norm[0]) <= STEP_REL * ref.grad_norm[0]
    for k, v in ref.losses[0].items():
        assert abs(m[k] - v) <= STEP_REL * max(abs(v), 1e-3), k
    b1 = opt.betas[0]
    g1 = {g.name: float(mu.norm()) / (1 - b1) for g, mu in zip(tr.optimizer.groups,
                                                                  tr.optimizer.mu)}
    assert sorted(g1) == sorted(ref.grad1)
    assert any(n.endswith("relative_position_bias_table") for n in g1)
    med = float(np.median(list(ref.grad1.values())))
    for n, v in ref.grad1.items():
        assert abs(g1[n] - v) <= STEP_REL * max(v, med), n
    params = dict(tr.model.named_parameters())
    for n, v in ref.change.items():
        d = float((params[n].detach() - P[n]).norm())
        assert abs(d - v) <= STEP_REL * max(v, 1e-12) + 1e-9, n


@pytest.mark.parametrize("workload", ["swinl_train", "swinl_serve"])
def test_a_small_traced_run_reads_the_window_attention(workload):
    """The small cells through the harness, traced, on the CPU (the device
    clock is the host's there): every host-side metric and the window
    attention's are read, and the run is correct under the cell's limits."""
    c = small_cell(workload)
    r = harness.run_cell(c, 2 ** 33 + 5, 1.0, True, "cpu", time.perf_counter())
    host = {m["name"] for m in c.per_layer if m["source"] != "device_trace"}
    assert {m for m in host if "window_attn" in m} == (
        {"train.span.window_attn_ms", "train.window_attn_roofline"} if workload == "swinl_train"
        else {"serve.span.window_attn_ms", "serve.window_attn_roofline"})
    assert host <= set(r["metrics"]), (host, r["metrics"])
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("key, value, message", [
    ("window_size", 7, "model.backbone.swin.window_size: port 12, file 7"),
    ("num_queries", 100, "model.decoder.num_queries: port 200, file 100"),
    ("embed_dim", 128, "model.backbone.swin.embed_dim: port 192, file 128"),
    ("use_checkpoint", True, "model.backbone.swin.use_checkpoint: port False, file True"),
])
def test_config_check_accepts_the_file_and_raises_on_a_change(key, value, message):
    conf = conf_file()
    for kind in ("train", "serve"):
        harness.verify_config(harness.port_config(conf, kind), conf, kind)
    wrong = copy.deepcopy(conf)
    target = wrong["arch"]["backbone"] if key in wrong["arch"]["backbone"] else wrong["arch"]
    target[key] = value
    with pytest.raises(ValueError, match=message):
        harness.verify_config(harness.port_config(conf, "train"), wrong, "train")


@pytest.mark.parametrize("key", ["ape", "patch_norm", "qkv_bias"])
def test_the_reference_runs_one_setting_of_each_switch(key):
    sizes = {**conf_file()["arch"]["backbone"]}
    sizes[key] = not sizes[key]
    net = Arch.from_dict(conf_file()["arch"]).net
    with pytest.raises(ValueError, match=key):
        net.param_specs(sizes)
    with pytest.raises(ValueError, match=key):
        net.forward(torch.empty(1, 3, 64, 64, device="meta"), {}, sizes)


def test_the_configuration_is_the_published_one():
    conf = conf_file()
    assert conf["reduced"] == [] and conf["preset"] == CONFIG
    assert conf["arch"]["backbone"] == {
        "name": "swin", "embed_dim": 192, "depths": [2, 2, 18, 2],
        "num_heads": [6, 12, 24, 48], "window_size": 12, "patch_size": 4, "mlp_ratio": 4.0,
        "qkv_bias": True, "qk_scale": None, "ape": False, "patch_norm": True,
        "pretrain_img_size": 384, "use_checkpoint": False}
    r50 = manifest.load_json(manifest.HERE / "configs" / "coco_instance_r50.json")
    head = {k: v for k, v in conf["arch"].items() if k not in ("backbone", "num_queries")}
    assert head == {k: v for k, v in r50["arch"].items() if k not in ("depth", "num_queries")}
    assert conf["arch"]["num_queries"] == 200
    assert conf["optimizer"] == {**r50["optimizer"], "steps": [655556, 710184]}
    for k in ("overrides", "train_overrides", "serve_overrides", "loss", "test",
              "train_precision", "serve_precision", "max_instances"):
        assert conf[k] == r50[k], k
    bench = manifest.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["source"] == conf["source"] and entry["reduced"] == []
    assert {w["name"]: w["chips"] for w in bench["workloads"]
            if w["config"] == CONFIG} == {"swinl_train": 1, "swinl_serve": 1}


def attention_count(B, H, W, embed, depths, window, patch=4):
    """4 nW N^2 C over the blocks, from the image size alone."""
    h, w, n = math.ceil(H / patch), math.ceil(W / patch), 0
    for s, depth in enumerate(depths):
        nW = B * math.ceil(h / window) * math.ceil(w / window)
        n += depth * 4 * nW * window ** 4 * embed * 2 ** s
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return n


def port_counters(arch, x):
    from bm2f_tpu_torch.utils import tracing

    with torch.device(x.device):
        m = port_backbone(Arch.from_dict(arch))
    with torch.no_grad(), tracing.collect():
        with tracing.span("count", "cpu"):
            m(x)
    return tracing.records()[-1]["counters"]


def test_the_programs_counters_match_a_count_from_the_image_size():
    conf = conf_file()
    small = {**conf["arch"], "backbone": {**conf["arch"]["backbone"], **SMALL}}
    got = port_counters(small, torch.zeros(2, 3, 100, 140))
    assert got["swin.attn_flops"] == attention_count(2, 100, 140, 32, (2, 2, 2, 2), 4)
    # Swin-L at its widths, on the meta device (shapes only)
    got = port_counters(conf["arch"], torch.empty(1, 3, 1024, 1024, device="meta"))
    assert got["swin.attn_flops"] == attention_count(1, 1024, 1024, 192, (2, 2, 18, 2), 12)
    assert got["swin.attn_flops"] == SWIN_L_ATTN_FLOPS_1024
    # q, k, v and the output, 4 bytes each, over the 115,789,824 channels of the padded tokens
    assert got["swin.attn_bytes"] == 4 * 4 * 115_789_824


def test_mfu_counts_the_reference_swin_ls_flops():
    """The FLOPs `mfu.*` divide by include every product of the reference
    Swin-L: the patch embedding, qkv and proj over the padded windows, the
    attention's two products, the MLP over the real tokens, the mergings;
    counted here by hand at B=1 1024x1024."""
    arch = conf_file()["arch"]
    a = Arch.from_dict(arch)
    P = {n: torch.empty(s, device="meta") for n, s, _ in a.net.param_specs(a.backbone)}
    with FlopCounterMode(display=False) as fc:
        a.net.forward(torch.empty(1, 3, 1024, 1024, device="meta"), P, a.backbone)
    h = w = 256
    C, hand = 192, 2 * h * w * 192 * 3 * 16
    for s, depth in enumerate((2, 2, 18, 2)):
        padded = math.ceil(h / 12) * 12 * math.ceil(w / 12) * 12
        hand += depth * (2 * padded * C * 3 * C + 2 * padded * C * C + 2 * 2 * h * w * C * 4 * C)
        if s < 3:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
            hand += 2 * h * w * 4 * C * 2 * C
            C *= 2
    hand += SWIN_L_ATTN_FLOPS_1024
    assert fc.get_total_flops() == hand
    head = bounds.forward_flops(arch, 1, 1024, 1024) - hand
    r50 = manifest.load_json(manifest.HERE / "configs" / "coco_instance_r50.json")["arch"]
    assert head > 0 and bounds.forward_flops(arch, 1, 1024, 1024) > bounds.forward_flops(
        r50, 1, 1024, 1024)


def test_the_reference_loads_nothing_of_the_port():
    body = ("import json, sys\n"
            "from port_bench.reference.backbones import load\n"
            "from port_bench.reference.model import Arch\n"
            "load('swin')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))\n")
    out = subprocess.run([sys.executable, "-c", body], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                                           "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"bm2f_tpu_torch", "bm2f_tpu", "jax", "jaxlib", "flax"}
    src = (manifest.HERE / "reference" / "backbones" / "swin.py").read_text()
    assert "bm2f_tpu" not in src and "jax" not in src


def test_a_small_run_loads_no_jax():
    body = ("import json, sys, time\n"
            "import torch\n"
            "torch.set_num_threads(2)\n"
            "from port_bench import harness\n"
            "from port_bench.tests.test_pb_swin import small_cell\n"
            "for w in ('swinl_train', 'swinl_serve'):\n"
            "    harness.run_cell(small_cell(w), 5, 0.5, False, 'cpu', time.perf_counter())\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))\n")
    out = subprocess.run([sys.executable, "-c", body], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                                           "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bm2f_tpu_torch" in loaded  # the runs did drive the port
    assert not loaded & {"bm2f_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["swinl_train", "swinl_serve"])
def test_control_is_not_correct_on_the_card(workload):
    """At the cell's own size, on three seeds: the reference in the
    precision below the configuration's, in the program's place, is not
    correct under the cell's limits, and the program is. About a minute a
    cell on an H100."""
    from port_bench import calibrate, check

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = manifest.cell(workload)
    for seed in (2 ** 34 + 1, 2 ** 34 + 2, 2 ** 34 + 3):
        drv = harness.DRIVERS[c.mix["driver"]](c, seed, "cuda")
        fn = calibrate.train_readings if c.mix["driver"] == "train" else calibrate.serve_readings
        readings = dict(fn(drv, True))
        control = next(v for k, v in readings.items() if k.startswith("control_"))
        ok, rows = check.judge(control, c.limits)
        assert not ok, ("control", seed, rows)
        ok, rows = check.judge(readings["program"], c.limits)
        assert ok, ("program", seed, rows)
        del drv
        harness.free("cuda")
