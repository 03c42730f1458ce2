"""The backbone a configuration names, found by file.

The ResNet path is what it was before the backbone moved into its own
file: the weights' names, shapes, kinds and order, the seeded weights, the
weights that train and take decay, the forward FLOPs that `mfu.*` divide by
and the tiny reference forward are held to values read before the move
(the forward's bits with one CPU thread, on x86-64). A toy backbone kept
beside these tests goes through the lookup, the weights, the forward and
the FLOP count, and a backbone with no file stops a run at set-up.
"""

import hashlib
import json
import pickle
import re
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import bounds, harness, manifest
from port_bench.reference import backbones
from port_bench.reference.model import Arch, forward, param_specs
from port_bench.reference.optim import NO_DECAY, trainable
from port_bench.tests.tiny import cpu_threads, tiny_cell
from port_bench.weights import RANDOM_KINDS, make_weights, seed_bits

TOY = Path(__file__).resolve().parent / "backbones"
SEED = 2 ** 40 + 18
ARCH = {c: manifest.load_json(manifest.HERE / "configs" / f"{c}.json")["arch"]
        for c in ("coco_instance_r50", "coco_instance_r50_wo_lsj_projpair")}
ARCH["tiny"] = tiny_cell("r50_train_mask").config["arch"]

# read before the ResNet moved out of reference/model.py
SPECS_SHA = {
    "coco_instance_r50": "c6d0110e2b92cd0c364f2cdbd6e1519628c2a2067f86ac859df243d6a93df333",
    "coco_instance_r50_wo_lsj_projpair":
        "c6d0110e2b92cd0c364f2cdbd6e1519628c2a2067f86ac859df243d6a93df333",
    "tiny": "7d6831904bf33fcc15d342964c0ea453688d2c311663991be4066fafa40d26f6",
}
OPTIMIZED_SHA = {
    "coco_instance_r50": "57321ad0c5e55944ebbca5e1b31168ef2a9469ebceb09ccf4a980842267457a6",
    "coco_instance_r50_wo_lsj_projpair":
        "57321ad0c5e55944ebbca5e1b31168ef2a9469ebceb09ccf4a980842267457a6",
    "tiny": "5917662fe400201fdf6cb97cb036c6cad93decc1a0e4e8dff76bf3d390505aa1",
}
WEIGHTS_SHA = "6dfd1375469e255650a7286f54fd0a62ac8ffbeafcbcee42a5ff2f4dc9df999b"
FORWARD_SHA = "462cb1e52b24b01e987447ed9652b73f8747d458f32a358065347db1964d6570"
FLOPS = {(2, 1024, 1024): 1029343944704.0, (1, 800, 1088): 427748454400.0}

TOY_ARCH = {**ARCH["tiny"], "backbone": {"name": "toy", "width": 8}}
del TOY_ARCH["depth"]


def setup_module(module):
    cpu_threads()


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("config", sorted(SPECS_SHA))
def test_resnet_weights_are_named_and_shaped_as_before(config):
    a = Arch.from_dict(ARCH[config])
    assert a.net.PORT_NAME == "resnet"
    specs = [[n, list(s), k] for n, s, k in param_specs(a)]
    assert sha(json.dumps(specs).encode()) == SPECS_SHA[config]
    names = [n for n, _, _ in specs]
    tr = trainable(names)
    decayed = [n for n in tr if NO_DECAY.search(n) is None]
    assert sha(json.dumps([tr, decayed]).encode()) == OPTIMIZED_SHA[config]


# a ResNet's folded BatchNorm and Swin's weights, as the port names them
POLICY = {  # name: (trains, takes weight decay)
    "backbone.res2.0.conv1.weight": (True, True),
    "backbone.res2.0.conv1.norm.scale": (False, None),
    "backbone.res2.0.conv1.norm.bias": (False, None),
    "backbone.patch_embed.norm.weight": (True, False),
    "backbone.patch_embed.norm.bias": (True, False),
    "backbone.layers.0.downsample.norm.bias": (True, False),
    "backbone.layers.2.blocks.5.norm1.weight": (True, False),
    "backbone.layers.1.blocks.0.attn.relative_position_bias_table": (True, False),
    "backbone.absolute_pos_embed": (True, False),
    "backbone.layers.1.blocks.0.attn.qkv.weight": (True, True),
}


@pytest.mark.parametrize("name", sorted(POLICY))
def test_training_policy_follows_names_for_any_backbone(name):
    """A frozen BatchNorm's folded constants stay; a LayerNorm (Swin's
    `.weight`, `.bias`) trains without decay, as do upstream's named
    exemptions. (A weight that does not train has no decay to decide.)"""
    trains, decays = POLICY[name]
    assert (name in trainable(POLICY)) == trains
    if trains:
        assert (NO_DECAY.search(name) is None) == decays


def test_explicit_resnet_backbone_is_the_default():
    arch = {k: v for k, v in ARCH["tiny"].items() if k != "depth"}
    arch["backbone"] = {"name": "resnet", "depth": ARCH["tiny"]["depth"]}
    assert param_specs(Arch.from_dict(arch)) == param_specs(Arch.from_dict(ARCH["tiny"]))


def test_resnet_seeded_weights_are_as_before():
    P = make_weights(Arch.from_dict(ARCH["tiny"]), SEED, "cpu")
    h = hashlib.sha256()
    for n, v in P.items():
        h.update(n.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA


@pytest.mark.parametrize("shape", sorted(FLOPS))
def test_resnet_forward_flops_are_as_before(shape):
    assert bounds.forward_flops(ARCH["coco_instance_r50"], *shape) == FLOPS[shape]


def test_resnet_reference_forward_is_bitwise_as_before():
    a = Arch.from_dict(ARCH["tiny"])
    P = make_weights(a, SEED, "cpu")
    img = torch.rand(2, 96, 128, 3, generator=torch.Generator().manual_seed(3)) * 255
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            out = forward(P, img, a)
    finally:
        torch.set_num_threads(threads)
    h = hashlib.sha256()
    for t in [out["pred_logits"], out["pred_masks"], *out["aux_logits"], *out["aux_masks"]]:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == FORWARD_SHA


def test_the_head_names_no_backbone():
    """The ResNet's name and sizes live in its file; the head's code names
    it once, as the default of an `arch` that names no backbone."""
    pb = manifest.HERE
    files = [pb / "harness.py", pb / "weights.py", pb / "bounds.py",
             pb / "reference" / "model.py"]
    text = "\n".join(f.read_text() for f in files)
    assert text.count('"resnet"') == 1 and 'DEFAULT_BACKBONE = "resnet"' in text
    for word in ("resnet.depth", "STAGES", "2048, 1024, 512", "FrozenBN", ".norm.scale"):
        assert word not in text, word


def test_toy_backbone_is_found_by_name():
    net = backbones.load("toy", TOY)
    assert net.PORT_NAME == "toy" and net.KINDS == {"toy_table": 0.02}
    assert backbones.load("toy", TOY) is net and sys.modules[net.__name__] is net
    assert pickle.loads(pickle.dumps(net.LEVELS)) == net.LEVELS
    a = Arch.from_dict(TOY_ARCH, TOY)
    assert a.net.PORT_NAME == "toy" and a.backbone == {"name": "toy", "width": 8}
    specs = param_specs(a)
    assert specs[:8] == net.param_specs({"width": 8})
    shapes = dict((n, s) for n, s, _ in specs)
    ch = net.channels({"width": 8})
    assert shapes["sem_seg_head.pixel_decoder.input_proj.0.0.weight"][1] == ch["res5"] == 64
    assert shapes["sem_seg_head.pixel_decoder.input_proj.2.0.weight"][1] == ch["res3"] == 16
    assert shapes["sem_seg_head.pixel_decoder.adapter_1.weight"][1] == ch["res2"] == 8


def test_toy_kind_is_drawn_in_spec_order():
    a = Arch.from_dict(TOY_ARCH, TOY)
    P = make_weights(a, SEED, "cpu")
    specs = param_specs(a)
    drawn = [(n, s, k) for n, s, k in specs if k in RANDOM_KINDS or k == "toy_table"]
    flat = torch.randn(sum(torch.Size(s).numel() for _, s, _ in drawn),
                       generator=torch.Generator().manual_seed(seed_bits(SEED)))
    off, tables = 0, 0
    for n, s, k in drawn:
        chunk = flat[off:off + torch.Size(s).numel()].view(s)
        off += chunk.numel()
        if k == "toy_table":
            assert torch.equal(P[n], chunk * 0.02), n
            tables += 1
    assert tables == 4 and set(P) == {n for n, _, _ in specs}


def test_toy_reference_forward_runs():
    a = Arch.from_dict(TOY_ARCH, TOY)
    P = make_weights(a, SEED, "cpu")
    img = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(4)) * 255
    with torch.no_grad():
        out = forward(P, img, a)
    assert out["pred_logits"].shape == (1, a.num_queries, a.num_classes + 1)
    assert out["pred_masks"].shape == (1, a.num_queries, 16, 24)
    assert all(torch.isfinite(t).all() for t in (out["pred_logits"], out["pred_masks"]))


def backbone_flops(a: Arch, B: int, H: int, W: int) -> float:
    P = {n: torch.empty(s, device="meta") for n, s, _ in a.net.param_specs(a.backbone)}
    with FlopCounterMode(display=False) as fc:
        a.net.forward(torch.empty(B, 3, H, W, device="meta"), P, a.backbone)
    return fc.get_total_flops()


def test_toy_forward_flops_follow_the_file():
    """The toy's FLOPs are its strided convolutions, counted by hand; the
    head's differ from the ResNet-14's only in the 1x1 convolutions that
    take each level's channels (`input_proj` of res5..res3, `adapter_1` of
    res2)."""
    B, H, W = 1, 64, 96
    toy, r14 = Arch.from_dict(TOY_ARCH, TOY), Arch.from_dict(ARCH["tiny"])
    ch, cin, hand, proj = toy.net.channels(toy.backbone), 3, 0, 0
    r14_ch, stride = r14.net.channels(r14.backbone), 1
    for lvl, s in toy.net.STRIDES.items():
        stride *= s
        n = B * (H // stride) * (W // stride)
        hand += 2 * n * ch[lvl] * cin * s * s
        proj += 2 * n * toy.conv_dim * (ch[lvl] - r14_ch[lvl])
        cin = ch[lvl]
    got = bounds.forward_flops(TOY_ARCH, B, H, W, TOY)
    r14_head = bounds.forward_flops(ARCH["tiny"], B, H, W) - backbone_flops(r14, B, H, W)
    assert got == hand + r14_head + proj


def test_a_backbone_without_a_file_stops_the_run_at_setup():
    c = tiny_cell("r50_train_mask")
    arch = {k: v for k, v in c.config["arch"].items() if k != "depth"}
    c.config = {**c.config, "arch": {**arch, "backbone": {"name": "no_such_backbone"}}}
    path = re.escape(str(backbones.HERE / "no_such_backbone.py"))
    with pytest.raises(FileNotFoundError, match=path):
        harness.run_cell(c, SEED, 1.0, False, "cpu", time.perf_counter())
    with pytest.raises(FileNotFoundError, match=path):
        bounds.forward_flops(c.config["arch"], 1, 64, 64)


@pytest.mark.parametrize("kind", ["fan_in", "embed", "class"])
def test_a_backbone_kind_may_not_reuse_the_heads(tmp_path, kind):
    text = (TOY / "toy.py").read_text().replace('KINDS = {"toy_table": 0.02}',
                                                 f'KINDS = {{"{kind}": 0.02}}')
    (tmp_path / "toy.py").write_text(text)
    with pytest.raises(ValueError, match=f"reuses the head's kinds \\['{kind}'\\]"):
        backbones.load("toy", tmp_path)
    assert not any(m.startswith("port_bench_backbone_toy_") and
                   str(tmp_path) in (getattr(sys.modules[m], "__file__", "") or "")
                   for m in list(sys.modules))


def test_config_check_takes_the_backbone_from_its_file():
    c = tiny_cell("r50_serve")
    cfg = harness.port_config(c.config, "serve")
    harness.verify_config(cfg, c.config, "serve")
    arch = {k: v for k, v in c.config["arch"].items() if k != "depth"}
    explicit = {**c.config, "arch": {**arch, "backbone": {"name": "resnet", "depth": 14}}}
    harness.verify_config(cfg, explicit, "serve")
    wrong = {**c.config, "arch": {**arch, "backbone": {"name": "resnet", "depth": 50}}}
    with pytest.raises(ValueError, match="model.backbone.resnet.depth: port 14, file 50"):
        harness.verify_config(cfg, wrong, "serve")
