"""`utils.tracing`: spans and counters off and on, the store's bound, and
the spans and counters of `Predictor.infer`, `Trainer.step` and the
criteria on tiny models on the CPU; on the card (the tests marked `cuda`
skip without one), the device's clock, with no synchronise and no kernel."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.losses.criterion import SetCriterionConfig, draw_points, set_criterion
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.tools.profile_request import STEPS, request_steps
from bm2f_tpu_torch.train.trainer import STAGES, Trainer, synthetic_batch
from bm2f_tpu_torch.utils import tracing
from port_bench import manifest, spans

# a tiny head on a depth-14 ResNet: one encoder and two decoder layers,
# six queries, 64 points
TINY = {
    "model.backbone.resnet.depth": 14,
    "model.pixel_decoder.conv_dim": 32,
    "model.pixel_decoder.mask_dim": 32,
    "model.pixel_decoder.transformer_enc_layers": 1,
    "model.pixel_decoder.transformer_dim_feedforward": 64,
    "model.decoder.hidden_dim": 32,
    "model.decoder.mask_dim": 32,
    "model.decoder.dim_feedforward": 64,
    "model.decoder.dec_layers": 2,
    "model.decoder.num_queries": 6,
    "model.loss.train_num_points": 64,
    "input.max_instances": 4,
}
STAGE_MARKS = list(STAGES.values())


class Untouchable:
    """Raises on any use."""

    def __getattribute__(self, name):
        raise AssertionError(f"touched: {name}")


def children(root, parent):
    return [s["name"] for s in root["spans"] if s["parent"] == parent]


def test_off_a_span_is_one_shared_null_and_a_count_touches_nothing():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b", "cpu") is tracing.NULL
    with tracing.span("a") as s:
        assert s is None
    tracing.count("c", Untouchable())
    n = len(tracing.records())
    with tracing.span("a"):
        tracing.count("c", Untouchable())
    assert len(tracing.records()) == n


def test_spans_nest_and_counters_sum_ints_and_tensors():
    ended = []
    with tracing.collect(on_end=ended.append):
        assert tracing.enabled()
        with tracing.span("r", "cpu"):
            with tracing.span("a"):
                tracing.count("n", 2)
                tracing.count("n", torch.tensor(3))
            with tracing.span("b"):
                with tracing.span("c"):
                    tracing.count("x", torch.tensor(1.5))
        with tracing.span("r2"):
            pass
    assert not tracing.enabled()
    assert ended == ["a", "c", "b", "r", "r2"]
    r, r2 = tracing.records()[-2:]
    assert [(s["name"], s["parent"]) for s in r["spans"]] == [
        ("r", None), ("a", 0), ("b", 0), ("c", 2)]
    assert {s["root"] for s in r["spans"]} == {r["id"]} and r2["id"] > r["id"]
    assert r["name"] == "r" and r["clock"] == "host"
    assert r["counters"] == {"n": 5, "x": 1.5} and r2["counters"] == {}
    for s in r["spans"]:
        assert s["end_ns"] >= s["start_ns"] and s["device_ms"] == s["host_ms"] >= 0
    outer, a, b, c = r["spans"]
    assert outer["start_ns"] <= a["start_ns"] <= a["end_ns"] <= b["start_ns"]
    assert b["start_ns"] <= c["start_ns"] <= c["end_ns"] <= b["end_ns"] <= outer["end_ns"]
    # a counter with no open root goes nowhere
    with tracing.collect():
        tracing.count("n", 1)
    assert tracing.records()[-1]["id"] == r2["id"]


def test_a_profile_turns_spans_on_and_shows_them():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("outer.span"):
            with tracing.span("inner.span"):
                torch.ones(3).sum()
    assert not tracing.enabled()
    assert tracing.records()[-1]["name"] == "outer.span"
    names = {e.name for e in prof.events()}
    assert {"outer.span", "inner.span"} <= names


def test_the_store_keeps_the_last_256_roots():
    with tracing.collect():
        for i in range(tracing.MAX_ROOTS + 44):
            with tracing.span(f"r{i}"):
                pass
    roots = tracing.records()
    assert len(roots) == tracing.MAX_ROOTS == 256
    assert [r["name"] for r in roots] == [f"r{i}" for i in range(44, 300)]


@pytest.fixture(scope="module")
def predictor():
    p = Predictor()
    p.setup("coco_instance_r50", device="cpu", overrides=TINY)
    return p


def test_infer_spans_count_the_bytes_to_the_host_and_change_no_output(predictor,
                                                                       monkeypatch):
    import bm2f_tpu_torch.predict as predict

    image = np.random.RandomState(0).randint(0, 256, (40, 56, 3)).astype(np.uint8)
    off = predictor.infer(image)
    seen = {}
    relabel = predict.relabel_panoptic

    def keep(pan):
        seen["pan"] = pan
        return relabel(pan)

    monkeypatch.setattr(predict, "relabel_panoptic", keep)
    with tracing.collect():
        on = predictor.infer(image)
    root = tracing.records()[-1]
    assert root["name"] == "serve.request"
    assert children(root, 0) == ["serve.prepare", "serve.network", "serve.modes",
                                 "serve.to_host", "serve.relabel"]
    net = [s["name"] for s in root["spans"]].index("serve.network")
    assert children(root, net) == ["net.backbone", "net.pixel_decoder", "net.decoder"]
    copied = [on["semantic"], *on["instances"].values(), *seen["pan"].values()]
    assert root["counters"] == {"serve.to_host_bytes": sum(a.nbytes for a in copied),
                                "serve.pinned_new_blocks": 0}
    np.testing.assert_array_equal(on["semantic"], off["semantic"])
    assert on["instances"].keys() == off["instances"].keys()
    for k, v in off["instances"].items():
        np.testing.assert_array_equal(on["instances"][k], v)
    np.testing.assert_array_equal(on["panoptic"][0], off["panoptic"][0])
    assert on["panoptic"][1] == off["panoptic"][1]


def test_profile_request_reads_its_steps_from_the_spans(predictor):
    image = np.random.RandomState(1).randint(0, 256, (48, 40, 3)).astype(np.uint8)
    steps = request_steps(predictor, image)
    assert list(steps) == [row for row, _, _ in STEPS] + ["segments"]
    assert all(steps[row] > 0 for row, _, _ in STEPS)
    assert steps["segments"] == len(predictor.infer(image)["panoptic"][1])


def _image_batch(seed):
    return synthetic_batch(2, 32, 4, seed=seed, num_classes=80, device="cpu")


def _clip_batch(seed, T=2, size=32, G=3):
    rng = np.random.RandomState(seed)
    valid = np.ones((2, G), bool)
    valid[0, 1:] = False
    return {"images": torch.from_numpy(rng.rand(2, T, size, size, 3).astype(np.float32) * 255),
            "labels": torch.from_numpy(rng.randint(0, 40, (2, G))),
            "masks": torch.from_numpy((rng.rand(2, G, T, size, size) > 0.7).astype(np.float32)),
            "valid": torch.from_numpy(valid)}


@pytest.mark.parametrize("preset,weak,batch", [
    ("coco_instance_r50", False, _image_batch),
    ("coco_instance_r50_wo_lsj_projpair", True, _image_batch),
    ("ytvis2019_video_r50", False, _clip_batch),
    ("ytvis2021_video_r50_proj_spatpair_temppair", True, _clip_batch),
], ids=["mask", "weak", "video_mask", "video_weak"])
def test_a_marked_step_sees_the_six_stages_and_counts_the_targets(preset, weak, batch):
    cfg = get_config(preset, TINY)
    trainer = Trainer(cfg, device="cpu")
    b = batch(3)
    n = len(tracing.records())
    trainer.step(b)  # untraced: no root
    assert len(tracing.records()) == n or n == tracing.MAX_ROOTS
    marks = []
    trainer.step(b, mark=marks.append)
    assert marks == STAGE_MARKS
    root = tracing.records()[-1]
    assert root["name"] == "train.step"
    assert children(root, 0) == list(STAGES)
    names = [s["name"] for s in root["spans"]]
    assert children(root, names.index("train.forward")) == [
        "net.backbone", "net.pixel_decoder", "net.decoder"]
    assert children(root, names.index("train.assign")) == [
        "assign.to_host", "assign.solve", "assign.to_device"]
    costs = children(root, names.index("train.matcher_costs"))
    layers, images = cfg.model.decoder.dec_layers + 1, 2
    frames = b["images"].shape[1] if cfg.task == "video" else 1
    if weak:
        assert costs == ["costs.projection", "costs.pairwise"] * (layers * images * frames)
    else:
        assert costs == []
    # every pairwise cost counts a call; on the CPU none launches the kernel;
    # the mask criteria count the slots they point-sample, B x G' (G' = 1 +
    # the highest valid slot)
    if weak:
        extra = {"costs.pairwise_calls": layers * images * frames}
    else:
        occupied = 1 + int(b["valid"].any(0).nonzero().max())
        extra = {"targets.point_slots": images * occupied}
    assert root["counters"] == {"targets.slots": b["valid"].numel(),
                                "targets.valid": int(b["valid"].sum()), **extra}


def test_the_mask_criterion_counts_its_point_slots_once_a_step(monkeypatch):
    """One step of `set_criterion` counts B x G' point slots, G' = 1 + the
    highest valid slot in any image (holes included); the reader of
    `train.point_slots_pct` gives 100 x their sum over the slots' sum, over
    the steps that count them, and None without them."""
    B, Q, G, K = 2, 20, 20, 5
    g = torch.Generator().manual_seed(0)
    outputs = {"pred_logits": torch.randn(B, Q, K + 1, generator=g),
               "pred_masks": torch.randn(B, Q, 8, 8, generator=g),
               "aux_logits": torch.randn(1, B, Q, K + 1, generator=g),
               "aux_masks": torch.randn(1, B, Q, 8, 8, generator=g)}
    valid = torch.zeros(B, G, dtype=torch.bool)
    valid[0, [0, 5, 17]] = True
    valid[1, 5] = True
    targets = {"labels": torch.randint(0, K, (B, G), generator=g),
               "masks": (torch.rand(B, G, 16, 16, generator=g) > 0.5).float(), "valid": valid}
    cfg = SetCriterionConfig(num_classes=K, num_points=64)
    points = draw_points(cfg, 2, B, g)
    with tracing.collect():
        with tracing.span("train.step"):
            set_criterion(outputs, targets, cfg, points)
    assert tracing.records()[-1]["counters"] == {
        "targets.slots": B * G, "targets.valid": 4, "targets.point_slots": B * 18}

    steps = [{"name": "train.step", "spans": [], "counters": c} for c in (
        {"targets.slots": 200, "targets.valid": 4, "targets.point_slots": 36},
        {"targets.slots": 200, "targets.valid": 3, "targets.point_slots": 4})]
    monkeypatch.setattr(spans, "roots", lambda name: steps if name == "train.step" else [])
    read = manifest.reader("train.point_slots_pct")
    assert read({"kind": "train"}) == 100.0 * 40 / 400
    assert read({"kind": "serve"}) is None
    for step in steps:
        del step["counters"]["targets.point_slots"]
    assert read({"kind": "train"}) is None


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_spans_time_the_device_with_no_synchronise_and_no_kernel():
    dev = require_cuda()
    x = torch.randn(2048, 2048, device=dev)
    total = x.sum()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.set_sync_debug_mode("error")  # a synchronise raises
        try:
            with tracing.span("card.empty", dev):
                with tracing.span("card.inner"):
                    tracing.count("card.n", total)
                    tracing.count("card.n", 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    with tracing.collect():
        with tracing.span("card.matmul", dev):
            for _ in range(20):
                x = x @ x / 2048.0
    root = tracing.records()[-1]
    assert root["clock"] == "cuda" and root["name"] == "card.matmul"
    (s,) = root["spans"]
    assert s["device_ms"] > s["host_ms"] * 0.5 > 0
    counted = [r for r in tracing.records() if r["name"] == "card.empty"][-1]
    assert counted["counters"] == {"card.n": pytest.approx(float(total) + 2, rel=1e-6)}


@pytest.mark.cuda
def test_on_the_card_a_served_request_is_timed_on_the_device():
    dev = require_cuda()
    p = Predictor()
    # the published widths: K1 takes heads of 32 channels
    p.setup("coco_instance_r50", device=dev,
            overrides={k: v for k, v in TINY.items() if "dim" not in k})
    image = np.random.RandomState(0).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    p.infer(image)
    with tracing.collect():
        p.infer(image)
    root = tracing.records()[-1]
    assert root["clock"] == "cuda" and children(root, 0) == [
        "serve.prepare", "serve.network", "serve.modes", "serve.to_host", "serve.relabel"]
    for s in root["spans"]:
        assert s["device_ms"] >= 0 and s["host_ms"] >= 0
