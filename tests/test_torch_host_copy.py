"""`utils.host_copy` and `Predictor.infer`'s copies across the host link.
On the CPU: the image padded and cast on the device gives the network the
input the host-built canvas gave, and `infer` returns what it returned
when it built that canvas and copied every result with `.cpu()` (both kept
here as the yardstick). On the card (the tests marked `cuda` skip without
one): the results live in pinned host memory, equal the `.cpu()` copies
of the same tensors bitwise, are not overwritten by a later request, and a
repeated shape takes every pinned block from the allocator's cache.
Imports no JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.evaluation.panoptic_post import relabel_panoptic
from bm2f_tpu_torch.models.maskformer import (
    instance_inference,
    normalize_images,
    panoptic_inference,
    semantic_inference,
)
from bm2f_tpu_torch.ops import resize_bilinear
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.utils import host_copy, tracing
from bm2f_tpu_torch.utils.precision import f32_scope
from test_torch_tracing import TINY

IMAGES = {
    "uint8": lambda rng: rng.randint(0, 256, (40, 56, 3)).astype(np.uint8),
    "float64": lambda rng: rng.rand(50, 33, 3) * 255.0,
    "float32": lambda rng: (rng.rand(33, 64, 3) * 255.0).astype(np.float32),
    "uint8_strided": lambda rng: rng.randint(0, 256, (37, 45, 3)).astype(np.uint8)[:, ::-1],
    "uint8_planar": lambda rng: rng.randint(0, 256, (3, 41, 50)).astype(np.uint8).transpose(
        1, 2, 0),
}


def prepare_before(p: Predictor, image: np.ndarray) -> torch.Tensor:
    """The network's input as `infer` built it before: the zero canvas and
    the f32 image on the host, one pageable copy in."""
    H, W = image.shape[:2]
    d = p.cfg.model.size_divisibility
    ph, pw = (H + d - 1) // d * d, (W + d - 1) // d * d
    x = torch.zeros((1, ph, pw, 3), dtype=torch.float32)
    x[0, :H, :W] = torch.from_numpy(np.asarray(image, np.float32))
    return normalize_images(x.to(p.device), p.cfg.model)


@torch.no_grad()
def infer_before(p: Predictor, image: np.ndarray) -> dict:
    """`infer` before its copies went through pinned memory: every result
    copied with `.cpu()`."""
    x = prepare_before(p, image)
    H, W = image.shape[:2]
    ph, pw = x.shape[1:3]
    K = p.cfg.model.num_classes
    with f32_scope(p.cfg.model.dtype):
        out = p.model(x)
        logits = out["pred_logits"][0]
        masks = resize_bilinear(out["pred_masks"][0], ph, pw)[:, :H, :W]
        sem = semantic_inference(logits, masks)
        inst = instance_inference(logits, masks, num_classes=K, topk=100)
        pan = panoptic_inference(
            logits, masks, num_classes=K, thing_mask=tuple([True] * K),
            object_mask_threshold=p.cfg.model.test.object_mask_threshold,
            overlap_threshold=p.cfg.model.test.overlap_threshold)
    return {"semantic": sem.cpu().numpy(),
            "instances": {k: v.cpu().numpy() for k, v in inst.items()},
            "panoptic": relabel_panoptic({k: v.cpu().numpy() for k, v in pan.items()})}


def network_input(p: Predictor, image: np.ndarray) -> torch.Tensor:
    """The input `p.infer(image)` gives the network."""
    seen = []
    hook = p.model.register_forward_pre_hook(lambda m, inputs: seen.append(inputs[0].clone()))
    try:
        p.infer(image)
    finally:
        hook.remove()
    (x,) = seen
    return x


def assert_same_result(got: dict, want: dict) -> None:
    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    same(got["semantic"], want["semantic"])
    assert got["instances"].keys() == want["instances"].keys()
    for k, v in want["instances"].items():
        same(got["instances"][k], v)
    same(got["panoptic"][0], want["panoptic"][0])
    assert got["panoptic"][1] == want["panoptic"][1]


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def predictor():
    """device -> one tiny predictor on it; on the card at K1's published
    head width (32 channels)."""
    made = {}

    def get(device: str) -> Predictor:
        if device not in made:
            over = TINY if device == "cpu" else {k: v for k, v in TINY.items() if "dim" not in k}
            made[device] = Predictor()
            made[device].setup("coco_instance_r50", device=device, overrides=over)
        return made[device]

    return get


@pytest.mark.parametrize("kind", list(IMAGES))
def test_infer_gives_what_the_host_canvas_and_cpu_copies_gave(kind, predictor):
    p = predictor("cpu")
    image = IMAGES[kind](np.random.RandomState(5))
    assert_same_result(p.infer(image), infer_before(p, image))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind", list(IMAGES))
def test_the_pad_and_cast_on_the_device_give_the_same_input_bitwise(kind, device, predictor):
    if device == "cuda":
        require_cuda()
    p = predictor(device)
    image = IMAGES[kind](np.random.RandomState(6))
    got, want = network_input(p, image), prepare_before(p, image)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind", list(IMAGES))
def test_to_device_keeps_dtype_shape_and_values(kind, device):
    if device == "cuda":
        require_cuda()
    a = IMAGES[kind](np.random.RandomState(4))
    t = host_copy.to_device(a, device)
    assert t.device.type == device and t.shape == a.shape
    assert t.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
    assert np.array_equal(t.cpu().numpy(), a)


def test_off_the_card_the_copies_are_plain():
    a = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    t = host_copy.to_device(a, "cpu")
    a[0, 0, 0] = 99  # a copy, not a view
    assert t[0, 0, 0] == 0 and torch.equal(t[1], torch.from_numpy(a[1]))
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3, dtype=torch.bool)}}
    host, done = host_copy.to_host(tree, torch.device("cpu"))
    assert host is tree and done is None


@pytest.mark.cuda
def test_on_the_card_results_are_pinned_and_equal_the_cpu_copies(monkeypatch, predictor):
    dev = require_cuda()
    p = predictor("cuda")
    seen = {}
    to_host = host_copy.to_host

    def keep(tensors, device):
        seen["device"] = tensors
        seen["host"], done = to_host(tensors, device)
        return seen["host"], done

    monkeypatch.setattr(host_copy, "to_host", keep)
    image = IMAGES["uint8"](np.random.RandomState(7))
    out = p.infer(image)
    dev_t = seen["device"]
    assert dev_t["sem"].device.type == dev.type
    arrays = [out["semantic"], *out["instances"].values()]
    assert all(torch.from_numpy(a).is_pinned() for a in arrays)
    np.testing.assert_array_equal(out["semantic"], dev_t["sem"].cpu().numpy())
    for k, v in dev_t["inst"].items():
        assert out["instances"][k].dtype == v.cpu().numpy().dtype
        np.testing.assert_array_equal(out["instances"][k], v.cpu().numpy())
    for k, v in dev_t["pan"].items():
        assert seen["host"]["pan"][k].is_pinned()
        assert torch.equal(seen["host"]["pan"][k], v.cpu())
    want = relabel_panoptic({k: v.cpu().numpy() for k, v in dev_t["pan"].items()})
    np.testing.assert_array_equal(out["panoptic"][0], want[0])
    assert out["panoptic"][1] == want[1]


@pytest.mark.cuda
def test_on_the_card_a_held_result_outlives_the_next_request(predictor):
    require_cuda()
    p = predictor("cuda")
    rng = np.random.RandomState(8)
    first = p.infer(IMAGES["uint8"](rng))
    kept = {"semantic": first["semantic"].copy(),
            **{k: v.copy() for k, v in first["instances"].items()}}
    second = p.infer(IMAGES["uint8"](rng))
    assert not np.array_equal(second["semantic"], kept["semantic"])
    np.testing.assert_array_equal(first["semantic"], kept["semantic"])
    for k, v in first["instances"].items():
        np.testing.assert_array_equal(v, kept[k])


@pytest.mark.cuda
def test_on_the_card_a_repeated_shape_allocates_no_pinned_block(predictor):
    require_cuda()
    p = predictor("cuda")
    image = IMAGES["uint8"](np.random.RandomState(9))
    p.infer(image)  # dropped: its blocks go back to the cache
    with tracing.collect():
        p.infer(image)
        p.infer(image[::-1].copy())
    roots = tracing.records()[-2:]
    assert [r["name"] for r in roots] == ["serve.request"] * 2
    assert [r["counters"]["serve.pinned_new_blocks"] for r in roots] == [0, 0]
