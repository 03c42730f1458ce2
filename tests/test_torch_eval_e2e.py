"""The port's eval (`bm2f_tpu_torch.eval`) against the JAX package's root
`eval.py`.

1. The post-processing on identical network outputs: the port's on-device
   crop, resize to the original size, binarization, rescoring, semantic
   argmax and panoptic fusion against the JAX eval's host path
   (`resize_bilinear_np`) and its jitted fusion.
2. `run_eval` end to end: a tiny `coco_instance_r50` (1 encoder layer, 1
   decoder layer, 8 queries, depth-14 ResNet), JAX weights converted with
   `jax_variables_to_state_dict`, on a synthetic COCO-format dataset of 3
   images in one bucket (`bm2f_tpu_torch.data.synthetic`, and an LVIS
   split of the same images), in each of the `coco`, `lvis`, `sem_seg` and
   `coco_panoptic_seg` evaluators: every image's predictions, as the
   evaluators receive them, and the metrics.
3. The entry point on the CPU, and a mismatch of the JAX eval recorded.

Error model. The two resizes to the original size differ only in their
index arithmetic (float64 against exact integers) and the rounding of one
f32 weight, so a resized logit differs by at most a few f32 ulps of the
largest input: RESIZE_EPS = 2^-20 of it. End to end the network outputs
differ as the whole-model parity allows (tests/test_torch_model.py:
rtol 1e-3 / atol 1.5e-3), and a bilinear resize (a convex combination)
carries that bound over: a logit differs by at most FWD_EPS = 1.5e-3 +
1e-3 * max |logit|. A mask pixel binarized at 0 may flip only where the
JAX logit lies within that distance of 0; a semantic label may change only
where the JAX eval's top two class probabilities lie within 2 * FWD_EPS of
each other (a probability moves by at most its logits' error); a panoptic
pixel may change only where a mask logit lies within FWD_EPS of 0 or its
two best queries within 2 * FWD_EPS. The band is read on the port's side
of the comparison (a value that crosses a boundary lies within the error
of it on both sides). When no prediction moved, the metrics are equal;
otherwise mIoU may move by 100 * moved / the smallest class union. With
random weights the synthetic ground truth scores AP = PQ = 0 on both sides
and mIoU a few points, so the per-image comparison carries the test.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eval as jax_eval
from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.data.datasets import register_all_builtin_datasets as jax_register
from bm2f_tpu.data.datasets.lvis import register_lvis_instances as jax_register_lvis
from bm2f_tpu.data.transforms import resize_bilinear_np
from bm2f_tpu.evaluation import coco_eval as jax_coco
from bm2f_tpu.evaluation import lvis_eval as jax_lvis
from bm2f_tpu.evaluation import panoptic_eval as jax_pan
from bm2f_tpu.evaluation import sem_seg_eval as jax_sem
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models import maskformer as jax_mf
from bm2f_tpu.ops import interpolate as jax_interp
from bm2f_tpu_torch import eval as port_eval
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.datasets.lvis import register_lvis_instances
from bm2f_tpu_torch.data.synthetic import STUFF, THINGS, write_synthetic_coco
from bm2f_tpu_torch.evaluation import coco_eval, lvis_eval, panoptic_eval, sem_seg_eval
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.ops import resize_bilinear_dynamic
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_port_utils import to_numpy_tree

RESIZE_EPS = 2.0 ** -20
K = 80
TINY = {"model.backbone.resnet.depth": 14, "model.decoder.dec_layers": 1,
        "model.decoder.num_queries": 8, "model.pixel_decoder.transformer_enc_layers": 1,
        "model.num_classes": THINGS + STUFF}


def test_bucket_ladder_matches_jax():
    for m in (160, 512, 1333, 2048, 2560):
        assert port_eval.bucket_ladder(m) == jax_eval.bucket_ladder(m)


# (src_hw, dst_hw, out_hw): downscale, upscale, odd sizes, and a region
# smaller than its output (the JAX eval's original-size buckets)
DYN = [((20, 30), (20, 30), (20, 30)), ((17, 23), (40, 61), (40, 61)),
       ((64, 48), (31, 29), (33, 32)), ((300, 213), (427, 640), (512, 640))]


@pytest.mark.parametrize("case", DYN)
def test_resize_bilinear_dynamic_matches_jax(case):
    (sh, sw), dst, (oh, ow) = case
    rng = np.random.RandomState(sh)
    x = rng.randn(3, sh + 5, sw + 3).astype(np.float32)
    ours = resize_bilinear_dynamic(torch.from_numpy(x), (sh, sw), dst, oh, ow).numpy()
    ref = np.asarray(jax_interp.resize_bilinear_dynamic(
        jnp.asarray(x.transpose(1, 2, 0)), jnp.int32([sh, sw]), jnp.int32(dst), oh, ow)
    ).transpose(2, 0, 1)
    dh, dw = dst
    np.testing.assert_allclose(ours[:, :dh, :dw], ref[:, :dh, :dw], rtol=0,
                               atol=RESIZE_EPS * np.abs(x).max())


def _outputs(seed, q=12, h4=24, w4=24):
    """Network outputs with structure: block masks (so panoptic fusion keeps
    segments) plus noise, confident classes for the first queries."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(q, K + 1) * 2).astype(np.float32)
    logits[: q // 2, rng.randint(0, K, q // 2)] += 8.0
    masks = np.full((q, h4, w4), -3.0, np.float32)
    for i in range(q):
        y, x = rng.randint(0, h4 - 6), rng.randint(0, w4 - 6)
        masks[i, y:y + rng.randint(4, 12), x:x + rng.randint(4, 12)] = 3.0
    masks += rng.randn(*masks.shape).astype(np.float32)
    return logits, masks


# (padded bucket, resized valid region, original size)
POST = [((96, 96), (72, 96), (300, 400)), ((96, 96), (96, 64), (150, 100)),
        ((96, 96), (95, 31), (61, 20))]


def _flips_allowed(ours, ref_logits, eps):
    """Every differing binary pixel has its reference logit within eps of 0;
    returns how many differ."""
    diff = ours != (ref_logits > 0)
    assert (np.abs(ref_logits[diff]) <= eps).all()
    return int(diff.sum())


@pytest.mark.parametrize("post", POST)
def test_instance_post_matches_jax_host_path(post):
    (H, W), (nh, nw), (oh, ow) = post
    logits, masks = _outputs(nh)
    # the JAX eval: upsample on the device, top-k, then the host path
    mf = jax_interp.resize_bilinear(jnp.asarray(masks).transpose(1, 2, 0), H, W)
    scores, labels, sel = (np.asarray(a) for a in jax_mf.instance_topk_select(
        jnp.asarray(logits), mf.transpose(2, 0, 1), num_classes=K, topk=100))
    m = resize_bilinear_np(sel[:, :nh, :nw], oh, ow)
    binary = m > 0
    prob = 1.0 / (1.0 + np.exp(-m))
    area = binary.reshape(len(binary), -1).sum(-1)
    ref_scores = scores * (prob * binary).reshape(len(binary), -1).sum(-1) / (area + 1e-6)

    with torch.no_grad():
        ours = port_eval.instance_on_device(torch.from_numpy(logits), torch.from_numpy(masks),
                                            (H, W), (nh, nw), (oh, ow), num_classes=K, topk=100)
    np.testing.assert_array_equal(ours["labels"].numpy(), labels)
    assert _flips_allowed(ours["masks"].numpy(), m, RESIZE_EPS * np.abs(sel).max()) == 0
    np.testing.assert_allclose(ours["scores"].numpy(), ref_scores, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("post", POST)
def test_semantic_post_matches_jax_host_path(post):
    (H, W), (nh, nw), (oh, ow) = post
    logits, masks = _outputs(nh + 1, h4=H // 4, w4=W // 4)
    sem = np.asarray(jax_mf.semantic_inference(jnp.asarray(logits), jnp.asarray(masks)))
    h4, w4 = max(int(round(nh / 4)), 1), max(int(round(nw / 4)), 1)
    probs = resize_bilinear_np(sem[:h4, :w4].transpose(2, 0, 1), oh, ow)
    with torch.no_grad():
        ours = port_eval.semantic_on_device(torch.from_numpy(logits), torch.from_numpy(masks),
                                            (H, W), (nh, nw), (oh, ow)).numpy()
    top2 = np.sort(probs, axis=0)[-2:]
    diff = ours != probs.argmax(0)
    assert (top2[1][diff] - top2[0][diff] <= 2 * RESIZE_EPS).all()


@pytest.mark.parametrize("post", POST)
def test_panoptic_post_matches_jax_fusion(post):
    """The JAX eval's fusion (upsample, `resize_bilinear_dynamic` into an
    original-size bucket, fuse) at an original size that fills its bucket
    (multiples of 128 do), against the port's at that size: the same
    segments and the same map."""
    (H, W), (nh, nw), _ = post
    oh, ow = 128, 256
    logits, masks = _outputs(nh + 2, h4=H // 4, w4=W // 4)
    thing = tuple(c < 40 for c in range(K))
    cfg = get_config("coco_instance_r50")
    mf = jax_interp.resize_bilinear(jnp.asarray(masks).transpose(1, 2, 0), H, W)
    mo = jax_interp.resize_bilinear_dynamic(mf, jnp.int32([nh, nw]), jnp.int32([oh, ow]),
                                            oh, ow).transpose(2, 0, 1)
    ref = jax_mf.panoptic_inference(jnp.asarray(logits), mo, num_classes=K, thing_mask=thing,
                                    object_mask_threshold=cfg.model.test.object_mask_threshold,
                                    overlap_threshold=cfg.model.test.overlap_threshold)
    with torch.no_grad():
        ours = port_eval.panoptic_on_device(cfg, torch.from_numpy(logits),
                                            torch.from_numpy(masks), (H, W), (nh, nw),
                                            (oh, ow), thing)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    assert ours["valid"].any()


def test_jax_panoptic_fusion_counts_bucket_padding():
    """A recorded mismatch (ROADMAP queue 3): the JAX eval fuses into an
    original-size bucket rounded up to 128 with the padding's logits at
    -1e9 (eval.py:316-320). Its fusion's argmax gives every padding pixel
    to the first kept query (0 > -1), so that query's `mask_area` counts
    the padding and its overlap test can pass where the reference's, over
    real pixels only, fails. The port fuses at the original size."""
    q, oh, ow, ob = 3, 20, 20, 128
    logits = np.full((q, K + 1), -5.0, np.float32)
    logits[:, 7] = 8.0  # every query kept, class 7 (a thing)
    masks = np.full((q, oh, ow), -6.0, np.float32)
    masks[0, :10, :10] = 6.0   # query 0 claims 100 pixels...
    masks[1, :10, 3:] = 7.0    # ...of which query 1 (more confident) takes 70
    masks[2, 10:, :] = 6.0
    thing = tuple(c == 7 for c in range(K))
    kw = dict(num_classes=K, thing_mask=thing, object_mask_threshold=0.8,
              overlap_threshold=0.8)
    padded = np.full((q, ob, ob), -1e9, np.float32)
    padded[:, :oh, :ow] = masks
    jax_valid = np.asarray(jax_mf.panoptic_inference(jnp.asarray(logits),
                                                     jnp.asarray(padded), **kw)["valid"])
    from bm2f_tpu_torch.models.maskformer import panoptic_inference

    ours = panoptic_inference(torch.from_numpy(logits), torch.from_numpy(masks), **kw)["valid"]
    assert jax_valid.tolist() == [True, True, True]
    assert ours.tolist() == [False, True, True]


# ---------------------------------------------------------------------------
# run_eval end to end
# ---------------------------------------------------------------------------

# originals that fill their 128-pixel panoptic buckets in the JAX eval (see
# test_jax_panoptic_fusion_counts_bucket_padding), resized into one bucket
SIZES = ((128, 256), (256, 128), (128, 128))
EVAL = dict(short_edge=64, max_size=128, bucket=128)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_eval")
    names = write_synthetic_coco(str(root), SIZES, seed=4)
    register_all_builtin_datasets(str(root), force=True)
    jax_register(str(root), force=True)
    # an LVIS split of the same images: the instances json with the LVIS
    # image fields and category frequencies
    coco = json.loads((root / "coco/annotations/instances_val2017.json").read_text())
    for i, img in enumerate(coco["images"]):
        img.update(neg_category_ids=[1 + (i + 2) % THINGS],
                   not_exhaustive_category_ids=[1 + i % THINGS])
    for c in coco["categories"]:
        c["frequency"] = "rcf"[c["id"] % 3]
    lvis_json = root / "lvis_val.json"
    lvis_json.write_text(json.dumps(coco))
    for register in (register_lvis_instances, jax_register_lvis):
        register("synthetic_lvis_val", str(lvis_json), str(root / "coco/val2017"))
    names["synthetic_lvis_val"] = "lvis"

    jcfg = jax_get_config("coco_instance_r50", TINY)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    cfg = get_config("coco_instance_r50", TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    return names, (jcfg, jmodel, variables), (cfg, model)


def _recording(monkeypatch, cls, store):
    orig = cls.process

    def process(self, *args):
        store.append(args)
        return orig(self, *args)

    monkeypatch.setattr(cls, "process", process)


EVALUATORS = {"coco": (jax_coco.COCOMaskAPEvaluator, coco_eval.COCOMaskAPEvaluator),
              "lvis": (jax_lvis.LVISMaskAPEvaluator, lvis_eval.LVISMaskAPEvaluator),
              "sem_seg": (jax_sem.SemSegEvaluator, sem_seg_eval.SemSegEvaluator),
              "coco_panoptic_seg": (jax_pan.PanopticEvaluator, panoptic_eval.PanopticEvaluator)}


def _fwd_eps(logits: torch.Tensor) -> float:
    return 1.5e-3 + 1e-3 * logits.abs().max().item()


def _allowed(etype, resized: torch.Tensor, eps: float) -> np.ndarray:
    """The pixels whose prediction may move within the error band, from the
    port's values resized to the original size (mask logits, or class
    probabilities for sem_seg)."""
    r = resized.float()
    if etype in ("coco", "lvis"):
        return (r.abs() <= eps).numpy()
    top2 = r.topk(2, dim=0).values
    near_tie = (top2[0] - top2[1] <= 2 * eps).numpy()
    if etype == "sem_seg":
        return near_tie
    return near_tie | (r.abs() <= eps).any(0).numpy()


@pytest.mark.parametrize("etype", ["coco", "lvis", "sem_seg", "coco_panoptic_seg"])
def test_run_eval_matches_jax(e2e, etype, monkeypatch):
    import bm2f_tpu_torch.ops as port_ops

    names, (jcfg, jmodel, variables), (cfg, model) = e2e
    name = next(n for n, t in names.items() if t == etype)
    seen = {"jax": [], "port": [], "resized": [], "eps": []}
    _recording(monkeypatch, EVALUATORS[etype][0], seen["jax"])
    _recording(monkeypatch, EVALUATORS[etype][1], seen["port"])
    resize, forward = port_ops.resize_bilinear_dynamic, port_eval._forward

    def recorded_resize(*args):
        seen["resized"].append(resize(*args))
        return seen["resized"][-1]

    def recorded_forward(*args):
        out = forward(*args)
        seen["eps"].append(_fwd_eps(torch.cat([out["pred_logits"].flatten(),
                                               out["pred_masks"].flatten()])))
        return out

    monkeypatch.setattr(port_ops, "resize_bilinear_dynamic", recorded_resize)
    monkeypatch.setattr(port_eval, "_forward", recorded_forward)
    ref = jax_eval.run_eval(jcfg, jmodel, variables, name, **EVAL)
    timings = []
    ours = port_eval.run_eval(cfg, model, name, **EVAL, timings=timings)
    assert len(seen["port"]) == len(seen["jax"]) == len(SIZES) == len(timings)
    assert {t["bucket"] for t in timings} == {EVAL["bucket"]}
    moved, unions = 0, []
    for (a, *ga), (b, *gb), r, eps in zip(seen["port"], seen["jax"], seen["resized"],
                                          seen["eps"]):
        if etype in ("coco", "lvis"):
            np.testing.assert_array_equal(ga[0]["masks"], gb[0]["masks"])  # same GT
            np.testing.assert_array_equal(a["labels"], b["labels"])
            # a score is a softmax probability (error <= 2 * eps in its log)
            # times a mean mask probability (<= eps / 4, and what moved pixels give)
            np.testing.assert_allclose(a["scores"], b["scores"], rtol=3 * eps)
            diff = a["masks"] != b["masks"]
        else:
            np.testing.assert_array_equal(ga[1] if etype != "sem_seg" else ga[0],
                                          gb[1] if etype != "sem_seg" else gb[0])
            diff = a != b
        assert not (diff & ~_allowed(etype, r, eps)).any()
        moved += int(diff.sum())
        if etype == "sem_seg":
            cls = np.union1d(np.unique(a), np.unique(ga[0][ga[0] != 255]))
            unions += [int(((a == c) | (ga[0] == c)).sum()) for c in cls]
    assert ours.keys() == ref.keys()
    if moved == 0:
        for k in ours:
            assert ours[k] == ref[k], (k, ours[k], ref[k])
    elif etype == "sem_seg":
        assert abs(ours["mIoU"] - ref["mIoU"]) <= 100 * moved / min(unions)


def test_entry_point_on_the_cpu(e2e, tmp_path, monkeypatch, capsys):
    """`python -m bm2f_tpu_torch.eval` with a registered synthetic dataset;
    `--tta` on a panoptic dataset is ignored, with a warning, as the root
    `run_eval` ignores it there."""
    names, _, _ = e2e
    root = tmp_path / "data"
    write_synthetic_coco(str(root), SIZES[:1], seed=5)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    monkeypatch.setattr("bm2f_tpu_torch.data.datasets.builtin._REGISTERED", False)
    argv = ["--config", "coco_instance_r50", "--dataset", "coco_2017_val_panoptic",
            "--device", "cpu", "--set", "input.min_size_test=64",
            "--set", "input.max_size_test=128"] + [
        a for k, v in TINY.items() for a in ("--set", f"{k}={v}")]
    from bm2f_tpu_torch.data.catalog import DatasetCatalog

    monkeypatch.setattr(DatasetCatalog, "allow_overwrite", True)
    res = port_eval.main(argv)
    assert {"PQ", "SQ", "RQ"} <= set(res)
    capsys.readouterr()
    assert port_eval.main(argv + ["--tta"]) == res
    assert "applies to sem_seg datasets only" in capsys.readouterr().out
