"""Test-time augmentation of the port (`models/tta.py`, `run_eval(...,
tta=True)`) against the JAX package's (`bm2f_tpu/models/tta.py`, root
`eval.py` `eval_semantic(tta=True)`).

1. `semantic_tta` on a shared deterministic `predict_fn` built from numpy
   (a fixed projection of the input's pixels, the same function in both
   frameworks): both resize the same f32 values with the same index math,
   so the averaged probabilities agree to f32 rounding of a few bilinear
   sums, held at 1e-6 (probabilities lie in [0, 1]).
2. The sizes of each scale, Python's round (half to even), on sides where
   side * s / 32 lands on .5.
3. `semantic_tta` through a tiny model on shared weights: each forward's
   probabilities differ as the whole-model parity allows
   (tests/test_torch_eval_e2e.py: FWD_EPS = 1.5e-3 + 1e-3 max|logit|; a
   probability moves by at most its logits' error), and an average of
   bilinear resizes of them by no more.
4. `run_eval(tta=True)` against the root eval's on a synthetic
   `ade20k_sem_seg_val` split of 2 images: a pixel's label may differ only
   where the port's top two averaged probabilities lie within 2 FWD_EPS;
   the mIoU then by at most 100 * moved / the smallest class union, and is
   equal when no pixel moved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval as jax_eval
from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.data.datasets import register_all_builtin_datasets as jax_register
from bm2f_tpu.evaluation import sem_seg_eval as jax_sem
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize
from bm2f_tpu.models.tta import semantic_tta as jax_semantic_tta
from bm2f_tpu_torch import eval as port_eval
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.synthetic import STUFF, THINGS, write_synthetic_coco
from bm2f_tpu_torch.evaluation import sem_seg_eval
from bm2f_tpu_torch.models import build_model, tta
from bm2f_tpu_torch.models.maskformer import normalize_images
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_port_utils import to_numpy_tree

Q, K = 6, 5
TINY = {"model.backbone.resnet.depth": 14, "model.decoder.dec_layers": 1,
        "model.decoder.num_queries": 8, "model.pixel_decoder.transformer_enc_layers": 1,
        "model.num_classes": THINGS + STUFF}
SIZES = ((48, 80), (48, 80))  # one size: one JAX compile a scale


def _numpy_predictor(seed=0):
    """A fixed, framework-independent (1, h, w, 3) -> (logits (1, Q, K+1),
    masks (1, Q, h/4, w/4)): every 4th pixel projected to Q mask logits,
    the mean colour to the class logits."""
    rng = np.random.RandomState(seed)
    wm = rng.randn(3, Q).astype(np.float32) / 40
    bm = rng.randn(Q).astype(np.float32)
    wl = rng.randn(3, Q * (K + 1)).astype(np.float32) / 40

    def jax_fn(v):
        feat = v[0, ::4, ::4, :] / 255.0 * 40
        masks = jnp.einsum("hwc,cq->qhw", feat, wm) + bm[:, None, None]
        logits = (feat.mean((0, 1)) @ wl).reshape(Q, K + 1)
        return logits[None], masks[None]

    def torch_fn(v):
        feat = v[0, ::4, ::4, :] / 255.0 * 40
        masks = torch.einsum("hwc,cq->qhw", feat, torch.from_numpy(wm)) \
            + torch.from_numpy(bm)[:, None, None]
        logits = (feat.mean((0, 1)) @ torch.from_numpy(wl)).reshape(Q, K + 1)
        return logits[None], masks[None]

    return jax_fn, torch_fn


@pytest.mark.parametrize("hw,flip", [((48, 80), True), ((80, 48), False), ((37, 53), True)])
def test_semantic_tta_matches_jax_on_a_shared_predictor(hw, flip):
    jax_fn, torch_fn = _numpy_predictor()
    image = np.random.RandomState(1).randint(0, 256, (*hw, 3)).astype(np.float32)
    ref = np.asarray(jax_semantic_tta(jax_fn, jnp.asarray(image), flip=flip))
    ours = tta.semantic_tta(torch_fn, torch.from_numpy(image), flip=flip).numpy()
    assert ours.shape == (*hw, K)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    # the flip takes part: without it the map differs
    if flip:
        plain = tta.semantic_tta(torch_fn, torch.from_numpy(image), flip=False).numpy()
        assert np.abs(plain - ours).max() > 1e-3


def test_sizes_round_half_to_even():
    """side * s / 32 on .5: 48 * 1.0 / 32 = 1.5 -> 2, 80 * 1.0 / 32 = 2.5 ->
    2, 80 * 0.5 / 32 = 1.25 -> 1; and the predictor sees those sizes."""
    scales = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
    sizes = tta.tta_sizes(48, 80, scales)
    assert sizes == [(int(round(48 * s / 32)) * 32, int(round(80 * s / 32)) * 32)
                     for s in scales]
    assert sizes[2] == (64, 64) and sizes[0] == (32, 32)
    seen = []
    _, torch_fn = _numpy_predictor()

    def recording(v):
        seen.append(tuple(v.shape[1:3]))
        return torch_fn(v)

    tta.semantic_tta(recording, torch.zeros(48, 80, 3), scales)
    assert seen == [s for s in sizes for _ in range(2)]


def _fwd_eps(logits) -> float:
    return 1.5e-3 + 1e-3 * float(np.abs(np.asarray(logits)).max())


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = jax_get_config("coco_instance_r50", TINY)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    cfg = get_config("coco_instance_r50", TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    return (jcfg, jmodel, variables), (cfg, model)


def test_semantic_tta_through_a_model_matches_jax(tiny_models):
    (jcfg, jmodel, variables), (cfg, model) = tiny_models
    scales = (0.75, 1.0, 1.25)
    eps = []

    @jax.jit
    def jax_fn(v):
        out = jmodel.apply(variables, jax_normalize(v, jcfg.model))
        return out["pred_logits"], out["pred_masks"]

    def torch_fn(v):
        with torch.no_grad():
            out = model(normalize_images(v, cfg.model))
        eps.append(_fwd_eps(torch.cat([out["pred_logits"].flatten(),
                                       out["pred_masks"].flatten()])))
        return out["pred_logits"], out["pred_masks"]

    image = np.random.RandomState(2).randint(0, 256, (40, 56, 3)).astype(np.float32)
    ref = np.asarray(jax_semantic_tta(jax_fn, jnp.asarray(image), scales))
    ours = tta.semantic_tta(torch_fn, torch.from_numpy(image), scales).numpy()
    assert len(eps) == 2 * len(scales)
    assert ours.shape == ref.shape == (40, 56, THINGS + STUFF)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=max(eps))


@pytest.fixture(scope="module")
def ade_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_ade")
    write_synthetic_coco(str(root), SIZES, seed=6)
    register_all_builtin_datasets(str(root), force=True)
    jax_register(str(root), force=True)
    return "ade20k_sem_seg_val"


def _recording(monkeypatch, cls, store):
    orig = cls.process

    def process(self, *args):
        store.append(args)
        return orig(self, *args)

    monkeypatch.setattr(cls, "process", process)


def test_run_eval_tta_matches_jax(tiny_models, ade_split, monkeypatch):
    (jcfg, jmodel, variables), (cfg, model) = tiny_models
    seen = {"jax": [], "port": [], "probs": [], "eps": []}
    _recording(monkeypatch, jax_sem.SemSegEvaluator, seen["jax"])
    _recording(monkeypatch, sem_seg_eval.SemSegEvaluator, seen["port"])
    semantic_tta, forward = tta.semantic_tta, port_eval._forward

    def recorded_tta(*args, **kw):
        seen["probs"].append(semantic_tta(*args, **kw))
        return seen["probs"][-1]

    def recorded_forward(*args):
        out = forward(*args)
        seen["eps"].append(_fwd_eps(torch.cat([out["pred_logits"].flatten(),
                                               out["pred_masks"].flatten()])))
        return out

    monkeypatch.setattr(tta, "semantic_tta", recorded_tta)
    monkeypatch.setattr(port_eval, "_forward", recorded_forward)
    ref = jax_eval.run_eval(jcfg, jmodel, variables, ade_split, tta=True)
    timings = []
    ours = port_eval.run_eval(cfg, model, ade_split, tta=True, timings=timings)
    assert len(seen["port"]) == len(seen["jax"]) == len(SIZES) == len(timings)
    assert len(seen["eps"]) == 12 * len(SIZES)  # 6 scales, each flipped
    assert [t["hw"] for t in timings] == [list(s) for s in SIZES]  # original sizes
    eps = max(seen["eps"])
    moved, unions = 0, []
    for (a, ga), (b, gb), p in zip(seen["port"], seen["jax"], seen["probs"]):
        np.testing.assert_array_equal(ga, gb)
        assert a.shape == b.shape == ga.shape
        top2 = p.topk(2, dim=-1).values
        diff = a != b
        assert not (diff & ~(top2[..., 0] - top2[..., 1] <= 2 * eps).numpy()).any()
        moved += int(diff.sum())
        cls = np.union1d(np.unique(a), np.unique(ga[ga != 255]))
        unions += [int(((a == c) | (ga == c)).sum()) for c in cls]
    assert ours.keys() == ref.keys()
    if moved == 0:
        for k in ours:
            assert ours[k] == ref[k], (k, ours[k], ref[k])
    else:
        assert abs(ours["mIoU"] - ref["mIoU"]) <= 100 * moved / min(unions)


def test_tta_on_other_evaluators_is_ignored(tiny_models, ade_split, capsys):
    """The root `run_eval` passes `tta` to `eval_semantic` only; the port
    evaluates the panoptic split without it, and says so."""
    _, (cfg, model) = tiny_models
    kw = dict(short_edge=64, max_size=128, bucket=128)
    with_tta = port_eval.run_eval(cfg, model, "coco_2017_val_panoptic", tta=True, **kw)
    assert "applies to sem_seg datasets only" in capsys.readouterr().out
    assert with_tta == port_eval.run_eval(cfg, model, "coco_2017_val_panoptic", **kw)
