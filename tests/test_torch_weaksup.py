"""The port's box-supervised losses against the JAX package's, on seeded numpy
inputs: every function of bm2f_tpu_torch/losses/weaksup.py,
`build_weaksup_targets`, `weaksup_set_criterion` (every loss, the
assignments, the gradients) and one SMALL weak train step against a JAX
`value_and_grad` of the same loss on shared weights.

Tolerances, from what each function computes in f32:
- pure data movement and integer arithmetic (`unfold_wo_center`,
  `box_targets_from_masks`, the step scalars): bitwise;
- `rgb_to_lab`: JAX's `cbrt` against `pow(1/3)`, each within an ulp or two
  of f = xyz^(1/3) <= ~1.03, scaled by up to 500 in a: atol 2e-4 (LAB units,
  |a|, |b| <= ~130), rtol 1e-5;
- sums of O(1) terms in another order (dice, log-probabilities, costs):
  rtol 1e-5 and atol 1e-5 (log-probabilities reach 60 at logits of +-30,
  where an f32 ulp is 4e-6);
- thresholds of a computed value (`color_similarity >= 0.3`, `sigmoid >=
  pix_thr`) may flip where the value lies within its own tolerance of the
  threshold: the flips are counted, and each must lie inside that band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.losses import target_prep as jax_tp
from bm2f_tpu.losses import weaksup as jw
from bm2f_tpu.losses.weaksup_criterion import weaksup_set_criterion as jax_weaksup_set_criterion
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize_images
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.losses import target_prep as tp
from bm2f_tpu_torch.losses import weaksup as tw
from bm2f_tpu_torch.losses.criterion import SetCriterionConfig
from bm2f_tpu_torch.losses.weaksup_criterion import weaksup_set_criterion
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.train.trainer import Trainer
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy, jax_variables_to_state_dict
from torch_port_utils import SMALL, randomize, to_numpy_tree

LAB_RTOL, LAB_ATOL = 1e-5, 2e-4
RTOL, ATOL = 1e-5, 1e-5
# color similarity exp(-d/2) <= 1: the LAB error moves the distance d by
# at most 2 sqrt(3) of itself and exp(-d/2) by half that (read 1.1e-5 on
# the images below)
CS_ATOL = 5e-5
BOUNDS = ("left_bounds", "right_bounds", "top_bounds", "bottom_bounds")


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def blocky_images(rng, B, H, W, block=16, noise=2.0):
    """Raw RGB in [0, 255]: one colour per block x block tile, plus uniform
    noise of +-noise, so that neighbours inside a tile are similar (color
    similarity above 0.3) and neighbours across tiles mostly are not."""
    colours = rng.randint(0, 256, (B, -(-H // block), -(-W // block), 3))
    img = colours.repeat(block, 1).repeat(block, 2)[:, :H, :W]
    return np.clip(img + rng.uniform(-noise, noise, img.shape), 0, 255).astype(np.float32)


def rect_masks(rng, B, G, H, W):
    """(B, G, H, W) rectangles; per image one empty, one full and one
    touching the borders, the rest random."""
    m = np.zeros((B, G, H, W), np.float32)
    for b in range(B):
        for g in range(G):
            kind = (b + g) % 4
            if kind == 1:
                m[b, g] = 1.0
            elif kind == 2:
                m[b, g, : H // 2, W // 3:] = 1.0  # top and right borders
            elif kind == 3:
                y0, x0 = rng.randint(0, H - 4), rng.randint(0, W - 4)
                m[b, g, y0:y0 + rng.randint(2, H - y0), x0:x0 + rng.randint(2, W - x0)] = 1.0
    return m


# -- colour ------------------------------------------------------------------


def test_rgb_to_lab_matches_jax():
    """Both branches of both piecewise maps: sRGB at or below 0.04045 and
    above, XYZ at or below 0.008856 and above, and values outside [0, 1]."""
    rng = np.random.RandomState(0)
    rgb = np.concatenate([rng.rand(400, 3), rng.rand(200, 3) * 0.05,
                          rng.uniform(-0.3, 1.3, (100, 3))]).astype(np.float32)
    want = np.asarray(jax.jit(jw.rgb_to_lab)(J(rgb)))
    got = tw.rgb_to_lab(T(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=LAB_RTOL, atol=LAB_ATOL)
    clipped = np.clip(rgb, 0, 1)
    lin = np.where(clipped > 0.04045, ((clipped + 0.055) / 1.055) ** 2.4, clipped / 12.92)
    y = lin @ np.array([0.212671, 0.715160, 0.072169])
    assert (clipped <= 0.04045).sum() > 50 and (clipped > 0.04045).sum() > 50
    assert (y <= 0.008856).sum() > 20 and (y > 0.008856).sum() > 20


@pytest.mark.parametrize("kernel_size,dilation", [(3, 2), (5, 1)])
def test_unfold_wo_center_matches_jax(kernel_size, dilation):
    """Bitwise, on odd sizes, with the same neighbour order."""
    assert tw.neighbor_offsets(kernel_size, dilation) == jw.neighbor_offsets(kernel_size,
                                                                            dilation)
    x = np.random.RandomState(1).randn(2, 7, 9, 3).astype(np.float32)
    want = np.asarray(jax.jit(jw.unfold_wo_center, static_argnums=(1, 2))(
        J(x), kernel_size, dilation))
    got = tw.unfold_wo_center(T(x), kernel_size, dilation).numpy()
    assert got.shape == want.shape == (2, 7, 9, 3, kernel_size ** 2 - 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel_size,dilation", [(3, 2), (5, 1)])
def test_color_similarity_matches_jax(kernel_size, dilation):
    lab = np.asarray(jax.jit(jw.rgb_to_lab)(
        J(blocky_images(np.random.RandomState(2), 2, 13, 11, block=4) / 255.0)))
    want = np.asarray(jax.jit(jw.get_images_color_similarity, static_argnums=(1, 2))(
        J(lab), kernel_size, dilation))
    got = tw.get_images_color_similarity(T(lab), kernel_size, dilation).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=CS_ATOL)


# -- box targets -------------------------------------------------------------


@pytest.mark.parametrize("H,W", [(37, 45), (64, 48)])
def test_box_targets_from_masks_match_jax(H, W):
    """Empty, full, border-touching and random masks, and a soft mask at
    the 0.5 threshold: every output bitwise (empty rows' right and bottom
    bounds 0)."""
    m = rect_masks(np.random.RandomState(3), 2, 4, H, W).reshape(8, H, W)
    m[7, 3:9, 5:20] = 0.5  # exactly at the threshold: not in the mask
    m[7, 10:20, 0:3] = 0.75
    want = jax.jit(jw.box_targets_from_masks)(J(m))
    got = tw.box_targets_from_masks(T(m), stride=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["box_masks"][0].sum() == 0 and got["box_masks"][1].min() == 1
    assert got["right_bounds"][0].max() == 0


# -- projection --------------------------------------------------------------


def _tied_logits(rng, shape):
    """Logits on a grid of 0.5: many equal maxima along rows and columns."""
    return (np.round(rng.randn(*shape) * 2) / 2).astype(np.float32)


def _bounds(rng, N, h, w):
    box = rect_masks(rng, 1, N, h * 4, w * 4)[0]
    return jw.box_targets_from_masks(J(box), stride=4)


def test_projection_loss_and_cost_match_jax_with_ties():
    """Argmax ties go to the first index in both frameworks (the flags), and
    the maxima's gradient is split evenly among ties as JAX's is."""
    rng = np.random.RandomState(4)
    N, Q, h, w = 6, 5, 12, 10
    src = _tied_logits(rng, (N, h, w))
    t = _bounds(rng, N, h, w)
    bounds = {k: t[k] for k in BOUNDS}
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    assert (src == src.max(2, keepdims=True)).sum(2).max() > 1  # ties in rows

    def jloss(s):
        return jw.projection_loss(s, t["box_masks"], bounds, J(valid), 4.0)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(J(src))
    s = T(src).requires_grad_()
    got = tw.projection_loss(s, T(t["box_masks"]), {k: T(v) for k, v in bounds.items()},
                             T(valid), 4.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=1e-7)

    pred = _tied_logits(rng, (Q, h, w))
    want_c = jax.jit(jw.projection_cost_matrix)(J(pred), t["box_masks"], bounds)
    got_c = tw.projection_cost_matrix(T(pred), T(t["box_masks"]),
                                      {k: T(v) for k, v in bounds.items()})
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL, atol=ATOL)


# -- pairwise ----------------------------------------------------------------


def test_log_same_prob_matches_jax_at_large_logits():
    """Logits of +-30 (probabilities within 1e-13 of 0 or 1) beside ordinary
    ones: the values and their gradient."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 9, 11).astype(np.float32) * 3
    x[rng.rand(*x.shape) < 0.3] = 30.0
    x[rng.rand(*x.shape) < 0.3] = -30.0
    gout = rng.randn(3, 9, 11, 8).astype(np.float32)
    want, want_g = jax.jit(lambda v, g: (lambda o, f: (o, f(g)[0]))(
        *jax.vjp(lambda u: jw.log_same_prob(u, 3, 2), v)))(J(x), J(gout))
    xt = T(x).requires_grad_()
    got = tw.log_same_prob(xt, 3, 2)
    got.backward(T(gout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)


def test_pairwise_loss_and_cost_match_jax():
    rng = np.random.RandomState(6)
    N, Q, h, w = 5, 4, 10, 12
    src = rng.randn(N, h, w).astype(np.float32) * 2
    cs = rng.rand(N, h, w, 8).astype(np.float32)
    box = rect_masks(rng, 1, N, h, w)[0]
    valid = np.array([1, 0, 1, 1, 1], np.float32)
    kw = dict(color_thresh=0.3, kernel_size=3, dilation=2, warmup_factor=0.25)

    want, want_g = jax.jit(jax.value_and_grad(
        lambda s: jw.pairwise_loss(s, J(cs), J(box), J(valid), 3.0, **kw)))(J(src))
    s = T(src).requires_grad_()
    got = tw.pairwise_loss(s, T(cs), T(box), T(valid), 3.0, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=1e-8)

    pred = rng.randn(Q, h, w).astype(np.float32) * 2
    cs_g = np.broadcast_to(cs[:1], (N, h, w, 8))
    want_c = jax.jit(lambda *a: jw.pairwise_cost_matrix(*a, **kw))(J(pred), J(cs_g), J(box))
    got_c = tw.pairwise_cost_matrix(T(pred), T(cs[:1]).expand(N, h, w, 8), T(box), **kw)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL, atol=ATOL)


# -- pseudo-mask update and the step's scalars --------------------------------


@pytest.mark.parametrize("pix_thr", [0.0, 0.5, 0.7])
def test_update_box_masks_matches_jax_flips_inside_the_band(pix_thr):
    """`sigmoid(x) >= pix_thr`: the port and JAX may round sigmoid apart by
    an ulp, so a pixel may flip only where sigmoid lies within 1e-6 of the
    threshold. Logits exactly at the threshold's logit are included."""
    rng = np.random.RandomState(7)
    B, Q, G, h, w = 2, 6, 4, 9, 13
    pred = rng.randn(B, Q, h, w).astype(np.float32) * 3
    if 0 < pix_thr < 1:
        pred[:, :, ::3, ::4] = np.float32(np.log(pix_thr / (1 - pix_thr)))
    asg = np.stack([rng.permutation(Q)[:G] for _ in range(B)])
    box = rect_masks(rng, B, G, h, w)
    want = np.asarray(jax.jit(jw.update_box_masks)(J(pred), J(asg), J(box), pix_thr))
    got = tw.update_box_masks(T(pred), T(asg), T(box), pix_thr).numpy()
    prob = 1 / (1 + np.exp(-np.take_along_axis(pred, asg[:, :, None, None], 1).astype(
        np.float64)))
    flips = got != want
    assert (np.abs(prob[flips] - pix_thr) <= 1e-6).all(), prob[flips]
    assert flips.sum() <= 0.05 * flips.size


def test_warmup_and_pixel_threshold_schedules_match_jax():
    for step in (0, 1, 3, 9999, 10000, 10001, 123457):
        for warmup in (0, 1, 3, 10000):
            assert tw.pairwise_warmup_factor(step, warmup) == float(
                jw.pairwise_warmup_factor(jnp.asarray(step), warmup)), (step, warmup)
    for step in (0, 1, 89999, 90000, 90001, 179999, 180000):
        for steps, thrs in (((0.0, 0.5, 1.0), (0.0, 0.5)), ((0.0, 0.3, 0.7), (0.1, 0.4, 0.8))):
            assert tw.mask_update_pix_thr(step, 180000, steps, thrs) == float(
                jw.mask_update_pix_thr(jnp.asarray(step), 180000, steps, thrs)), (step, thrs)


# -- targets -------------------------------------------------------------------


def test_build_weaksup_targets_matches_jax():
    """Box masks and bounds bitwise; color similarity within CS_ATOL, and
    its threshold at 0.3 flipping only inside that band."""
    rng = np.random.RandomState(8)
    B, G, H, W = 2, 5, 64, 48
    images = blocky_images(rng, B, H, W, noise=4.0)
    masks = rect_masks(rng, B, G, H, W)
    labels = rng.randint(0, 80, (B, G)).astype(np.int32)
    valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    want = jax.jit(jax_tp.build_weaksup_targets)(J(images), J(labels), J(masks), J(valid))
    got = tp.build_weaksup_targets(T(images), T(labels), T(masks), T(valid))
    assert set(got) == set(want)
    for k in ("labels", "valid", "box_masks", *BOUNDS):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    cs_w, cs_g = np.asarray(want["color_similarity"]), got["color_similarity"].numpy()
    assert cs_g.shape == (B, 16, 12, 8)
    np.testing.assert_allclose(cs_g, cs_w, rtol=0, atol=CS_ATOL)
    flips = (cs_g >= 0.3) != (cs_w >= 0.3)
    assert (np.abs(cs_w[flips] - 0.3) <= CS_ATOL).all()
    above = (cs_w >= 0.3).mean()
    assert 0.2 < above < 0.95, above  # the threshold splits the edges


# -- the criterion ---------------------------------------------------------------


def _criterion_case(seed=9):
    """Random final + 2 aux layers (B=2, Q=6, G=4, 16x16 masks), targets of
    the JAX `build_weaksup_targets` on blocky images, 3 of 8 targets
    padding (label -1, empty mask)."""
    rng = np.random.RandomState(seed)
    B, Q, K, G, L = 2, 6, 5, 4, 2
    outs = {"pred_logits": rng.randn(B, Q, K + 1), "pred_masks": rng.randn(B, Q, 16, 16) * 3,
            "aux_logits": rng.randn(L, B, Q, K + 1), "aux_masks": rng.randn(L, B, Q, 16, 16) * 3}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 0]], bool)
    masks = rect_masks(rng, B, G, 64, 64) * valid[:, :, None, None]
    labels = np.where(valid, rng.randint(0, K, (B, G)), -1).astype(np.int32)
    targets = jax.jit(jax_tp.build_weaksup_targets)(J(blocky_images(rng, B, 64, 64)),
                                                    J(labels), J(masks), J(valid))
    return outs, {k: np.asarray(v) for k, v in targets.items()}, K


@pytest.mark.parametrize("pix_thr", [None, 0.5], ids=["no_update", "update"])
@pytest.mark.parametrize("sup_type", ["mask_projection", "mask_projection_and_pairwise"])
def test_weaksup_set_criterion_matches_jax(sup_type, pix_thr):
    """The costs of every layer (through the assign functions), equal
    assignments, every loss, the total and the gradients of the outputs."""
    outs, targets, K = _criterion_case()
    kw = dict(sup_type=sup_type, projection_weight=5.0, pairwise_weight=5.0,
              color_thresh=0.3, kernel_size=3, dilation=2, warmup_factor=0.5,
              mask_update_pix_thr=pix_thr)
    from bm2f_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
    from bm2f_tpu.matching.hungarian import assign_fn_default

    def f(o):
        seen = []

        def jassign(c):
            seen.append(c)
            return assign_fn_default(c)

        total, losses = jax_weaksup_set_criterion(
            o, {k: J(v) for k, v in targets.items()}, JaxCriterionConfig(num_classes=K),
            None, assign_fn=jassign, **kw)
        return total, (losses, seen[0])

    (jtotal, (jlosses, jcosts)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: J(v) for k, v in outs.items()})
    jasg = np.asarray(assign_fn_default(jcosts))
    seen = {}

    def tassign(c):
        seen["costs"] = c
        seen["asg"] = assign(c)
        return seen["asg"]

    o = {k: T(v).requires_grad_() for k, v in outs.items()}
    total, losses = weaksup_set_criterion(o, {k: T(v) for k, v in targets.items()},
                                          SetCriterionConfig(num_classes=K),
                                          assign_fn=tassign, **kw)
    total.backward()

    np.testing.assert_allclose(seen["costs"].numpy(), np.asarray(jcosts), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(seen["asg"].numpy(), jasg)
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=RTOL)
    if "pairwise" in sup_type:
        assert losses["loss_pairwise"].item() > 0
    for k in outs:
        np.testing.assert_allclose(o[k].grad.numpy(), np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


# -- the SMALL weak step ---------------------------------------------------------

WEAK, WEAK_SUP = "coco_instance_r50_wo_lsj_projpair", "mask_projection_and_pairwise"
# step 5 of 10: pairwise warmup 0.5, pixel threshold 0.5 (mask update on)
WEAK_OVER = {**SMALL, "model.loss.weak.pairwise.warmup_iters": 10,
             "model.loss.weak.mask_update_enabled": True, "train.optimizer.max_iter": 10}
STEP = 5


@pytest.fixture(scope="module")
def weak_step():
    """The SMALL model on a (2, 64, 64, 3) batch of blocky images with 4
    rectangle targets each, 1 of image 0 padding: JAX's value_and_grad of
    build_weaksup_targets + weaksup_set_criterion at STEP, and the port's
    Trainer at step_count STEP."""
    jcfg = jax_get_config(WEAK, WEAK_OVER)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    rng = np.random.RandomState(10)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    batch = {"images": blocky_images(rng, 2, 64, 64),
             "labels": np.where(valid, rng.randint(0, 80, (2, 4)), -1).astype(np.int32),
             "masks": rect_masks(rng, 2, 4, 64, 64) * valid[:, :, None, None],
             "valid": valid}
    weak = jcfg.model.loss.weak
    warm = jw.pairwise_warmup_factor(jnp.asarray(STEP), weak.pairwise.warmup_iters)
    thr = jw.mask_update_pix_thr(jnp.asarray(STEP), jcfg.train.optimizer.max_iter,
                                 weak.mask_update_steps, weak.mask_update_pix_thrs)
    assert float(warm) == 0.5 and float(thr) == 0.5

    def loss_fn(p):
        out = jmodel.apply({"params": p, "frozen": variables["frozen"]},
                           jax_normalize_images(J(batch["images"]), jcfg.model))
        targets = jax_tp.build_weaksup_targets(*(J(batch[k]) for k in
                                                 ("images", "labels", "masks", "valid")))
        return jax_weaksup_set_criterion(
            out, targets, jax_criterion_config(jcfg), None, sup_type=WEAK_SUP,
            projection_weight=weak.projection_weight, pairwise_weight=weak.pairwise_weight,
            color_thresh=weak.pairwise.color_thresh, warmup_factor=warm,
            mask_update_pix_thr=thr)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))

    cfg = get_config(WEAK, WEAK_OVER)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    trainer.optimizer.count = STEP
    metrics = trainer.step({k: T(v) for k, v in batch.items()})
    ref = {"losses": {k: float(v) for k, v in jlosses.items()}, "total": float(jtotal),
           "grad_norm": float(optax.global_norm(jgrads)),
           "grads": jax_tree_to_numpy({"params": jgrads})}
    return ref, metrics, trainer


def test_small_weak_step_losses_match_jax(weak_step):
    ref, metrics, _ = weak_step
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert ref["losses"]["loss_pairwise"] > 0 and ref["losses"]["loss_mask_projection"] > 0
    np.testing.assert_allclose(metrics["total_loss"].item(), ref["total"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-3)


def test_small_weak_step_gradients_match_jax(weak_step):
    """Every parameter's gradient within a norm-relative 1e-3, as the mask
    step's (tests/test_torch_train.py), the deformable projections
    included."""
    ref, _, trainer = weak_step
    checked = 0
    for name, p in trainer.model.named_parameters():
        want = ref["grads"][name]
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))
        checked += ".self_attn.sampling_offsets." in name and np.linalg.norm(want) > 0
    assert checked == 4
