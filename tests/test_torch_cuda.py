"""The port on the card: its hand-written CUDA kernels against their plain
PyTorch versions, and the full-width R50 Mask2Former on the card against the
from-scratch torch reference forward of tests/torch_oracle.py (run on the
CPU) on one detectron2-named state dict. Imports no JAX, so that it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (decided inside the test, never at import).
"""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.ops import ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import (
    ms_deform_attn_bwd_cuda,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_cuda,
    ms_deform_attn_plain,
)
from bm2f_tpu_torch.utils.convert_weights import load_d2_state_dict
from torch_oracle import make_r50_m2f_state_dict, torch_mask2former_forward

# (B, M, D, P, Q, spatial shapes): ordinary levels, levels of height 1 and
# width 1, a 1x1 level, D over one warp, Q not a power of two
CASES = [
    (1, 2, 32, 4, 20, ((8, 8), (4, 4))),
    (2, 2, 32, 3, 29, ((1, 7), (5, 1), (4, 6))),
    (1, 8, 64, 4, 333, ((1, 1), (3, 9), (16, 12))),
]


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ms_deform_attn_kernel_matches_plain(case):
    dev = require_cuda()
    B, M, D, P, Q, shapes = case
    rng = np.random.RandomState(0)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(dev)
    loc = torch.from_numpy(
        (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)).to(dev)
    attn = torch.from_numpy(
        (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)).to(dev)
    before = ms_deform_attn_cuda.launches
    got = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 1
    want = ms_deform_attn_plain(value, shapes, loc, attn)
    # f32, at most 4*L*P weighted terms summed in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _deform_inputs(case, dev, seed=0):
    B, M, D, P, Q, shapes = case
    rng = np.random.RandomState(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(dev)
    loc = torch.from_numpy(
        (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)).to(dev)
    attn = torch.from_numpy(
        (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)).to(dev)
    grad_out = torch.from_numpy(rng.randn(B, Q, M * D).astype(np.float32)).to(dev)
    return shapes, value, loc, attn, grad_out


# tests/test_ops.py:176-178
GRAD_TOL = {"d_value": dict(rtol=1e-4, atol=1e-5),
            "d_loc": dict(rtol=1e-3, atol=1e-4),
            "d_attn": dict(rtol=1e-4, atol=1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ms_deform_attn_bwd_kernel_matches_plain(case):
    """K2, reached through the autograd Function, against the closed-form
    plain backward; one K1 and one K2 launch."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _deform_inputs(case, dev)
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
    before = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches)
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want = ms_deform_attn_bwd_plain(value, shapes, loc, attn, g)
    for name, a, b in zip(GRAD_TOL, got, want):
        torch.testing.assert_close(a, b, msg=name, **GRAD_TOL[name])


@pytest.mark.cuda
def test_ms_deform_attn_bwd_kernel_repeats():
    """Run twice on the same inputs: d_loc and d_attn are written once per
    sample and come out bitwise equal; d_value is summed with atomics in
    another order each run, so it agrees only to f32 rounding of its sums
    (rtol 1e-5, atol 1e-6 of its largest element, as chip_smoke.py)."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _deform_inputs(CASES[2], dev, seed=1)
    a = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    b = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-6 * a[0].abs().max().item())


@pytest.mark.cuda
def test_ms_deform_attn_kernel_rejects_what_it_does_not_take():
    dev = require_cuda()
    shapes = ((4, 4),)
    value = torch.zeros(1, 16, 2, 16, device=dev)  # D = 16: not a warp multiple
    loc = torch.zeros(1, 3, 2, 1, 4, 2, device=dev)
    attn = torch.zeros(1, 3, 2, 1, 4, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        ms_deform_attn(value, shapes, loc, attn)
    with pytest.raises(TypeError, match="float32"):
        ms_deform_attn(torch.zeros(1, 16, 2, 32, device=dev, dtype=torch.float64),
                       shapes, loc, attn)


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_full_r50_on_card_matches_torch_oracle(no_tf32):
    """coco_instance_r50 at full width (d2 weights through
    `load_d2_state_dict`, K1 in every encoder layer) against the reference
    forward; tolerances of tests/test_full_model_golden.py:58-75."""
    dev = require_cuda()
    rng = np.random.RandomState(3)
    sd = make_r50_m2f_state_dict(rng, 80, 100)
    images = rng.randn(2, 96, 128, 3).astype(np.float32)  # already normalized
    with torch.no_grad():
        ref = torch_mask2former_forward(
            sd, torch.from_numpy(images.transpose(0, 3, 1, 2)).contiguous(), 80, 100)
        model = build_model(get_config("coco_instance_r50"), device=dev)
        model.load_state_dict(load_d2_state_dict(sd), strict=True)
        before = ms_deform_attn_cuda.launches
        ours = model(torch.from_numpy(images).to(dev))
        torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 6
    for key, atol in (("pred_logits", 1e-3), ("pred_masks", 1.5e-3),
                      ("aux_logits", 1e-3), ("aux_masks", 1.5e-3)):
        np.testing.assert_allclose(ours[key].cpu().numpy(), ref[key].numpy(),
                                   rtol=1e-3, atol=atol, err_msg=key)


@pytest.mark.cuda
def test_full_r50_train_step_gradients_match_plain_path(no_tf32):
    """coco_instance_r50 at full width, B=1 at 512x512: the loss and every
    parameter's gradient through K1/K2 against the plain deformable path on
    the same random points (loss rtol 1e-4, gradients within a
    norm-relative 1e-3: a near-tie in the importance top-k can swap one
    sample point). The kernel path launches K1 and K2 once per encoder
    layer."""
    from bm2f_tpu_torch.losses.criterion import draw_points
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

    dev = require_cuda()
    trainer = Trainer(get_config("coco_instance_r50"), device=dev, seed=0)
    perturb_deformable(trainer.model)  # general sampling locations, not a grid
    batch = synthetic_batch(1, 512, 4, seed=2, device=dev)
    points = draw_points(trainer.ccfg, 10, 1, torch.Generator(device=dev).manual_seed(3))
    names, params = zip(*trainer.model.named_parameters())
    res = {}
    for impl in ("auto", "plain"):
        before = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches)
        total, _ = trainer.loss(batch, points, deform_impl=impl)
        grads = torch.autograd.grad(total, params)
        torch.cuda.synchronize()
        launched = (ms_deform_attn_cuda.launches - before[0],
                    ms_deform_attn_bwd_cuda.launches - before[1])
        assert launched == ((6, 6) if impl == "auto" else (0, 0))
        res[impl] = (total.item(), grads)
    (lk, gk), (lp, gp) = res["auto"], res["plain"]
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-4 * abs(lp)
    for name, a, b in zip(names, gk, gp):
        assert (a - b).norm() <= 1e-3 * b.norm(), name
