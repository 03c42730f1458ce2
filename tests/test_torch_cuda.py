"""The port on the card: its hand-written CUDA kernels against their plain
PyTorch versions (K1 on f32 and bf16 values, K2 on f32 and bf16 values, its
d_value bitwise equal across runs, tile orders and to the plain mirror of its
design, and under deterministic algorithms, the probe's K3 and K4), the
full-width R50 Mask2Former on the card against the from-scratch torch
reference forward of tests/torch_oracle.py (run on the CPU) on one
detectron2-named state dict, the full-width bf16 forward against the f32
kernel path, and the f32 entry points computing in f32 whatever the global
TF32 flags say. Imports no JAX, so that it runs on a machine with a card and no
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (decided inside the test, never at import).
"""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.ops import deform_attn, ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import (
    TilePlan,
    d_value_by_destination,
    destination_plan,
    ms_deform_attn_bwd_cuda,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_cuda,
    ms_deform_attn_plain,
    tile_plan,
)
from bm2f_tpu_torch.ops.gather_probe import (
    row_gather_sum_cuda,
    row_gather_sum_onehot_cuda,
    row_gather_sum_plain,
)
from bm2f_tpu_torch.tools.roofline_microbench import make_inputs
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_ms_deform_attn_kernel_matches_plain(case, dtype):
    """K1 on an f32 or a bf16 `value` (bf16 rows, f32 arithmetic, as the
    plain version, which upcasts `value`): one launch, counted by dtype."""
    dev = require_cuda()
    B, M, D, P, Q, shapes = case
    rng = np.random.RandomState(0)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(dev, dtype)
    loc = torch.from_numpy(
        (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)).to(dev)
    attn = torch.from_numpy(
        (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)).to(dev)
    before = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    with torch.no_grad():
        got = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    assert got.dtype == torch.float32
    want = ms_deform_attn_plain(value, shapes, loc, attn)
    # f32, at most 4*L*P weighted terms summed in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("coherent", [False, True], ids=["random", "coherent"])
@pytest.mark.parametrize("S", [40, 625, 2500])
def test_gather_probe_kernels_bitwise_equal_plain(S, coherent):
    """K3 and K4, f32 and bf16 tables, at a middle size: BM 4, QP 1000 (not
    a multiple of K4's 64-query pass), K 4; a few indices out of range."""
    dev = require_cuda()
    table, idx = make_inputs(S, coherent, 4, 1000, 4)
    idx[1, 2, :4] = [-1, S, S + 7, -5]
    t, i = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
    want = row_gather_sum_plain(t, i)
    for dtype in (torch.float32, torch.bfloat16):
        tt = t.to(dtype)
        for fn in (row_gather_sum_cuda, lambda a, b: row_gather_sum_onehot_cuda(a, b, 128)):
            got = fn(tt, i)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (dtype, (got - want).abs().max().item())
    assert row_gather_sum_cuda.launches_bf16 > 0 and row_gather_sum_onehot_cuda.launches_bf16 > 0


# (BM, S, K, QP, pattern) of the gather kernels' edge cases: S not a multiple
# of a chunk or an MMA k-step, QP not a multiple of K3's 32-query run, K4's
# 64-query pass or its qt, K = 1..4, BM = 1, and the index patterns of
# `_gather_inputs`
GATHER_CASES = [
    (2, 1, 4, 100, "random"),
    (2, 40, 4, 100, "random"),
    (2, 625, 4, 100, "random"),
    (2, 2500, 4, 100, "random"),
    (2, 10000, 4, 100, "random"),
    (1, 625, 4, 1, "random"),
    (1, 625, 4, 13125, "random"),
    (3, 625, 1, 100, "random"),
    (3, 625, 2, 100, "random"),
    (3, 2500, 3, 100, "random"),
    (2, 625, 4, 300, "out_of_range"),
    (2, 2500, 4, 300, "one_row"),
    (2, 2500, 4, 300, "one_chunk"),
    (2, 2500, 4, 300, "empty_pass"),
]


def _gather_inputs(BM, S, K, QP, pattern, seed=0):
    """A bf16-representable table and uniform indices, then: `out_of_range`
    puts -1, S and 2^30 among them; `one_row` sends every index to one row;
    `one_chunk` keeps them in one 32-row block (inside one chunk of K4 in
    f32 and in bf16); `empty_pass` leaves queries 64-127 (a whole K4 pass)
    with no index in range."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(BM, S, 128).astype(np.float32))
    table = table.to(torch.bfloat16).float().numpy()
    idx = rng.randint(0, S, (BM, K, QP)).astype(np.int32)
    if pattern == "out_of_range":
        idx.reshape(-1)[::7] = -1
        idx.reshape(-1)[3::7] = S
        idx.reshape(-1)[5::7] = 2**30
    elif pattern == "one_row":
        idx[...] = S // 2
    elif pattern == "one_chunk":
        lo = S // 2 // 64 * 64
        idx = (lo + rng.randint(0, min(32, S - lo), idx.shape)).astype(np.int32)
    elif pattern == "empty_pass":
        idx[:, :, 64:128] = -1
    return table, idx


def _twice_bitwise(wrapper, call, bf16, want):
    """Two calls of one kernel: each equal to the plain version (torch.equal,
    as the probe checks), equal to each other, one launch counted each."""
    counter = "launches_bf16" if bf16 else "launches"
    before = getattr(wrapper, counter)
    a, b = call(), call()
    torch.cuda.synchronize()
    assert getattr(wrapper, counter) == before + 2
    assert torch.equal(a, want), (a - want).abs().max().item()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: "-".join(map(str, c)))
def test_gather_kernels_edge_cases_bitwise_equal_plain(case, dtype):
    """K3, and K4 at qt 64 and 192 (one and three passes a block), on every
    edge case, in f32 and bf16: bitwise equal to the plain version and
    across two runs, one launch counted per call."""
    dev = require_cuda()
    table, idx = _gather_inputs(*case)
    t = torch.from_numpy(table).to(dev, dtype)
    i = torch.from_numpy(idx).to(dev)
    want = row_gather_sum_plain(t, i)
    bf16 = dtype == torch.bfloat16
    _twice_bitwise(row_gather_sum_cuda, lambda: row_gather_sum_cuda(t, i), bf16, want)
    for qt in (64, 192):
        _twice_bitwise(row_gather_sum_onehot_cuda,
                       lambda: row_gather_sum_onehot_cuda(t, i, qt), bf16, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pattern", ["random", "out_of_range"])
def test_gather_rows_any_k(pattern, dtype):
    """K3 at K = 7 (its indices walked in chunks of 4) and K = 0 (zero
    rows), bitwise equal to the plain version."""
    dev = require_cuda()
    for K in (7, 0):
        table, idx = _gather_inputs(2, 625, K, 100, pattern)
        t = torch.from_numpy(table).to(dev, dtype)
        i = torch.from_numpy(idx).to(dev)
        want = row_gather_sum_plain(t, i)
        _twice_bitwise(row_gather_sum_cuda, lambda: row_gather_sum_cuda(t, i),
                       dtype == torch.bfloat16, want)


@pytest.mark.cuda
@pytest.mark.parametrize("coherent", [False, True], ids=["random", "coherent"])
@pytest.mark.parametrize("S", [625, 2500, 10000])
def test_gather_probe_kernels_production_shapes(S, coherent):
    """The probe's own data at its production shapes (BM 32, QP 13312, K 4,
    qt 512): K3 and K4 in f32 and bf16, bitwise equal to the plain version
    and across two runs."""
    dev = require_cuda()
    table, idx = make_inputs(S, coherent)
    t, i = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
    want = row_gather_sum_plain(t, i)
    for dtype in (torch.float32, torch.bfloat16):
        tt = t.to(dtype)
        bf16 = dtype == torch.bfloat16
        _twice_bitwise(row_gather_sum_cuda, lambda: row_gather_sum_cuda(tt, i), bf16, want)
        _twice_bitwise(row_gather_sum_onehot_cuda,
                       lambda: row_gather_sum_onehot_cuda(tt, i, 512), bf16, want)


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
    sample, and d_value is summed destination-major in a fixed order, so
    all three come out bitwise equal."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _deform_inputs(CASES[2], dev, seed=1)
    a = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    b = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# encoder-like calls (Q == S: the queries are the levels' pixels): (B, M, D,
# P, spatial shapes). The model's L=3, P=4, D=32 (the unrolled instantiation)
# at two level sets, and the generic one (L=2, P=3, D=64)
ENCODER_CASES = [
    (1, 2, 32, 4, ((13, 13), (25, 25), (50, 50))),
    (2, 2, 32, 4, ((8, 8), (16, 16), (32, 32))),
    (2, 2, 64, 3, ((5, 7), (10, 14))),
]


def _encoder_inputs(case, dev, far: bool, seed=0):
    """Locations at the encoder's reference points +- a few pixels of each
    level; with `far`, a quarter of the samples pushed 10-30 pixels away
    (across tiles, or outside their level)."""
    from bm2f_tpu_torch.models.pixel_decoder import encoder_reference_points

    B, M, D, P, shapes = case
    rng = np.random.RandomState(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    off = rng.randn(B, S, M, L, P, 2) * 2.0
    if far:
        push = rng.rand(B, S, M, L, P, 1) < 0.25
        off += push * rng.choice([-1, 1], off.shape) * rng.uniform(10, 30, off.shape)
    ref = encoder_reference_points(shapes).numpy()[None, :, None, :, None, :]
    norm = np.array([[w, h] for h, w in shapes])[None, None, None, :, None, :]
    loc = (ref + off / norm).astype(np.float32)
    value = rng.randn(B, S, M, D).astype(np.float32)
    attn = rng.rand(B, S, M, L * P).astype(np.float32)
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(B, S, M, L, P)
    g = rng.randn(B, S, M * D).astype(np.float32)
    return shapes, *(torch.from_numpy(a).to(dev) for a in (value, loc, attn, g))


@pytest.mark.cuda
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ENCODER_CASES)
def test_ms_deform_attn_kernel_encoder_tiles_match_plain(case, dtype, far):
    """K1 on encoder-like inputs (Q == S), the samples near their reference
    points or, with
    `far`, a quarter of them far off or outside their level. One launch,
    rtol/atol 1e-5 against the plain version."""
    dev = require_cuda()
    shapes, value, loc, attn, _ = _encoder_inputs(case, dev, far)
    value = value.to(dtype)
    before = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    got = ms_deform_attn_cuda(value, shapes, loc, attn)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    want = ms_deform_attn_plain(value, shapes, loc, attn)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("case", ENCODER_CASES)
def test_ms_deform_attn_bwd_kernel_encoder_tiles_match_plain(case, far):
    """K2 on the encoder-like inputs of the K1 test (Q == S: blocks take
    encoder cells of neighbouring queries). One launch per call;
    GRAD_TOL against the closed-form plain backward; all three gradients
    bitwise equal across two runs."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _encoder_inputs(case, dev, far, seed=1)
    before = ms_deform_attn_bwd_cuda.launches
    a = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    b = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert ms_deform_attn_bwd_cuda.launches == before + 2
    want = ms_deform_attn_bwd_plain(value, shapes, loc, attn, g)
    for name, x, w in zip(GRAD_TOL, a, want):
        torch.testing.assert_close(x, w, msg=name, **GRAD_TOL[name])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# K2 on a bf16 `value` against the plain bf16 backward: d_value is an f32 sum
# rounded to bf16 once by both, the sums in another order, so an element may
# round to the next bf16 (2^-8 of it) or move by the f32 noise of the largest
# sum; d_loc and d_attn are f32 sums of f32 products of the same bf16 rows
BF16_D_VALUE_RTOL, BF16_D_VALUE_ATOL_OF_MAX = 2.0 ** -7, 1e-5


def _check_bf16_bwd(got, want, second):
    """K2-bf16's (d_value, d_loc, d_attn) against the plain bf16 backward,
    and a second run: all three bitwise equal."""
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    scale = want[0].float().abs().max().item()
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=BF16_D_VALUE_RTOL,
                               atol=BF16_D_VALUE_ATOL_OF_MAX * scale)
    for name, a, b in zip(("d_loc", "d_attn"), got[1:], want[1:]):
        torch.testing.assert_close(a, b, msg=name, **GRAD_TOL[name])
    for a, b in zip(got, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ms_deform_attn_bwd_bf16_kernel_matches_plain(case):
    """K2 on a bf16 `value`, reached through the autograd Function: one
    K1-bf16 and one K2-bf16 launch, d_value in bf16, against the plain bf16
    backward (which upcasts, computes in f32 and rounds d_value once)."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _deform_inputs(case, dev)
    value = value.to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
    before = (ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16,
              ms_deform_attn_bwd_cuda.launches)
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16,
            ms_deform_attn_bwd_cuda.launches) == (before[0] + 1, before[1] + 1, before[2])
    want = ms_deform_attn_bwd_plain(value, shapes, loc, attn, g)
    _check_bf16_bwd(got, want, ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g))


@pytest.mark.cuda
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("case", ENCODER_CASES)
def test_ms_deform_attn_bwd_bf16_kernel_encoder_tiles_match_plain(case, far):
    """K2-bf16 on the encoder-like inputs (Q == S, encoder cells), the
    model's L=3, P=4, D=32 instantiation and the generic one, twice."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _encoder_inputs(case, dev, far, seed=1)
    value = value.to(torch.bfloat16)
    a = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    b = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    _check_bf16_bwd(a, ms_deform_attn_bwd_plain(value, shapes, loc, attn, g), b)


@pytest.mark.cuda
def test_ms_deform_attn_bwd_kernel_alerts_under_deterministic_algorithms():
    """K2 uses no float atomics, so under torch.use_deterministic_algorithms
    it raises nothing and warns nothing (warnings are errors here),
    launches, and repeats bitwise, on an f32 and a bf16 `value`."""
    import warnings

    dev = require_cuda()
    shapes, value, loc, attn, g = _deform_inputs(CASES[0], dev)
    before = (ms_deform_attn_bwd_cuda.launches, ms_deform_attn_bwd_cuda.launches_bf16)
    try:
        torch.use_deterministic_algorithms(True)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for v in (value, value.to(torch.bfloat16)):
                a = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
                b = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
                torch.cuda.synchronize()
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
    finally:
        torch.use_deterministic_algorithms(False)
    assert (ms_deform_attn_bwd_cuda.launches, ms_deform_attn_bwd_cuda.launches_bf16) == (
        before[0] + 2, before[1] + 2)


def _reversed_tables(shapes, Q, dev, seed=3):
    """K2's tile tables with the tiles in reverse order and the queries of
    each tile shuffled, as `_device_plan` returns them."""
    plan = tile_plan(shapes, Q, cells=True)
    rng = np.random.RandomState(seed)
    ptr = plan.tile_ptr
    tiles = [rng.permutation(plan.tile_q[ptr[t]:ptr[t + 1]]) for t in range(len(ptr) - 1)]
    tiles = tiles[::-1]
    new = TilePlan(np.concatenate([[0], np.cumsum([len(t) for t in tiles])]).astype(np.int32),
                   np.concatenate(tiles).astype(np.int32))
    return (*(torch.from_numpy(a).to(dev) for a in new), len(tiles))


# the encoder cases near and far, and two with Q != S (runs of queries)
MIRROR_CASES = [(c, far) for c in ENCODER_CASES for far in (False, True)] + [
    (CASES[1], None), (CASES[2], None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,far", MIRROR_CASES)
def test_ms_deform_attn_bwd_kernel_equals_plain_mirror_and_ignores_tile_order(case, far, dtype):
    """K2's d_value bitwise equal to the plain mirror of its design
    (`destination_plan`, `d_value_by_destination`: the same products and
    sums in the same order, a multiply and an add each rounded), and all
    three gradients bitwise equal when its tiles come in reverse order with
    the queries of each shuffled."""
    dev = require_cuda()
    if far is None:
        shapes, value, loc, attn, g = _deform_inputs(case, dev, seed=4)
    else:
        shapes, value, loc, attn, g = _encoder_inputs(case, dev, far, seed=1)
    value = value.to(dtype)
    got = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    tables = _reversed_tables(shapes, loc.shape[1], dev)
    orig = deform_attn._device_plan
    deform_attn._device_plan = lambda *args: tables
    try:
        rev = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    finally:
        deform_attn._device_plan = orig
    torch.cuda.synchronize()
    for x, y in zip(got, rev):
        assert torch.equal(x, y)
    mirror = d_value_by_destination(destination_plan(shapes, loc, attn), shapes, g,
                                    value.shape[2], dtype)
    assert got[0].dtype == mirror.dtype == dtype
    assert torch.equal(got[0], mirror), (got[0].float() - mirror.float()).abs().max().item()


# coco_instance_r50 at full width with a depth-14 ResNet and 3 decoder layers
SMALL_CARD = {"model.backbone.resnet.depth": 14, "model.decoder.dec_layers": 3,
              "model.decoder.num_queries": 20}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_is_bitwise_repeatable_under_deterministic_algorithms(dtype):
    """A whole train step (SMALL_CARD at 512x512, K1 and K2 on every encoder
    layer) under torch.use_deterministic_algorithms(True): PyTorch alerts
    about no operation (warnings are errors here), and two trainers from one
    seed end the step with the same bits in every parameter and buffer."""
    import warnings

    from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

    dev = require_cuda()
    over = {} if dtype == "float32" else {"model.dtype": "bfloat16",
                                          "model.pixel_decoder_f32": False}
    states = []
    launches = ms_deform_attn_bwd_cuda.launches + ms_deform_attn_bwd_cuda.launches_bf16
    try:
        torch.use_deterministic_algorithms(True)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for _ in range(2):
                trainer = Trainer(get_config("coco_instance_r50", {**SMALL_CARD, **over}),
                                  device=dev, seed=0)
                trainer.step(synthetic_batch(2, 512, 4, seed=0, device=dev))
                torch.cuda.synchronize()
                states.append({k: v.detach().clone()
                               for k, v in trainer.model.state_dict().items()})
    finally:
        torch.use_deterministic_algorithms(False)
    assert (ms_deform_attn_bwd_cuda.launches + ms_deform_attn_bwd_cuda.launches_bf16
            - launches) == 2 * 6  # 6 encoder layers a step
    differing = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    assert not differing, differing[:8]


@pytest.mark.cuda
def test_mask_criterion_at_the_cells_padding_matches_the_cpu_and_repeats():
    """`set_criterion` at the train cells' padding: G = 100 slots of which
    8 and 3 hold targets (G' = 8), 100 queries, 256x256 mask logits against
    1024x1024 targets, the default 112*112 points, 3 aux layers, in the
    train step's scopes (f32 without TF32, deterministic algorithms): on the
    card, under the CPU's assignment and on its points, every term and the
    gradients of the mask logits equal the CPU's (rtol 1e-5, atol 1e-5 of
    the largest), and a second run repeats them bitwise."""
    from bm2f_tpu_torch.losses.criterion import SetCriterionConfig, draw_points, set_criterion
    from bm2f_tpu_torch.matching.hungarian import assign
    from bm2f_tpu_torch.utils.precision import deterministic_scope, f32_scope

    dev = require_cuda()
    B, Q, G, K, L, h, Hg = 2, 100, 100, 80, 4, 256, 1024
    g = torch.Generator().manual_seed(0)
    outputs = {"pred_logits": torch.randn(B, Q, K + 1, generator=g) * 2,
               "pred_masks": torch.randn(B, Q, h, h, generator=g) * 3,
               "aux_logits": torch.randn(L - 1, B, Q, K + 1, generator=g) * 2,
               "aux_masks": torch.randn(L - 1, B, Q, h, h, generator=g) * 3}
    valid = torch.zeros(B, G, dtype=torch.bool)
    valid[0, :8] = True
    valid[1, :3] = True
    cells = torch.rand(B, G, Hg // 64, Hg // 64, generator=g) > 0.6
    targets = {"labels": torch.randint(0, K, (B, G), generator=g),
               "masks": cells.float().repeat_interleave(64, 2).repeat_interleave(64, 3),
               "valid": valid}
    cfg = SetCriterionConfig(num_classes=K)
    points = draw_points(cfg, L, B, g)
    seen = {}

    def run(device, assign_fn):
        leaves = {k: v.to(device, copy=True).requires_grad_(True) for k, v in outputs.items()}
        with f32_scope("float32"), deterministic_scope():
            total, losses = set_criterion(
                leaves, {k: v.to(device) for k, v in targets.items()}, cfg,
                {k: v.to(device) for k, v in points.items()}, assign_fn=assign_fn)
            total.backward()
        got = {k: v.detach().cpu() for k, v in losses.items()}
        got.update({k: leaves[k].grad.cpu() for k in ("pred_masks", "aux_masks")})
        return got

    def cpu_assign(c):
        seen["asg"] = assign(c)
        return seen["asg"]

    want = run("cpu", cpu_assign)
    on_card = [run(dev, lambda c: seen["asg"].to(dev)) for _ in range(2)]
    assert want["pred_masks"].abs().max() > 0 and want["aux_masks"].abs().max() > 0
    for k, v in want.items():
        np.testing.assert_allclose(on_card[0][k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(v.abs().max()), err_msg=k)
        assert torch.equal(on_card[0][k], on_card[1][k]), k


@pytest.fixture
def global_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on


@pytest.mark.cuda
def test_f32_entry_points_compute_in_f32_whatever_the_global_flags(global_tf32):
    """`Predictor.predict` and `Trainer.step` of an f32 model give the same
    outputs with the global TF32 flags on as off: they scope their work in
    f32. The forward is deterministic (bitwise); a step's gradient norm goes
    through K2's atomics (rtol 1e-5), where TF32 would move it by ~1e-3."""
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

    dev = require_cuda()
    image = np.random.RandomState(5).randint(0, 256, (200, 264, 3)).astype(np.uint8)
    batch = synthetic_batch(1, 256, 4, seed=6, device=dev)
    res = {}
    for on in (True, False):
        _set_tf32(on)
        pred = Predictor()
        pred.setup("coco_instance_r50", device="cuda", seed=0, overrides=SMALL_CARD)
        out = pred.predict(image)
        trainer = Trainer(get_config("coco_instance_r50", SMALL_CARD), device=dev, seed=0)
        metrics = {k: v.item() for k, v in trainer.step(batch).items()}
        res[on] = (out, metrics)
    (a, ma), (b, mb) = res[True], res[False]
    np.testing.assert_array_equal(a["semantic"], b["semantic"])
    np.testing.assert_array_equal(a["instances"]["scores"], b["instances"]["scores"])
    for k in ma:
        if k == "grad_norm":
            np.testing.assert_allclose(ma[k], mb[k], rtol=1e-5, err_msg=k)
        else:
            assert ma[k] == mb[k], k


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


@pytest.mark.cuda
def test_full_r50_bf16_forward_matches_f32_kernel_path(no_tf32):
    """coco_instance_r50 at full width with model.dtype=bfloat16 (the pixel
    decoder in bf16: K1 on a bf16 value in every encoder layer) against the
    f32 model on the same weights, norm-relative on pred_logits and
    pred_masks, and against its own plain path in bf16. Read on an H100:
    7.4e-3 (logits) to 2.0e-2 (masks) both ways; held at 0.05, 2.5x the
    largest reading, as chip_smoke.py."""
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    dev = require_cuda()
    over = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False}
    bf16 = build_model(get_config("coco_instance_r50", over), device=dev)
    perturb_deformable(bf16)
    f32 = build_model(get_config("coco_instance_r50"), device=dev)
    f32.load_state_dict(bf16.state_dict())
    images = torch.from_numpy(np.random.RandomState(4).randn(2, 256, 320, 3)
                              .astype(np.float32)).to(dev)
    with torch.no_grad():
        before = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
        ours = bf16(images)
        torch.cuda.synchronize()
        assert (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16) == (
            before[0], before[1] + 6)
        ref, plain = f32(images), bf16(images, deform_impl="plain")
    for key in ("pred_logits", "pred_masks"):
        assert ours[key].dtype == torch.float32 and torch.isfinite(ours[key]).all()
        r_f32 = ((ours[key] - ref[key]).norm() / ref[key].norm()).item()
        r_plain = ((ours[key] - plain[key]).norm() / plain[key].norm()).item()
        assert r_f32 <= 0.05 and r_plain <= 0.05, (key, r_f32, r_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_is_bitwise_repeatable_without_a_global_mode(dtype):
    """`Trainer.step` runs deterministically whatever the caller's global
    settings (`utils.precision.deterministic_scope`): with no deterministic
    mode set, two trainers from one seed end a SMALL_CARD step at 512x512
    with the same bits in every parameter and buffer, and the mode is still
    off after."""
    from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

    dev = require_cuda()
    assert not torch.are_deterministic_algorithms_enabled()
    over = {} if dtype == "float32" else {"model.dtype": "bfloat16",
                                          "model.pixel_decoder_f32": False}
    states = []
    for _ in range(2):
        trainer = Trainer(get_config("coco_instance_r50", {**SMALL_CARD, **over}),
                          device=dev, seed=0)
        trainer.step(synthetic_batch(2, 512, 4, seed=0, device=dev))
        torch.cuda.synchronize()
        states.append({k: v.detach().clone() for k, v in trainer.model.state_dict().items()})
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.backends.cudnn.deterministic
    differing = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    assert not differing, differing[:8]


@pytest.mark.cuda
def test_eval_post_processing_on_the_card_matches_the_cpu():
    """The eval's on-device post-processing (`bm2f_tpu_torch.eval`) on the
    card against the same functions on the CPU, on identical network
    outputs at the 1344 bucket and a 480x640 original: the same labels,
    instance masks that differ only where the CPU's logit lies within 1e-5
    of 0 (f32 rounding of the two resizes), scores to rtol 1e-5, the same
    semantic labels except at near-ties, the same panoptic map."""
    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.models.maskformer import instance_topk_select

    dev = require_cuda()
    rng = np.random.RandomState(8)
    q, k = 20, 80
    logits = torch.from_numpy((rng.randn(q, k + 1) * 2).astype(np.float32))
    logits[:10, rng.randint(0, k, 10)] += 8.0
    masks = torch.from_numpy(rng.randn(q, 336, 336).astype(np.float32) * 3)
    pad, valid, orig = (1344, 1344), (800, 1067), (480, 640)
    cfg = get_config("coco_instance_r50")
    thing = tuple(c < 40 for c in range(k))
    out = {}
    with torch.no_grad():
        for d in ("cpu", dev):
            lg, mk = logits.to(d), masks.to(d)
            inst = port_eval.instance_on_device(lg, mk, pad, valid, orig, num_classes=k,
                                                topk=100)
            sem = port_eval.semantic_on_device(lg, mk, pad, valid, orig)
            pan = port_eval.panoptic_on_device(cfg, lg, mk, pad, valid, orig, thing)
            out[str(d)] = ({k_: v.cpu() for k_, v in inst.items()}, sem.cpu(),
                           {k_: v.cpu() for k_, v in pan.items()})
        sel = instance_topk_select(logits, masks, num_classes=k, topk=100)[2]
        cpu_logits = port_eval._to_original(sel, pad, valid, orig)
    (ic, sc, pc), (ig, sg, pg) = out["cpu"], out[str(dev)]
    assert torch.equal(ic["labels"], ig["labels"])
    flips = ic["masks"] != ig["masks"]
    assert (cpu_logits[flips].abs() <= 1e-5 * masks.abs().max()).all()
    torch.testing.assert_close(ig["scores"], ic["scores"], rtol=1e-5, atol=1e-7)
    assert (sg != sc).float().mean().item() <= 1e-4
    assert torch.equal(pg["valid"], pc["valid"])
    assert (pg["panoptic_quidx"] != pc["panoptic_quidx"]).float().mean().item() <= 1e-4


# the box-supervised preset at SMALL_CARD width; its pairwise warmup over one
# step, so that the second step's pairwise loss counts, and the pseudo-mask
# update on
WEAK_CARD = {**SMALL_CARD, "model.loss.weak.pairwise.warmup_iters": 1,
             "model.loss.weak.mask_update_enabled": True}


def _weak_batch(dev, seed=0, B=2, size=512, G=4):
    """Raw images of 64x64-pixel colour tiles with +-2 of noise (so that the
    pairwise loss has similar neighbours), rectangle masks, the last target
    of image 0 padding."""
    rng = np.random.RandomState(seed)
    tiles = rng.randint(0, 256, (B, size // 64, size // 64, 3))
    images = tiles.repeat(64, 1).repeat(64, 2) + rng.uniform(-2, 2, (B, size, size, 3))
    masks = np.zeros((B, G, size, size), np.float32)
    for b in range(B):
        for g in range(G):
            y0, x0 = rng.randint(0, size // 2, 2)
            masks[b, g, y0:y0 + rng.randint(32, size // 2), x0:x0 + rng.randint(32, size // 2)] = 1
    valid = np.ones((B, G), bool)
    valid[0, -1] = False
    batch = {"images": images.astype(np.float32), "masks": masks * valid[:, :, None, None],
             "labels": np.where(valid, rng.randint(0, 80, (B, G)), -1), "valid": valid}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _weak_trainer(dev, over=None):
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    trainer = Trainer(get_config("coco_instance_r50_wo_lsj_projpair",
                                 {**WEAK_CARD, **(over or {})}), device=dev, seed=0)
    perturb_deformable(trainer.model)
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weak_train_step_is_bitwise_repeatable(dtype):
    """Two trainers of the box-supervised preset from one seed end two steps
    (the second with the pairwise loss on) with the same bits in every
    parameter, buffer and AdamW moment, with no global deterministic mode."""
    dev = require_cuda()
    over = {} if dtype == "float32" else {"model.dtype": "bfloat16",
                                          "model.pixel_decoder_f32": False}
    batches = [_weak_batch(dev, seed=s) for s in (0, 1)]
    states = []
    for _ in range(2):
        trainer = _weak_trainer(dev, over)
        metrics = [trainer.step(b) for b in batches]
        torch.cuda.synchronize()
        assert metrics[1]["loss_pairwise"].item() > 0
        sd = trainer.state_dict()
        states.append({**{f"model.{k}": v for k, v in sd["model"].items()},
                       **{f"{m}.{k}": v for m in ("mu", "nu")
                          for k, v in sd["optimizer"][m].items()}})
    differing = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    assert not differing, differing[:8]


@pytest.mark.cuda
def test_weak_train_step_launches_k1_and_k2_per_encoder_layer():
    """A box-supervised step launches K1 and K2 once per encoder layer (6
    each), none on a bf16 value, and its gradient reaches every encoder
    layer's deformable projections."""
    dev = require_cuda()
    trainer = _weak_trainer(dev)
    batch = _weak_batch(dev)
    trainer.step(batch)
    before = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches,
              ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16)
    metrics = trainer.step(batch)
    torch.cuda.synchronize()
    after = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches,
             ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 6, 0, 0)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert metrics["loss_pairwise"].item() > 0 and metrics["loss_mask_projection"].item() > 0
    for layer in trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers:
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            assert getattr(layer.self_attn, name).weight.grad.abs().sum() > 0, name


@pytest.mark.cuda
def test_weak_loss_gradients_match_plain_path(no_tf32):
    """The box-supervised loss and every parameter's gradient at the pairwise
    warmup's end, three ways on the same weights and batch: K1 + K2 (A), K1
    + the closed-form plain backward (C), and the plain deformable path (B).
    A-C, K2 against the plain backward on the same forward: every gradient
    within a norm-relative 1e-5 (chip_smoke.py's SAME_FORWARD_REL; read
    5e-7 to 1.4e-6 on the mask step). A-B, the whole path: the loss to
    rtol 1e-4 and all gradients together within a norm-relative 1e-3. K1
    and the plain forward round apart, which moves a few samples across a
    pixel-centre line, where the bilinear derivative jumps: at this small
    width one parameter alone (layer 0's sampling offsets) read 1.1e-3 on
    an H100, where chip_smoke.py's full-width weak step reads 9.9e-5."""
    from unittest import mock

    dev = require_cuda()
    trainer = _weak_trainer(dev)
    trainer.optimizer.count = 1  # pairwise warmup 1
    batch = _weak_batch(dev, seed=2)
    names, params = zip(*trainer.model.named_parameters())
    res = {}
    for run, impl, bwd in (("A", "auto", None), ("C", "auto", ms_deform_attn_bwd_plain),
                           ("B", "plain", None)):
        with mock.patch.object(deform_attn, "ms_deform_attn_bwd_cuda",
                               bwd or deform_attn.ms_deform_attn_bwd_cuda):
            total, losses = trainer.loss(batch, deform_impl=impl)
            grads = torch.autograd.grad(total, params)
        res[run] = (total.item(), losses["loss_pairwise"].item(), grads)
    (la, pa, ga), (_, _, gc), (lb, _, gb) = res["A"], res["C"], res["B"]
    assert pa > 0 and np.isfinite(la) and abs(la - lb) <= 1e-4 * abs(lb)
    for name, a, c in zip(names, ga, gc):
        assert (a - c).norm() <= 1e-5 * c.norm(), name
    flat_a, flat_b = (torch.cat([g.reshape(-1) for g in gs]) for gs in (ga, gb))
    assert (flat_a - flat_b).norm() <= 1e-3 * flat_b.norm()


# the video slice's shapes, the model's heads (M=8, D=32, L=3, P=4): K1 over
# B*T frames of the eval's 8- and 40-frame buckets at its 640 bucket (levels
# 20, 40, 80), and K2 over the train step's 2 clips x 2 frames at 512x512
VIDEO_EVAL_CASES = [(Tp, 8, 32, 4, ((20, 20), (40, 40), (80, 80))) for Tp in (8, 40)]
VIDEO_TRAIN_CASE = (4, 8, 32, 4, ((16, 16), (32, 32), (64, 64)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", VIDEO_EVAL_CASES, ids=["Tp8", "Tp40"])
def test_ms_deform_attn_kernel_at_video_eval_shapes(case):
    """K1 in one launch over every frame of a clip bucket (value rows of
    Tp frames), on encoder-like inputs: rtol/atol 1e-5 against the plain
    version, as at the image shapes."""
    dev = require_cuda()
    shapes, value, loc, attn, _ = _encoder_inputs(case, dev, far=True, seed=2)
    before = ms_deform_attn_cuda.launches
    got = ms_deform_attn_cuda(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 1 and got.shape[0] == case[0]
    torch.testing.assert_close(got, ms_deform_attn_plain(value, shapes, loc, attn),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ms_deform_attn_bwd_kernel_at_video_train_shape():
    """K2 over the 4 frames of a video train step: GRAD_TOL against the
    closed-form plain backward, d_value bitwise equal to the plain mirror
    of its design, and all three gradients bitwise equal across two runs."""
    dev = require_cuda()
    shapes, value, loc, attn, g = _encoder_inputs(VIDEO_TRAIN_CASE, dev, far=True, seed=3)
    a = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    b = ms_deform_attn_bwd_cuda(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    want = ms_deform_attn_bwd_plain(value, shapes, loc, attn, g)
    for name, x, w in zip(GRAD_TOL, a, want):
        torch.testing.assert_close(x, w, msg=name, **GRAD_TOL[name])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    mirror = d_value_by_destination(destination_plan(shapes, loc, attn), shapes, g,
                                    value.shape[2], torch.float32)
    assert torch.equal(a[0], mirror)


def _video_batch(dev, seed=0, B=2, T=2, size=256, G=4):
    """Clips of `_weak_batch` images (the tiles move 64 pixels a frame),
    rectangle masks that move with them, DINO-like (B, T, 16, 16, 384)
    grids whose patches keep their feature as they move."""
    first = _weak_batch("cpu", seed, B, size + 64 * T, G)
    imgs = first["images"]
    images = torch.stack([imgs[:, :size, 64 * (T - t):64 * (T - t) + size] for t in range(T)], 1)
    masks = torch.stack([first["masks"][:, :, :size, 64 * (T - t):64 * (T - t) + size]
                         for t in range(T)], 2)
    gen = torch.Generator().manual_seed(seed)
    base = torch.randn(B, 16, 16 + 4 * T, 384, generator=gen)
    feats = torch.stack([base[:, :, 4 * (T - t):4 * (T - t) + 16] for t in range(T)], 1)
    labels = torch.where(first["valid"], first["labels"] % 40, -1)  # YouTube-VIS: 40
    batch = {"images": images, "masks": masks, "labels": labels,
             "valid": first["valid"], "dino_feats": feats}
    return {k: v.to(dev) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["ytvis2021_video_r50",
                                    "ytvis2021_video_r50_proj_spatpair_temppair"],
                         ids=["mask", "temppair"])
def test_video_train_step_launches_kernels_and_repeats(preset):
    """A video step (2 clips x 2 frames) launches K1 and K2 once per encoder
    layer over the 4 frames (6 each, none on a bf16 value), its losses are
    finite (the temporal pairwise loss nonzero at the warmup's end), and two
    trainers from one seed end two steps with the same bits."""
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    dev = require_cuda()
    over = {**SMALL_CARD, "input.max_instances": 4,
            "model.loss.weak.pairwise.warmup_iters": 1}
    batches = [_video_batch(dev, seed=s) for s in (0, 1)]
    states = []
    for run in range(2):
        trainer = Trainer(get_config(preset, over), device=dev, seed=0)
        perturb_deformable(trainer.model)
        trainer.step(batches[0])
        before = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches,
                  ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16)
        metrics = trainer.step(batches[1])
        torch.cuda.synchronize()
        after = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches,
                 ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16)
        assert tuple(x - y for x, y in zip(after, before)) == (6, 6, 0, 0)
        assert all(torch.isfinite(v) for v in metrics.values())
        if "temppair" in preset:
            assert metrics["loss_mask_temporal_pairwise"].item() > 0
        sd = trainer.state_dict()
        states.append({**{f"model.{k}": v for k, v in sd["model"].items()},
                       **{f"{m}.{k}": v for m in ("mu", "nu")
                          for k, v in sd["optimizer"][m].items()}})
    differing = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    assert not differing, differing[:8]


@pytest.mark.cuda
def test_ddp_across_cards_matches_one_card(tmp_path):
    """`coco_instance_r50` trained data-parallel over NCCL, one rank a card
    (up to 4), 2 images a card at 512x512 for 2 steps, through
    `tools/ddp_bench.py` under `torch.distributed.run`: every rank ends
    with the same parameters, and the first step's losses and grad_norm
    are one card's on the same global batch within the tool's REL (the sums
    in another order). Skips below 2 cards."""
    import subprocess
    import sys
    from pathlib import Path

    from bm2f_tpu_torch.tools.ddp_bench import compare

    require_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards")
    world = min(n, 4)
    common = ["--ims-per-batch", str(2 * world), "--size", "512", "--steps", "2",
              "--profile-steps", "1"]
    root = Path(__file__).resolve().parent.parent
    runs = {
        "multi": [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                  str(world), "-m", "bm2f_tpu_torch.tools.ddp_bench"] + common,
        "single": [sys.executable, "-m", "bm2f_tpu_torch.tools.ddp_bench", "--single",
                   "--share-of", str(world)] + common,
    }
    for name, cmd in runs.items():
        res = subprocess.run(cmd + ["--out", str(tmp_path / f"{name}.json")], cwd=root,
                             capture_output=True, text=True, timeout=900)
        assert res.returncode == 0, (name, res.stdout[-2000:], res.stderr[-4000:])
    got = compare(str(tmp_path / "single.json"), str(tmp_path / "multi.json"))
    assert got["max_rel_vs_single"] <= got["rel_bound"]


@pytest.mark.cuda
def test_tp_across_cards_matches_one_card(tmp_path):
    """`coco_instance_r50` trained tensor-parallel over NCCL through
    `tools/ddp_bench.py --model 2` under `torch.distributed.run`: mesh
    (data 1, model 2) on 2 cards and, with 4 cards, (2, 2), 2 images a data
    rank at 512x512 for 2 steps. Every rank ends with the same gathered
    parameters, each rank's state bytes are the rules' count, and the first
    step's losses and grad_norm are one card's on the same global batch
    within the tool's REL. Skips below 2 cards."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models.maskformer import MaskFormer
    from bm2f_tpu_torch.parallel import tp as tparallel
    from bm2f_tpu_torch.tools.ddp_bench import compare

    require_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards")
    with torch.device("meta"):
        _, sharded, total = tparallel.count_sharded(
            MaskFormer(get_config("coco_instance_r50").model), 2)
    root = Path(__file__).resolve().parent.parent
    for data in ((1, 2) if n >= 4 else (1,)):
        common = ["--ims-per-batch", str(2 * data), "--size", "512", "--steps", "2",
                  "--profile-steps", "1"]
        runs = {
            "multi": [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                      str(2 * data), "-m", "bm2f_tpu_torch.tools.ddp_bench", "--model", "2"]
            + common,
            "single": [sys.executable, "-m", "bm2f_tpu_torch.tools.ddp_bench", "--single",
                       "--share-of", str(data)] + common,
        }
        for name, cmd in runs.items():
            res = subprocess.run(cmd + ["--out", str(tmp_path / f"{name}{data}.json")],
                                 cwd=root, capture_output=True, text=True, timeout=900)
            assert res.returncode == 0, (name, res.stdout[-2000:], res.stderr[-4000:])
        got = compare(str(tmp_path / f"single{data}.json"), str(tmp_path / f"multi{data}.json"))
        assert got["max_rel_vs_single"] <= got["rel_bound"]
        multi = json.loads((tmp_path / f"multi{data}.json").read_text())
        assert multi["mesh"] == [data, 2]
        assert multi["state_bytes_by_rank"] == [3 * (total - sharded // 2)] * (2 * data)


@pytest.mark.cuda
def test_ddp_eval_gathers_across_cards_on_nccl(tmp_path):
    """`python -m bm2f_tpu_torch.train --distributed --eval-only` over NCCL,
    one rank a card (up to 4), on a synthetic COCO split: each rank
    evaluates its shard on its own card and `gather_evaluator`
    (`all_gather_object` on NCCL) merges them; the one result printed is
    one process's on the same seeded model. Skips below 2 cards."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from bm2f_tpu_torch.data.synthetic import write_synthetic_coco

    require_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards")
    world = min(n, 4)
    write_synthetic_coco(str(tmp_path / "data"), sizes=((480, 640), (640, 480), (500, 375),
                                                        (600, 600), (427, 640)), seed=0)
    args = ["-m", "bm2f_tpu_torch.train", "--eval-only", "--eval-dataset", "coco_2017_val",
            "--data-root", str(tmp_path / "data"), "--output", str(tmp_path / "out")]
    root = Path(__file__).resolve().parent.parent
    outs = {}
    for name, cmd in (("multi", ["-m", "torch.distributed.run", "--nproc-per-node",
                                 str(world)] + args + ["--distributed"]),
                      ("single", args)):
        res = subprocess.run([sys.executable] + cmd, cwd=root, capture_output=True,
                             text=True, timeout=900)
        assert res.returncode == 0, (name, res.stdout[-2000:], res.stderr[-4000:])
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("eval ")]
        assert len(lines) == 1, (name, res.stdout[-2000:])
        outs[name] = json.loads(lines[0][5:])
    assert outs["multi"].keys() == outs["single"].keys() and "eval/AP" in outs["multi"]
    for k, v in outs["single"].items():
        np.testing.assert_allclose(outs["multi"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)
