"""K2's d_value, summed destination-major in a fixed order, on the CPU: the
plain mirror of the kernel's design (`destination_plan`, the sample pass and
the sort; `d_value_by_destination`, the reduce) against the JAX package.

- The plan holds every valid bilinear corner exactly once, each destination
  row's entries in the stated order: corner c = 0..3, then ascending sample
  index n = ((b M + m) Q + q) K + k. The corners are worked out here again
  with numpy, independently of the port.
- The mirror's d_value against `jax.grad` of `bm2f_tpu.ops.ms_deform_attn(
  impl="im2col")` in f32, at tests/test_torch_deform_attn_grad.py's
  tolerance (`check_mirror_d_value`, whose cases run from
  tests/test_torch_deform_scatter_{a,b,c}.py); on a bf16 `value` against the Pallas VJP in interpret mode,
  relative to JAX's own bf16 error (both against the f64 backward, as
  tests/test_torch_train_bf16.py): e(mirror, f64) <= e(jax, f64) + 1e-6.
- The mirror bitwise equal to itself when the tiles come in reverse order
  and the queries of each tile shuffled, and its sort equal to a stable
  library sort.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.ops import ms_deform_attn as jax_ms_deform_attn
from bm2f_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas
from bm2f_tpu_torch.ops.deform_attn import (
    TilePlan,
    d_value_by_destination,
    destination_entries,
    destination_plan,
    ms_deform_attn_bwd_plain,
    radix_order_plain,
    tile_plan,
)
from test_torch_cuda import CASES, ENCODER_CASES, _deform_inputs, _encoder_inputs

# tests/test_torch_deform_attn_grad.py (tests/test_ops.py:176-178)
D_VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
# the encoder cases (Q == S, samples near their reference points or, `far`,
# a quarter pushed across tiles or out of their level), then two with Q != S
SCATTER_CASES = ([("encoder", c, far) for c in ENCODER_CASES for far in (False, True)]
                 + [("queries", c, None) for c in CASES[1:]])
IDS = [f"{kind}{i}-{'far' if far else 'near' if far is not None else 'runs'}"
       for i, (kind, _, far) in enumerate(SCATTER_CASES)]


def _inputs(kind, case, far):
    """(shapes, value, loc, attn, grad_out) as CPU tensors."""
    if kind == "encoder":
        return _encoder_inputs(case, "cpu", far, seed=1)
    return _deform_inputs(case, "cpu", seed=2)


def _valid_corners(shapes, loc, M):
    """{(row, n, c)} of every corner inside its level, worked out with numpy:
    row = (b S + s) M + m for the corner's pixel s."""
    loc = loc.numpy()
    B, Q, _, L, P, _ = loc.shape
    S, K = sum(h * w for h, w in shapes), L * P
    out, start = set(), 0
    b, q, m, p = np.meshgrid(np.arange(B), np.arange(Q), np.arange(M), np.arange(P),
                             indexing="ij")
    for lid, (H, W) in enumerate(shapes):
        x0 = np.floor(loc[:, :, :, lid, :, 0] * np.float32(W) - np.float32(0.5))
        y0 = np.floor(loc[:, :, :, lid, :, 1] * np.float32(H) - np.float32(0.5))
        n = ((b * M + m) * Q + q) * K + lid * P + p
        for c in range(4):
            y, x = y0 + (c >> 1), x0 + (c & 1)
            ok = (y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)
            s = start + y[ok].astype(np.int64) * W + x[ok].astype(np.int64)
            rows = (b[ok] * S + s) * M + m[ok]
            out.update(zip(rows.tolist(), n[ok].tolist(), [c] * int(ok.sum())))
        start += H * W
    return out


def _shuffled_reversed(plan: TilePlan, seed=3) -> TilePlan:
    """The same tiles, last first, the queries of each shuffled."""
    rng = np.random.RandomState(seed)
    ptr = plan.tile_ptr
    tiles = [rng.permutation(plan.tile_q[ptr[t]:ptr[t + 1]]) for t in range(len(ptr) - 1)]
    tiles = tiles[::-1]
    new_ptr = np.concatenate([[0], np.cumsum([len(t) for t in tiles])])
    return TilePlan(new_ptr.astype(np.int32), np.concatenate(tiles).astype(np.int32))


@pytest.mark.parametrize("kind,case,far", SCATTER_CASES, ids=IDS)
def test_plan_holds_every_valid_corner_once_in_order(kind, case, far):
    shapes, value, loc, attn, _ = _inputs(kind, case, far)
    B, _, M, _ = value.shape
    plan = destination_plan(shapes, loc, attn)
    (rows, samples, corners, positions), per_row = destination_entries(plan, shapes, B, M)
    got = list(zip(rows.tolist(), samples.tolist(), corners.tolist()))
    assert len(got) == len(set(got)), "an entry appears twice"
    assert set(got) == _valid_corners(shapes, loc, M)
    # each row's positions are 0..count-1, and (c, n) rises along them
    key = rows * int(positions.max() + 1) + positions
    idx = torch.argsort(key)
    r, n, c, j = rows[idx], samples[idx], corners[idx], positions[idx]
    assert torch.equal(torch.bincount(rows, minlength=per_row.numel()), per_row)
    same = r[1:] == r[:-1]
    assert torch.equal(j[1:][same], j[:-1][same] + 1)
    assert bool(((c[1:] > c[:-1]) | ((c[1:] == c[:-1]) & (n[1:] > n[:-1])))[same].all())
    # a corner outside its level, and a sample with none inside, carry nothing
    inside = torch.zeros_like(plan.wa, dtype=torch.bool)
    inside[samples, corners] = True
    assert bool((plan.wa[~inside] == 0).all())
    assert bool((plan.keys[(plan.wa != 0).any(1)] < plan.S_pad).all())
    assert int(plan.row_ptr[-1]) == plan.keys.numel()  # every sample has a key


def scatter_cases(ids):
    """The SCATTER_CASES of `ids`, for a file's own parametrize."""
    return [SCATTER_CASES[IDS.index(i)] for i in ids]


def check_mirror_d_value(kind, case, far):
    """`test_mirror_d_value_matches_jax_grad` of one case. Its eight cases
    run from tests/test_torch_deform_scatter_{a,b,c}.py, a few to a file, so
    that no file holds a pytest worker (one file each under --dist
    loadfile) for much longer than the others: JAX's gradient takes up to
    a few minutes a case on the CPU."""
    shapes, value, loc, attn, g = _inputs(kind, case, far)
    M = value.shape[2]

    def loss(v, lo, a):  # sum(out * g): grad_out is g
        return jnp.sum(jax_ms_deform_attn(v, shapes, lo, a, impl="im2col") * g.numpy())

    # jitted: one compiled gradient (op by op, JAX takes minutes a case on a
    # loaded CPU)
    want = jax.jit(jax.grad(loss))(*(jnp.asarray(t.numpy()) for t in (value, loc, attn)))
    got = d_value_by_destination(destination_plan(shapes, loc, attn), shapes, g, M)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **D_VALUE_TOL)
    # and the closed-form plain backward, which the CPU path takes
    torch.testing.assert_close(got, ms_deform_attn_bwd_plain(value, shapes, loc, attn, g)[0],
                               **D_VALUE_TOL)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# small enough for the Pallas kernel in interpret mode
BF16_CASES = [("queries", c, None) for c in CASES[:2]] + [("encoder", ENCODER_CASES[2], True)]


@pytest.mark.parametrize("kind,case,far", BF16_CASES, ids=["queries0", "queries1", "encoder2-far"])
def test_mirror_bf16_d_value_within_jax_bf16_error(kind, case, far):
    """A bf16 `value`: the mirror sums in f32 and rounds once; JAX rounds the
    f32 patch gradient to bf16 and sums the four corners in bf16."""
    shapes, value, loc, attn, g = _inputs(kind, case, far)
    B, Q, M, D = *loc.shape[:3], value.shape[3]
    vb = value.to(torch.bfloat16)

    def loss(v, lo, a):
        out = ms_deform_attn_pallas(v, shapes, lo, a, q_tile=8, interpret=True,
                                    out_head_major=True)  # (B, M, Q, D) f32
        return jnp.sum(out * jnp.asarray(g.numpy()).reshape(B, Q, M, D).transpose(0, 2, 1, 3))

    jax_dv = jax.grad(loss)(jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(loc.numpy()), jnp.asarray(attn.numpy()))
    assert jax_dv.dtype == jnp.bfloat16
    got = d_value_by_destination(destination_plan(shapes, loc, attn), shapes, g, M,
                                 torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = ms_deform_attn_bwd_plain(vb.double(), shapes, loc.double(), attn.double(),
                                   g.double())[0].numpy()
    e_port = _rel(got.float().numpy(), ref)
    e_jax = _rel(np.asarray(jax_dv.astype(jnp.float32)), ref)
    assert e_port <= e_jax + 1e-6, (e_port, e_jax)


@pytest.mark.parametrize("kind,case,far", SCATTER_CASES, ids=IDS)
def test_mirror_bitwise_invariant_to_tile_order(kind, case, far):
    shapes, value, loc, attn, g = _inputs(kind, case, far)
    Q, M = loc.shape[1], value.shape[2]
    tiles = tile_plan(shapes, Q, cells=True)
    a = destination_plan(shapes, loc, attn, tiles)
    b = destination_plan(shapes, loc, attn, _shuffled_reversed(tiles))
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(d_value_by_destination(a, shapes, g, M, dtype),
                           d_value_by_destination(b, shapes, g, M, dtype))


@pytest.mark.parametrize("n_keys", [5, 300, 70000])
def test_radix_order_is_a_stable_sort(n_keys):
    """One, two and three 8-bit passes; many equal keys, the largest key
    (the kernels' key for a sample with no corner inside) among them."""
    rng = np.random.RandomState(n_keys)
    keys = rng.randint(0, n_keys + 1, size=5000)
    keys[::7] = n_keys
    got = radix_order_plain(torch.from_numpy(keys), n_keys)
    np.testing.assert_array_equal(got.numpy(), np.argsort(keys, kind="stable"))
