"""The host-side tables of the port's deformable-attention kernels (K1 and
K2, bm2f_tpu_torch/csrc/ms_deform_attn_*.cu): the tiles of queries a block
takes: runs, and K2's encoder cells against a brute-force assignment. CPU
only: the kernels themselves run in tests/test_torch_cuda.py on a card."""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.ops.deform_attn import (
    CELL,
    RUN,
    encoder_cells,
    ms_deform_attn_plain,
    tile_plan,
)

# the serve (800x800) and train (1024x1024) level sets of coco_instance_r50,
# levels of height or width 1 and a 1x1 level, and a set whose finest height
# and width come from different levels
LEVEL_SETS = {
    "serve": ((25, 25), (50, 50), (100, 100)),
    "train": ((32, 32), (64, 64), (128, 128)),
    "edge": ((1, 7), (5, 1), (4, 6)),
    "mixed": ((1, 1), (3, 9), (16, 12)),
}


@pytest.mark.parametrize("cells", [True, False], ids=["cells", "runs"])
@pytest.mark.parametrize("encoder", [True, False], ids=["q_eq_s", "q_ne_s"])
@pytest.mark.parametrize("name", list(LEVEL_SETS))
def test_tiles_cover_every_query_once(name, encoder, cells):
    """Every query lies in exactly one tile and no tile is empty; runs
    (K1's tiles, and K2's when Q != S) are at most RUN consecutive
    queries."""
    shapes = LEVEL_SETS[name]
    S = sum(h * w for h, w in shapes)
    Q = S if encoder else S + 37
    plan = tile_plan(shapes, Q, cells)
    assert plan.tile_ptr.dtype == np.int32 and plan.tile_q.dtype == np.int32
    assert plan.tile_ptr[0] == 0 and plan.tile_ptr[-1] == Q
    assert (np.diff(plan.tile_ptr) > 0).all()
    assert np.array_equal(np.sort(plan.tile_q), np.arange(Q))
    if not (cells and encoder):
        assert np.array_equal(plan.tile_q, np.arange(Q))
        assert np.diff(plan.tile_ptr).max() <= RUN


@pytest.mark.parametrize("name", list(LEVEL_SETS))
def test_encoder_cells_match_brute_force(name):
    """Each query's cell is the CELL x CELL cell of the finest height and
    width that holds its reference point (the pixel centre, normalized), and
    a tile holds exactly the queries of one cell, in their order."""
    shapes = LEVEL_SETS[name]
    Hf, Wf = max(h for h, _ in shapes), max(w for _, w in shapes)
    n_cx = -(-Wf // CELL)
    want = []
    for H, W in shapes:
        for y in range(H):
            for x in range(W):
                u, v = (x + 0.5) / W, (y + 0.5) / H
                want.append(int(v * Hf / CELL) * n_cx + int(u * Wf / CELL))
    want = np.array(want)
    assert np.array_equal(encoder_cells(shapes), want)
    plan = tile_plan(shapes, len(want), cells=True)
    for t in range(len(plan.tile_ptr) - 1):
        qs = plan.tile_q[plan.tile_ptr[t]:plan.tile_ptr[t + 1]]
        assert len(set(want[qs])) == 1 and (np.diff(qs) > 0).all()
    assert len(plan.tile_ptr) - 1 == len(set(want))


def test_serve_cells_span_one_cell_of_every_level():
    """At 800x800 a tile is an 8x8 cell of the finest level with the 4x4 and
    2x2 cells of the others under it: 84 queries inside the grid's edge."""
    plan = tile_plan(LEVEL_SETS["serve"], 25 * 25 + 50 * 50 + 100 * 100, cells=True)
    sizes = np.diff(plan.tile_ptr)
    assert len(sizes) == 13 * 13 and sizes.max() == 84


@pytest.mark.parametrize("cells", [True, False], ids=["cells", "runs"])
def test_tiles_reassemble_the_output(cells):
    """Each tile's queries computed on their own, as a block of the kernels
    computes them, and written to their rows of the output give the whole
    output, bitwise (the plain version per tile against the whole call)."""
    shapes = LEVEL_SETS["edge"]
    S = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(0)
    value = torch.from_numpy(rng.randn(2, S, 2, 32).astype(np.float32))
    loc = torch.from_numpy(rng.rand(2, S, 2, 3, 4, 2).astype(np.float32) * 1.4 - 0.2)
    attn = torch.from_numpy(rng.rand(2, S, 2, 3, 4).astype(np.float32))
    plan = tile_plan(shapes, S, cells)
    out = torch.full((2, S, 64), float("nan"))
    for t in range(len(plan.tile_ptr) - 1):
        qs = torch.from_numpy(plan.tile_q[plan.tile_ptr[t]:plan.tile_ptr[t + 1]]).long()
        out[:, qs] = ms_deform_attn_plain(value, shapes, loc[:, qs], attn[:, qs])
    assert torch.equal(out, ms_deform_attn_plain(value, shapes, loc, attn))
