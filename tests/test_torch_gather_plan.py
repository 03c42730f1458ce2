"""The host-side counts behind the gather probe's K4 lines: the one-hot
fragments K4 issues products for (`onehot_hit_steps`, behind
`onehot_hit_tc_bound_ms`) and the table rows it stages (`onehot_staged_rows`,
behind `staged_mb`, with the kernel's switch to walking every chunk), each
against a brute-force loop over the kernel's tiles, passes and blocks, and
the hit shares hand-counted at the probe's production shapes."""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.ops.gather_probe import (
    ONEHOT_CHUNK_STEPS,
    ONEHOT_DENSE_BITS,
    ONEHOT_DENSE_SHARE,
    ONEHOT_PASS,
    ONEHOT_STEP,
    ONEHOT_TILE,
    ROW,
    onehot_dense_steps,
    onehot_hit_ops,
    onehot_hit_steps,
    onehot_staged_rows,
)
from bm2f_tpu_torch.tools import roofline_microbench as probe


def _indices(BM, K, QP, S, pattern, seed=0):
    """Uniform indices; `out_of_range` mixes in -1, S and 2^30; `coherent`
    follows the query's position (the probe's coherent draw); `one_chunk`
    keeps every index in one chunk of rows."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, S, (BM, K, QP))
    if pattern == "out_of_range":
        idx.reshape(-1)[::5] = -1
        idx.reshape(-1)[2::5] = S
        idx.reshape(-1)[4::7] = 2**30
    elif pattern == "coherent":
        base = np.linspace(0, S - 1, QP)[None, None, :]
        idx = np.clip(np.round(base + rng.randn(BM, K, QP) * 3), 0, S - 1)
    elif pattern == "one_chunk":
        idx = rng.randint(S // 2, min(S, S // 2 + 7), (BM, K, QP))
    return torch.from_numpy(idx.astype(np.int32))


def _hit_steps_brute(idx, S, bf16):
    step = ONEHOT_STEP[bf16]
    hits = set()
    BM, K, QP = idx.shape
    for bm in range(BM):
        for k in range(K):
            for q in range(QP):
                s = int(idx[bm, k, q])
                if 0 <= s < S:
                    hits.add((bm, k, q // ONEHOT_TILE, s // step))
    return len(hits)


def _staged_rows_brute(idx, S, bf16, qt):
    """K4's walk, block by block: each pass's selected chunks, or every chunk
    of every pass when the chunks its first pass selects set enough of the
    bits c % 32."""
    rows = ONEHOT_STEP[bf16] * ONEHOT_CHUNK_STEPS
    n_chunks = -(-S // rows)
    BM, K, QP = idx.shape
    staged = 0
    for bm in range(BM):
        for q0 in range(0, QP, qt):
            passes = []
            for p0 in range(q0, min(q0 + qt, QP), ONEHOT_PASS):
                chunks = {int(s) // rows for k in range(K)
                          for s in idx[bm, k, p0:min(p0 + ONEHOT_PASS, QP)] if 0 <= s < S}
                passes.append(chunks)
            bits = {c % ONEHOT_DENSE_BITS for c in passes[0]}
            if len(bits) >= ONEHOT_DENSE_SHARE * min(n_chunks, ONEHOT_DENSE_BITS):
                staged += S * len(passes)
            else:
                staged += sum(min(rows, S - c * rows) for chunks in passes for c in chunks)
    return staged


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("pattern", ["random", "out_of_range", "coherent", "one_chunk"])
@pytest.mark.parametrize("S", [1, 40, 700])
def test_hit_steps_match_brute_force(S, pattern, bf16):
    idx = _indices(2, 3, 150, S, pattern)
    n = onehot_hit_steps(idx, S, bf16)
    assert n == _hit_steps_brute(idx, S, bf16)
    assert n <= onehot_dense_steps(2, S, 3, 150, bf16)
    assert onehot_hit_ops(idx, S, bf16) == n * 2 * ONEHOT_TILE * ONEHOT_STEP[bf16] * ROW


@pytest.mark.parametrize("qt", [64, 192, 512])
@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("pattern", ["random", "out_of_range", "coherent", "one_chunk"])
@pytest.mark.parametrize("S", [40, 700, 5000])
def test_staged_rows_match_brute_force(S, pattern, bf16, qt):
    idx = _indices(2, 4, 600, S, pattern, seed=1)
    assert onehot_staged_rows(idx, S, bf16, qt) == _staged_rows_brute(idx, S, bf16, qt)


def test_production_counts_match_hand_counts():
    """The probe's data at its production shapes (BM 32, QP 13312, K 4,
    qt 512), S 2500: the share of fragments with a one, hand-counted per
    (16-query tile, k, k-step), and the rows staged: with random addresses
    every block walks every chunk (6656 passes x 2500 rows), with coherent
    ones only the selected chunks."""
    BM, QP, K, S = probe.BM, probe.QP, probe.K, 2500
    shares = {}
    for coherent in (False, True):
        _, idx = probe.make_inputs(S, coherent)
        idx = torch.from_numpy(idx)
        for bf16 in (True, False):
            share = onehot_hit_steps(idx, S, bf16) / onehot_dense_steps(BM, S, K, QP, bf16)
            shares[coherent, bf16] = round(share, 3)
        staged = {bf16: onehot_staged_rows(idx, S, bf16, probe.QT) for bf16 in (True, False)}
        if not coherent:
            assert staged == {True: 6656 * 2500, False: 6656 * 2500}
            # the products K4 issues on the tensor cores: 0.108 ms bf16, 0.110 TF32
            hit_ms = {impl: probe.onehot_hit_tc_bound_ms(impl, idx, S)
                      for impl in ("onehot_bf16", "onehot")}
            assert hit_ms == {"onehot_bf16": pytest.approx(0.1077, abs=5e-4),
                              "onehot": pytest.approx(0.1101, abs=5e-4)}
            assert probe.onehot_hit_tc_bound_ms("scalar", idx, S) is None
        else:
            assert 0.05 * 6656 * 2500 < staged[True] < 0.2 * 6656 * 2500
            assert 0.05 * 6656 * 2500 < staged[False] < 0.2 * 6656 * 2500
    # coherent TF32: 0.028498, so 0.028 to three places
    assert shares == {(False, True): 0.097, (False, False): 0.05,
                      (True, True): 0.038, (True, False): 0.028}
