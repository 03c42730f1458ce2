"""The gather probe (K3, K4) against the JAX package's: the four Pallas probe
kernels of tools/roofline_microbench.py, run in interpret mode at the JAX
tool's --smoke shapes (BM 2, QP 128, QT 128, K 4, S 40), are bitwise equal
to the port's `row_gather_sum_plain`, with random and with coherent
addresses; the port's probe CLI on the CPU; the kernel wrappers' refusals;
and the byte and operation counts behind the bounds."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu_torch.ops import gather_probe
from bm2f_tpu_torch.ops.gather_probe import (
    gather_bytes,
    onehot_ops,
    row_gather_sum_cuda,
    row_gather_sum_onehot_cuda,
    row_gather_sum_plain,
    rows_read,
)
from bm2f_tpu_torch.tools import roofline_microbench as probe

ROOT = Path(__file__).resolve().parent.parent
SMOKE = dict(BM=2, QP=128, QT=128, K=4)
S_SMOKE = 40


@pytest.fixture(scope="module")
def jax_probe():
    """tools/roofline_microbench.py, loaded from its path (it is no package
    module) with its globals set to the --smoke shapes, as its main() does."""
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_microbench", ROOT / "tools" / "roofline_microbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in SMOKE.items():
        setattr(mod, name, value)
    return mod


def test_inputs_are_the_jax_tools(jax_probe):
    """The port draws the JAX tool's data: RandomState(0), a randn table
    rounded to bf16 by jnp, then the indices (bench_level :187-203)."""
    for coherent in (False, True):
        table, idx = probe.make_inputs(S_SMOKE, coherent, 2, 128, 4)
        rng = np.random.RandomState(0)
        want = np.asarray(jnp.asarray(rng.randn(2, S_SMOKE, 128).astype(np.float32))
                          .astype(jnp.bfloat16).astype(jnp.float32))
        if coherent:
            base = np.linspace(0, S_SMOKE - 1, 128)[None, None, :]
            jit_ = rng.randn(2, 4, 128) * max(2.0, S_SMOKE * 0.01)
            want_idx = np.clip(np.round(base + jit_), 0, S_SMOKE - 1).astype(np.int32)
        else:
            want_idx = rng.randint(0, S_SMOKE, (2, 4, 128)).astype(np.int32)
        np.testing.assert_array_equal(table, want)
        np.testing.assert_array_equal(idx, want_idx)


@pytest.mark.parametrize("coherent", [False, True], ids=["random", "coherent"])
@pytest.mark.parametrize("impl", ["scalar", "onehot", "scalar_bf16", "onehot_bf16"])
def test_pallas_probe_kernel_bitwise_equals_plain(jax_probe, impl, coherent):
    make_scalar, make_onehot, make_scalar_bf16, make_onehot_bf16 = jax_probe._kernels()
    make = {"scalar": make_scalar, "onehot": make_onehot,
            "scalar_bf16": make_scalar_bf16, "onehot_bf16": make_onehot_bf16}[impl]
    table, idx = probe.make_inputs(S_SMOKE, coherent, 2, 128, 4)
    fn = jax.jit(lambda t, i, f=make(S_SMOKE): f(i, t))
    ref = np.asarray(fn(jnp.asarray(table), jnp.asarray(idx)))
    t = torch.from_numpy(table)
    if impl.endswith("bf16"):
        t = t.to(torch.bfloat16)
    ours = row_gather_sum_plain(t, torch.from_numpy(idx))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (2, 128, 128)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_plain_adds_rows_in_k_order_and_zeros_out_of_range():
    rng = np.random.RandomState(1)
    table = rng.randn(2, 9, 128).astype(np.float32) * np.float32(1e4)
    idx = rng.randint(0, 9, (2, 3, 5)).astype(np.int32)
    idx[0, 0, 0], idx[1, 2, 4], idx[0, 1, 3] = -1, 9, 2**30
    want = np.zeros((2, 5, 128), np.float32)
    for b in range(2):
        for q in range(5):
            acc = None
            for k in range(3):
                s = idx[b, k, q]
                row = table[b, s] if 0 <= s < 9 else np.zeros(128, np.float32)
                acc = row if acc is None else acc + row  # f32 adds in k order
            want[b, q] = acc
    ours = row_gather_sum_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(ours.numpy(), want)


def test_probe_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("ROOFLINE_IMPLS", raising=False)
    assert probe.main(["--device", "cpu", "--smoke"]) == 0
    assert probe.main(["--device", "cpu", "--smoke", "--coherent"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(ln["impl"], ln["addresses"]) for ln in lines] == [
        (i, a) for a in ("random", "coherent") for i in probe.IMPLS]
    for ln in lines:
        assert ln["S"] == S_SMOKE and ln["qt"] == 128 and ln["k"] == 4
        assert ln["max_err_vs_plain"] == 0.0 and ln["bitwise_equal"] is True
        assert ln["device"] == "cpu"
        # a CPU run measures nothing
        for key in ("ms_per_level_layer", "ns_per_descriptor", "share_of_bound",
                    "plain_ms", "embedding_bag_ms"):
            assert ln[key] is None, key
        itemsize = 2 if ln["impl"].endswith("bf16") else 4
        n_bytes = gather_bytes(2, 4, 128, 2 * S_SMOKE, itemsize)
        assert ln["bound_ms"] == pytest.approx(n_bytes / 3.35e12 * 1e3)
        assert ln["bound_by"] == "bytes"
        tc = ln["onehot_tc_bound_ms"]
        if ln["impl"].startswith("onehot"):
            bf16 = ln["impl"].endswith("bf16")
            peak = 989e12 if bf16 else 495e12
            assert tc == pytest.approx(onehot_ops(2, S_SMOKE, 4, 128) / peak * 1e3)
            # the products K4 issues: its 16-query fragments that hold a one
            # (every k-step is 8 or 16 rows, so S=40 pads to 48 rows in bf16)
            _, idx = probe.make_inputs(S_SMOKE, ln["addresses"] == "coherent", 2, 128, 4)
            hit = gather_probe.onehot_hit_ops(torch.from_numpy(idx), S_SMOKE, bf16)
            assert ln["onehot_hit_tc_bound_ms"] == pytest.approx(hit / peak * 1e3)
            assert 0 < hit <= 2 * 16 * (16 if bf16 else 8) * 128 * gather_probe.onehot_dense_steps(
                2, S_SMOKE, 4, 128, bf16)
            # one chunk covers S=40: every 64-query pass stages it
            assert ln["staged_mb"] == pytest.approx(2 * 2 * S_SMOKE * 128 * (2 if bf16 else 4) / 1e6)
        else:
            assert tc is None
            assert ln["onehot_hit_tc_bound_ms"] is None and ln["staged_mb"] is None
    monkeypatch.setenv("ROOFLINE_IMPLS", "onehot,scalar_bf16")
    assert probe.main(["--device", "cpu", "--smoke"]) == 0
    names = [json.loads(ln)["impl"] for ln in capsys.readouterr().out.splitlines()]
    assert names == ["onehot", "scalar_bf16"]


def test_probe_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe.main(["--smoke"]) == 2


@pytest.mark.parametrize("wrapper", [
    row_gather_sum_cuda,
    lambda t, i: row_gather_sum_onehot_cuda(t, i, 64),
], ids=["K3", "K4"])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    """Never the plain version: CPU tensors, other dtypes and shapes raise,
    and no launch is counted."""
    table = torch.zeros(2, 40, 128)
    idx = torch.zeros(2, 4, 64, dtype=torch.int32)
    before = [(f.launches, f.launches_bf16)
              for f in (row_gather_sum_cuda, row_gather_sum_onehot_cuda)]
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(table, idx)
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(table.to(torch.bfloat16), idx)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wrapper(table.double(), idx)
    with pytest.raises(TypeError, match="int32"):
        wrapper(table, idx.long())
    with pytest.raises(ValueError, match="128"):
        wrapper(torch.zeros(2, 40, 64), idx)
    with pytest.raises(ValueError, match="BM=2"):
        wrapper(table, torch.zeros(3, 4, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(table.transpose(0, 1).contiguous().transpose(0, 1), idx)
    assert before == [(f.launches, f.launches_bf16)
                      for f in (row_gather_sum_cuda, row_gather_sum_onehot_cuda)]


def test_onehot_wrapper_refuses_k_and_qt_it_does_not_take():
    table = torch.zeros(2, 40, 128)
    with pytest.raises(ValueError, match="1 to 4"):
        row_gather_sum_onehot_cuda(table, torch.zeros(2, 5, 64, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        row_gather_sum_onehot_cuda(table, torch.zeros(2, 4, 64, dtype=torch.int32), 96)


def test_counts_match_hand_counts():
    # the production shapes at S=2500: idx 6.8 MB, table 40.96 MB (f32) or
    # 20.48 MB (bf16), out 218.1 MB
    BM, QP, K, S = 32, 13312, 4, 2500
    assert gather_bytes(BM, K, QP, BM * S, 4) == 6_815_744 + 40_960_000 + 218_103_808
    assert gather_bytes(BM, K, QP, BM * S, 2) == 6_815_744 + 20_480_000 + 218_103_808
    assert onehot_ops(BM, S, K, QP) == 1_090_519_040_000
    # K3 and K4 compute one function, which needs only bytes: one bound
    for impl in ("scalar", "onehot"):
        ms, by = probe.bound(impl, BM, K, QP, BM * S)
        assert by == "bytes" and ms == pytest.approx(265_879_552 / 3.35e12 * 1e3)
        assert ms == pytest.approx(0.0794, abs=5e-5)
    for impl in ("scalar_bf16", "onehot_bf16"):
        ms, by = probe.bound(impl, BM, K, QP, BM * S)
        assert by == "bytes" and ms == pytest.approx(245_399_552 / 3.35e12 * 1e3)
    # the one-hot products' own ceiling on the tensor cores, apart
    assert probe.onehot_tc_bound_ms("scalar", BM, S, K, QP) is None
    assert probe.onehot_tc_bound_ms("onehot_bf16", BM, S, K, QP) == pytest.approx(1.1027, abs=5e-4)
    assert probe.onehot_tc_bound_ms("onehot", BM, S, K, QP) == pytest.approx(2.2031, abs=5e-4)
    # rows read: distinct in-range (bm, row) pairs
    idx = torch.tensor([[[0, 1, 1, -1]], [[1, 1, 7, 3]]], dtype=torch.int32)
    assert rows_read(idx, 5) == 2 + 2
    assert gather_probe.ROW == 128
