"""The port's assignment solvers and their dispatch against the JAX
package's (bm2f_tpu/matching/hungarian.py, bm2f_tpu/train/trainer.py:
173-205), on seeded costs: rectangular, square, padded, and realistic
matcher costs with `PAD_COST` columns, as tests/test_matching.py:190-242
builds them.

- the host LAP (the port's copy of native/lap/lap.cpp) against `_solve_host`
  on the JAX package's native solver: the same assignment, ties included;
- `jv_assign` against the JAX `jv_assign`: the same assignment, and the host
  solve's total cost;
- `auction_assign` against the JAX `auction_assign`, and its greedy fill
  one-to-one when the rounds run out;
- `make_assign_fn` for every value of `train.matcher`, and `Trainer` using
  what it picks."""

import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.matching import hungarian as jax_hungarian
from bm2f_tpu.matching.matcher import hungarian_matcher_costs as jax_matcher_costs
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.matching import hungarian
from bm2f_tpu_torch.matching.hungarian import (
    assign,
    auction_assign,
    jv_assign,
    make_assign_fn,
    solve_host,
)
from bm2f_tpu_torch.matching.matcher import PAD_COST
from bm2f_tpu_torch.ops import cuda_build
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from torch_port_utils import SMALL


def _realistic(seed, B=4, Q=50, K=20, G=12, n_valid=10):
    """Matcher costs of random predictions against blocky targets, the last
    G - n_valid targets of every image padding (tests/test_matching.py:197)."""
    rng = np.random.RandomState(seed)
    logits = jnp.asarray(rng.randn(B, Q, K + 1).astype(np.float32))
    masks = jnp.asarray(rng.randn(B, Q, 16, 16).astype(np.float32) * 3)
    labels = jnp.asarray(rng.randint(0, K, (B, G)).astype(np.int32))
    gt = jnp.asarray((rng.rand(B, G, 32, 32) > 0.7).astype(np.float32))
    valid = np.ones((B, G), bool)
    valid[:, n_valid:] = False
    C = np.array(jax_matcher_costs(logits, masks, labels, gt, jnp.asarray(valid),
                                   jax.random.PRNGKey(seed), num_points=512))
    assert (C[:, :, n_valid:] == PAD_COST).all()
    return C


def _cases():
    rng = np.random.RandomState(0)
    padded = rng.rand(4, 40, 40).astype(np.float32) * 20
    padded[:, :, 7:] = 1e4
    return {
        "rect": rng.rand(6, 20, 7).astype(np.float32),
        "square": rng.rand(3, 24, 24).astype(np.float32) * 20,
        "padded": padded,
        "matcher": _realistic(0),
        # the train shape: B=2 images x L+1=10 layers, Q=100, G=8, 2 padding
        "matcher_train": _realistic(1, B=20, Q=100, G=8, n_valid=6),
    }


CASES = _cases()


def _total(C, a):
    return np.array([C[b, a[b], np.arange(C.shape[2])].sum(dtype=np.float64)
                     for b in range(C.shape[0])])


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_lap_matches_jax_solve_host(name):
    C = CASES[name]
    ours = solve_host(C)
    ref = jax_hungarian._solve_host(C)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, ref)
    # through `assign`, with a leading layer dimension, from a tensor
    np.testing.assert_array_equal(assign(torch.from_numpy(C)[None]).numpy()[0], ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jv_assign_matches_jax_jv(name):
    C = CASES[name]
    ours = jv_assign(torch.from_numpy(C)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_hungarian.jv_assign(jnp.asarray(C))))
    for b in range(C.shape[0]):
        assert len(set(ours[b].tolist())) == C.shape[2]
    np.testing.assert_allclose(_total(C, ours), _total(C, solve_host(C)), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name", ["rect", "square", "matcher"])
def test_auction_assign_matches_jax_auction(name):
    C = CASES[name]
    ours = auction_assign(torch.from_numpy(C)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_hungarian.auction_assign(jnp.asarray(C))))


def test_auction_fallback_is_one_to_one():
    """With one round a phase the auction cannot converge; the greedy fill
    must still give every column its own row (tests/test_matching.py:51),
    as the JAX package's does."""
    rng = np.random.RandomState(1)
    C = rng.rand(8, 20, 12).astype(np.float32) + 1.0
    C[:, 0, :] = 0.0  # one row is cheapest for every column
    ours = auction_assign(torch.from_numpy(C), num_iters=1).numpy()
    for b in range(C.shape[0]):
        assert len(set(ours[b].tolist())) == 12
    np.testing.assert_array_equal(
        ours, np.asarray(jax_hungarian.auction_assign(jnp.asarray(C), num_iters=1)))


def _cfg(matcher, iters=300):
    return get_config("coco_instance_r50", {"train.matcher": matcher,
                                            "train.auction_iters": iters})


@pytest.mark.parametrize("matcher,solver", [
    ("auto", "lap"), ("lap", "lap"), ("jv", "jv"), ("auction", "auction"),
])
def test_make_assign_fn_dispatches_train_matcher(matcher, solver, caplog):
    """(B, L, Q, G) costs -> (B, L, G) by the solver `train.matcher` names;
    "auto" is the host solve on every device; "auction" warns as the JAX
    Trainer does and takes `train.auction_iters`."""
    C = CASES["matcher_train"].reshape(2, 10, 100, 8)
    with caplog.at_level(logging.WARNING, logger=hungarian.__name__):
        fn = make_assign_fn(_cfg(matcher, iters=50))
    warned = any("EXPERIMENTAL" in r.getMessage() for r in caplog.records)
    assert warned == (matcher == "auction")
    got = fn(torch.from_numpy(C))
    assert got.shape == (2, 10, 8) and got.dtype == torch.int64
    flat = torch.from_numpy(C.reshape(20, 100, 8))
    want = {"lap": lambda: solve_host(C.reshape(20, 100, 8)),
            "jv": lambda: jv_assign(flat).numpy(),
            "auction": lambda: auction_assign(flat, num_iters=50).numpy()}[solver]()
    np.testing.assert_array_equal(got.reshape(20, 8).numpy(), want)


def test_make_assign_fn_refuses_an_unknown_matcher():
    with pytest.raises(ValueError, match="train.matcher 'hungarian'"):
        make_assign_fn(_cfg("hungarian"))


def test_host_lap_raises_without_a_compiler(tmp_path, monkeypatch):
    """No fallback to scipy (it breaks ties otherwise): with no library
    built and no host compiler, the host solve raises and names it."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(hungarian, "_lap_fn", None)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        solve_host(CASES["rect"])


def test_trainer_assigns_with_the_dispatched_solver():
    """`Trainer` takes `make_assign_fn(cfg)`: with train.matcher="jv" the
    SMALL step's costs of all L+1 layers go through `jv_assign` once."""
    calls = []

    def spy(costs):
        calls.append(costs.shape)
        return jv_assign(costs)

    cfg = get_config("coco_instance_r50", {**SMALL, "train.matcher": "jv"})
    with mock.patch.object(hungarian, "jv_assign", spy):
        trainer = Trainer(cfg, device="cpu")
    batch = synthetic_batch(2, 64, 4, seed=3, device="cpu")
    with torch.no_grad():
        total, _ = trainer.loss(batch)
    assert torch.isfinite(total)
    assert calls == [(2 * 7, 10, 4)]  # B x (6 decoder layers + 1), Q, G
