"""DatasetEvaluator protocol + inference loop (replacement for detectron2's
inference_on_dataset used by the reference's Trainer.test), the port's copy
of the JAX package's `evaluation/evaluator.py` with the cross-process gather
on `torch.distributed` instead of JAX's multihost utilities."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable

import numpy as np
import torch
import torch.distributed as dist


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def inference_on_dataset(
    predict_fn: Callable[[Dict], Dict],
    data_loader: Iterable[Dict],
    process_fn: Callable[[Dict, Dict], None],
    evaluate_fn: Callable[[], Dict[str, float]],
    *,
    log_every: int = 50,
) -> Dict[str, float]:
    """predict_fn: batched model+inference; process_fn feeds each
    (prediction, batch) pair, as numpy, into the evaluator(s)."""
    n = 0
    t0 = time.time()
    for batch in data_loader:
        preds = _to_numpy(predict_fn(batch))
        process_fn(preds, batch)
        n += 1
        if n % log_every == 0:
            print(f"inference {n} batches ({(time.time()-t0)/n:.3f} s/batch)")
    return evaluate_fn()


def gather_evaluator(ev):
    """Merge evaluator state across processes before evaluate() (reference:
    ytvis_eval.py:120-126 comm.gather / d2 comm.synchronize). Every rank
    all-gathers each rank's `state_dict()` (`all_gather_object`), then
    resets and folds them in, in rank order, via `merge_state`. A no-op when
    no process group is initialized or it has one rank."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return ev
    states = [None] * dist.get_world_size()
    dist.all_gather_object(states, ev.state_dict())
    ev.reset()
    for state in states:
        ev.merge_state(state)
    return ev


def verify_results(expected: Dict[str, float], results: Dict[str, float],
                   tolerance: float = 0.3) -> bool:
    """Assert metric parity against expected numbers (reference: detectron2
    verify_results driven by TEST.EXPECTED_RESULTS, train_net.py:317)."""
    ok = True
    for k, v in expected.items():
        got = results.get(k)
        if got is None or abs(got - v) > tolerance:
            print(f"verify_results FAIL: {k}: expected {v} got {got}")
            ok = False
        else:
            print(f"verify_results OK: {k}: {got} (expected {v} +- {tolerance})")
    return ok
