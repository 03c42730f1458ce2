"""The port's evaluators (copies of the JAX package's numpy evaluators)
against the JAX package's on identical predictions: every metric bitwise
equal (or NaN in both), in the perfect, false-positive, missed and crowd
cases, after `merge_state`, and through `gather_evaluator` across two
processes on gloo."""

import multiprocessing as mp
import pickle

import numpy as np
import pytest

from bm2f_tpu.evaluation import coco_eval as jax_coco
from bm2f_tpu.evaluation import lvis_eval as jax_lvis
from bm2f_tpu.evaluation import panoptic_eval as jax_pan
from bm2f_tpu.evaluation import sem_seg_eval as jax_sem
from bm2f_tpu.evaluation.evaluator import verify_results as jax_verify
from bm2f_tpu_torch.evaluation import coco_eval, lvis_eval, panoptic_eval, sem_seg_eval
from bm2f_tpu_torch.evaluation.evaluator import (
    gather_evaluator,
    inference_on_dataset,
    verify_results,
)
from torch_eval_cases import (
    CASES,
    THING,
    K,
    case_scenes,
    gather_worker,
    instance_scene,
    panoptic_scene,
    port_evaluator,
    process,
    same_results,
    sem_scene,
)


def _fill(ev, scenes):
    for pred, gt in scenes:
        ev.process(pred, gt)
    return ev


@pytest.mark.parametrize("case", CASES)
def test_coco_ap_bitwise(case):
    scenes = [instance_scene(case, s) for s in range(4)]
    ours = _fill(coco_eval.COCOMaskAPEvaluator(K), scenes).evaluate()
    ref = _fill(jax_coco.COCOMaskAPEvaluator(K), scenes).evaluate()
    same_results(ours, ref)
    if case == "perfect":
        assert ours["AP"] == 100.0


@pytest.mark.parametrize("case", CASES)
def test_lvis_ap_bitwise(case):
    scenes = []
    for s in range(4):
        pred, gt = instance_scene(case, s)
        gt["neg_categories"] = [(s + 1) % K]
        gt["not_exhaustive_categories"] = [(s + 2) % K]
        scenes.append((pred, gt))
    freqs = ["r", "c", "f"] * (K // 3)
    ours = _fill(lvis_eval.LVISMaskAPEvaluator(K, frequencies=freqs), scenes).evaluate()
    ref = _fill(jax_lvis.LVISMaskAPEvaluator(K, frequencies=freqs), scenes).evaluate()
    same_results(ours, ref)


@pytest.mark.parametrize("case", CASES)
def test_sem_seg_bitwise(case):
    scenes = [sem_scene(case, s) for s in range(3)]
    ours, ref = sem_seg_eval.SemSegEvaluator(K), jax_sem.SemSegEvaluator(K)
    for p, g in scenes:
        ours.process(p, g)
        ref.process(p, g)
    same_results(ours.evaluate(), ref.evaluate())


@pytest.mark.parametrize("case", CASES)
def test_panoptic_bitwise(case):
    ours, ref = panoptic_eval.PanopticEvaluator(K, THING), jax_pan.PanopticEvaluator(K, THING)
    for s in range(3):
        scene = panoptic_scene(case, s)
        ours.process(*scene)
        ref.process(*scene)
    same_results(ours.evaluate(), ref.evaluate())
    if case == "perfect":
        assert ours.evaluate()["PQ"] == 100.0


_JAX_EVALUATORS = {"coco": lambda: jax_coco.COCOMaskAPEvaluator(K),
                   "sem_seg": lambda: jax_sem.SemSegEvaluator(K),
                   "panoptic": lambda: jax_pan.PanopticEvaluator(K, THING)}


def _evaluators(kind):
    """(port evaluator, JAX evaluator, scenes) of one kind, mixed cases."""
    return port_evaluator(kind), _JAX_EVALUATORS[kind](), case_scenes(kind)


_process = process


@pytest.mark.parametrize("kind", ["coco", "sem_seg", "panoptic"])
def test_merge_state_bitwise(kind):
    """Two halves merged, in the port and in the JAX package: the same state
    (pickled bytes) and the same results."""
    merged = []
    for side in (0, 1):
        evs = [_evaluators(kind) for _ in range(2)]
        first, second = evs[0][side], evs[1][side]
        scenes = evs[0][2]
        for s in scenes[:2]:
            _process(first, s)
        for s in scenes[2:]:
            _process(second, s)
        first.merge_state(second.state_dict())
        merged.append(first)
    ours, ref = merged
    assert pickle.dumps(ours.state_dict()) == pickle.dumps(ref.state_dict())
    same_results(ours.evaluate(), ref.evaluate())


def test_gather_evaluator_is_a_no_op_in_one_process():
    ours, _, scenes = _evaluators("sem_seg")
    for s in scenes:
        _process(ours, s)
    before = ours.evaluate()
    assert gather_evaluator(ours) is ours
    same_results(ours.evaluate(), before)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["coco", "sem_seg", "panoptic"])
def test_gather_evaluator_across_two_ranks_on_gloo(kind):
    """Two spawned processes, each with its share of the images: after the
    gather both score all of them, as the JAX evaluator does in one
    process (the COCO entries merge in rank order, so the scenes are split
    in an order whose merge the AP does not see: the AP sorts by score)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=gather_worker, args=(r, 2, port, kind, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    _, ref, scenes = _evaluators(kind)
    for s in scenes:
        _process(ref, s)
    for rank in (0, 1):
        same_results(got[rank], ref.evaluate())


def test_verify_results_and_inference_on_dataset(capsys):
    import torch

    expected, results = {"AP": 40.0, "PQ": 50.0}, {"AP": 40.2, "PQ": 49.0}
    assert verify_results(expected, results) is False
    assert jax_verify(expected, results) is False
    assert verify_results({"AP": 40.0}, results) is True

    ev, ref, scenes = _evaluators("sem_seg")
    loader = [{"i": i} for i in range(len(scenes))]
    res = inference_on_dataset(
        lambda b: {"pred": torch.from_numpy(scenes[b["i"]][0])}, loader,
        lambda p, b: ev.process(p["pred"], scenes[b["i"]][1]), ev.evaluate, log_every=2)
    for s in scenes:
        _process(ref, s)
    same_results(res, ref.evaluate())
    assert "inference 2 batches" in capsys.readouterr().out
