"""Seeded evaluation scenes shared by tests/test_torch_evaluation.py and the
processes it spawns (this module imports no JAX, so a spawned rank starts
quickly): per case, one image's ground truth and predictions for the
instance, semantic and panoptic evaluators."""

import math

import numpy as np

from bm2f_tpu_torch.evaluation import coco_eval, panoptic_eval, sem_seg_eval

K = 6
H, W = 48, 64
CASES = ("perfect", "false_positive", "missed", "crowd", "noisy")


def same_results(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = float(a[k]), float(b[k])
        assert (math.isnan(x) and math.isnan(y)) or x == y, (k, x, y)


def _blobs(rng, n):
    masks = np.zeros((n, H, W), bool)
    for i in range(n):
        y0, x0 = rng.randint(0, H - 8), rng.randint(0, W - 8)
        masks[i, y0:y0 + rng.randint(4, 24), x0:x0 + rng.randint(4, 30)] = True
    return masks


def instance_scene(case: str, seed: int):
    """(pred, gt) for one image: GT blobs, predictions derived per case."""
    rng = np.random.RandomState(seed)
    g = rng.randint(2, 6)
    gt = {"labels": rng.randint(0, K, g), "masks": _blobs(rng, g),
          "iscrowd": np.zeros(g, bool)}
    masks, labels = gt["masks"].copy(), gt["labels"].copy()
    scores = rng.rand(g).astype(np.float32)
    if case == "false_positive":
        masks = np.concatenate([masks, _blobs(rng, 3)])
        labels = np.concatenate([labels, rng.randint(0, K, 3)])
        scores = np.concatenate([scores, rng.rand(3).astype(np.float32)])
    elif case == "missed":
        masks, labels, scores = masks[1:], labels[1:], scores[1:]
    elif case == "crowd":
        gt["iscrowd"][0] = True
        inside = masks[0] & (rng.rand(H, W) > 0.3)
        masks = np.concatenate([masks, inside[None]])
        labels = np.concatenate([labels, labels[:1]])
        scores = np.concatenate([scores, np.float32([0.99])])
    elif case == "noisy":
        masks = masks ^ (rng.rand(*masks.shape) > 0.9)
    pred = {"scores": scores, "labels": labels, "masks": masks,
            "valid": np.ones(len(scores), bool)}
    return pred, gt


def sem_scene(case: str, seed: int):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, K, (H, W))
    gt[:4] = 255  # ignored strip
    pred = gt.copy()
    pred[:4] = rng.randint(0, K, (4, W))
    if case == "false_positive":
        pred[10:20, 10:20] = (gt[10:20, 10:20] + 1) % K
    elif case == "missed":
        gt[30:40, :] = K - 1
        pred[30:40, :] = 0
    elif case in ("noisy", "crowd"):
        flip = rng.rand(H, W) > 0.8
        pred[flip] = rng.randint(0, K, int(flip.sum()))
    return pred, gt


THING = (True, True, True, False, False, False)


def panoptic_scene(case: str, seed: int):
    """(pred_map, pred_segments, gt_map, gt_segments), ids from 0, -1 void."""
    rng = np.random.RandomState(seed)
    gt_map = np.full((H, W), -1, np.int64)
    segs = []
    for sid, (y0, x0) in enumerate(((0, 0), (0, 32), (24, 0), (24, 32))):
        gt_map[y0 + 2:y0 + 22, x0 + 2:x0 + 30] = sid
        segs.append({"id": sid, "category_id": int(rng.randint(0, K)), "iscrowd": 0})
    pred_map, pred_segs = gt_map.copy(), [dict(s) for s in segs]
    if case == "false_positive":
        pred_map[0:2, :] = 9
        pred_segs.append({"id": 9, "category_id": 1})
    elif case == "missed":
        pred_map[pred_map == 3] = -1
        pred_segs = pred_segs[:3]
    elif case == "crowd":
        segs[0]["iscrowd"] = 1
    elif case == "noisy":
        flip = rng.rand(H, W) > 0.85
        pred_map[flip] = rng.randint(-1, 4, int(flip.sum()))
    return pred_map, [{"id": s["id"], "category_id": s["category_id"]} for s in pred_segs], \
        gt_map, segs




def case_scenes(kind: str):
    """One scene of each case, in order."""
    make = {"coco": instance_scene, "sem_seg": sem_scene, "panoptic": panoptic_scene}[kind]
    return [make(c, i) for i, c in enumerate(CASES)]


def port_evaluator(kind: str):
    if kind == "coco":
        return coco_eval.COCOMaskAPEvaluator(K)
    if kind == "sem_seg":
        return sem_seg_eval.SemSegEvaluator(K)
    return panoptic_eval.PanopticEvaluator(K, THING)


def process(ev, scene) -> None:
    ev.process(*scene)


def gather_worker(rank, world, port, kind, queue):
    """One rank of a gloo group: its share of the scenes, then
    `gather_evaluator` and the results into `queue`."""
    import torch.distributed as dist

    from bm2f_tpu_torch.evaluation.evaluator import gather_evaluator

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        ev = port_evaluator(kind)
        for s in case_scenes(kind)[rank::world]:
            process(ev, s)
        queue.put((rank, gather_evaluator(ev).evaluate()))
    finally:
        dist.destroy_process_group()
