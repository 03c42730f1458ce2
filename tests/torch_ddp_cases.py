"""What the data-parallel tests (tests/test_torch_ddp*.py) run in their
spawned ranks, and the checks they share. Each rank is a process of a gloo
group on the CPU, started through `parallel.init_distributed` from the
variables `torch.distributed.run` would set, with one torch thread. This
module imports no JAX, so that a spawned rank does not either.

The tolerances, from an error model of what differs:

- The port at world 2 against the JAX `Trainer` step over a 2-device mesh
  on the global batch: the same model as the one-process comparison of
  tests/test_torch_train.py (losses rtol 1e-4, grad_norm rtol 1e-3, every
  parameter within lr of JAX's after the update), because what data
  parallelism adds, the order of a two-term sum per denominator and per
  gradient element, is one f32 rounding, ~1e-7 relative, far below it.
- The port at world 2 against the port at world 1 on the same global
  batch: nothing differs but the order of sums. Each rank runs a batch of
  one where one process runs two, and the CPU's GEMM and convolution
  kernels block their sums by the batch; the gradients add across ranks.
  That is f32 rounding of sums through ~20 layers: on the SMALL mask step
  the losses read up to 4.7e-6 apart, each parameter's gradient up to
  1.2e-5 of its norm (2.5e-6 of the global norm). Held at WORLD_REL =
  1e-4 on every loss, on grad_norm, and, through AdamW's update, on the
  parameters (`update_bound`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# the sums' order between world sizes (see the module's docstring)
WORLD_REL = 1e-4
# the port against JAX (tests/test_torch_train.py)
JAX_LOSS_RTOL, JAX_NORM_RTOL = 1e-4, 1e-3
ADAM_EPS = 1e-8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(target, rank, world, port, args, queue):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from bm2f_tpu_torch.parallel import init_distributed

    init_distributed("cpu")
    try:
        queue.put((rank, target(*args)))
    except BaseException:
        queue.put((rank, RuntimeError(f"rank {rank}:\n{traceback.format_exc()}")))
    finally:
        dist.destroy_process_group()


def run_ranks(target: Callable, world: int, *args, timeout: float = 300) -> List[object]:
    """`target(*args)` in each of `world` spawned ranks of a gloo group;
    their results by rank. Raises a rank's exception."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r in range(world):
        if isinstance(got[r], BaseException):
            raise got[r]
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [got[r] for r in range(world)]


# -- the variants of the step -------------------------------------------------------------


def _upstream_denominators(v: torch.Tensor) -> torch.Tensor:
    """Upstream Mask2Former's recipe in this summing frame: `num_masks`
    (the first entry) over all ranks, every other denominator the rank's
    own, times the world size (so that equal halves give the global one):
    the ranks' losses then sum to the mean of their means."""
    from bm2f_tpu_torch.parallel import global_sum, world_size

    return torch.cat([global_sum(v[:1]), v[1:] * world_size()])


def _no_f(x, tp):
    """Megatron's f with its backward all-reduce left out."""
    return x


def _bias_on_every_rank(linear, x, tp):
    """A row-parallel layer that adds its bias before the sum over the
    model group, so every rank adds it."""
    import torch.nn.functional as F

    from bm2f_tpu_torch.parallel import tp as tparallel

    b = None if linear.bias is None else linear.bias.to(x.dtype)
    return tparallel.reduce_from_model(F.linear(x, linear.weight.to(x.dtype), b), tp)


def _norm_counting_replicated(self, grads):
    """grad_norm's sum of squares with the replicated parameters summed
    over the model group too, so that each counts T times."""
    import torch.distributed as dist

    sq = torch.cat([g.reshape(-1) for g in grads]).square().sum()
    dist.all_reduce(sq, group=self.model_group)
    return sq


def _patched(variant: str):
    """What `variant` replaces: "ours" nothing; "num_masks_only" the
    criteria's denominators (`_upstream_denominators`); "mean_grads" the
    DDP hook by DDP's default, which averages the gradients. Under tensor
    parallelism: "no_f_backward" Megatron's f by the identity (no gradient
    sum over the model group), "bias_every_rank" the row-parallel layers
    by ones that add their bias on every rank, "norm_replicated_t_times"
    grad_norm's sum by one that counts each replicated parameter T times."""
    from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

    from bm2f_tpu_torch.losses import deep_supervision
    from bm2f_tpu_torch.parallel import tp as tparallel
    from bm2f_tpu_torch.train import optim, trainer

    if variant == "ours":
        return []
    if variant == "num_masks_only":
        return [(deep_supervision, "global_sum", _upstream_denominators)]
    if variant == "mean_grads":
        return [(trainer, "sum_gradients", allreduce_hook)]
    if variant == "no_f_backward":
        return [(tparallel, "copy_to_model", _no_f)]
    if variant == "bias_every_rank":
        return [(tparallel, "row_linear", _bias_on_every_rank)]
    if variant == "norm_replicated_t_times":
        return [(optim.AdamW, "_sharded_sq_sum", _norm_counting_replicated)]
    raise ValueError(variant)


def _whole(trainer, tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """`tensors` by parameter name as numpy, the shares of a tensor-parallel
    trainer gathered whole (every rank of its model group calls it)."""
    from bm2f_tpu_torch.parallel import tp as tparallel

    if trainer.shard is not None:
        tensors = tparallel.gather_state(tensors, trainer.splits, trainer.shard)
    return {n: t.detach().numpy().copy() for n, t in tensors.items()}


def train_steps(config: str, overrides: dict, state_dict: Dict[str, torch.Tensor],
                batches: Sequence[dict], points: Sequence[Optional[dict]],
                variants: Sequence[str] = ("ours",), step_count: int = 0,
                keep_params: bool = True) -> dict:
    """For each variant: a `Trainer` on the CPU (in the process group when
    there is one) with `state_dict` loaded (cut to the rank's shares under
    tensor parallelism, `overrides`' "mesh.model") and `step_count` steps
    taken, then a step on this rank's rows (`local_rows`) of each global
    batch, with its rows of `points[i]` (the trainer's own draws where
    None). Returns {variant: {"metrics": [per step], "params": [per step],
    "grads": [per step] (whole tensors), "replicated": [per step] (the
    rank's replicated parameters), "no_grad": names without a gradient}}."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.parallel import local_rows
    from bm2f_tpu_torch.parallel import tp as tparallel
    from bm2f_tpu_torch.train.trainer import Trainer

    cfg = get_config(config, overrides)
    out = {}
    for variant in variants:
        saved = []
        for mod, name, value in _patched(variant):
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, value)
        try:
            trainer = Trainer(cfg, device="cpu")
            local = state_dict
            if trainer.shard is not None:
                local = tparallel.shard_state(state_dict, trainer.splits,
                                              trainer.shard.rank, trainer.shard.size)
            trainer.model.load_state_dict(local, strict=True)
            trainer.optimizer.count = step_count
            opt = trainer.optimizer
            res = {"metrics": [], "params": [], "grads": [], "replicated": [],
                   "no_grad": set(), "lr": [],
                   "lr_mult": {g.name: g.lr_mult for g in opt.groups},
                   "clip": opt.cfg.clip_gradients}
            for batch, pts in zip(batches, points):
                batch = local_rows({k: torch.as_tensor(v) for k, v in batch.items()})
                if pts is not None:
                    pts = local_rows(pts, axis=1)
                m = trainer.step(batch, pts)
                res["metrics"].append({k: v.item() for k, v in m.items()})
                res["lr"].append(opt.schedule(opt.count - 1))
                named = list(trainer.model.named_parameters())
                res["no_grad"] |= {n for n, p in named if p.grad is None}
                if keep_params:
                    res["params"].append(_whole(trainer, dict(named)))
                    res["grads"].append(_whole(trainer, {n: p.grad for n, p in named
                                                         if p.grad is not None}))
                    res["replicated"].append({n: p.detach().numpy().copy()
                                              for n, p in named if n not in trainer.splits})
            out[variant] = res
        finally:
            for mod, name, value in saved:
                setattr(mod, name, value)
    return out


# -- the checks ---------------------------------------------------------------------------


def check_losses(want: Dict[str, float], got: Dict[str, float], rtol: float,
                 norm_rtol: float, atol: float = 1e-7) -> None:
    """Every loss of `want` (total_loss and grad_norm included) in `got`."""
    assert set(want) <= set(got), sorted(set(want) ^ set(got))
    for k, v in want.items():
        tol = norm_rtol if k == "grad_norm" else rtol
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=atol, err_msg=k)


def update_bound(g: np.ndarray, lr_eff: float, rel: float, ulp: np.ndarray) -> np.ndarray:
    """The largest |update_a - update_b| of AdamW's first update, per
    element, when the clipped gradient `g` (f64) of the two sides differs
    by `rel` of its tensor's norm plus `rel` of itself: the update
    lr_eff (g / (|g| + eps) + wd p) moves by lr_eff eps |dg| / (|g| +
    eps)^2, at most the 2 lr_eff of a flipped sign; plus the f32
    arithmetic of the update (some seven roundings of values up to lr_eff,
    4 ulp of lr_eff) and an ulp of the new parameter, on each side."""
    ag = np.abs(g)
    tau = rel * (np.linalg.norm(g) + ag)
    return (lr_eff * np.minimum(ADAM_EPS * tau / (ag + ADAM_EPS) ** 2, 2.0)
            + 8 * 2.0 ** -23 * lr_eff + 2 * ulp)


def check_update(want: dict, got: Dict[str, np.ndarray], step: int = 0,
                 rel: float = WORLD_REL) -> None:
    """Every element of `got`, the parameters after step `step` from the
    same parameters and moments as `want`'s (a `train_steps` result), within
    `update_bound` of `want`'s, with `want`'s raw gradients of that step."""
    grads = want["grads"][step]
    norm = float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                             for g in grads.values())))
    clip = want["clip"] / norm if norm >= want["clip"] else 1.0
    params = want["params"][step]
    assert set(params) == set(got) == set(grads)
    for name, w in params.items():
        o = got[name]
        ulp = np.spacing(np.maximum(np.abs(w), np.abs(o))).astype(np.float64)
        d = np.abs(o.astype(np.float64) - w.astype(np.float64))
        bound = update_bound(grads[name].astype(np.float64) * clip,
                             want["lr"][step] * want["lr_mult"][name], rel, ulp)
        excess = float((d / bound).max())
        assert excess <= 1.0, (name, excess)
