"""Linear sum assignment for Hungarian matching: the counterparts of the JAX
package's solvers (bm2f_tpu/matching/hungarian.py) and of its Trainer's
choice among them (`Trainer._make_assign_fn`, bm2f_tpu/train/trainer.py:
173-205).

- `solve_host` / `assign`: the exact host solve, on the port's copy of the
  JAX package's native Jonker-Volgenant solver (`csrc/lap.cpp`, built with
  the host C++ compiler at first use and bound with `ctypes`). The costs of
  ALL layers and images come to the host in ONE copy per step (the
  reference calls scipy once per image per layer, matcher.py:557-559). A
  missing compiler raises: the JAX package falls back to scipy, which breaks
  ties differently, and with the padding columns at `PAD_COST` ties are the
  norm.
- `jv_assign`: the exact solver on the costs' device, batched JV with done
  masks (`:317-415`), in a fixed number of masked rounds and no host
  synchronise.
- `auction_assign`: the epsilon-scaling auction (`:121-285`), approximate.
- `make_assign_fn(cfg)`: "lap", "jv", "auction" (with the JAX package's
  warning), and "auto" = "lap" (see `TrainConfig.matcher`).

Every function takes costs (..., Q, G) with Q >= G and gives, for every
column (target), the row (query) assigned to it.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Callable

import numpy as np
import torch

from bm2f_tpu_torch.ops import cuda_build
from bm2f_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

_LAP_SOURCE = "lap.cpp"
_lap_fn = None


def _solve_lap_batch():
    """`solve_lap_batch` of the native solver, built first if needed."""
    global _lap_fn
    if _lap_fn is None:
        fn = cuda_build.load(_LAP_SOURCE).solve_lap_batch
        fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
        _lap_fn = fn
    return _lap_fn


def solve_host(costs: np.ndarray) -> np.ndarray:
    """costs (..., Q, G) with Q >= G, on the host. Returns (..., G) int64:
    for every column (target) the row (query) assigned to it, as the JAX
    package's `_solve_host` gives it with its native solver."""
    lead, (Q, G) = costs.shape[:-2], costs.shape[-2:]
    if Q < G:  # the native solver would not return
        raise ValueError(f"{G} targets but {Q} queries: every target needs a query "
                         "(model.decoder.num_queries >= input.max_instances)")
    flat = np.ascontiguousarray(costs, dtype=np.float32).reshape(-1, Q, G)
    out = np.empty((flat.shape[0], G), dtype=np.int32)
    if flat.shape[0] and G:
        _solve_lap_batch()(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           flat.shape[0], Q, G,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out.astype(np.int64).reshape(*lead, G)


def assign(costs: torch.Tensor) -> torch.Tensor:
    """(..., Q, G) costs on any device -> (..., G) query index of every
    target, on the costs' device. One device-to-host copy of all costs.
    Traced as the spans "assign.to_host", "assign.solve" and
    "assign.to_device"."""
    with tracing.span("assign.to_host"):
        host = costs.detach().float().cpu().numpy()
    with tracing.span("assign.solve"):
        rows = solve_host(host)
    with tracing.span("assign.to_device"):
        return torch.from_numpy(rows).to(costs.device)


@torch.no_grad()
def jv_assign(costs: torch.Tensor) -> torch.Tensor:
    """Exact rectangular LSA on the costs' device: batched Jonker-Volgenant
    shortest augmenting paths, the port of the JAX package's `jv_assign`.
    costs (B, Q, G), Q >= G. Returns (B, G) int64.

    One Dijkstra per column j0, all B problems in lockstep with done masks,
    then the dual update and the augmentation. JAX runs each Dijkstra and
    each augmentation as a `while_loop` until every problem is done; here
    each takes a fixed count of masked rounds instead, so that no round asks
    the host. Column j0 meets j0 assigned rows, so its Dijkstra scans at
    most j0 + 1 rows before it reaches a free one, and its augmenting path
    has at most j0 + 1 steps: j0 + 1 rounds each, in which a finished
    problem changes nothing, give JAX's result with no synchronise."""
    B, Q, G = costs.shape
    dev = costs.device
    costs = costs.float()
    INF = torch.tensor(3e38, device=dev)
    rows = torch.arange(Q, device=dev)
    cols = torch.arange(G, device=dev)
    bidx = torch.arange(B, device=dev)
    v = torch.zeros((B, Q), device=dev)
    row_to_col = torch.full((B, Q), -1, dtype=torch.long, device=dev)
    col_to_row = torch.full((B, G), -1, dtype=torch.long, device=dev)
    for j0 in range(G):
        d = costs[:, :, j0] - v
        pred = torch.full((B, Q), j0, dtype=torch.long, device=dev)
        scanned = torch.zeros((B, Q), dtype=torch.bool, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        r_end = torch.zeros((B,), dtype=torch.long, device=dev)
        mu_end = torch.zeros((B,), device=dev)
        for _ in range(j0 + 1):
            dm = torch.where(scanned, INF, d)
            r_star = dm.argmin(1)
            mu = dm[bidx, r_star]
            scanned = scanned | ((rows[None, :] == r_star[:, None]) & ~done[:, None])
            j_owner = row_to_col[bidx, r_star]
            is_free = j_owner < 0
            newly = ~done & is_free
            r_end = torch.where(newly, r_star, r_end)
            mu_end = torch.where(newly, mu, mu_end)
            done = done | is_free
            # relax through the owning column j: nd[r] = mu + (cost[r, j] -
            # v[r]) - (cost[r*, j] - v[r*]), for problems still running
            jc = costs[bidx, :, j_owner.clamp(min=0)] - v  # (B, Q)
            nd = mu[:, None] + jc - jc[bidx, r_star][:, None]
            improve = ~done[:, None] & ~scanned & (nd < d)
            d = torch.where(improve, nd, d)
            pred = torch.where(improve, j_owner[:, None], pred)
        # dual update over the finalized rows (r_end's d == mu_end: no-op)
        v = torch.where(scanned, v + torch.clamp(d - mu_end[:, None], max=0.0), v)
        # augment: walk pred back to j0, flipping assignments
        r = r_end
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        for _ in range(j0 + 1):
            j = pred[bidx, r]
            old_r = col_to_row[bidx, j]
            row_to_col = torch.where((rows[None, :] == r[:, None]) & active[:, None],
                                     j[:, None], row_to_col)
            col_to_row = torch.where((cols[None, :] == j[:, None]) & active[:, None],
                                     r[:, None], col_to_row)
            active = active & (j != j0)
            r = torch.where(active, old_r, r)
    return col_to_row


# rounds of an auction phase between two checks whether every column is
# assigned: a round with none left changes nothing, so the check (one host
# synchronise) only saves the rest of the phase's rounds
_AUCTION_CHECK = 8


@torch.no_grad()
def auction_assign(costs: torch.Tensor, num_iters: int = 300, phases: int = 7,
                   eps_decay: float = 5.0) -> torch.Tensor:
    """The epsilon-scaling forward auction on the costs' device, the port of
    the JAX package's `auction_assign` (experimental there: on padded
    production costs the identical padding columns bid against each other
    and bounded rounds leave it suboptimal). costs (B, Q, G) to minimize.
    Returns (B, G) int64, one-to-one: columns left unassigned after a phase's
    `num_iters` rounds take the cheapest row no column holds, column by
    column."""
    B, Q, G0 = costs.shape
    dev = costs.device
    costs = costs.float()
    benefits = -costs
    # per-column shift (assignment-invariant), then scale-free normalisation
    benefits = benefits - benefits.amax(1, keepdim=True)
    scale = torch.clamp((-benefits).amax((1, 2), keepdim=True), min=1e-12)
    benefits = benefits / scale
    # square it up with dummy columns below the minimum benefit
    G = Q
    if G0 < Q:
        floor = benefits.amin((1, 2), keepdim=True) - 0.1
        benefits = torch.cat([benefits, floor.expand(B, Q, Q - G0)], 2)
    # the deterministic sub-eps tie-break of the JAX package (int32 products
    # wrap there; 2^32 is a multiple of 1024, so the residues agree)
    qg = (torch.arange(Q, device=dev)[:, None] * 1103515245
          + torch.arange(G, device=dev)[None, :] * 12345) % 1024
    benefits = benefits + (qg.float() / 1024.0) * 1e-6
    col_ids = torch.arange(G, device=dev)[None, :]

    def round_(price, owner, eps):
        value = benefits - price[:, :, None]  # (B, Q, G)
        best, best_row = value.max(1)
        row_onehot = torch.arange(Q, device=dev)[None, :, None] == best_row[:, None, :]
        second = torch.where(row_onehot, -torch.inf, value).amax(1)
        second = torch.where(torch.isfinite(second), second, best - 1.0)
        bid = best - second + eps
        unassigned = owner < 0
        bid_matrix = torch.where(unassigned[:, None, :] & row_onehot, bid[:, None, :],
                                 -torch.inf)
        win_bid, win_col = bid_matrix.max(2)
        row_has_bid = torch.isfinite(win_bid)
        price = torch.where(row_has_bid, price + torch.maximum(win_bid, eps), price)
        evicted = (owner >= 0) & torch.gather(row_has_bid, 1, owner.clamp(min=0))
        owner = torch.where(evicted, -1, owner)
        col_won = (unassigned & torch.gather(row_has_bid, 1, best_row)
                   & (torch.gather(win_col, 1, best_row) == col_ids))
        return price, torch.where(col_won, best_row, owner)

    eps_sched = 0.25 / (eps_decay ** torch.arange(phases, dtype=torch.float32, device=dev))
    price = torch.zeros((B, Q), device=dev)
    owner = torch.full((B, G), -1, dtype=torch.long, device=dev)
    for p in range(phases):
        eps = eps_sched[p]
        # keep the assignment; release the columns the tighter eps violates
        value = benefits - price[:, :, None]
        best = value.amax(1)
        cur = torch.gather(value, 1, owner.clamp(min=0)[:, None, :])[:, 0]
        owner = torch.where((owner >= 0) & (cur >= best - eps * 1.000001), owner, -1)
        for it in range(num_iters):
            if it % _AUCTION_CHECK == 0 and not bool((owner < 0).any()):
                break
            price, owner = round_(price, owner, eps)
    owner = owner[:, :G0]  # drop the dummy columns
    # collision-free greedy fill of any stragglers, column by column
    taken = torch.zeros((B, Q), dtype=torch.bool, device=dev)
    taken[(owner >= 0).nonzero(as_tuple=True)[0], owner[owner >= 0]] = True
    bidx = torch.arange(B, device=dev)
    for g in range(G0):
        need = owner[:, g] < 0
        row = torch.where(taken, torch.inf, costs[:, :, g]).argmin(1)
        owner[:, g] = torch.where(need, row, owner[:, g])
        taken[bidx, row] |= need
    return owner


def make_assign_fn(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """The assignment the train step takes, from `cfg.train.matcher`, as the
    JAX `Trainer._make_assign_fn` picks it: (B, L, Q, G) costs -> (B, L, G)
    on the costs' device. "auto" is "lap" on every device: the JAX package
    picks "jv" on accelerators only because its TPU runtime had no host
    callbacks, and both are exact. The sharded assign waits for DDP."""
    choice = cfg.train.matcher
    if choice == "auto":
        choice = "lap"
    if choice == "lap":
        return assign
    if choice == "jv":
        return _batched(jv_assign)
    if choice == "auction":
        log.warning(
            "train.matcher='auction' is EXPERIMENTAL: the epsilon-scaling"
            " auction is measurably suboptimal on padded production cost"
            " matrices (identical padding columns cause bidding wars)."
            " Use the default exact on-device JV solver instead"
            " (train.matcher='jv').")
        iters = cfg.train.auction_iters
        return _batched(lambda c: auction_assign(c, num_iters=iters))
    raise ValueError(f"train.matcher {cfg.train.matcher!r}: one of 'auto', 'lap', "
                     "'jv', 'auction'")


def _batched(solver):
    """(B, L, Q, G) -> (B, L, G) through a (B*L, Q, G) solver."""
    def fn(costs4: torch.Tensor) -> torch.Tensor:
        B, L, Q, G = costs4.shape
        return solver(costs4.reshape(B * L, Q, G)).reshape(B, L, G)
    return fn
