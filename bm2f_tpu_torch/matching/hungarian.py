"""Exact Hungarian assignment on the host (the JAX package's fallback solve,
bm2f_tpu/matching/hungarian.py:75-117 and :288-292).

The reference calls scipy `linear_sum_assignment` once per image per decoder
layer, each a device-to-host synchronise (reference: matcher.py:557-559).
Here the costs of ALL layers and images come to the host in ONE copy per
step, and scipy solves the small (Q x G) problems there.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def solve_host(costs: np.ndarray) -> np.ndarray:
    """costs (..., Q, G) with Q >= G. Returns (..., G) int64: for every
    column (target) the row (query) assigned to it."""
    lead, (Q, G) = costs.shape[:-2], costs.shape[-2:]
    flat = np.ascontiguousarray(costs, dtype=np.float32).reshape(-1, Q, G)
    out = np.empty((flat.shape[0], G), dtype=np.int64)
    for i, c in enumerate(flat):
        rows, cols = linear_sum_assignment(c)
        out[i, cols] = rows
    return out.reshape(*lead, G)


def assign(costs: torch.Tensor) -> torch.Tensor:
    """(B, L, Q, G) costs on any device -> (B, L, G) query index of every
    target, on the costs' device. One device-to-host copy of all costs."""
    return torch.from_numpy(solve_host(costs.cpu().numpy())).to(costs.device)
