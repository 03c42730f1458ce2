"""PointRend-style uncertainty point sampling (reference: detectron2
point_rend.point_features.get_uncertain_point_coords_with_randomness), as
the JAX package writes it (bm2f_tpu/losses/point_features.py): masks in
(N, H, W), points (x, y) in [0, 1].

The most uncertain candidates are picked in JAX's order: `jax.lax.top_k`
returns them by value, the lower index first among equal values, which
`torch.topk` does not promise; a stable descending sort does.
"""

from __future__ import annotations

import torch

from bm2f_tpu_torch.ops.sampling import point_sample


def sample_mask_points(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks: (N, H, W), coords: (N, P, 2) in [0, 1] -> (N, P)."""
    return point_sample(masks[..., None], coords)[..., 0]


def uncertain_point_coords(mask_logits: torch.Tensor, cand: torch.Tensor,
                           rand: torch.Tensor, num_points: int,
                           importance_sample_ratio: float = 0.75) -> torch.Tensor:
    """The points of `get_uncertain_point_coords_with_randomness` from given
    draws: the int(importance_sample_ratio * num_points) candidates of
    `cand` (N, n_cand, 2) with the smallest |logit|, most uncertain first,
    then `rand` (N, num_points - that, 2). Returns (N, num_points, 2)."""
    uncertainty = -sample_mask_points(mask_logits, cand).abs()
    num_uncertain = int(importance_sample_ratio * num_points)
    order = torch.sort(uncertainty, dim=1, descending=True, stable=True).indices
    idx = order[:, :num_uncertain]
    picked = torch.take_along_dim(cand, idx[..., None], dim=1)
    if num_points - num_uncertain > 0:
        picked = torch.cat([picked, rand], dim=1)
    return picked


def get_uncertain_point_coords_with_randomness(
    generator: torch.Generator,
    mask_logits: torch.Tensor,  # (N, H, W)
    num_points: int,
    oversample_ratio: float = 3.0,
    importance_sample_ratio: float = 0.75,
) -> torch.Tensor:
    """Sample `num_points` coords per mask: the most uncertain (smallest
    |logit|) among num_points * oversample_ratio uniform candidates, topped
    up with fresh uniform points, both drawn from `generator` (on the
    logits' device). Returns (N, num_points, 2)."""
    N = mask_logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    num_random = num_points - int(importance_sample_ratio * num_points)
    kw = dict(generator=generator, device=mask_logits.device, dtype=torch.float32)
    cand = torch.rand((N, num_sampled, 2), **kw)
    rand = torch.rand((N, max(num_random, 0), 2), **kw)
    return uncertain_point_coords(mask_logits, cand, rand, num_points,
                                  importance_sample_ratio)
