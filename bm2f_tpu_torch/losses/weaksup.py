"""Box-supervised (weak) segmentation losses of images, as the JAX package
computes them (bm2f_tpu/losses/weaksup.py; reference:
mask2former/utils/weaksup_utils.py, modeling/criterion.py SetCriterionProj
:445 / SetCriterionProjPair :184, matcher.py HungarianMatcherProj :356 /
HungarianMatcherProjPair :219).

Everything is batched tensor math on the inputs' device, channels last as in
the JAX package: `unfold_wo_center` takes K zero-padded shifts, the LAB
conversion runs on the device, and the projection flags of every (query,
target) pair are one broadcast comparison.

Where the two frameworks give different bits:
- `rgb_to_lab` takes `xyz ** (1/3)` where JAX takes `cbrt` (the same
  function on the non-negative `xyz`, not the same rounding);
- the maxima of `projection_*` are `amax`, whose gradient is split evenly
  among ties as JAX's `max` is; the argmax takes the first of equal values
  in both frameworks.
The training step's scalars (`pairwise_warmup_factor`,
`mask_update_pix_thr`) are computed on the host in f32, as JAX computes
them, and returned as Python floats.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
_D65_WHITE = (0.95047, 1.0, 1.08883)


# ---------------------------------------------------------------------------
# Color utilities
# ---------------------------------------------------------------------------


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0, 1] -> CIELAB, matching skimage.color.rgb2lab (D65).
    rgb: (..., 3)."""
    rgb = rgb.clamp(0.0, 1.0)
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = torch.tensor(_RGB_TO_XYZ, dtype=rgb.dtype, device=rgb.device)
    xyz = linear @ m.T
    xyz = xyz / torch.tensor(_D65_WHITE, dtype=rgb.dtype, device=rgb.device)
    f = torch.where(xyz > 0.008856, xyz.pow(1.0 / 3.0), 7.787 * xyz + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def neighbor_offsets(kernel_size: int, dilation: int) -> List[Tuple[int, int]]:
    r = kernel_size // 2
    return [(dy * dilation, dx * dilation)
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if not (dy == 0 and dx == 0)]


def unfold_wo_center(x: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C, K) neighbour values, zero outside the
    image, K = kernel_size^2 - 1 (reference: weaksup_utils.py:7-31)."""
    B, H, W, C = x.shape
    p = (kernel_size // 2) * dilation
    padded = F.pad(x, (0, 0, p, p, p, p))
    return torch.stack([padded[:, p + dy:p + dy + H, p + dx:p + dx + W]
                        for dy, dx in neighbor_offsets(kernel_size, dilation)], dim=-1)


def get_images_color_similarity(lab: torch.Tensor, kernel_size: int = 3,
                                dilation: int = 2) -> torch.Tensor:
    """(B, H, W, 3) LAB -> (B, H, W, K) exp(-||diff|| / 2)
    (reference: weaksup_utils.py:34-57)."""
    neigh = unfold_wo_center(lab, kernel_size, dilation)  # (B, H, W, 3, K)
    diff = lab[..., None] - neigh
    dist = torch.sqrt((diff ** 2).sum(dim=3) + 1e-12)
    return torch.exp(-dist * 0.5)


# ---------------------------------------------------------------------------
# Box-mask targets + projection bounds
# ---------------------------------------------------------------------------


def _first_true(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along `dim`, 0 where there is none (JAX's
    argmax of a bool array)."""
    return torch.argmax(m.to(torch.uint8), dim=dim)


def box_targets_from_masks(gt_masks: torch.Tensor, stride: int = 4) -> Dict[str, torch.Tensor]:
    """Box masks and projection bounds from full-resolution masks
    (reference: maskformer_model.py:454-492 prepare_weaksup_targets):
    left/right bounds per row, top/bottom per column, subsampled by `stride`
    starting at stride // 2, divided by stride. Only the subsampled rows and
    columns are computed: the same values as subsampling the full ones.

    gt_masks: (N, H, W). Returns box_masks (N, H/s, W/s), left/right_bounds
    (N, H/s), top/bottom_bounds (N, W/s), all f32."""
    N, H, W = gt_masks.shape
    dev = gt_masks.device
    start = stride // 2
    m = gt_masks > 0.5
    rows_s = m[:, start::stride, :]  # (N, h, W)
    cols_s = m[:, :, start::stride]  # (N, H, w)
    # the first True of each subsampled row and column; an empty row's
    # right (column's bottom) bound is multiplied to 0
    left = _first_true(rows_s, 2).float()
    right = (W - _first_true(rows_s.flip(2), 2)).float() * rows_s.any(2)
    top = _first_true(cols_s, 1).float()
    bottom = (H - _first_true(cols_s.flip(1), 1)).float() * cols_s.any(1)

    any_row, any_col = m.any(2), m.any(1)  # (N, H), (N, W)
    rows, cols = torch.arange(H, device=dev), torch.arange(W, device=dev)
    y0 = torch.where(any_row, rows, H).amin(1)
    y1 = torch.where(any_row, rows, -1).amax(1)
    x0 = torch.where(any_col, cols, W).amin(1)
    x1 = torch.where(any_col, cols, -1).amax(1)
    yy = rows[start::stride][None, :, None]
    xx = cols[start::stride][None, None, :]
    box = ((yy >= y0[:, None, None]) & (yy <= y1[:, None, None])
           & (xx >= x0[:, None, None]) & (xx <= x1[:, None, None])).float()
    return {"box_masks": box, "left_bounds": left / stride, "right_bounds": right / stride,
            "top_bounds": top / stride, "bottom_bounds": bottom / stride}


# ---------------------------------------------------------------------------
# Projection (limited-label) loss
# ---------------------------------------------------------------------------


def _proj_dice(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-instance 1D projection dice (reference: criterion.py:39-75
    projection_dice_loss, eps=1e-3, squared union)."""
    p = torch.sigmoid(inputs)
    inter = (p * targets).sum(-1)
    union = (p ** 2).sum(-1) + (targets ** 2).sum(-1) + 1e-3
    return 1.0 - 2.0 * inter / union


def _projections(masks: torch.Tensor):
    """(N, H, W) logits -> the row maxima (N, H) with each row's argmax
    column, and the column maxima (N, W) with each column's argmax row."""
    src_y, amax_x = masks.amax(2), masks.argmax(2).float()
    src_x, amax_y = masks.amax(1), masks.argmax(1).float()
    return src_y, amax_x, src_x, amax_y


def projection_loss(src_masks: torch.Tensor, box_masks: torch.Tensor,
                    bounds: Dict[str, torch.Tensor], valid: torch.Tensor,
                    num_masks) -> torch.Tensor:
    """Projection-limited-label dice (reference: criterion.py:573-603): the
    row / column projection of a matched mask counts only where its argmax
    falls inside the box bounds. src_masks (N, H, W) logits, box_masks
    (N, H, W), bounds left/right (N, H) and top/bottom (N, W), valid (N,)."""
    src_y, amax_x, src_x, amax_y = _projections(src_masks)
    flag_y = (amax_x >= bounds["left_bounds"]) & (amax_x < bounds["right_bounds"])
    flag_x = (amax_y >= bounds["top_bounds"]) & (amax_y < bounds["bottom_bounds"])
    tgt_y = box_masks.amax(2) * flag_y.to(src_masks.dtype)
    tgt_x = box_masks.amax(1) * flag_x.to(src_masks.dtype)
    loss = (_proj_dice(src_x, tgt_x) + _proj_dice(src_y, tgt_y)) * valid
    return loss.sum() / num_masks


def projection_cost_matrix(pred_masks: torch.Tensor, box_masks: torch.Tensor,
                           bounds: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(Q, G) projection-limited-label dice cost (reference: matcher.py
    batch_axis_projection_limited_label :181-216). pred_masks (Q, H, W)
    logits, box_masks (G, H, W), bounds (G, H) / (G, W)."""
    src_y, amax_x, src_x, amax_y = _projections(pred_masks)
    flag_y = ((amax_x[:, None] >= bounds["left_bounds"][None])
              & (amax_x[:, None] < bounds["right_bounds"][None]))  # (Q, G, H)
    flag_x = ((amax_y[:, None] >= bounds["top_bounds"][None])
              & (amax_y[:, None] < bounds["bottom_bounds"][None]))  # (Q, G, W)
    tgt_y = box_masks.amax(2)[None] * flag_y
    tgt_x = box_masks.amax(1)[None] * flag_x
    py = torch.sigmoid(src_y)[:, None]  # (Q, 1, H)
    px = torch.sigmoid(src_x)[:, None]
    dice_y = 1.0 - 2.0 * (py * tgt_y).sum(-1) / (
        (py ** 2).sum(-1) + (tgt_y ** 2).sum(-1) + 1e-3)
    dice_x = 1.0 - 2.0 * (px * tgt_x).sum(-1) / (
        (px ** 2).sum(-1) + (tgt_x ** 2).sum(-1) + 1e-3)
    return dice_x + dice_y


# ---------------------------------------------------------------------------
# Pairwise (color-affinity) loss
# ---------------------------------------------------------------------------


def log_same_prob(mask_logits: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """(N, H, W) logits -> (N, H, W, K) log P(same label as the neighbour),
    in log space (reference: criterion.py:156-181 calculate_pred_similaries).
    The 1e-12 inside the log is JAX's, not `logaddexp`'s."""
    log_fg = F.logsigmoid(mask_logits)[..., None]  # (N, H, W, 1)
    log_bg = F.logsigmoid(-mask_logits)[..., None]
    fg_n = unfold_wo_center(log_fg, kernel_size, dilation)[..., 0, :]  # (N, H, W, K)
    bg_n = unfold_wo_center(log_bg, kernel_size, dilation)[..., 0, :]
    same_fg = log_fg + fg_n
    same_bg = log_bg + bg_n
    mx = torch.maximum(same_fg, same_bg)
    return torch.log(torch.exp(same_fg - mx) + torch.exp(same_bg - mx) + 1e-12) + mx


def pairwise_loss(src_masks: torch.Tensor, color_similarity: torch.Tensor,
                  box_masks: torch.Tensor, valid: torch.Tensor, num_masks, *,
                  color_thresh: float = 0.3, kernel_size: int = 3, dilation: int = 2,
                  warmup_factor: float = 1.0) -> torch.Tensor:
    """BoxInst pairwise loss (reference: criterion.py:25-36 pairwise_loss +
    SetCriterionProjPair.loss_*_pairwise :257-323): -log P(same) averaged
    over the edges inside the box whose color similarity reaches the
    threshold. src_masks (N, H, W) logits, color_similarity (N, H, W, K),
    box_masks (N, H, W), valid (N,)."""
    weights = pairwise_weights(color_similarity, box_masks, valid, color_thresh,
                               src_masks.dtype)
    return weighted_pairwise_loss(src_masks, weights, weights.sum().clamp(min=1.0),
                                  num_masks, kernel_size=kernel_size, dilation=dilation,
                                  warmup_factor=warmup_factor)


def pairwise_weights(color_similarity: torch.Tensor, box_masks: torch.Tensor,
                     valid: torch.Tensor, color_thresh: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W, K) 0/1 weights of the pairwise loss's edges: inside the box
    and of colour similarity at least `color_thresh`, on valid rows. They
    depend on no prediction, so a criterion computes them once for every
    layer."""
    return ((color_similarity >= color_thresh).to(dtype)
            * box_masks[..., None] * valid[:, None, None, None])


def weighted_pairwise_loss(src_masks: torch.Tensor, weights: torch.Tensor,
                           weight_sum: torch.Tensor, num_masks, *, kernel_size: int = 3,
                           dilation: int = 2, warmup_factor: float = 1.0) -> torch.Tensor:
    """`pairwise_loss` on `pairwise_weights`, over `weight_sum`: the batch's
    sum of the weights, at least 1 (the global batch's under data
    parallelism, `criterion.label_denominators`)."""
    lsp = log_same_prob(src_masks, kernel_size, dilation)
    loss = (-lsp * weights).sum() / weight_sum
    return loss / num_masks * warmup_factor


def pairwise_cost_matrix(pred_masks: torch.Tensor, color_similarity: torch.Tensor,
                         box_masks: torch.Tensor, *, color_thresh: float = 0.3,
                         kernel_size: int = 3, dilation: int = 2,
                         warmup_factor: float = 1.0) -> torch.Tensor:
    """(Q, G) pairwise-affinity matching cost (reference: matcher.py:50-88
    calculate_similarity_cost with the warmup :296-300): cost[q, g] =
    sum(-lsp_q * w_g) / sum(w_g). pred_masks (Q, H, W) logits,
    color_similarity (G, H, W, K) (per-target copies; an expanded view
    will do), box_masks (G, H, W)."""
    lsp = log_same_prob(pred_masks, kernel_size, dilation)  # (Q, H, W, K)
    w = (color_similarity >= color_thresh).to(lsp.dtype) * box_masks[..., None]
    num = -torch.einsum("qhwk,ghwk->qg", lsp, w)
    den = w.sum(dim=(1, 2, 3)).clamp(min=1.0)[None]
    return num / den * warmup_factor


# ---------------------------------------------------------------------------
# Progressive pseudo-mask update
# ---------------------------------------------------------------------------


def update_box_masks(pred_masks: torch.Tensor, assignment: torch.Tensor,
                     box_masks: torch.Tensor, pix_thr: float) -> torch.Tensor:
    """Progressive target update (reference: criterion.py:625-676
    update_targets): pseudo-mask = (sigmoid(pred) >= pix_thr) AND box mask,
    each image from its own predictions (the JAX package's fix of the
    reference's `.split(B, 0)[0]`). pred_masks (B, Q, H, W) logits of the
    final layer, assignment (B, G), box_masks (B, G, H, W)."""
    B, G = assignment.shape
    src = torch.gather(pred_masks, 1,
                       assignment[:, :, None, None].expand(B, G, *pred_masks.shape[2:]))
    return (torch.sigmoid(src) >= pix_thr).to(box_masks.dtype) * box_masks


def pairwise_warmup_factor(step: int, warmup_iters: int) -> float:
    """min(step / warmup_iters, 1), in f32 as JAX computes it."""
    return float(min(np.float32(step) / np.float32(max(warmup_iters, 1)), np.float32(1.0)))


def mask_update_pix_thr(step: int, max_iter: int, steps: Sequence[float],
                        thrs: Sequence[float]) -> float:
    """The pixel threshold of the training progress step / max_iter: thrs[i]
    from the fraction steps[i] on (reference: criterion.py:704-708), in f32
    as JAX compares them."""
    frac = np.float32(step) / np.float32(max(max_iter, 1))
    thr = np.float32(thrs[0])
    for i in range(1, len(thrs)):
        if frac >= np.float32(steps[i]):
            thr = np.float32(thrs[i])
    return float(thr)
