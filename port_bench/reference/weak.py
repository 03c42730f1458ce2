"""Box-supervised Mask2Former (BM2F: wenhe-jia/BM2F, after BoxInst, Tian et
al. CVPR 2021) in plain PyTorch: the "mask_projection_and_pairwise"
criterion and its matcher.

Targets, at the predicted masks' stride s = 4, sampled at pixel s // 2 of
every s x s cell:
- the box mask of each instance (its mask's bounding box);
- each sampled row's leftmost and rightmost mask pixel, and each sampled
  column's top and bottom one, over s (an empty row's right and bottom
  bounds are 0);
- the colour similarity of each pixel with its 8 neighbours at dilation
  2: exp(-|LAB difference| / 2), LAB after skimage's rgb2lab (D65), zero
  outside the image.

Matcher, per image and layer: 2 x (-p(class)) + 5 x the projection dice
(the mask's row and column maxima of sigmoid against the box's, each
counted only where the maximum's position falls inside the box's bounds;
dice with eps 1e-3 and squared terms) + 5 x the pairwise cost (the mean,
over the box's edges of colour similarity >= 0.3, of -log P(same label),
times the warm-up factor); padding targets are not matched.

Losses: the class CE as the mask criterion's; the projection loss of each
matched mask against its box, summed / the number of targets; the pairwise
loss summed over matched masks and edges, over the batch's count of such
edges (at least 1), / the number of targets, times the warm-up factor.
With the pseudo-mask update on, the box masks are first intersected with
the final layer's assigned mask where sigmoid >= the schedule's threshold.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from port_bench.reference.criterion import LossWeights, class_loss, layers_of, solve

RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
              (0.212671, 0.715160, 0.072169),
              (0.019334, 0.119193, 0.950227))
WHITE = (0.95047, 1.0, 1.08883)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> CIELAB (skimage.color.rgb2lab, D65)."""
    rgb = rgb.clamp(0, 1)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = lin @ torch.tensor(RGB_TO_XYZ, device=rgb.device).t()
    xyz = xyz / torch.tensor(WHITE, device=rgb.device)
    f = torch.where(xyz > 0.008856, xyz.clamp(min=0) ** (1 / 3), 7.787 * xyz + 16 / 116)
    return torch.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                        200 * (f[..., 1] - f[..., 2])], -1)


def neighbours(x: torch.Tensor, k: int = 3, d: int = 2) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 8, H, W): the k x k neighbours at dilation d
    but the centre, zero outside (BoxInst's unfold_wo_center)."""
    N, C, H, W = x.shape
    u = F.unfold(x, k, dilation=d, padding=(k // 2) * d).view(N, C, k * k, H, W)
    c = k * k // 2
    return torch.cat([u[:, :, :c], u[:, :, c + 1:]], 2)


def color_similarity(images: torch.Tensor, s: int = 4) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 255] -> (B, 8, H/s, W/s)."""
    lab = rgb2lab(images[:, s // 2::s, s // 2::s].float() / 255).permute(0, 3, 1, 2)
    diff = lab[:, :, None] - neighbours(lab)
    return torch.exp(-diff.norm(dim=1) * 0.5)


def box_targets(masks: torch.Tensor, s: int = 4) -> Dict[str, torch.Tensor]:
    """masks (N, H, W) -> box (N, h, w), left/right (N, h), top/bottom (N, w)."""
    N, H, W = masks.shape
    m = masks > 0.5
    rows, cols = m[:, s // 2::s, :], m[:, :, s // 2::s]
    xs = torch.arange(W, device=masks.device)
    ys = torch.arange(H, device=masks.device)
    big = torch.tensor(10 ** 9, device=masks.device)
    left = torch.where(rows, xs, big).amin(2)
    right = torch.where(rows, xs + 1, 0).amax(2)
    top = torch.where(cols, ys[:, None], big).amin(1)
    bottom = torch.where(cols, ys[:, None] + 1, 0).amax(1)
    left = torch.where(rows.any(2), left, 0)
    top = torch.where(cols.any(1), top, 0)
    any_y, any_x = m.any(2), m.any(1)
    y0 = torch.where(any_y, ys, big).amin(1)
    y1 = torch.where(any_y, ys, -1).amax(1)
    x0 = torch.where(any_x, xs, big).amin(1)
    x1 = torch.where(any_x, xs, -1).amax(1)
    yy = ys[s // 2::s][None, :, None]
    xx = xs[s // 2::s][None, None, :]
    box = ((yy >= y0[:, None, None]) & (yy <= y1[:, None, None])
           & (xx >= x0[:, None, None]) & (xx <= x1[:, None, None])).float()
    return {"box": box, "left": left.float() / s, "right": right.float() / s,
            "top": top.float() / s, "bottom": bottom.float() / s}


def projection_dice(logits: torch.Tensor, t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """logits (Q, h, w) against targets of G boxes -> (Q, G) dice_x + dice_y."""
    ry, ax = logits.max(2)  # row maxima and their columns (Q, h)
    rx, ay = logits.max(1)  # column maxima and their rows (Q, w)
    fy = (ax[:, None] >= t["left"][None]) & (ax[:, None] < t["right"][None])
    fx = (ay[:, None] >= t["top"][None]) & (ay[:, None] < t["bottom"][None])
    ty = t["box"].amax(2)[None] * fy
    tx = t["box"].amax(1)[None] * fx

    def dice(x, tt):
        p = x.sigmoid()[:, None]
        return 1 - 2 * (p * tt).sum(-1) / ((p ** 2).sum(-1) + (tt ** 2).sum(-1) + 1e-3)

    return dice(rx, tx) + dice(ry, ty)


def neg_log_same(logits: torch.Tensor) -> torch.Tensor:
    """(N, h, w) -> (N, 8, h, w): -log P(pixel and neighbour share a label)."""
    fg = F.logsigmoid(logits)[:, None]
    bg = F.logsigmoid(-logits)[:, None]
    same_fg = fg[:, :, None] + neighbours(fg)
    same_bg = bg[:, :, None] + neighbours(bg)
    return -torch.logaddexp(same_fg, same_bg)[:, 0]


def weak_criterion(outputs, images: torch.Tensor, targets: Mapping[str, torch.Tensor],
                   w: LossWeights, *, projection_weight: float = 5.0,
                   pairwise_weight: float = 5.0, color_thresh: float = 0.3,
                   warmup_factor: float = 1.0, pix_thr=None):
    """images (B, H, W, 3) RGB; targets: labels (B, G), masks (B, G, H, W)
    (boxes are taken from them), valid (B, G). Returns (total, losses)."""
    layers = layers_of(outputs)
    B = targets["labels"].shape[0]
    rows = [targets["valid"][b].nonzero()[:, 0] for b in range(B)]
    num_masks = max(float(sum(len(r) for r in rows)), 1.0)
    sim = color_similarity(images)  # (B, 8, h, w)
    tg = [box_targets(targets["masks"][b, rows[b]].float()) for b in range(B)]
    labels = [targets["labels"][b, rows[b]].long() for b in range(B)]
    edges = [(sim[b][None] >= color_thresh).float() * tg[b]["box"][:, None] for b in range(B)]

    assigned = []
    with torch.no_grad():
        for logits, masks in layers:
            per = []
            for b in range(B):
                m = masks[b].float()
                cost = (w.class_weight * -logits[b].float().softmax(-1)[:, labels[b]]
                        + projection_weight * projection_dice(m, tg[b]))
                if pairwise_weight > 0:
                    nls = neg_log_same(m)  # (Q, 8, h, w)
                    e = edges[b]
                    pair = torch.einsum("qkhw,gkhw->qg", nls, e) / e.sum((1, 2, 3)).clamp(min=1)
                    cost = cost + pairwise_weight * warmup_factor * pair
                per.append(torch.as_tensor(solve(cost), device=masks.device))
            assigned.append(per)
    if pix_thr is not None:
        final = outputs["pred_masks"].detach().float()
        for b in range(B):
            upd = (final[b, assigned[-1][b]].sigmoid() >= pix_thr).float()
            tg[b] = dict(tg[b], box=tg[b]["box"] * upd)
            edges[b] = (sim[b][None] >= color_thresh).float() * tg[b]["box"][:, None]
    edge_sum = max(float(sum(e.sum() for e in edges)), 1.0)

    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for i, (logits, masks) in enumerate(layers):
        matched = [(b, int(q), int(lab)) for b in range(B)
                   for q, lab in zip(assigned[i][b].tolist(), labels[b].tolist())]
        ce = class_loss(logits, matched, w)
        proj, pair = 0.0, 0.0
        for b in range(B):
            src = masks[b, assigned[i][b]].float()
            proj = proj + projection_dice(src, tg[b]).diagonal().sum()
            pair = pair + (neg_log_same(src) * edges[b]).sum()
        proj = proj / num_masks
        pair = pair / edge_sum / num_masks * warmup_factor
        sfx = "" if i == len(layers) - 1 else f"_{i}"
        losses[f"loss_ce{sfx}"] = ce
        losses[f"loss_mask_projection{sfx}"] = proj
        losses[f"loss_pairwise{sfx}"] = pair
        total = (total + w.class_weight * ce + projection_weight * proj
                 + pairwise_weight * pair)
    return total, losses
