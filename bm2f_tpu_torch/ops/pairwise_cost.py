"""The box matcher's pairwise-affinity sums on the card:
`csrc/pairwise_cost.cu`, a kernel of the port alone (the JAX package leaves
the same function to XLA's einsum).

    S[q, p] = sum_k 1[cs[p, k] >= color_thresh] * lsp(q, p, k)

for logits (Q, H, W) f32 and one image's colour similarity (H, W, K) f32,
with lsp the log-probability that pixel p and its k-th neighbour take the
same label (`losses.weaksup.log_same_prob`). Its plain version, which the
CPU path runs and the card tests compare against, is
`losses.weaksup.log_same_sum`; `losses.weaksup.pairwise_cost_matrix`
chooses between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from bm2f_tpu_torch.ops import cuda_build

SOURCE = "pairwise_cost.cu"
TILE_H, TILE_W = 16, 32  # output pixels a block takes
MAX_RADIUS = 3  # kernel_size 7: 48 edges, one 64-bit mask a pixel
MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def n_edges(kernel_size: int) -> int:
    """K: the neighbours of `neighbor_offsets(kernel_size, dilation)`."""
    return (2 * (kernel_size // 2) + 1) ** 2 - 1


def smem_bytes(kernel_size: int, dilation: int) -> int:
    """Two buffers of (fg, bg) f32 over a tile and its halo."""
    pad = (kernel_size // 2) * dilation
    return 2 * 8 * (TILE_H + 2 * pad) * (TILE_W + 2 * pad)


def _check(logits: torch.Tensor, sim: torch.Tensor, kernel_size: int, dilation: int) -> None:
    """Raises unless logits is a contiguous (Q, H, W) f32 CUDA tensor, sim a
    contiguous (H, W, K) f32 tensor on the same device with K the edges of
    `kernel_size`, and (kernel_size, dilation) a neighbourhood the kernel
    takes."""
    for name, t in (("logits", logits), ("similarity", sim)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not logits.is_cuda:
        raise ValueError(f"logits must lie on a CUDA device, got {logits.device}")
    if sim.device != logits.device:
        raise ValueError(f"similarity must lie on {logits.device}, got {sim.device}")
    r = kernel_size // 2
    if not 1 <= r <= MAX_RADIUS or dilation < 1:
        raise ValueError(f"kernel_size {kernel_size} and dilation {dilation}: the kernel "
                         f"takes kernel_size // 2 in 1..{MAX_RADIUS} and dilation >= 1")
    if smem_bytes(kernel_size, dilation) > MAX_SMEM:
        raise ValueError(f"dilation {dilation} at kernel_size {kernel_size}: the halo "
                         f"needs more than {MAX_SMEM} bytes of shared memory")
    if logits.dim() != 3:
        raise ValueError(f"logits must be (Q, H, W), got {tuple(logits.shape)}")
    want = (*logits.shape[1:], n_edges(kernel_size))
    if tuple(sim.shape) != want:
        raise ValueError(f"similarity must be {want}, got {tuple(sim.shape)}")


def log_same_sum_cuda(logits: torch.Tensor, sim: torch.Tensor, color_thresh: float,
                      kernel_size: int, dilation: int) -> torch.Tensor:
    """S (Q, H*W) f32 by the kernel, on the current stream. Raises as
    `_check` says, and when the build or the launch fails."""
    _check(logits, sim, kernel_size, dilation)
    Q, H, W = logits.shape
    out = torch.empty((Q, H * W), device=logits.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = cuda_build.load(SOURCE).pairwise_lsp_sum
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(logits.data_ptr(), sim.data_ptr(), out.data_ptr(), Q, H, W, kernel_size,
            dilation, color_thresh, torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_lsp_sum launch failed: CUDA error {rc}")
    log_same_sum_cuda.launches += 1
    return out


log_same_sum_cuda.launches = 0
