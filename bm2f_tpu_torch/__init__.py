"""bm2f_tpu_torch — the PyTorch/CUDA port of bm2f_tpu for NVIDIA Hopper.

Imports torch and numpy only; nothing of JAX or of the `bm2f_tpu` package."""

__version__ = "0.1.0"
