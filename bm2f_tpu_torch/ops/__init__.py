from bm2f_tpu_torch.ops.deform_attn import level_start_index, ms_deform_attn
from bm2f_tpu_torch.ops.interpolate import (
    resize_bilinear,
    resize_bilinear_dynamic,
    resize_nearest,
)

__all__ = ["level_start_index", "ms_deform_attn", "resize_bilinear",
           "resize_bilinear_dynamic", "resize_nearest"]
