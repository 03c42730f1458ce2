from bm2f_tpu_torch.models.maskformer import MaskFormer, build_model

__all__ = ["MaskFormer", "build_model"]
