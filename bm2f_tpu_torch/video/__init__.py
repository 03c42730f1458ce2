from bm2f_tpu_torch.video.video_maskformer import VideoMaskFormer, build_video_model

__all__ = ["VideoMaskFormer", "build_video_model"]
