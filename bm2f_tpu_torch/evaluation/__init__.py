from bm2f_tpu_torch.evaluation.coco_eval import COCOMaskAPEvaluator
from bm2f_tpu_torch.evaluation.sem_seg_eval import SemSegEvaluator
from bm2f_tpu_torch.evaluation.panoptic_eval import PanopticEvaluator

__all__ = ["COCOMaskAPEvaluator", "SemSegEvaluator", "PanopticEvaluator"]
