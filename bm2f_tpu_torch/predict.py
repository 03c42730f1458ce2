"""Simple predictor API for the port (the counterpart of the root
`predict.py`): loads a config and weights once; `predict(image)` returns the
semantic, instance and panoptic outputs of one image."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.evaluation.panoptic_post import relabel_panoptic
from bm2f_tpu_torch.models.maskformer import (
    build_model,
    instance_inference,
    normalize_images,
    panoptic_inference,
    semantic_inference,
)
from bm2f_tpu_torch.ops import resize_bilinear
from bm2f_tpu_torch.utils.precision import f32_scope


class Predictor:
    def setup(self, config: str = "coco_instance_r50", weights: str = "",
              device="cuda", seed: int = 0,
              overrides: Optional[Mapping[str, Any]] = None) -> None:
        """No weights: seeded random init. `.pkl`/`.pth`: a detectron2
        checkpoint. `overrides` set config fields, for example the bench's
        bf16 serving: {"model.dtype": "bfloat16", "model.pixel_decoder_f32":
        False} (the same f32 weights serve either dtype). Once loaded, the
        weights are cast to the dtype each part computes in."""
        self.cfg = get_config(config, overrides)
        self.device = torch.device(device)
        self.model = build_model(self.cfg, device=self.device, seed=seed)
        if weights.endswith((".pkl", ".pth")):
            from bm2f_tpu_torch.utils.convert_weights import load_d2_state_dict

            self.model.load_state_dict(load_d2_state_dict(weights), strict=True)
        elif weights:
            raise NotImplementedError(
                f"{weights!r}: loading JAX (orbax) checkpoints is ROADMAP "
                "queue 1 item 9")
        self.model.cast_weights_for_inference_()

    @torch.no_grad()
    def predict(self, image: np.ndarray) -> Dict:
        """image: (H, W, 3) RGB. Pads to `size_divisibility`, runs the
        network, resizes the masks to the padded size and crops, then runs
        the three inference modes on the f32 predictions (in either model
        dtype); the outputs on the host are f32. An f32 model computes in
        f32 (no TF32), whatever the global flags say."""
        H, W = image.shape[:2]
        d = self.cfg.model.size_divisibility
        ph, pw = (H + d - 1) // d * d, (W + d - 1) // d * d
        x = torch.zeros((1, ph, pw, 3), dtype=torch.float32)
        x[0, :H, :W] = torch.from_numpy(np.asarray(image, np.float32))
        x = normalize_images(x.to(self.device), self.cfg.model)
        K = self.cfg.model.num_classes
        with f32_scope(self.cfg.model.dtype):
            out = self.model(x)
            logits = out["pred_logits"][0]
            masks = resize_bilinear(out["pred_masks"][0], ph, pw)[:, :H, :W]
            sem = semantic_inference(logits, masks)
            inst = instance_inference(logits, masks, num_classes=K, topk=100)
            pan = panoptic_inference(
                logits, masks, num_classes=K, thing_mask=tuple([True] * K),
                object_mask_threshold=self.cfg.model.test.object_mask_threshold,
                overlap_threshold=self.cfg.model.test.overlap_threshold,
            )
        seg_map, seg_info = relabel_panoptic(
            {k: v.cpu().numpy() for k, v in pan.items()})
        return {
            "semantic": sem.cpu().numpy(),
            "instances": {k: v.cpu().numpy() for k, v in inst.items()},
            "panoptic": (seg_map, seg_info),
        }
