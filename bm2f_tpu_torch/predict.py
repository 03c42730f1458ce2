"""Simple predictor API for the port (the counterpart of the root
`predict.py`): loads a config and weights once; `predict(image)` returns the
semantic, instance and panoptic outputs of one image and a side-by-side
visualization (panoptic | instance | semantic).

    python -m bm2f_tpu_torch.predict --input img.jpg [--output prediction.png] \\
        [--config coco_panoptic_r50] [--weights W] [--device cuda] [--set KEY=VALUE ...]
"""

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
from bm2f_tpu_torch.utils import host_copy, tracing
from bm2f_tpu_torch.utils.precision import f32_scope


class Predictor:
    def setup(self, config: str = "coco_panoptic_r50", weights: str = "",
              device="cuda", seed: int = 0,
              overrides: Optional[Mapping[str, Any]] = None) -> None:
        """No weights: seeded random init. Otherwise `weights` is a path
        that `utils.convert_weights.load_weights` takes: a detectron2
        `.pkl`/`.pth`, a checkpoint directory of the port, or an orbax
        directory of the JAX package. `overrides` set config fields, for example the bench's
        bf16 serving: {"model.dtype": "bfloat16", "model.pixel_decoder_f32":
        False} (the same f32 weights serve either dtype). Once loaded, the
        weights are cast to the dtype each part computes in."""
        self.cfg = get_config(config, overrides)
        self.device = torch.device(device)
        self.model = build_model(self.cfg, device=self.device, seed=seed)
        if weights:
            from bm2f_tpu_torch.utils.convert_weights import load_weights

            self.model.load_state_dict(load_weights(weights, self.cfg), strict=True)
        self.model.cast_weights_for_inference_()

    def predict(self, image: np.ndarray) -> Dict:
        """`infer(image)` and its `"visualization"` (`visualize`)."""
        out = self.infer(image)
        out["visualization"] = self.visualize(image, out)
        return out

    @torch.no_grad()
    def infer(self, image: np.ndarray) -> Dict:
        """image: (H, W, 3) RGB. Pads to `size_divisibility`, runs the
        network, resizes the masks to the padded size and crops, then runs
        the three inference modes on the f32 predictions (in either model
        dtype); the outputs on the host are f32. An f32 model computes in
        f32 (no TF32), whatever the global flags say. The panoptic fusion
        treats every class as a thing, as the root `Predictor` does.

        The image crosses to the device in its own dtype if it is uint8
        (else as f32) and is padded and cast there. On the card every copy
        across the host link goes through pinned memory from PyTorch's
        caching host allocator: the returned arrays are views of pinned host
        tensors, whose blocks go back to the allocator's cache only when the
        caller drops the result, so no result shares memory with a later
        request's.

        Traced (`utils.tracing`) as the root span "serve.request" with the
        children "serve.prepare" (the copy in, padding, normalisation),
        "serve.network", "serve.modes" (the resize and the three modes),
        "serve.to_host" (every copy of the result to the host, waited for
        inside the span; counter "serve.to_host_bytes") and "serve.relabel".
        The counter "serve.pinned_new_blocks" is the number of pinned blocks
        the request allocated rather than took from the cache (0 off the
        card)."""
        with tracing.span("serve.request", self.device):
            # read only while traced, so that the untraced path adds nothing;
            # off the card nothing is pinned
            traced = tracing.enabled()
            pinned = traced and self.device.type == "cuda"
            allocated = torch.cuda.host_memory_stats()["num_host_alloc"] if pinned else 0
            with tracing.span("serve.prepare"):
                image = np.asarray(image)
                if image.dtype != np.uint8:
                    image = image.astype(np.float32, copy=False)
                H, W = image.shape[:2]
                d = self.cfg.model.size_divisibility
                ph, pw = (H + d - 1) // d * d, (W + d - 1) // d * d
                x = torch.zeros((1, ph, pw, 3), dtype=torch.float32, device=self.device)
                x[0, :H, :W] = host_copy.to_device(image, self.device)
                x = normalize_images(x, self.cfg.model)
            K = self.cfg.model.num_classes
            with f32_scope(self.cfg.model.dtype):
                with tracing.span("serve.network"):
                    out = self.model(x)
                with tracing.span("serve.modes"):
                    logits = out["pred_logits"][0]
                    masks = resize_bilinear(out["pred_masks"][0], ph, pw)[:, :H, :W]
                    sem = semantic_inference(logits, masks)
                    inst = instance_inference(logits, masks, num_classes=K, topk=100)
                    pan = panoptic_inference(
                        logits, masks, num_classes=K, thing_mask=tuple([True] * K),
                        object_mask_threshold=self.cfg.model.test.object_mask_threshold,
                        overlap_threshold=self.cfg.model.test.overlap_threshold,
                    )
            with tracing.span("serve.to_host"):
                host, done = host_copy.to_host({"sem": sem, "inst": inst, "pan": pan},
                                               self.device)
                if done is not None:
                    done.synchronize()
                sem = host["sem"].numpy()
                inst = {k: v.numpy() for k, v in host["inst"].items()}
                pan = {k: v.numpy() for k, v in host["pan"].items()}
                tracing.count("serve.to_host_bytes", sem.nbytes + sum(
                    a.nbytes for a in (*inst.values(), *pan.values())))
                if traced:
                    now = torch.cuda.host_memory_stats()["num_host_alloc"] if pinned else 0
                    tracing.count("serve.pinned_new_blocks", now - allocated)
            with tracing.span("serve.relabel"):
                panoptic = relabel_panoptic(pan)
        return {"semantic": sem, "instances": inst, "panoptic": panoptic}

    @staticmethod
    def visualize(image: np.ndarray, out: Dict) -> np.ndarray:
        """(H, 3W, 3) uint8, as root predict.py:88-101 draws it: the panoptic
        map's palette colours over the image, then `demo.draw_instances`,
        then `demo.draw_semantic`, side by side. Host time."""
        from bm2f_tpu_torch.demo import color_palette, draw_instances, draw_semantic

        inst = out["instances"]
        seg_map, _ = out["panoptic"]
        vis_sem = draw_semantic(image, out["semantic"])
        vis_inst = draw_instances(image, inst["masks"], inst["labels"], inst["scores"])
        palette = color_palette(seg_map.max() + 1)
        vis_pan = (0.5 * image + 0.5 * palette[seg_map]).astype(np.uint8)
        return np.concatenate([vis_pan, vis_inst, vis_sem], axis=1)


def main(argv=None) -> str:
    import argparse

    from PIL import Image

    from bm2f_tpu_torch.config import parse_override
    from bm2f_tpu_torch.data.mappers import read_image

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="coco_panoptic_r50")
    ap.add_argument("--weights", default="")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="prediction.png")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE", help="a config field, e.g. model.dtype=bfloat16")
    args = ap.parse_args(argv)
    p = Predictor()
    p.setup(args.config, args.weights, device=args.device, overrides=dict(args.set))
    out = p.predict(read_image(args.input))
    Image.fromarray(out["visualization"]).save(args.output)
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
