"""The forward's segments, timed on the card (the JAX package's
tools/profile_forward.py, on the port).

    python -m bm2f_tpu_torch.tools.profile_forward [--batch 4] [--size 800] \\
        [--iters 10] [--device cuda]

`coco_instance_r50` in bf16 (`model.dtype=bfloat16`,
`model.pixel_decoder_f32=False`) with seeded random weights (the
deformable projections perturbed as in `chip_smoke.py`, so that the
sampling leaves the init's grid; the weights cast once for inference, as
the `Predictor` casts them), on --batch images of --size x --size drawn
from `numpy.random.RandomState(0)`. Each segment is timed with CUDA events
over --iters back-to-back calls after a warm-up:
  - the full forward;
  - the backbone alone;
  - the pixel decoder with its 6 encoder layers, and with 0 (a model built
    with `transformer_enc_layers=0`): their difference is the encoder;
  - the deformable core alone at the encoder's shapes (levels 100x100,
    50x50, 25x25 at 800x800; M=8, D=32, L=3, P=4, Q=S) on a bf16 `value`
    and uniform f32 locations and softmaxed attention weights
    (`tools.deform_attn_bench.deform_inputs`), through `ms_deform_attn`:
    K1 on a bf16 `value` (the JAX tool's `impl="im2col"`), ns per sample;
  - `MaskFormerHead` (pixel decoder and transformer decoder);
  - the summary line.
K1's bf16 launches of one full forward and of one 6-layer pixel decoder
are counted and printed (`ms_deform_attn_cuda.launches_bf16`). Only the
port's K1 runs, never its plain version. Runs on the card unless --device
cpu (the plain versions, host clock; --batch and --size cut the shapes
for a smoke run).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

BF16 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False}


def main(argv=None) -> dict:
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models import build_model
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops import ms_deform_attn
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.tools.deform_attn_bench import deform_inputs
    from bm2f_tpu_torch.tools.device import timed_ms, tool_device
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = tool_device("profile_forward", args.device)
    B, H = args.batch, args.size

    def model_with(enc_layers=None):
        over = dict(BF16)
        if enc_layers is not None:
            over["model.pixel_decoder.transformer_enc_layers"] = enc_layers
        cfg = get_config("coco_instance_r50", over)
        model = build_model(cfg, device=dev, seed=0).requires_grad_(False)
        perturb_deformable(model)
        return cfg, model.cast_weights_for_inference_()

    cfg, model = model_with()
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(B, H, H, 3).astype(np.float32) * 255).to(dev)
    ms, launches = {}, {}

    def segment(name, fn, iters=args.iters):
        with torch.no_grad():
            ms[name] = timed_ms(fn, iters, dev=dev)
            before = ms_deform_attn_cuda.launches_bf16
            out = fn()
            launches[name] = ms_deform_attn_cuda.launches_bf16 - before
        return out

    head = model.sem_seg_head
    segment("full", lambda: model(normalize_images(images, cfg.model)))
    print(f"full forward: {ms['full']:.2f} ms  ({B / ms['full'] * 1e3:.2f} img/s), "
          f"K1 bf16 launches {launches['full']}", flush=True)

    x = normalize_images(images, cfg.model).permute(0, 3, 1, 2).contiguous()
    feats = segment("backbone", lambda: model.backbone(x))
    print(f"backbone: {ms['backbone']:.2f} ms", flush=True)

    segment("pixel_decoder", lambda: head.pixel_decoder(feats))
    print(f"pixel decoder (6 enc layers): {ms['pixel_decoder']:.2f} ms, K1 bf16 launches "
          f"{launches['pixel_decoder']}", flush=True)

    _, model0 = model_with(enc_layers=0)
    segment("pixel_decoder_0", lambda: model0.sem_seg_head.pixel_decoder(feats))
    del model0
    enc = ms["pixel_decoder"] - ms["pixel_decoder_0"]
    print(f"pixel decoder (0 enc layers): {ms['pixel_decoder_0']:.2f} ms "
          f"-> encoder cost {enc:.2f} ms ({enc / 6:.2f} ms/layer)", flush=True)

    shapes = tuple((H // s, H // s) for s in (8, 16, 32))
    S = sum(h * w for h, w in shapes)
    value, loc, attn = deform_inputs(B, shapes, S, torch.Generator().manual_seed(0), dev,
                                     loc_range=(0.0, 1.0))
    value = value.to(torch.bfloat16)
    out = segment("ms_deform_attn", lambda: ms_deform_attn(value, shapes, loc, attn))
    ndesc = loc[..., 0].numel()
    print(f"ms_deform_attn op (B={B}, Q={value.shape[1]}, bf16 value): "
          f"{ms['ms_deform_attn']:.4f} ms ({ndesc / 1e6:.2f} M desc, "
          f"{ms['ms_deform_attn'] * 1e6 / ndesc:.4f} ns/desc)", flush=True)

    segment("head", lambda: head(feats))
    dec = ms["head"] - ms["pixel_decoder"]
    print(f"head (pixel decoder + transformer decoder): {ms['head']:.2f} ms "
          f"-> decoder-only ~{dec:.2f} ms", flush=True)

    print("--- summary ---")
    print(f"backbone {ms['backbone']:.2f} + encoder {enc:.2f} + "
          f"pd-rest {ms['pixel_decoder_0']:.2f} + decoder {dec:.2f} "
          f"= {ms['backbone'] + ms['head']:.2f} vs full {ms['full']:.2f} ms", flush=True)
    return {"ms": ms, "launches": launches, "raw_op": (value, shapes, loc, attn, out)}


if __name__ == "__main__":
    main()
