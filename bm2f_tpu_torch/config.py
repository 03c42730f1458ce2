"""Typed configuration tree for bm2f_tpu_torch (the same tree as the JAX
package's, kept as a copy so that the port imports nothing of it).

Mirrors the knobs of the reference yacs config (reference:
mask2former/config.py:6-166 `add_maskformer2_config`,
mask2former_video/config.py:6-12 `add_maskformer2_video_config`) as frozen
dataclasses. Unlike the reference's mutable CfgNode, configs here are
immutable and hashable so they can be closed over by jitted functions as
static values.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


@dataclass(frozen=True)
class SwinConfig:
    """Swin backbone knobs (reference: mask2former/config.py:74-90)."""

    pretrain_img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.3
    ape: bool = False
    patch_norm: bool = True
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    use_checkpoint: bool = False


@dataclass(frozen=True)
class ResNetConfig:
    """ResNet backbone knobs (reference uses detectron2 builtin R50/R101)."""

    depth: int = 50
    norm: str = "frozen_bn"  # detectron2 default for COCO models
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    stem_type: str = "basic"


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "resnet"  # "resnet" | "swin"
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    swin: SwinConfig = field(default_factory=SwinConfig)


@dataclass(frozen=True)
class PixelDecoderConfig:
    """MSDeformAttn pixel decoder (reference: msdeformattn.py:165-358) or FPN
    (fpn.py:38-204)."""

    name: str = "msdeform"  # "msdeform" | "fpn" | "transformer_fpn"
    conv_dim: int = 256
    mask_dim: int = 256
    norm: str = "group_norm"  # GN32 in the reference
    # deformable encoder
    transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    transformer_enc_layers: int = 6
    transformer_nheads: int = 8
    transformer_dim_feedforward: int = 1024  # reference msdeformattn.py:204
    transformer_n_points: int = 4
    common_stride: int = 4
    dropout: float = 0.0
    # chunk the deformable-sampling gather over queries (1 = off): divides
    # the layer's dominant transient (the gathered-rows tensor) for training
    # memory headroom at large resolutions
    deform_q_chunks: int = 1
    # query-tile size of the JAX package's Pallas kernel; kept so that the
    # two packages share one configuration tree. The port does not read it.
    deform_q_tile: int = 1024
    # deformable-sampling implementation of the JAX package ("auto" |
    # "pallas" | "im2col" | "patch" | "xla"); the port dispatches on the
    # tensor's device instead and does not read it.
    deform_impl: str = "auto"
    # rematerialize encoder layers in backward — the deformable sampling's
    # gathered-row intermediates are ~2 GB/layer at 1024^2 and must not be
    # saved as residuals (jax.checkpoint; analogue of the reference's
    # activation-checkpointing memory strategy, SURVEY §2.5)
    remat: bool = True


@dataclass(frozen=True)
class DecoderConfig:
    """Masked transformer decoder (reference:
    mask2former_transformer_decoder.py:207-465)."""

    name: str = "multi_scale_masked"  # | "standard"
    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9  # reference passes DEC_LAYERS-1=9 conv blocks for 10 rounds of heads
    pre_norm: bool = False
    mask_dim: int = 256
    enforce_input_project: bool = False
    num_feature_levels: int = 3
    dropout: float = 0.0


@dataclass(frozen=True)
class TestConfig:
    """Inference-path switches (reference: config.py:54-60)."""

    semantic_on: bool = True
    instance_on: bool = False
    panoptic_on: bool = False
    object_mask_threshold: float = 0.0
    overlap_threshold: float = 0.0
    sem_seg_postprocessing_before_inference: bool = False
    # video inference
    topk_per_video: int = 10


@dataclass(frozen=True)
class PairwiseConfig:
    """Weak-supervision pairwise-loss knobs (reference: config.py:126-136)."""

    size: int = 3
    dilation: int = 2
    color_thresh: float = 0.3
    warmup_iters: int = 10000
    point_sample: bool = False
    train_num_points: int = 112 * 112
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    topk: int = 1  # temporal-pairwise DINO patch match topk


@dataclass(frozen=True)
class WeakSupervisionConfig:
    """Box-supervised training (reference: config.py:119-136)."""

    bbox_weight: float = 5.0
    giou_weight: float = 2.0
    projection_weight: float = 5.0
    pairwise_weight: float = 5.0
    temporal_pairwise_weight: float = 5.0
    pairwise: PairwiseConfig = field(default_factory=PairwiseConfig)
    # progressive pseudo-mask update (referenced by the model but commented out
    # of the reference config — a latent defect we implement properly;
    # reference: maskformer_model.py:190-195, criterion.py:625-676)
    mask_update_enabled: bool = False
    mask_update_steps: Tuple[float, ...] = (0.0, 0.5, 1.0)
    mask_update_pix_thrs: Tuple[float, ...] = (0.0, 0.5)


@dataclass(frozen=True)
class LossConfig:
    """Matching + criterion weights (reference: config.py:33-37, 108-114)."""

    deep_supervision: bool = True
    no_object_weight: float = 0.1
    class_weight: float = 2.0  # maskformer2 default (Base-COCO yaml)
    dice_weight: float = 5.0
    mask_weight: float = 5.0
    train_num_points: int = 112 * 112
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # "mask" | "mask_projection" | "mask_projection_and_pairwise" (image)
    # video adds "..._and_spatial_pairwise[_and_temporal_pairwise]"
    sup_type: str = "mask"
    weak: WeakSupervisionConfig = field(default_factory=WeakSupervisionConfig)


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    num_classes: int = 80
    size_divisibility: int = 32
    # detectron2 BGR pixel stats (Base-COCO yaml); images arrive RGB and we
    # convert in the input pipeline.
    pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    test: TestConfig = field(default_factory=TestConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    # numerics: "bfloat16" compute with float32 params, or "float32".
    dtype: str = "float32"
    # keep the deformable pixel-decoder encoder in f32 even under bf16
    # (reference: msdeformattn.py:314 @autocast(enabled=False)).
    pixel_decoder_f32: bool = True
    # video
    num_frames: int = 2


@dataclass(frozen=True)
class OptimizerConfig:
    """Reference: train_net.py:184-263 build_optimizer."""

    name: str = "adamw"
    base_lr: float = 1e-4
    weight_decay: float = 0.05
    weight_decay_norm: float = 0.0
    weight_decay_embed: float = 0.0
    backbone_multiplier: float = 0.1
    clip_gradients: float = 0.01  # full-model L2 clip value
    betas: Tuple[float, float] = (0.9, 0.999)
    # schedule: "multistep" (WarmupMultiStepLR, COCO/YTVIS configs) or
    # "poly" (WarmupPolyLR, all ADE20K/Cityscapes/Mapillary configs —
    # Base-ADE20K-SemanticSegmentation.yaml:27)
    lr_schedule: str = "multistep"
    max_iter: int = 368750
    warmup_iters: int = 10
    warmup_factor: float = 1.0
    steps: Tuple[int, ...] = (327778, 355092)
    gamma: float = 0.1
    poly_power: float = 0.9
    poly_constant_ending: float = 0.0


@dataclass(frozen=True)
class InputConfig:
    """Static-shape input pipeline (reference: LSJ config.py:97-99 and
    dataset mappers)."""

    image_size: int = 1024  # LSJ / crop size (crop height for semantic)
    min_scale: float = 0.1
    max_scale: float = 2.0
    dataset_mapper: str = "coco_instance_lsj"
    color_aug_ssd: bool = False
    size_divisibility: int = 32
    max_instances: int = 100  # static G_max padding for targets
    # non-LSJ mappers (mask_former_semantic/panoptic/instance):
    # ResizeShortestEdge choices (reference MIN_SIZE_TRAIN, e.g.
    # Base-ADE20K yaml:37 [int(x*0.1*512) for x in range(5,21)]);
    # () = single choice of image_size
    short_edge_choices: Tuple[int, ...] = ()
    max_size_train: int = 2048
    # test-time resize protocol (reference MIN_SIZE_TEST/MAX_SIZE_TEST, e.g.
    # Base-ADE20K-SemanticSegmentation.yaml:39-41 512/2048, Cityscapes
    # 1024/2048, Mapillary 2048/2048; COCO = d2 defaults 800/1333). eval.py
    # derives its static padding-bucket ladder from max_size_test
    min_size_test: int = 800
    max_size_test: int = 1333
    # crop width when != crop height (Cityscapes semantic crops (512, 1024),
    # Base-Cityscapes-SemanticSegmentation.yaml); 0 = square image_size
    crop_width: int = 0
    # video
    sampling_frame_num: int = 2
    sampling_frame_range: int = 20
    sampling_frame_shuffle: bool = False


@dataclass(frozen=True)
class TrainConfig:
    ims_per_batch: int = 16
    # Hungarian assignment implementation (matching/hungarian.py
    # `make_assign_fn`): "lap" is the exact host solve (the native C++ JV
    # solver, one copy of all costs a step), "jv" the EXACT batched
    # Jonker-Volgenant solver on the costs' device. "auto" is "lap" on every
    # device: the JAX package picks "jv" on accelerators only because its
    # TPU runtime had no host callbacks, and PyTorch always has them; both
    # solvers are exact.
    # "auction" is EXPERIMENTAL: the epsilon-scaling auction shows measurable
    # suboptimality on production matcher costs (the ~Q-G identical padding
    # columns trigger bidding wars; see hungarian.auction_assign docstring).
    # It exists as a bounded-round approximate fallback only — "jv" is exact,
    # on-device, and costs nothing measurable in the train step.
    matcher: str = "auto"  # "auto" | "lap" | "jv" | "auction" (experimental)
    auction_iters: int = 300  # bidding rounds per epsilon-scaling phase
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    checkpoint_period: int = 5000
    log_period: int = 20
    eval_period: int = 5000
    seed: int = 0
    output_dir: str = "./output"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit. The reference is DP-only over NCCL
    (SURVEY §2.5); we default to pure DP over ICI but keep a model axis for
    optional backbone sharding."""

    data: int = -1  # -1 = all devices
    model: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    task: str = "instance"  # "semantic" | "instance" | "panoptic" | "video"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _replace_nested(obj, path: str, value):
    """Return a copy of nested frozen dataclasses with `path` (dot-separated)
    replaced by `value`."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(obj, **{head: _freeze(value)})
    child = getattr(obj, head)
    return dataclasses.replace(obj, **{head: _replace_nested(child, rest, value)})


def update(cfg: Config, overrides: Mapping[str, Any]) -> Config:
    """Apply {"model.decoder.num_queries": 200, ...} style overrides."""
    for k, v in overrides.items():
        cfg = _replace_nested(cfg, k, v)
    return cfg


def parse_override(text: str) -> Tuple[str, Any]:
    """A command line's "KEY=VALUE" as (key, value): the value as a Python
    literal where it parses as one, else the string."""
    key, _, value = text.partition("=")
    try:
        return key, ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return key, value


# ---------------------------------------------------------------------------
# Named presets mirroring the reference's key yaml configs.
# ---------------------------------------------------------------------------


# Backbone variants (reference: configs/*/swin/*.yaml deltas; the two IN21k
# flavours share the architecture with their IN1k counterparts — they differ
# only in pretrained weights, which live outside the config tree here).
_SWIN = {
    "swin_t": {
        "model.backbone.swin.embed_dim": 96,
        "model.backbone.swin.depths": (2, 2, 6, 2),
        "model.backbone.swin.num_heads": (3, 6, 12, 24),
        "model.backbone.swin.window_size": 7,
        "model.backbone.swin.pretrain_img_size": 224,
    },
    "swin_s": {
        "model.backbone.swin.embed_dim": 96,
        "model.backbone.swin.depths": (2, 2, 18, 2),
        "model.backbone.swin.num_heads": (3, 6, 12, 24),
        "model.backbone.swin.window_size": 7,
        "model.backbone.swin.pretrain_img_size": 224,
    },
    "swin_b": {
        "model.backbone.swin.embed_dim": 128,
        "model.backbone.swin.depths": (2, 2, 18, 2),
        "model.backbone.swin.num_heads": (4, 8, 16, 32),
        "model.backbone.swin.window_size": 12,
        "model.backbone.swin.pretrain_img_size": 384,
    },
    "swin_l": {
        "model.backbone.swin.embed_dim": 192,
        "model.backbone.swin.depths": (2, 2, 18, 2),
        "model.backbone.swin.num_heads": (6, 12, 24, 48),
        "model.backbone.swin.window_size": 12,
        "model.backbone.swin.pretrain_img_size": 384,
    },
}


def _with_backbone(cfg: Config, backbone: str, swin_l_queries: int = 200) -> Config:
    """Apply a backbone variant name: r50 | r101 | swin_{t,s,b,l}."""
    if backbone == "r50":
        return cfg
    if backbone == "r101":
        return update(cfg, {"model.backbone.resnet.depth": 101})
    over = dict(_SWIN[backbone])
    over["model.backbone.name"] = "swin"
    if backbone == "swin_l":
        over["model.decoder.num_queries"] = swin_l_queries
    return update(cfg, over)


def _se_choices(base: int) -> Tuple[int, ...]:
    """MIN_SIZE_TRAIN 'choice' ladder: [int(x*0.1*base) for x in 5..20]
    (e.g. Base-ADE20K-SemanticSegmentation.yaml:37)."""
    return tuple(int(x * 0.1 * base) for x in range(5, 21))


def _poly(cfg: Config, max_iter: int) -> Config:
    """WarmupPolyLR solver block shared by all ADE20K / Cityscapes /
    Mapillary configs (WARMUP_ITERS 0, POLY_LR_POWER 0.9)."""
    return update(cfg, {
        "train.optimizer.lr_schedule": "poly",
        "train.optimizer.max_iter": max_iter,
        "train.optimizer.warmup_iters": 0,
        "train.optimizer.steps": (),
    })


def _test_flags(task: str) -> dict:
    if task == "semantic":
        return {"model.test.semantic_on": True, "model.test.instance_on": False,
                "model.test.panoptic_on": False}
    if task == "instance":
        return {"model.test.semantic_on": False, "model.test.instance_on": True,
                "model.test.panoptic_on": False,
                "model.test.object_mask_threshold": 0.8}
    return {"model.test.semantic_on": True, "model.test.instance_on": True,
            "model.test.panoptic_on": True,
            "model.test.object_mask_threshold": 0.8,
            "model.test.overlap_threshold": 0.8}


def coco_base(task: str) -> Config:
    """configs/coco/{instance,panoptic}-segmentation/Base-*.yaml: LSJ 1024,
    AdamW multistep 368750 (50 epochs at bs16)."""
    over = {
        "task": task,
        "model.num_classes": 80 if task == "instance" else 133,
        "input.image_size": 1024,
        "input.dataset_mapper":
            "coco_instance_lsj" if task == "instance" else "coco_panoptic_lsj",
        "train.optimizer.max_iter": 368750,
        "train.optimizer.steps": (327778, 355092),
    }
    over.update(_test_flags(task))
    return update(Config(), over)


def ade20k_base(task: str) -> Config:
    """configs/ade20k/*/Base-*.yaml: poly 160k; semantic trains at 512,
    instance/panoptic at 640 (Base-ADE20K-*Segmentation.yaml)."""
    size = 512 if task == "semantic" else 640
    over = {
        "task": task,
        "model.num_classes": {"semantic": 150, "instance": 100,
                              "panoptic": 150}[task],
        "input.image_size": size,
        "input.short_edge_choices": _se_choices(size),
        "input.max_size_train": 2048 if task == "semantic" else 2560,
        "input.min_size_test": size,
        "input.max_size_test": 2048 if task == "semantic" else 2560,
        "input.color_aug_ssd": True,
        "input.dataset_mapper": f"mask_former_{task}",
    }
    over.update(_test_flags(task))
    return _poly(update(Config(), over), 160000)


def cityscapes_base(task: str) -> Config:
    """configs/cityscapes/*/Base-*.yaml: poly 90k, shortest-edge ladder off
    1024, rectangular 512x1024 crops."""
    over = {
        "task": task,
        "model.num_classes": {"semantic": 19, "instance": 8,
                              "panoptic": 19}[task],
        "input.image_size": 512,
        "input.crop_width": 1024,
        "input.short_edge_choices": _se_choices(1024),
        "input.max_size_train": 4096,
        "input.min_size_test": 1024,
        "input.max_size_test": 2048,
        "input.color_aug_ssd": True,
        "input.dataset_mapper": f"mask_former_{task}",
    }
    over.update(_test_flags(task))
    return _poly(update(Config(), over), 90000)


def mapillary_base(task: str) -> Config:
    """configs/mapillary-vistas/*/Base-*.yaml: poly 300k, ladder off 2048,
    1024^2 crops, 65 classes."""
    over = {
        "task": task,
        "model.num_classes": 65,
        "input.image_size": 1024,
        "input.short_edge_choices": _se_choices(2048),
        "input.max_size_train": 8192,
        "input.min_size_test": 2048,
        "input.max_size_test": 2048,
        "input.color_aug_ssd": True,
        "input.dataset_mapper": f"mask_former_{task}",
    }
    over.update(_test_flags(task))
    return _poly(update(Config(), over), 300000)


def ytvis_base(year: int) -> Config:
    """configs/youtubevis_{2019,2021}/Base-*.yaml (2021_mini shares 2021's
    schedule)."""
    return update(Config(), {
        "task": "video",
        "model.num_classes": 40,
        "model.test.instance_on": True,
        "model.test.semantic_on": False,
        "model.num_frames": 2,
        "input.image_size": 512,
        "input.short_edge_choices": (360, 480),
        "input.min_size_test": 360,  # Base-YouTubeVIS yaml:42
        "input.max_size_test": 1333,  # d2 default (yaml leaves it unset)
        "input.dataset_mapper": "ytvis",
        "train.optimizer.max_iter": 6000 if year == 2019 else 8000,
        "train.optimizer.steps": (4000,) if year == 2019 else (5500,),
    })


def _weak(cfg: Config, sup_type: str, *, batch: int, lr: float,
          max_iter: int, steps: Tuple[int, ...],
          pairwise_weight: float = None,
          temporal_pairwise_weight: float = None) -> Config:
    """BM2F weak-supervision variant solver block (e.g.
    youtubevis_2021/video_maskformer2_R50_bs16_8k_proj*.yaml)."""
    over = {
        "model.loss.sup_type": sup_type,
        "train.ims_per_batch": batch,
        "train.optimizer.base_lr": lr,
        "train.optimizer.max_iter": max_iter,
        "train.optimizer.steps": steps,
    }
    if pairwise_weight is not None:
        over["model.loss.weak.pairwise_weight"] = pairwise_weight
    if temporal_pairwise_weight is not None:
        over["model.loss.weak.temporal_pairwise_weight"] = temporal_pairwise_weight
    return update(cfg, over)


def _build_presets():
    """The reference's full configs/ tree as named presets (one per yaml;
    the *_IN21k_* weight-only twins fold into their architecture preset)."""
    p = {}

    # --- COCO instance + panoptic (LSJ, multistep) ---
    for task in ("instance", "panoptic"):
        for bb in ("r50", "r101", "swin_t", "swin_s", "swin_b", "swin_l"):
            def mk(task=task, bb=bb):
                cfg = _with_backbone(coco_base(task), bb)
                if bb == "swin_l":  # 100-epoch schedule (swin yaml)
                    cfg = update(cfg, {
                        "train.optimizer.max_iter": 737500,
                        "train.optimizer.steps": (655556, 710184),
                    })
                return cfg
            p[f"coco_{task}_{bb}"] = mk
    # weak supervision on LSJ COCO (maskformer2_R50_bs16_50ep_proj.yaml)
    p["coco_instance_r50_proj"] = lambda: update(
        coco_base("instance"), {"model.loss.sup_type": "mask_projection"})

    # --- COCO without LSJ (BM2F weak-sup family, configs/coco_wo_lsj;
    # shortest-edge (512..864) max 1400 mapper; solver bs8/5e-5/180k.
    # Static-shape deviation: resized images are cropped/padded to a fixed
    # 864x1408 canvas (the reference pads per-batch dynamically). ---
    def coco_wo_lsj(sup="mask"):
        cfg = update(coco_base("instance"), {
            "input.dataset_mapper": "mask_former_instance",
            "input.image_size": 864,
            "input.crop_width": 1408,
            "input.short_edge_choices": (512, 640, 704, 768, 800, 864),
            "input.max_size_train": 1400,
        })
        if sup != "mask":
            cfg = _weak(cfg, sup, batch=8, lr=5e-5, max_iter=180000,
                        steps=(120000, 160000))
        return cfg

    p["coco_instance_r50_wo_lsj"] = lambda: coco_wo_lsj()
    p["coco_instance_r50_wo_lsj_proj"] = lambda: coco_wo_lsj("mask_projection")
    p["coco_instance_r50_wo_lsj_projpair"] = (
        lambda: coco_wo_lsj("mask_projection_and_pairwise"))

    # --- ADE20K ---
    for bb in ("r50", "r101", "swin_t", "swin_s", "swin_b", "swin_l"):
        def mk_sem(bb=bb):
            cfg = _with_backbone(ade20k_base("semantic"), bb,
                                 swin_l_queries=100)
            if bb in ("swin_b", "swin_l"):  # res640 swin semantic variants
                cfg = update(cfg, {
                    "input.image_size": 640,
                    "input.short_edge_choices": _se_choices(640),
                    "input.max_size_train": 2560,
                    "input.min_size_test": 640,  # res640 yaml:20-22
                    "input.max_size_test": 2560,
                })
            return cfg
        p[f"ade20k_semantic_{bb}"] = mk_sem
    for task in ("instance", "panoptic"):
        for bb in ("r50", "swin_l"):
            p[f"ade20k_{task}_{bb}"] = (
                lambda task=task, bb=bb: _with_backbone(ade20k_base(task), bb))

    # --- Cityscapes ---
    for task in ("semantic", "instance", "panoptic"):
        for bb in ("r50", "r101", "swin_t", "swin_s", "swin_b", "swin_l"):
            p[f"cityscapes_{task}_{bb}"] = (
                lambda task=task, bb=bb: _with_backbone(
                    cityscapes_base(task), bb,
                    swin_l_queries=100 if task == "semantic" else 200))

    # --- Mapillary Vistas ---
    for task in ("semantic", "panoptic"):
        for bb in ("r50", "swin_l"):
            p[f"mapillary_{task}_{bb}"] = (
                lambda task=task, bb=bb: _with_backbone(
                    mapillary_base(task), bb,
                    swin_l_queries=100 if task == "semantic" else 200))

    # --- YouTubeVIS ---
    for year in (2019, 2021):
        for bb in ("r50", "r101", "swin_t", "swin_s", "swin_b", "swin_l"):
            def mk_vis(year=year, bb=bb):
                cfg = _with_backbone(ytvis_base(year), bb)
                # swin video configs test at 480 (e.g. youtubevis_2019/swin/
                # video_maskformer2_swin_tiny_bs16_8ep.yaml:17); the 2021
                # swin-L yaml leaves it commented out -> base 360
                if bb.startswith("swin") and not (year == 2021 and bb == "swin_l"):
                    cfg = update(cfg, {"input.min_size_test": 480})
                return cfg
            p[f"ytvis{year}_video_{bb}"] = mk_vis
    # BM2F weak-sup video variants (2021 + 2021_mini share the deltas)
    for mini in ("", "_mini"):
        base_name = f"ytvis2021{mini}_video_r50"
        if mini:
            p[base_name] = lambda: ytvis_base(2021)
        p[f"{base_name}_proj"] = lambda: _weak(
            ytvis_base(2021), "mask_projection",
            batch=8, lr=5e-5, max_iter=16000, steps=(11000,))
        p[f"{base_name}_proj_spatpair"] = lambda: _weak(
            ytvis_base(2021), "mask_projection_and_spatial_pairwise",
            batch=8, lr=5e-5, max_iter=16000, steps=(11000,),
            pairwise_weight=2.0)
        p[f"{base_name}_proj_spatpair_temppair"] = lambda: _weak(
            ytvis_base(2021),
            "mask_projection_and_spatial_pairwise_and_temporal_pairwise",
            batch=4, lr=2.5e-5, max_iter=32000, steps=(22000,),
            pairwise_weight=2.0, temporal_pairwise_weight=2.0)
    p["ytvis2021_mini_video_r50_proj_spatpair_batch4"] = lambda: _weak(
        ytvis_base(2021), "mask_projection_and_spatial_pairwise",
        batch=4, lr=2.5e-5, max_iter=32000, steps=(22000,),
        pairwise_weight=2.0)

    return p


PRESETS = _build_presets()


def get_config(name: str, overrides: Optional[Mapping[str, Any]] = None) -> Config:
    cfg = PRESETS[name]()
    if overrides:
        cfg = update(cfg, overrides)
    return cfg
