"""The train step on one device: the counterpart of the JAX package's
`make_train_step` / `Trainer` (bm2f_tpu/train/trainer.py:36-167). The
criterion is the one `losses.build.build_criterion` picks from `task` and
`model.loss.sup_type`, as the JAX `compute_loss` is dispatched: images
(`build_model`) and video (`task` "video", the clip model
`video.build_video_model` on (B, T, H, W, 3) batches), mask- or
box-supervised.

A step is: forward, matcher costs, the assignment (`train.matcher`:
`matching.hungarian.make_assign_fn`), losses, backward, clip + AdamW. It
returns the same metrics as the JAX step: every loss, `total_loss` and
`grad_norm` (before clipping). The deformable encoder layers run K1 forward
and K2 backward on the card (`ops.deform_attn.MSDeformAttnFunction`), which
saves only each layer's inputs; the port does not rematerialise
(`PixelDecoderConfig.remat` only changes memory, and the JAX package needs
it for the gathered rows its formulation keeps).

`model.dtype` "bfloat16" trains as the JAX bench does: the model computes
in bf16 (K1 and K2 on a bf16 `value` when the pixel decoder does too), its
parameters and the AdamW moments stay f32, as in the JAX `TrainState`, and
there is no loss scaling, as there is none in JAX. An f32 model computes in
f32 (`utils.precision.f32_scope`: no TF32), and every step is deterministic
(`utils.precision.deterministic_scope`: two trainers from one seed end a
step with the same bits), whatever the global flags say.
`state_dict()` holds what the JAX `TrainState` holds, for
`train.checkpoint.Checkpointer`.

Data parallelism (`parallel/`): a trainer built in a process group trains
its rank's rows of the global batch, the JAX package's SPMD step over the
"data" mesh axis (bm2f_tpu/train/trainer.py:233-248) in PyTorch's idiom.
The model is wrapped in `DistributedDataParallel` (`broadcast_buffers=False`:
the FrozenBN buffers are constants) with `sum_gradients` as its comm hook,
so that every rank holds the SUM of the ranks' gradients, not DDP's
average: the criteria divide each rank's numerators by the global batch's
denominators, so the summed gradient is the JAX step's gradient of the
global loss. `grad_norm`, the global-norm clip and AdamW then see what
they see in JAX, and every rank makes the same update. The reported losses
are summed over the ranks (the global ones), in one all-reduce of a small
vector, with no synchronise of the host. Every parameter of the image,
video, box-supervised and MaskFormer-v1 models gets a gradient in every
step, so DDP needs no `find_unused_parameters`. The assignment is each
rank's own (the counterpart of `make_sharded_assign_fn`): the criterion
hands `assign_fn` only this rank's costs. The AdamW groups are built from
the unwrapped model, and `state_dict()` is the unwrapped model's, so a
checkpoint written at one world size resumes at another.

Tensor parallelism (`cfg.mesh.model` T > 1, `parallel.tp`): the ranks form
JAX's (data, model) grid (`parallel.init_mesh`), the batch is sharded over
the data axis only, and the model, built whole from the seed, is cut to the
rank's shares of the wide transformer parameters (`tp.shard_model_`), as
the JAX step places its state with `state_shardings`
(bm2f_tpu/train/trainer.py:223-241). DDP and the summed losses run over the
data group; `grad_norm` sums the shares' squares over the model group
(`AdamW`). `state_dict()` gathers the full tensors of the parameters and of
both moments and `load_state_dict` cuts them, so that a checkpoint is the
same file whatever T is; `eval_model()` is a whole model on the gathered
weights, as JAX evaluates `device_get(state.params)`.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from bm2f_tpu_torch.config import Config
from bm2f_tpu_torch.losses.build import build_criterion, criterion_config
from bm2f_tpu_torch.matching.hungarian import make_assign_fn
from bm2f_tpu_torch.models.maskformer import build_model, normalize_images
from bm2f_tpu_torch.parallel import global_sum, init_mesh
from bm2f_tpu_torch.parallel import tp as tparallel
from bm2f_tpu_torch.video import build_video_model
from bm2f_tpu_torch.train.optim import AdamW
from bm2f_tpu_torch.utils import tracing
from bm2f_tpu_torch.utils.precision import deterministic_scope, f32_scope

log = logging.getLogger(__name__)

# the stages of a train step: each child span of "train.step" -> its `mark` name
STAGES = {"train.forward": "forward", "train.matcher_costs": "matcher_costs",
          "train.assign": "assign", "train.losses": "losses",
          "train.backward": "backward", "train.optimizer": "optimizer"}


def synthetic_batch(batch: int, size: int, instances: int, seed: int,
                    num_classes: int = 80, device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded batch in the JAX bench's train recipe (bench.py:315-330):
    uint8-range float images (B, size, size, 3), labels in 0..num_classes-1,
    masks `rand > 0.8`. The last 2 targets of image 0 are padding (invalid;
    fewer when it has fewer than 3), so that the matcher's PAD_COST columns are exercised."""
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, size, size, 3).astype(np.float32) * 255
    labels = rng.randint(0, num_classes, (batch, instances))
    masks = rng.rand(batch, instances, size, size) > 0.8
    valid = np.ones((batch, instances), bool)
    valid[0, max(instances - 2, 1):] = False
    return {
        "images": torch.from_numpy(images).to(device),
        "labels": torch.from_numpy(labels).to(device),
        "masks": torch.from_numpy(masks).to(device=device, dtype=torch.float32),
        "valid": torch.from_numpy(valid).to(device),
    }


class StageTimer:
    """Host-clock time of consecutive stages, with a device synchronise at
    every mark (so that each stage's device work is charged to it). Costs
    one synchronise per mark; the train step takes none without it."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms: Dict[str, float] = {}
        self.start()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.ms[stage] = self.ms.get(stage, 0.0) + (now - self._t) * 1e3
        self._t = now


def _stage_marks(mark: Callable[[str], None]) -> Callable[[str], None]:
    """`tracing.collect`'s on_end: `mark(stage)` as each stage's span ends."""
    def on_end(name: str) -> None:
        stage = STAGES.get(name)
        if stage is not None:
            mark(stage)
    return on_end


def sum_gradients(group, bucket):
    """DDP comm hook: the bucket's gradients (a `dist.GradBucket`) summed
    over the ranks, a future of the summed tensor (DDP's default hook
    divides the sum by the world size). Unannotated: DDP compares the
    annotation with the class, and this module's annotations are strings."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


class Trainer:
    """Image or video training on one device, mask- or box-supervised; in a
    process group, data-parallel over its ranks (see the module's
    docstring). The model is drawn from `seed` (`build_model`, or
    `build_video_model` for task "video"); the mask criterion's random
    points come from a `torch.Generator` on `device` seeded with `seed`
    (the weak criteria draw none)."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # through the attribute, so that `assign_fn` may be swapped on the trainer
        self.criterion = build_criterion(cfg, lambda costs: self.assign_fn(costs),
                                         self.generator)
        self.video = cfg.task == "video"
        self.seed = seed
        self.mesh = init_mesh(cfg.mesh.model, cfg.mesh.data)
        self.model = self._build().train()
        # this rank's share of the model group, and what it splits
        self.shard, self.splits = None, {}
        if self.mesh.model_size > 1:
            self.shard = tparallel.ModelShard(self.mesh.model_rank, self.mesh.model_size,
                                              self.mesh.model_group)
            self.splits = tparallel.shard_model_(self.model, self.shard)
        # the module the step calls: DDP's wrapper in a process group
        self.forward = self.model
        if dist.is_available() and dist.is_initialized():
            # device_ids None: the module is on one device, its inputs too
            group = self.mesh.data_group
            self.forward = DistributedDataParallel(self.model, broadcast_buffers=False,
                                                   process_group=group)
            self.forward.register_comm_hook(group, sum_gradients)
        self.ccfg = criterion_config(cfg)
        self.assign_fn = make_assign_fn(cfg)
        self.optimizer = AdamW(self.model, cfg.train.optimizer, sharded=self.splits,
                               model_group=self.mesh.model_group)
        log.info("training without rematerialisation: each deformable "
                 "encoder layer saves only its inputs for K2")

    @property
    def step_count(self) -> int:
        """Steps taken (the JAX `TrainState.step`)."""
        return self.optimizer.count

    def _build(self):
        build = build_video_model if self.video else build_model
        return build(self.cfg, device=self.device, seed=self.seed)

    def state_dict(self) -> Dict[str, object]:
        """What the JAX `TrainState` holds: the step, the parameters and the
        FrozenBN buffers (the model's `state_dict`), the AdamW moments and
        count, and the criterion generator's state (JAX's `rng`). Under
        tensor parallelism the parameters and moments are gathered whole
        (every rank of the model group calls it)."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.shard is not None:
            model = tparallel.gather_state(model, self.splits, self.shard)
            for key in ("mu", "nu"):
                opt[key] = tparallel.gather_state(opt[key], self.splits, self.shard)
        return {"step": self.step_count, "model": model, "optimizer": opt,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Restores `state_dict()` bit for bit, cut to this rank's shares
        under tensor parallelism; raises on a missing or an extra key or a
        step that disagrees with the optimizer's count."""
        if int(state["step"]) != int(state["optimizer"]["count"]):
            raise ValueError(f"step {state['step']} but the optimizer has made "
                             f"{state['optimizer']['count']} updates")
        model, opt = state["model"], dict(state["optimizer"])
        if self.shard is not None:
            cut = functools.partial(tparallel.shard_state, splits=self.splits,
                                    rank=self.shard.rank, size=self.shard.size)
            model = cut(model)
            opt.update(mu=cut(opt["mu"]), nu=cut(opt["nu"]))
        self.model.load_state_dict(model, strict=True)
        self.optimizer.load_state_dict(opt)
        self.generator.set_state(state["generator"])

    def eval_model(self) -> torch.nn.Module:
        """The model to evaluate: `self.model`; under tensor parallelism a
        whole model on the gathered weights (every rank of the model group
        calls it), as the JAX loop evaluates `device_get(state.params)`."""
        if self.shard is None:
            return self.model
        weights = tparallel.gather_state(self.model.state_dict(), self.splits, self.shard)
        model = self._build()
        model.load_state_dict(weights, strict=True)
        return model

    def loss(self, batch: Mapping[str, torch.Tensor],
             points: Optional[Mapping[str, torch.Tensor]] = None,
             deform_impl: str = "auto",
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward + criterion: (total_loss, losses). `points` as
        `draw_points` gives them (drawn from the trainer's generator when
        None; the weak criterion takes none); deform_impl="plain" runs the
        plain deformable attention (a parity reference for the kernels).
        The weak criterion's pairwise warmup and pixel threshold are read at
        `step_count`, before the step's update, as JAX reads `state.step`."""
        with tracing.span("train.forward"):
            x = normalize_images(batch["images"], self.cfg.model)
            out = self.forward(x, deform_impl=deform_impl)
        return self.criterion(out, batch, points, self.step_count)

    def step(self, batch: Mapping[str, torch.Tensor],
             points: Optional[Mapping[str, torch.Tensor]] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step. Returns every loss, total_loss and grad_norm
        as 0-d device tensors, the global batch's in a process group.
        Deterministic and, for an f32 model, in f32, whatever the global
        flags say.

        Traced (`utils.tracing`) as the root span "train.step" with the
        children of `STAGES` in order (the criteria open the middle three).
        `mark(stage)`, when given, turns tracing on for the step and is
        called as each of them ends, with its stage name ("forward",
        "matcher_costs", "assign", "losses", "backward", "optimizer")."""
        traced = (tracing.collect(_stage_marks(mark)) if mark is not None
                  else contextlib.nullcontext())
        with traced, tracing.span("train.step", self.device):
            with f32_scope(self.cfg.model.dtype), deterministic_scope():
                self.optimizer.zero_grad()
                total, losses = self.loss(batch, points)
                with tracing.span("train.backward"):
                    total.backward()
                with tracing.span("train.optimizer"):
                    grad_norm = self.optimizer.step()
            # the global batch's losses: the sum of the ranks' terms
            keys = [*losses, "total_loss"]
            summed = global_sum(torch.stack([*losses.values(), total]).detach())
        metrics = dict(zip(keys, summed.unbind(0)))
        metrics["grad_norm"] = grad_norm
        return metrics
