"""One run of one cell: set-up, the measured window, the traced stretches
and the check against the plain reference.

A cell's traffic names its driver:
- "train": `Trainer.step` of bm2f_tpu_torch on a pool of batches. Set-up
  builds the trainer, loads the benchmark's weights, takes the mix's
  `checked_steps` steps on distinct batches (their losses, gradient norms,
  first gradient and change, and the first step's first-head masks, are
  what the reference checks) and one step on every other batch of the
  pool; the window then cycles the pool.
- "requests": `Predictor.infer` of bm2f_tpu_torch, one client in a closed
  loop. Set-up builds the predictor, loads the weights and warms every
  shape of the mix; the window sends the mix's order of shapes; one
  request of each shape, drawn from the seed, is checked. A server serves
  one model: its weights are drawn from the configuration's name, the
  same in every run, and the seed draws the traffic and the requests
  checked. (The weights decide how many panoptic segments a request
  keeps, which the relabelling walks one by one on the host: weights
  drawn from the seed moved a run's median latency by 8 %.)

`--trace 1` splits the window into three stretches: plain (FLOPs over
time), marked (the train step's `StageTimer` marks, or hooks on the
served network), and a short profiled one (device busy time, the
deformable core's device time, the breakdown).
"""

from __future__ import annotations

import functools
import gc
import statistics
import time
from typing import Dict, Mapping

import numpy as np
import torch

from port_bench import bounds, check, generator, trace
from port_bench.manifest import Cell, reader
from port_bench.reference.criterion import LossWeights
from port_bench.reference.model import Arch
from port_bench.reference.optim import AdamWConfig
from port_bench.reference.train import WeakConfig, first_head_masks
from port_bench.weights import make_weights

GiB = float(2 ** 30)
# the traced run's share of the window for the plain and the marked stretch
PLAIN_SHARE, MARKED_SHARE = 0.45, 0.35
# steps or requests in the profiled stretch
PROFILED_STEPS, PROFILED_REQUESTS = 3, 6
FWD_RANGE = "port_bench.msda_fwd"

# the reference's names of the configuration's numbers -> the port's config paths
# (the backbone's: its file's PORT_KEYS)
PORT_KEYS = {
    "arch": {"conv_dim": "model.pixel_decoder.conv_dim",
             "mask_dim": "model.pixel_decoder.mask_dim",
             "enc_layers": "model.pixel_decoder.transformer_enc_layers",
             "enc_heads": "model.pixel_decoder.transformer_nheads",
             "enc_ffn": "model.pixel_decoder.transformer_dim_feedforward",
             "enc_points": "model.pixel_decoder.transformer_n_points",
             "num_queries": "model.decoder.num_queries", "hidden_dim": "model.decoder.hidden_dim",
             "dec_heads": "model.decoder.nheads", "dec_ffn": "model.decoder.dim_feedforward",
             "dec_layers": "model.decoder.dec_layers", "num_classes": "model.num_classes",
             "size_divisibility": "model.size_divisibility", "pixel_mean": "model.pixel_mean",
             "pixel_std": "model.pixel_std"},
    "loss": {"num_classes": "model.num_classes", "eos_coef": "model.loss.no_object_weight",
             "class_weight": "model.loss.class_weight", "mask_weight": "model.loss.mask_weight",
             "dice_weight": "model.loss.dice_weight", "num_points": "model.loss.train_num_points",
             "oversample_ratio": "model.loss.oversample_ratio",
             "importance_sample_ratio": "model.loss.importance_sample_ratio"},
    "optimizer": {"base_lr": "train.optimizer.base_lr",
                  "weight_decay": "train.optimizer.weight_decay",
                  "backbone_multiplier": "train.optimizer.backbone_multiplier",
                  "clip": "train.optimizer.clip_gradients", "betas": "train.optimizer.betas",
                  "warmup_iters": "train.optimizer.warmup_iters",
                  "warmup_factor": "train.optimizer.warmup_factor",
                  "steps": "train.optimizer.steps", "gamma": "train.optimizer.gamma"},
    "weak": {"projection_weight": "model.loss.weak.projection_weight",
             "pairwise_weight": "model.loss.weak.pairwise_weight",
             "color_thresh": "model.loss.weak.pairwise.color_thresh",
             "warmup_iters": "model.loss.weak.pairwise.warmup_iters",
             "mask_update": "model.loss.weak.mask_update_enabled",
             "mask_update_steps": "model.loss.weak.mask_update_steps",
             "mask_update_thrs": "model.loss.weak.mask_update_pix_thrs",
             "max_iter": "train.optimizer.max_iter"},
    "test": {"object_mask_threshold": "model.test.object_mask_threshold",
             "overlap_threshold": "model.test.overlap_threshold"},
}
# what the reference holds fixed, in the port's config (and the backbone's
# file's PORT_NAME)
PORT_FIXED = {"model.pixel_decoder.name": "msdeform",
              "model.decoder.name": "multi_scale_masked", "model.decoder.pre_norm": False,
              "model.decoder.enforce_input_project": False,
              "model.pixel_decoder.transformer_in_features": ("res3", "res4", "res5"),
              "model.pixel_decoder.common_stride": 4, "model.decoder.num_feature_levels": 3,
              "model.loss.weak.pairwise.size": 3, "model.loss.weak.pairwise.dilation": 2}


def port_config(conf: Mapping, kind: str):
    """The port's Config of a configuration file for a driver kind."""
    from bm2f_tpu_torch.config import get_config

    over = {**conf["overrides"], **conf[f"{kind}_overrides"]}
    return get_config(conf["preset"], over)


def verify_config(cfg, conf: Mapping, kind: str) -> None:
    """Raises unless the port runs the numbers the file states."""
    get = lambda path: functools.reduce(getattr, path.split("."), cfg)
    wrong = []

    def same(path, want):
        try:
            have = get(path)
        except AttributeError:
            wrong.append(f"{path}: not in the port's config, file {want!r}")
            return
        if isinstance(have, (tuple, list)) or isinstance(want, (tuple, list)):
            ok = tuple(have) == tuple(want)
        else:
            ok = have == want
        if not ok:
            wrong.append(f"{path}: port {have!r}, file {want!r}")

    arch = Arch.from_dict(conf["arch"])
    for key, path in PORT_KEYS["arch"].items():
        same(path, getattr(arch, key))
    same("model.backbone.name", arch.net.PORT_NAME)
    for key, path in arch.net.PORT_KEYS.items():
        same(path, arch.backbone[key])
    for group in ("loss", "optimizer", "test"):
        for key, path in PORT_KEYS[group].items():
            if key in conf[group]:
                same(path, conf[group][key])
    if conf["weak"] is not None:
        for key, path in PORT_KEYS["weak"].items():
            same(path, conf["weak"][key])
        same("model.loss.sup_type", "mask_projection_and_pairwise")
    else:
        same("model.loss.sup_type", "mask")
    same("input.max_instances", conf["max_instances"])
    for path, want in PORT_FIXED.items():
        same(path, want)
    same("model.dtype", conf[f"{kind}_precision"])
    if conf[f"{kind}_precision"] != "float32":
        same("model.pixel_decoder_f32", False)
    if wrong:
        raise ValueError("the port's configuration departs from the file: " + "; ".join(wrong))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Driver:
    def __init__(self, c: Cell, seed: int, device):
        self.c, self.seed, self.device = c, seed, torch.device(device)
        self.conf, self.mix = c.config, c.mix
        self.arch = Arch.from_dict(self.conf["arch"])
        self.weights_seed = seed


class TrainDriver(Driver):
    kind = "train"

    def __init__(self, c: Cell, seed: int, device):
        super().__init__(c, seed, device)
        self.lw = LossWeights(**self.conf["loss"])
        self.weak = WeakConfig(**self.conf["weak"]) if self.conf["weak"] else None
        self.B = int(self.mix["batch"])

    def setup(self) -> None:
        from bm2f_tpu_torch.train.trainer import Trainer

        cfg = port_config(self.conf, "train")
        verify_config(cfg, self.conf, "train")
        P0 = make_weights(self.arch, self.weights_seed, self.device)
        self.trainer = Trainer(cfg, device=self.device,
                               seed=generator.sub_seed(self.seed, "trainer") % 2 ** 31)
        self.trainer.model.load_state_dict(P0, strict=True)
        self.pool = generator.train_pool(self.mix, self.seed, self.device,
                                         self.conf["max_instances"], self.arch.num_classes)
        self.gen = torch.Generator(device=self.device).manual_seed(
            generator.sub_seed(self.seed, "points"))
        n_check = int(self.mix["checked_steps"])
        if n_check > len(self.pool):
            raise ValueError("the checked steps need distinct batches: pool_batches >= checked_steps")
        prog = {"total": [], "losses": [], "grad_norm": [], "out1": {}}

        def keep_first_head(module, inputs, out):
            prog["out1"]["masks0"] = first_head_masks(out).detach().clone()

        self.check_points = []
        for t in range(n_check):
            pts = self.points()
            self.check_points.append(pts)
            hook = self.trainer.model.register_forward_hook(keep_first_head) if t == 0 else None
            m = {k: float(v) for k, v in self.step(self.pool[t], pts).items()}
            if hook is not None:
                hook.remove()
            prog["total"].append(m.pop("total_loss"))
            prog["grad_norm"].append(m.pop("grad_norm"))
            prog["losses"].append(m)
            if t == 0:
                prog["grad1"] = self.first_grad_norms()
        prog["change"] = self.change_norms(P0)
        del P0
        for t in range(n_check, len(self.pool)):
            self.step(self.pool[t], self.points())
        sync(self.device)
        self.prog, self.next = prog, len(self.pool)

    def points(self):
        """The mask criterion's points of one step (the weak one takes none)."""
        if self.weak is not None:
            return None
        lw = self.lw
        return generator.draw_points(self.gen, self.arch.dec_layers + 1, self.B,
                                     lw.num_points, lw.oversample_ratio,
                                     lw.importance_sample_ratio)

    def step(self, batch, pts, mark=None):
        return self.trainer.step(batch, pts, mark=mark)

    def next_step(self, mark=None):
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.step(batch, self.points(), mark)

    @torch.no_grad()
    def first_grad_norms(self) -> Dict[str, float]:
        """Each weight's first clipped gradient as the optimizer got it, from
        its AdamW state after one step: mu / (1 - beta1)."""
        opt = self.trainer.optimizer
        b1 = opt.cfg.betas[0]
        norms = torch.stack([m.float().norm() for m in opt.mu]) / (1 - b1)
        return dict(zip([g.name for g in opt.groups], norms.tolist()))

    @torch.no_grad()
    def change_norms(self, P0) -> Dict[str, float]:
        params = dict(self.trainer.model.named_parameters())
        names = [g.name for g in self.trainer.optimizer.groups]
        norms = torch.stack([(params[n].float() - P0[n]).norm() for n in names])
        return dict(zip(names, norms.tolist()))

    def run_for(self, seconds: float, mark=None) -> tuple:
        sync(self.device)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            if mark is not None:
                mark.start()
            self.next_step(mark)
            steps += 1
        sync(self.device)
        return steps, time.perf_counter() - t0

    def window(self, seconds: float) -> tuple:
        steps, elapsed = self.run_for(seconds)
        return {"train_images_per_s": steps * self.B / elapsed}, steps

    def traced(self, seconds: float) -> tuple:
        from bm2f_tpu_torch.train.trainer import StageTimer

        import bm2f_tpu_torch.models.pixel_decoder as pdm

        n1, t1 = self.run_for(seconds * PLAIN_SHARE)
        timer = StageTimer(self.device)
        n2, _ = self.run_for(seconds * MARKED_SHARE, mark=timer)
        calls = []
        orig = pdm.ms_deform_attn

        def core(value, spatial_shapes, loc, attn):
            with torch.profiler.record_function(FWD_RANGE):
                out = orig(value, spatial_shapes, loc, attn)
            calls.append((tuple(value.shape), value.element_size(),
                          tuple(tuple(int(v) for v in s) for s in spatial_shapes),
                          loc.detach(), out.grad_fn.name() if out.grad_fn is not None else None))
            return out

        pdm.ms_deform_attn = core
        try:
            tr = trace.profiled(lambda: [self.next_step() for _ in range(PROFILED_STEPS)],
                                self.device)
        finally:
            pdm.ms_deform_attn = orig
        H, W = self.mix["canvas"]
        rec = {"kind": "train", "precision": self.conf["train_precision"],
               "plain": {"steps": n1, "seconds": t1, "images": n1 * self.B,
                         "flops": n1 * 3 * bounds.forward_flops(self.conf["arch"], self.B, H, W)},
               "stages_ms": {k: v / n2 for k, v in timer.ms.items()},
               "busy_s": tr.busy_s(), "window_s": tr.window_s}
        if calls:
            bwd = {f for *_, f in calls if f}
            rec["msda"] = {
                "fwd_least_s": sum(bounds.deform_fwd_seconds(s, b, sh, loc)
                                   for s, b, sh, loc, _ in calls),
                "fwd_device_s": tr.device_seconds_in([FWD_RANGE]),
                "bwd_least_s": sum(bounds.deform_bwd_seconds(s, b, sh, loc)
                                   for s, b, sh, loc, _ in calls),
                "bwd_device_s": tr.device_seconds_in(
                    [*bwd, *(f"autograd::engine::evaluate_function: {f}" for f in bwd)])}
        del calls
        return rec, tr, n1 + n2 + PROFILED_STEPS

    def release(self) -> None:
        """Frees the program's state."""
        self.trainer = None
        free(self.device)

    def check(self):
        """(the numbers, the reference's StepRecord), the trainer freed first."""
        from port_bench.reference.train import train_steps

        n = len(self.prog["total"])
        self.release()
        batches = self.pool[:n]
        P0 = make_weights(self.arch, self.weights_seed, self.device)
        opt = AdamWConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in self.conf["optimizer"].items()})
        ref = train_steps(P0, batches, self.check_points, self.arch, self.lw, opt, self.weak)
        self.ref_inputs = (batches, opt)
        return check.train_numbers(self.prog, ref), ref


class ServeDriver(Driver):
    kind = "serve"

    def __init__(self, c: Cell, seed: int, device):
        super().__init__(c, seed, device)
        self.weights_seed = generator.sub_seed(0, f"served weights of {c.config_name}")

    def setup(self) -> None:
        from bm2f_tpu_torch.predict import Predictor

        over = {**self.conf["overrides"], **self.conf["serve_overrides"]}
        p = Predictor()
        p.setup(self.conf["preset"], device=self.device, overrides=over)
        verify_config(p.cfg, self.conf, "serve")
        P0 = make_weights(self.arch, self.weights_seed, self.device)
        p.model.load_state_dict(P0, strict=True)
        p.model.cast_weights_for_inference_()
        del P0
        self.p = p
        self.slot = None
        self.hook = p.model.register_forward_hook(self._capture)
        self.images = generator.request_images(self.mix, self.seed, self.device)
        for s, per in enumerate(self.images):
            for k in range(int(self.mix["warm_requests_per_shape"])):
                self.p.infer(per[k % len(per)])
        self.order = generator.request_order(self.mix, self.seed, cycles=500)
        self.sample_rng = np.random.default_rng(generator.sub_seed(self.seed, "sample"))
        self.seen = [0] * len(self.images)
        self.kept: Dict[int, tuple] = {}
        self.i = 0
        sync(self.device)

    def _capture(self, module, inputs, out):
        self.slot = (out["pred_logits"][0], out["pred_masks"][0])

    def request(self) -> float:
        s = self.order[self.i % len(self.order)]
        k = self.seen[s] % len(self.images[s])
        t0 = time.perf_counter()
        out = self.p.infer(self.images[s][k])
        dt = time.perf_counter() - t0
        self.i += 1
        self.seen[s] += 1
        if self.sample_rng.random() < 1.0 / self.seen[s]:
            self.kept[s] = (k, out, self.slot)
        return dt

    def run_for(self, seconds: float) -> tuple:
        lat, shapes = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            shapes.append(self.order[self.i % len(self.order)])
            lat.append(self.request())
        return lat, shapes, time.perf_counter() - t0

    def window(self, seconds: float) -> tuple:
        lat, _, _ = self.run_for(seconds)
        ms = np.asarray(lat) * 1e3
        return {"request_p50_ms": float(np.percentile(ms, 50)),
                "request_p95_ms": float(np.percentile(ms, 95))}, len(lat)

    def traced(self, seconds: float) -> tuple:
        lat1, shapes1, t1 = self.run_for(seconds * PLAIN_SHARE)
        net = []

        def pre(module, inputs):
            sync(self.device)
            self._t = time.perf_counter()

        def post(module, inputs, out):
            sync(self.device)
            net.append(time.perf_counter() - self._t)

        hooks = [self.p.model.register_forward_pre_hook(pre),
                 self.p.model.register_forward_hook(post)]
        try:
            lat2, _, _ = self.run_for(seconds * MARKED_SHARE)
        finally:
            for h in hooks:
                h.remove()
        tr = trace.profiled(lambda: [self.request() for _ in range(PROFILED_REQUESTS)],
                           self.device)
        d = self.arch.size_divisibility
        flops = {}
        for s in set(shapes1):
            h, w = self.mix["shapes"][s]
            flops[s] = bounds.forward_flops(self.conf["arch"], 1, -(-h // d) * d, -(-w // d) * d)
        rec = {"kind": "serve", "precision": self.conf["serve_precision"],
               "plain": {"requests": len(lat1), "seconds": t1,
                         "flops": sum(flops[s] for s in shapes1)},
               "network_ms": 1e3 * statistics.fmean(net),
               "request_ms": 1e3 * statistics.fmean(lat2),
               "busy_s": tr.busy_s(), "window_s": tr.window_s}
        return rec, tr, len(lat1) + len(lat2) + PROFILED_REQUESTS

    def release(self) -> None:
        self.p = self.slot = None
        free(self.device)

    def check(self):
        """(the numbers, None), the predictor freed first."""
        from port_bench.reference.serve import infer

        self.hook.remove()
        kept = [(s, k, out, {"pred_logits": sl[0], "pred_masks": sl[1]})
                for s, (k, out, sl) in sorted(self.kept.items())]
        self.release()
        P0 = make_weights(self.arch, self.weights_seed, self.device)
        test = self.conf["test"]
        rows = []
        for s, k, out, net in kept:
            ref = infer(P0, self.images[s][k], self.arch, device=self.device,
                        object_mask_threshold=test["object_mask_threshold"],
                        overlap_threshold=test["overlap_threshold"])
            rows.append(check.serve_numbers({**out, **net}, ref, self.arch.num_classes))
            del ref
        self.samples = [(s, k) for s, k, _, _ in kept]
        self.rows = rows
        return check.served(rows), None


DRIVERS = {"train": TrainDriver, "requests": ServeDriver}


def run_cell(c: Cell, seed: int, seconds: float, traced: bool, device, t_start: float):
    """One run; returns the result's fields (the caller prints them)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    drv = DRIVERS[c.mix["driver"]](c, seed, dev)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if traced:
        rec, tr, attempted = drv.traced(seconds)
        metrics = {}
        for m in c.per_layer:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e, attempted = drv.window(seconds)
        metrics = {k: {"value": v, "unit": m["unit"]} for m in c.end_to_end
                   for k, v in e2e.items() if m["name"] == k}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if not traced:
        metrics["peak_mem_gib"] = {"value": peak / GiB, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(max(peak, peak_setup))}
    result = {"attempted": attempted, "failed": 0, "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"], device_info["window_s"] = rec["busy_s"], rec["window_s"]
        result["breakdown"] = tr.breakdown()
    numbers, _ = drv.check()
    ok, rows = check.judge(numbers, c.limits)
    result["correct"] = ok
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result
