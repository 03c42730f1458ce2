"""The plain reference against bm2f_tpu_torch on the CPU, at a small size,
on the benchmark's seeded weights: the forward, one mask-supervised and one
box-supervised train step (losses, gradient norm, each weight's first
gradient and change), AdamW's parameter policy, and a served request's
three outputs.

Error model. Both sides compute in f32 on the CPU, the same mathematics in
another order (the port's deformable core is a row gather where the
reference calls `F.grid_sample`; the port resizes the mask features before
the decoder's mask product, the reference after; the port's criterion
weights candidate points where the reference gathers them). One rounding
is 2^-24 = 6e-8 relative; a value passes through about 60 dependent
products and norms here, and the gradient through as many again, so gaps
of 1e-6 relative are expected and 1e-4 (FWD_REL, STEP_REL) leaves two
decades of room, while a wrong term (a missing layer, a wrong weight or
normaliser) moves these numbers by 1e-2 or more. Thresholds (the decoder's
sigmoid < 0.5 attention mask, the mask > 0 instance masks, argmaxes of
the projection loss, the importance sampler's top-k) can turn on a tie;
the seed here has none, and the served outputs are compared exactly where
they are discrete. At this size ties are common: of the seeds 2^40 + 17
to + 24, three hold one in a step test (the mask step's first batch of
2^40 + 17 reads 1.2e-4 on the first gradient of many weights with 2
threads and 7e-6 with 4, its loss within 3e-7 either way).
"""

import numpy as np
import pytest
import torch

from port_bench.generator import draw_points, train_pool
from port_bench.reference.criterion import LossWeights
from port_bench.reference.model import Arch, forward
from port_bench.reference.optim import NO_DECAY, AdamWConfig, trainable
from port_bench.reference.serve import infer
from port_bench.reference.train import WeakConfig, train_steps
from port_bench.tests.tiny import cpu_threads, tiny_cell
from port_bench.weights import make_weights

FWD_REL = 1e-4
STEP_REL = 1e-4
SEED = 2 ** 40 + 18


def setup_module(module):
    cpu_threads()


def port_cfg(c, kind="train"):
    from port_bench.harness import port_config

    conf = dict(c.config)
    conf["train_overrides"] = {**conf["train_overrides"], "model.dtype": "float32"}
    return port_config(conf, kind)


def test_forward_matches_port():
    from bm2f_tpu_torch.models.maskformer import MaskFormer, normalize_images

    c = tiny_cell("r50_train_mask")
    cfg = port_cfg(c)
    a = Arch.from_dict(c.config["arch"])
    P = make_weights(a, SEED, "cpu")
    m = MaskFormer(cfg.model).eval()
    m.load_state_dict(P, strict=True)
    img = torch.rand(2, 96, 128, 3, generator=torch.Generator().manual_seed(3)) * 255
    with torch.no_grad():
        out = m(normalize_images(img, cfg.model))
        ref = forward(P, img, a)
    for key in ("pred_logits", "pred_masks"):
        gap = (out[key] - ref[key]).abs().max() / ref[key].abs().max()
        assert gap < FWD_REL, (key, float(gap))
    for i, r in enumerate(ref["aux_masks"]):
        gap = (out["aux_masks"][i] - r).abs().max() / r.abs().max()
        assert gap < FWD_REL, ("aux_masks", i, float(gap))


@pytest.mark.parametrize("workload", ["r50_train_mask", "boxsup_train"])
def test_train_step_matches_port(workload):
    from bm2f_tpu_torch.train.trainer import Trainer

    c = tiny_cell(workload)
    cfg = port_cfg(c)
    a = Arch.from_dict(c.config["arch"])
    lw = LossWeights(**c.config["loss"])
    weak = WeakConfig(**c.config["weak"]) if c.config["weak"] else None
    opt = AdamWConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in c.config["optimizer"].items()})
    P = make_weights(a, SEED, "cpu")
    batch = train_pool(c.mix, SEED, "cpu", c.config["max_instances"], a.num_classes)[0]
    gen = torch.Generator().manual_seed(5)
    pts = None if weak else draw_points(gen, a.dec_layers + 1, batch["images"].shape[0],
                                        lw.num_points, lw.oversample_ratio,
                                        lw.importance_sample_ratio)
    tr = Trainer(cfg, device="cpu", seed=0)
    tr.model.load_state_dict(P, strict=True)
    m = {k: float(v) for k, v in tr.step(batch, pts).items()}
    ref = train_steps(P, [batch], [pts], a, lw, opt, weak)
    assert abs(m["total_loss"] - ref.total[0]) <= STEP_REL * abs(ref.total[0])
    assert abs(m["grad_norm"] - ref.grad_norm[0]) <= STEP_REL * ref.grad_norm[0]
    for k, v in ref.losses[0].items():
        assert abs(m[k] - v) <= STEP_REL * max(abs(v), 1e-3), k
    b1 = opt.betas[0]
    g1 = {g.name: float(mu.norm()) / (1 - b1) for g, mu in zip(tr.optimizer.groups,
                                                                  tr.optimizer.mu)}
    params = dict(tr.model.named_parameters())
    assert sorted(g1) == sorted(ref.grad1)
    med = float(np.median(list(ref.grad1.values())))
    for n, v in ref.grad1.items():
        assert abs(g1[n] - v) <= STEP_REL * max(v, med), n
        change = float((params[n].detach() - P[n]).norm())
        assert abs(change - ref.change[n]) <= STEP_REL * max(ref.change[n], 1e-12) + 1e-9, n


def test_adamw_policy_matches_port():
    """Which weights train, take weight decay and the backbone's rate."""
    from bm2f_tpu_torch.models.maskformer import MaskFormer
    from bm2f_tpu_torch.train.optim import param_groups

    c = tiny_cell("r50_train_mask")
    cfg = port_cfg(c)
    with torch.device("meta"):
        m = MaskFormer(cfg.model)
    groups = param_groups(m, cfg.train.optimizer)
    names = trainable(make_weights(Arch.from_dict(c.config["arch"]), 1, "cpu"))
    assert sorted(g.name for g in groups) == sorted(names)
    for g in groups:
        assert g.decay == (NO_DECAY.search(g.name) is None), g.name
        assert g.lr_mult == (0.1 if g.name.startswith("backbone.") else 1.0), g.name


def test_served_request_matches_port():
    from bm2f_tpu_torch.predict import Predictor

    c = tiny_cell("r50_serve")
    a = Arch.from_dict(c.config["arch"])
    P = make_weights(a, SEED, "cpu")
    p = Predictor()
    p.setup(c.config["preset"], device="cpu", overrides=c.config["overrides"])
    p.model.load_state_dict(P, strict=True)
    rng = np.random.default_rng(0)
    image = (rng.random((70, 100, 3)) * 255).astype(np.uint8)
    out = p.infer(image)
    t = c.config["test"]
    ref = infer(P, image, a, device="cpu", object_mask_threshold=t["object_mask_threshold"],
                overlap_threshold=t["overlap_threshold"])
    assert np.abs(out["semantic"] - ref["semantic"].numpy()).max() < FWD_REL
    inst = out["instances"]
    np.testing.assert_array_equal(inst["labels"], ref["instances"]["labels"].numpy())
    np.testing.assert_array_equal(inst["masks"], ref["instances"]["masks"].numpy())
    np.testing.assert_allclose(inst["scores"], ref["instances"]["scores"].numpy(),
                               rtol=FWD_REL, atol=1e-7)
    seg, segments = out["panoptic"]
    np.testing.assert_array_equal(seg, ref["panoptic"][0].numpy())
    assert segments == ref["panoptic"][1]


def test_tiny_overrides_cover_the_reference():
    """The small model's overrides and the reference's sizes agree (the
    harness's `verify_config` raises otherwise)."""
    from port_bench.harness import port_config, verify_config

    for w in ("r50_train_mask", "boxsup_train", "r50_serve"):
        c = tiny_cell(w)
        kind = "serve" if c.mix["driver"] == "requests" else "train"
        verify_config(port_config(c.config, kind), c.config, kind)


def test_fp8_scope_rounds_forward_and_backward():
    """Under the fp8 control every value an operation makes, the gradients
    too, lies on e4m3's grid."""
    from port_bench.reference.numerics import Numerics, fp8

    g = torch.Generator().manual_seed(7)
    x = torch.randn(16, 32, generator=g)
    w = torch.randn(32, 8, generator=g, requires_grad=True)
    with Numerics("fp8").scope():
        y = (x @ w).sigmoid()
        (gw,) = torch.autograd.grad(y.square().sum(), [w])
    for t in (y, gw):
        assert torch.equal(fp8(t.detach()), t.detach())
    assert not torch.equal(fp8(x), x)  # the rounding does bite
    with torch.no_grad():
        exact = (x @ w).sigmoid()
    assert (y - exact).abs().max() > 1e-3

