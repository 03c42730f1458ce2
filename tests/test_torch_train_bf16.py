"""bf16 training of the port against the JAX package's `model.dtype =
"bfloat16"` step, on the CPU.

- The plain backward of deformable attention on a bf16 `value` (upcast,
  f32 arithmetic, d_value rounded to bf16 once: what K2 on a bf16 `value`
  computes) against `jax.grad` through `ms_deform_attn_pallas(...,
  interpret=True)`, whose bf16 d_value is the kernel's f32 patch gradient
  rounded to bf16 and summed over the four corners in bf16. Both are held
  against the f64 backward on the same bf16 values, with e(a, b) = |a - b| /
  |b| (Frobenius norms):
      e(port, f64) <= e(jax, f64) + 1e-6,
  and the f32 gradients d_loc, d_attn also directly, rtol 1e-5. Readings
  (on a CPU), e_port / e_jax: d_value 1.65e-3 / 2.27e-3 (one bf16 rounding
  against one per corner), d_loc and d_attn 0.9-1.9e-7 / 0.7-1.7e-7.
- One SMALL step (depth-14 ResNet, 2 encoder and 6 decoder layers, 10
  queries, 64x64, JAX's own random points) in bf16 against the JAX bf16
  step, relative to JAX's own bf16 error against its f32 step, as
  tests/test_torch_bf16.py does for the forward:
      e(port_bf16, jax_f32) <= 2 e(jax_bf16, jax_f32) + ATOL_REL,
  for the vector of every loss, every gradient (all parameters at once and
  each top-level part alone) and every parameter update of AdamW. The
  parameters and the AdamW moments stay f32. Readings (on a CPU), e_port /
  e_jax: losses 6.6e-3 / 4.4e-3, gradients 0.124 / 0.135 (backbone 0.174 /
  0.191, pixel decoder 0.070 / 0.073, predictor 0.072 / 0.079), updates
  0.41 / 0.43: bf16 moves the gradients by ~10 % in both frameworks (the
  decoder's 0.5 mask threshold flips bits), and Adam's first update is
  about lr x sign(g), so a small gradient whose sign flips moves it whole.
- Under `torch.use_deterministic_algorithms` the plain backward, which CPU
  tensors take, repeats bitwise, and K2's wrapper (deterministic since its
  d_value is summed destination-major) neither raises nor warns about it:
  without a card here it gets only as far as refusing CPU tensors.
- The bf16 entry point (`--set model.dtype=bfloat16 --set
  model.pixel_decoder_f32=False --set train.matcher=jv`) on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.losses.criterion import set_criterion as jax_set_criterion
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize_images
from bm2f_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas
from bm2f_tpu.train import optim as jax_optim
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.ops import ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import (
    ms_deform_attn_bwd_cuda,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_plain,
)
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy, jax_variables_to_state_dict
from torch_port_utils import SMALL, jax_criterion_points, randomize, to_numpy_tree

BF16 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False}
# tests/test_torch_bf16.py:64-67
CASES = [
    (1, 2, 32, 4, 20, ((8, 8), (4, 4))),
    (2, 2, 32, 3, 29, ((1, 7), (5, 1), (4, 6))),
]
ATOL_REL = {"losses": 5e-3, "grads": 1e-3, "updates": 1e-3}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _deform_case(case, seed=0):
    B, M, D, P, Q, shapes = case
    rng = np.random.RandomState(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = np.array(jnp.asarray(rng.randn(B, S, M, D)).astype(jnp.bfloat16)
                     .astype(jnp.float32))  # bf16-representable
    loc = (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)
    attn = (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)
    g = rng.randn(B, Q, M, D).astype(np.float32)
    return shapes, value, loc, attn, g


@pytest.mark.parametrize("case", CASES)
def test_plain_bf16_backward_matches_pallas_vjp(case):
    shapes, value, loc, attn, g = _deform_case(case)
    B, Q, M, D = g.shape

    def loss(v, lo, a):  # sum(out * g): grad_out is g in both frameworks
        out = ms_deform_attn_pallas(v, shapes, lo, a, q_tile=8, interpret=True,
                                    out_head_major=True)  # (B, M, Q, D) f32
        return jnp.sum(out * jnp.asarray(g).transpose(0, 2, 1, 3))

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value).astype(jnp.bfloat16), jnp.asarray(loc), jnp.asarray(attn))
    assert jgrads[0].dtype == jnp.bfloat16
    jax_g = [np.asarray(x.astype(jnp.float32)) for x in jgrads]

    tv = torch.from_numpy(value).to(torch.bfloat16)
    tl, ta, tg = (torch.from_numpy(x) for x in (loc, attn, g.reshape(B, Q, M * D)))
    ours = ms_deform_attn_bwd_plain(tv, shapes, tl, ta, tg)
    assert ours[0].dtype == torch.bfloat16 and ours[1].dtype == ours[2].dtype == torch.float32
    ref = ms_deform_attn_bwd_plain(tv.double(), shapes, tl.double(), ta.double(), tg.double())
    for name, o, j, r in zip(("d_value", "d_loc", "d_attn"), ours, jax_g, ref):
        e_port, e_jax = rel(o.float().numpy(), r.numpy()), rel(j, r.numpy())
        assert e_port <= e_jax + 1e-6, (name, e_port, e_jax)
        if name != "d_value":
            np.testing.assert_allclose(o.numpy(), j, rtol=1e-5, atol=1e-6, err_msg=name)

    # the autograd Function takes the plain backward on the CPU
    leaves = [t.clone().requires_grad_(True) for t in (tv, tl, ta)]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, leaves, tg)
    for a, b in zip(got, ours):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_plain_backward_is_deterministic_and_k2_alerts():
    """Under torch.use_deterministic_algorithms, with and without warn_only,
    the CPU path (the plain backward, f32 and bf16) runs and repeats
    bitwise, and K2's wrapper no longer alerts: no warning (warnings are
    errors here) and no error of its own, only the refusal of CPU tensors."""
    import warnings

    shapes, value, loc, attn, g = _deform_case(CASES[0], seed=1)
    B, Q, M, D = g.shape
    tl, ta, tg = (torch.from_numpy(x) for x in (loc, attn, g.reshape(B, Q, M * D)))
    try:
        for warn_only in (False, True):
            torch.use_deterministic_algorithms(True, warn_only=warn_only)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                for dtype in (torch.float32, torch.bfloat16):
                    grads = []
                    for _ in range(2):
                        leaves = [torch.from_numpy(value).to(dtype).requires_grad_(True),
                                  tl, ta]
                        grads.append(torch.autograd.grad(
                            ms_deform_attn(leaves[0], shapes, tl, ta), leaves[:1], tg)[0])
                    assert torch.equal(grads[0], grads[1])
                    with pytest.raises(ValueError, match="must lie on"):  # no card here
                        ms_deform_attn_bwd_cuda(torch.from_numpy(value).to(dtype), shapes,
                                                tl, ta, tg)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def steps():
    """One SMALL step of JAX in f32 and bf16 and of the port in bf16, on the
    same converted weights (deformable projections drawn from N(0, 0.05)),
    batch and JAX random points: (losses, gradients, new parameters) of
    each under the port's names, and the port's trainer."""
    jcfg = jax_get_config("coco_instance_r50", SMALL)
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = to_numpy_tree(jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0), sample))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    batch = synthetic_batch(2, 64, 4, seed=3, device="cpu")
    np_batch = {k: v.numpy() for k, v in batch.items()}
    step_rng = jax.random.PRNGKey(11)
    targets = {k: jnp.asarray(np_batch[k]) for k in ("labels", "masks", "valid")}
    params = jax.tree.map(jnp.asarray, variables["params"])
    res = {}
    for name, over in (("jax_f32", {}), ("jax_bf16", BF16)):
        cfg = jax_get_config("coco_instance_r50", {**SMALL, **over})
        model = jax_build_model(cfg)
        images = jax_normalize_images(jnp.asarray(np_batch["images"]), cfg.model)

        def loss_fn(p, model=model, images=images, cfg=cfg):
            out = model.apply({"params": p, "frozen": variables["frozen"]}, images)
            return jax_set_criterion(out, targets, jax_criterion_config(cfg), step_rng)

        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = jax_optim.make_optimizer(cfg.train.optimizer, params)
        updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
        new = optax.apply_updates(params, updates)
        res[name] = ({k: float(v) for k, v in losses.items()},
                     jax_tree_to_numpy({"params": grads}), jax_tree_to_numpy({"params": new}))

    cfg = get_config("coco_instance_r50", {**SMALL, **BF16})
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    points = jax_criterion_points(step_rng, cfg.model.decoder.dec_layers + 1, 2, trainer.ccfg)
    metrics = trainer.step(batch, points)
    named = dict(trainer.model.named_parameters())
    res["port_bf16"] = ({k: v.item() for k, v in metrics.items()},
                        {k: p.grad.numpy() for k, p in named.items()},
                        {k: p.detach().numpy() for k, p in named.items()})
    old = jax_tree_to_numpy({"params": variables["params"]})
    return res, old, trainer


def _stack(tree, names):
    return np.concatenate([np.asarray(tree[n], np.float64).ravel() for n in names])


def _check(part, port, jbf16, jf32):
    e_port, e_jax = rel(port, jf32), rel(jbf16, jf32)
    assert e_port <= 2 * e_jax + ATOL_REL[part], (part, e_port, e_jax, rel(port, jbf16))


def test_small_bf16_step_losses_match_jax(steps):
    res, _, _ = steps
    keys = sorted(res["jax_f32"][0])
    assert set(res["port_bf16"][0]) == set(keys) | {"total_loss", "grad_norm"}
    vec = {n: np.array([r[0][k] for k in keys]) for n, r in res.items()}
    _check("losses", vec["port_bf16"], vec["jax_bf16"], vec["jax_f32"])


@pytest.mark.parametrize("part", ["all", "backbone", "sem_seg_head.pixel_decoder",
                                  "sem_seg_head.predictor"])
def test_small_bf16_step_gradients_match_jax(steps, part):
    """Every gradient, all at once and by part; the gradient reaches the
    encoder's deformable projections through the bf16 backward."""
    res, _, trainer = steps
    names = [n for n, _ in trainer.model.named_parameters()
             if part == "all" or n.startswith(part + ".")]
    assert names
    _check("grads", *(_stack(res[k][1], names) for k in ("port_bf16", "jax_bf16", "jax_f32")))
    for n in names:
        if ".self_attn." in n and n.endswith(".weight"):
            assert np.abs(res["port_bf16"][1][n]).sum() > 0, n


def test_small_bf16_step_updates_match_jax(steps):
    """AdamW's update (new minus old parameters) of every parameter, on f32
    parameters and f32 moments."""
    res, old, trainer = steps
    names = [n for n, _ in trainer.model.named_parameters()]
    upd = {k: _stack(res[k][2], names) - _stack(old, names)
           for k in ("port_bf16", "jax_bf16", "jax_f32")}
    _check("updates", upd["port_bf16"], upd["jax_bf16"], upd["jax_f32"])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(m.dtype == torch.float32 for m in trainer.optimizer.mu + trainer.optimizer.nu)


def test_bf16_entry_point_runs_on_cpu(capsys):
    """The JAX train bench's configuration through `python -m
    bm2f_tpu_torch.train` at a small size: finite losses."""
    args = ["--device", "cpu", "--size", "64", "--batch", "2", "--instances", "3",
            "--steps", "1"]
    for k, v in {**SMALL, **BF16, "train.matcher": "jv",
                 "model.decoder.dec_layers": 2}.items():
        args += ["--set", f"{k}={v!r}"]
    assert train_main.main(args) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("step 0 total_loss")
    assert np.isfinite(float(line.split()[3]))


def test_bf16_plain_forward_takes_gradients():
    """deform_impl="plain" (the parity reference) differentiates a bf16
    `value` through autograd of the upcast, as the Function does."""
    shapes, value, loc, attn, g = _deform_case(CASES[1], seed=2)
    B, Q, M, D = g.shape
    tv = torch.from_numpy(value).to(torch.bfloat16).requires_grad_(True)
    out = ms_deform_attn_plain(tv, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    (d_value,) = torch.autograd.grad(out, (tv,), torch.from_numpy(g.reshape(B, Q, M * D)))
    want = ms_deform_attn_bwd_plain(tv.detach(), shapes, torch.from_numpy(loc),
                                    torch.from_numpy(attn),
                                    torch.from_numpy(g.reshape(B, Q, M * D)))[0]
    assert d_value.dtype == torch.bfloat16
    torch.testing.assert_close(d_value.float(), want.float(), rtol=2 ** -7, atol=1e-6)
