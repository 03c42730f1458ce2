"""`tools/analyze_model` of the port against the JAX package's
(tools/analyze_model.py, loaded from its path):

- the parameter table of the SMALL R50 and SMALL Swin models (the Swin
  case in test_torch_tools_analyze_swin.py) is the JAX
  tool's, line for line (its total and its 25 largest groups by the first
  two components of the JAX parameter path), and its counts are the JAX
  `params` leaves' sizes group for group;
- the FLOPs of the SMALL R50 model at 64x64 are exactly an analytic count
  from the model's shapes: 2 per multiply-add of every convolution and
  linear layer, of attention's packed input projection and its two
  products, of the decoder's two mask products, and K1's term (4 corners
  of every sample and channel), with nothing counted twice: the plain
  deformable core's own product is left out;
- on the CPU the tool says so in its first line; without a card and
  without --device cpu it raises.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bm2f_tpu.config as jax_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.models.layers import MultiHeadAttention
from bm2f_tpu_torch.tools import analyze_model
from torch_port_utils import SMALL, SMALL_SWIN

ROOT = Path(__file__).resolve().parent.parent
CASES = {"r50": ("coco_instance_r50", SMALL), "swin": ("coco_instance_swin_t", SMALL_SWIN)}


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_tool_analyze_model",
                                                  ROOT / "tools" / "analyze_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _set_args(over):
    return [a for k, v in over.items() for a in ("--set", f"{k}={v!r}")]


def check_param_table(case, monkeypatch, capsys):
    """The port's table of CASES[case] printed as the JAX tool prints it,
    and its counts the JAX `params` leaves' sizes group for group."""
    config, over = CASES[case]
    orig = jax_config.get_config
    monkeypatch.setattr(jax_config, "get_config", lambda name, o=None: orig(name, over))
    mod = jax_tool()
    monkeypatch.setattr(sys, "argv", [mod.__file__, "--config", config, "--size", "64",
                                      "--tasks", "params"])
    capsys.readouterr()
    mod.main()
    ref = capsys.readouterr().out.splitlines()
    res = analyze_model.main(["--config", config, "--size", "64", "--tasks", "params",
                              "--device", "cpu"] + _set_args(over))
    ours = capsys.readouterr().out.splitlines()
    assert ours[0].startswith("analyze_model: device cpu, the plain versions")
    assert ours[1:] == ref

    cfg = jax_config.get_config(config, over)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0),
                            jax_normalize(jnp.zeros((1, 64, 64, 3)), cfg.model))
    groups = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        g = "/".join(str(getattr(k, "key", k)) for k in path[:2])
        groups[g] = groups.get(g, 0) + int(np.prod(leaf.shape))
    assert res["groups"] == groups and list(res["groups"]) == list(groups)
    assert res["params"] == sum(groups.values())


# the JAX tool initialises the model op by op (~30 s on a CPU): the Swin
# case runs from test_torch_tools_analyze_swin.py, so that no one file sets
# the suite's wall time under --dist loadfile
@pytest.mark.parametrize("case", ["r50"])
def test_param_table_is_the_jax_table(case, monkeypatch, capsys):
    check_param_table(case, monkeypatch, capsys)


def test_flops_are_the_analytic_count(capsys):
    over = dict(SMALL)
    cfg = get_config("coco_instance_r50", over)
    model = build_model(cfg, device="cpu").requires_grad_(False)
    counts = {"conv": 0, "linear": 0, "attention": 0}

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            k = module.in_channels // module.groups * module.kernel_size[0] * module.kernel_size[1]
            counts["conv"] += 2 * out.numel() * k
        elif isinstance(module, torch.nn.Linear):
            counts["linear"] += 2 * out.numel() * module.in_features
        elif isinstance(module, MultiHeadAttention):
            q, k = inputs[0], inputs[1]
            B, Nq, C = q.shape
            Nk = k.shape[1]
            # q, k, v projections (the packed in_proj), then QK^T and AV
            counts["attention"] += 2 * B * (Nq + 2 * Nk) * C * C + 2 * 2 * B * Nq * Nk * C

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, MultiHeadAttention))]
    size = 64
    try:
        res = analyze_model.main(["--size", str(size), "--tasks", "flops", "--device", "cpu"]
                                 + _set_args(over))
        # the hooks count the tool's forward, of the model the tool builds:
        # run the same forward here on the same architecture
        from bm2f_tpu_torch.models.maskformer import normalize_images

        with torch.no_grad():
            model(normalize_images(torch.zeros(1, size, size, 3), cfg.model))
    finally:
        for h in handles:
            h.remove()
    pd, dec = cfg.model.pixel_decoder, cfg.model.decoder
    levels = [(size // s, size // s) for s in (32, 16, 8)]  # the decoder's, coarse first
    S = sum(h * w for h, w in levels)
    C, Q, L = dec.hidden_dim, dec.num_queries, dec.dec_layers
    # the mask products: the attention bias before each layer and after the
    # last (on the level the next layer reads), and the L + 1 layers' masks
    mask_bias = sum(2 * Q * C * levels[(i + 1) % 3][0] * levels[(i + 1) % 3][1]
                    for i in range(-1, L))
    mask_out = 2 * (L + 1) * Q * C * (size // 4) ** 2
    k1 = pd.transformer_enc_layers * 2 * 4 * S * pd.transformer_nheads * 3 \
        * pd.transformer_n_points * (pd.conv_dim // pd.transformer_nheads)
    want = counts["conv"] + counts["linear"] + counts["attention"] + mask_bias + mask_out
    assert res["k1_flops"] == k1
    assert res["flops"] == want, (res, counts, mask_bias, mask_out)


def test_no_card_raises_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_model.main(["--size", "64", "--tasks", "params"])


def test_a_deformable_call_from_elsewhere_raises():
    """A module that reaches the deformable core other than through the
    pixel decoder would have its K1 term missed: the count raises."""
    from bm2f_tpu_torch.ops import ms_deform_attn
    from bm2f_tpu_torch.tools.deform_attn_bench import deform_inputs

    shapes = ((4, 4), (2, 2))
    value, loc, attn = deform_inputs(1, shapes, 5, torch.Generator().manual_seed(0), "cpu")

    class Elsewhere(torch.nn.Module):
        def forward(self, images):
            return ms_deform_attn(value, shapes, loc, attn)

    cfg = get_config("coco_instance_r50", dict(SMALL))
    with pytest.raises(RuntimeError, match="ran 1 times but 0 calls were counted"):
        analyze_model.forward_flops(Elsewhere(), torch.zeros(1, 8, 8, 3), cfg.model)
