"""`tools/convert_torchvision_weights` of the port against the JAX
package's (tools/convert_torchvision_weights.py, loaded from its path), on
seeded state dicts under torchvision's ResNet-50 names (blocks 3, 4, 6, 3,
with batch-norm statistics) and timm's Swin names, saved with `torch.save`:

- both CLIs write the same pickle: the same names in the same order, each
  array bitwise equal and of the same dtype;
- the port loads it through `load_d2_state_dict` and `load_weights`: the
  ResNet's dict strictly into the port's ResNet-50 (FrozenBN folded),
  bitwise the JAX converter's folding (`convert_resnet`) mapped to the
  port's names; the Swin dict into the SMALL Swin backbone with exactly
  two kinds of names left over, both of them ImageNet Swin's: the final
  `norm` it carries and detectron2's per-stage output norms `norm0..3` it
  does not (neither the JAX converter nor detectron2 takes them from it),
  and every other tensor bitwise the JAX converter's (`convert_swin`);
- the port's ResNet-50 on those weights at 64x64 against the JAX ResNet on
  the JAX converter's tree, stage by stage, within the error model below.
"""

import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from bm2f_tpu.models.resnet import ResNet as JaxResNet
from bm2f_tpu.utils import convert_weights as jax_cw
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.models.resnet import ResNet
from bm2f_tpu_torch.models.swin import relative_position_index
from bm2f_tpu_torch.tools import convert_torchvision_weights as port_tool
from bm2f_tpu_torch.utils.convert_weights import (
    jax_tree_to_numpy,
    load_d2_state_dict,
    load_weights,
)
from torch_port_utils import SMALL_SWIN

ROOT = Path(__file__).resolve().parent.parent

# Error model of the depth-50 ResNet (as tests/test_torch_layers.py's for
# depth 14): each output sums up to 3 x 3 x 512 = 4608 f32 products in
# another order on each side (oneDNN against XLA's CPU convolutions), ~68
# ulps (eps 1.2e-7) of the layer's activation scale, ~8e-6 of it, and the
# 53 convolutions carry it along: the error of an element follows its
# stage's largest activation, atol = RESNET50_ATOL_OF_MAX x max |ref| per
# stage, with the depth-14 test's 1e-5 doubled for the 4x as many blocks.
# Readings on a CPU: max error / max |ref| 7.7e-7 (res2) to 1.3e-6 (res4),
# max |ref| 69 to 27388 (random weights: the activations grow by stage).
RESNET50_ATOL_OF_MAX = 2e-5
RTOL = 1e-4


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_convert_torchvision_weights", ROOT / "tools" / "convert_torchvision_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def torchvision_resnet50(rng) -> dict:
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.randn(cout, cin, k, k) * np.sqrt(2.0 / (cin * k * k))).astype(np.float32))

    def bn(name, c):
        sd[f"{name}.weight"] = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
        sd[f"{name}.running_mean"] = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3)), 1):
        for b in range(blocks):
            p = f"layer{layer}.{b}"
            conv(f"{p}.conv1", planes, cin, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0", planes * 4, cin, 1)
                bn(f"{p}.downsample.1", planes * 4)
            cin = planes * 4
    sd["fc.weight"] = torch.from_numpy(rng.randn(1000, 2048).astype(np.float32) * 0.01)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def swin_model():
    cfg = get_config("coco_instance_swin_t", SMALL_SWIN)
    return cfg, build_model(cfg, device="cpu").backbone


def timm_swin(rng, backbone) -> dict:
    """timm's names for the SMALL Swin: the port's backbone's names without
    the per-stage output norms, with the final norm, the classifier, each
    block's relative position index and a shifted block's attention mask."""
    sd = {}
    for k, v in backbone.state_dict().items():
        if k.startswith("norm"):
            continue
        sd[k] = torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1)
        if k.endswith("attn.relative_position_bias_table"):
            w = (int(np.sqrt(v.shape[0])) + 1) // 2
            sd[k.replace("bias_table", "index")] = torch.from_numpy(relative_position_index(w))
    C = backbone.state_dict()["norm3.weight"].shape[0]
    sd["layers.0.blocks.1.attn_mask"] = torch.zeros(4, 49, 49)
    sd["norm.weight"], sd["norm.bias"] = torch.ones(C), torch.zeros(C)
    sd["head.weight"], sd["head.bias"] = torch.zeros(1000, C), torch.zeros(1000)
    return sd


def convert_both(sd, arch, tmp_path, monkeypatch):
    src = tmp_path / f"{arch}.pth"
    torch.save({"model": sd} if arch == "swin" else sd, src)
    outs = tmp_path / "jax" / "out.pkl", tmp_path / "port" / "out.pkl"
    mod = jax_tool()
    monkeypatch.setattr(sys, "argv", [mod.__file__, str(src), str(outs[0]), "--arch", arch])
    mod.main()
    port_tool.main([str(src), str(outs[1]), "--arch", arch])
    loaded = []
    for p in outs:
        with open(p, "rb") as f:
            loaded.append(pickle.load(f)["model"])
    ref, ours = loaded
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    return str(outs[1]), ref


@pytest.fixture(scope="module")
def rng_module():
    return np.random.RandomState(0)


def test_resnet50_pickles_equal_and_load_strictly(tmp_path, monkeypatch, rng_module):
    path, d2 = convert_both(torchvision_resnet50(rng_module), "resnet50", tmp_path, monkeypatch)
    state = load_d2_state_dict(path)
    cfg = get_config("coco_instance_r50")
    assert {k: v.shape for k, v in load_weights(path, cfg).items()} == {
        k: v.shape for k, v in state.items()}
    port = ResNet(50)
    port.load_state_dict({k[len("backbone."):]: v for k, v in state.items()}, strict=True)

    params, frozen = {}, {}
    jax_cw.convert_resnet(jax_cw.load_state_dict(path), params, frozen, 50)
    mapped = jax_tree_to_numpy({"params": params, "frozen": frozen})
    assert set(mapped) == set(state)
    for k, v in mapped.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)

    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    jax_vars = {"params": params["backbone"], "frozen": frozen["backbone"]}
    ref = jax.jit(JaxResNet(depth=50).apply)(jax_vars, x)
    with torch.no_grad():
        ours = port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
    assert set(ours) == set(ref)
    for name in ref:
        want = np.asarray(ref[name]).transpose(0, 3, 1, 2)
        got = ours[name].numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=RESNET50_ATOL_OF_MAX * scale,
            err_msg=f"{name}: max err / max |ref| {np.abs(got - want).max() / scale:.3e}")


def test_swin_pickles_equal_and_load_into_the_backbone(tmp_path, monkeypatch, rng_module):
    cfg, backbone = swin_model()
    path, d2 = convert_both(timm_swin(rng_module, backbone), "swin", tmp_path, monkeypatch)
    assert not any(k.startswith("backbone.head.") for k in d2)
    state = load_d2_state_dict(path)
    missing, unexpected = backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in state.items()}, strict=False)
    assert sorted(unexpected) == ["norm.bias", "norm.weight"]
    assert sorted(missing) == sorted(f"norm{i}.{p}" for i in range(4) for p in ("bias", "weight"))
    params = {}
    jax_cw.convert_swin(jax_cw.load_state_dict(path), params,
                        tuple(cfg.model.backbone.swin.depths))
    mapped = jax_tree_to_numpy({"params": params})
    assert set(mapped) == set(state) - {"backbone.norm.weight", "backbone.norm.bias"}
    for k, v in mapped.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(backbone.state_dict()[k[len("backbone."):]].numpy(), v)
