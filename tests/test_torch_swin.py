"""The port's Swin backbone (`bm2f_tpu_torch/models/swin.py`) against the JAX
package's (`bm2f_tpu/models/swin.py`), part by part and whole, on weights
carried across by the converter, with inputs made from a seed.

Error model. Both sides compute in f32 and differ only in the order of sums
(the products of the attention and the Linear layers, LayerNorm's
statistics, the softmax) and in the libraries' erf:
- the relative-position index, the shift mask and the window partition and
  its reverse are integer arithmetic or copies: equal bits;
- a part (attention, block, merging) on unit-scale inputs sums at most
  4C = 128 terms a product: a few 1e-7 relative; held at rtol / atol 1e-5;
- the small backbone chains 9 blocks and 3 mergings, each renormalised by
  LayerNorm; held at rtol / atol 1e-4 (measured <= 3e-6).
The small backbone: embed 32, heads (1, 2, 4, 8), depths (2, 2, 3, 2) (stage
2 is odd: the JAX package unrolls it instead of scanning pairs), windows 7
and 12, `ape` off and on (a 16x16 table resized to the input's grid). Its
input (2, 90, 118, 3) reaches every padding case: the patch embedding pads
to 92x120 (23x30 patches), the blocks pad 23x30 to window multiples, the
odd 23 makes `PatchMerging` pad, and the last stage (3x4) is one padded
window that still rolls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.config import PRESETS as JAX_PRESETS
from bm2f_tpu.models import swin as jswin
from bm2f_tpu_torch.config import PRESETS, get_config
from bm2f_tpu_torch.models import swin
from bm2f_tpu_torch.models.layers import TRUNC_NORMAL_STD, init_parameters
from bm2f_tpu_torch.models.maskformer import MaskFormer
from torch_port_utils import randomize, submodule_state_dict, to_numpy_tree

PART_TOL = dict(rtol=1e-5, atol=1e-5)
BACKBONE_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL_KW = dict(embed_dim=32, depths=(2, 2, 3, 2), num_heads=(1, 2, 4, 8))


def _biases(rng):
    """Every bias, bias table and absolute position table at N(0, 0.05), so
    that each of them shows in the outputs (biases init at zero)."""
    return lambda tree: randomize(tree, rng, 0.05, only=lambda p: p.endswith(
        ("bias", "relative_position_bias_table", "absolute_pos_embed")))


def _init_jax(module, rng, *args):
    variables = to_numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(0), *args))
    return _biases(rng)(variables)


def _load(module, variables, jax_prefix, port_prefix):
    module.load_state_dict(submodule_state_dict(variables, jax_prefix, port_prefix),
                           strict=True)
    return module


# -- index, mask, partition --------------------------------------------------


@pytest.mark.parametrize("window", [7, 12])
def test_relative_position_index_matches_jax(window):
    np.testing.assert_array_equal(swin.relative_position_index(window),
                                  jswin._relative_position_index(window))


@pytest.mark.parametrize("hp,wp,w,s", [(24, 36, 12, 6), (14, 21, 7, 3), (12, 12, 12, 6),
                                       (7, 7, 7, 3), (28, 35, 7, 3)])
def test_shift_mask_matches_jax(hp, wp, w, s):
    ours = swin.shift_attn_mask(hp, wp, w, s, torch.device("cpu"))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), jswin._shift_attn_mask(hp, wp, w, s))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jswin._shift_attn_mask_device(hp, wp, w, s)))
    # cached per shape, device and dtype
    assert swin.shift_attn_mask(hp, wp, w, s, torch.device("cpu")) is ours
    half = swin.shift_attn_mask(hp, wp, w, s, torch.device("cpu"), torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(half.float(), ours)


def test_window_partition_and_reverse_match_jax(rng):
    x = rng.randn(2, 14, 21, 5).astype(np.float32)
    ours = swin.window_partition(torch.from_numpy(x), 7)
    ref = np.asarray(jswin.window_partition(jnp.asarray(x), 7))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # batch-major window order: window 1 of image 0 is rows 0-6, columns 7-13
    np.testing.assert_array_equal(ours[1].numpy(), x[0, :7, 7:14].reshape(49, 5))
    back = swin.window_reverse(ours, 7, 2, 14, 21)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin.window_reverse(jnp.asarray(ref), 7, 2, 14, 21)))


# -- parts -------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(rng, masked):
    dim, heads, w = 32, 4, 7
    x = rng.randn(2 * 6, w * w, dim).astype(np.float32)  # B=2, 2x3 windows
    mask = jswin._shift_attn_mask(14, 21, w, 3) if masked else None
    jmod = jswin.WindowAttention(dim, w, heads)
    variables = _init_jax(jmod, rng, jnp.asarray(x), mask)
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x), mask))
    ours = _load(swin.WindowAttention(dim, w, heads), variables,
                 "backbone/stage0_block0/attn", "backbone.layers.0.blocks.0.attn")
    with torch.no_grad():
        got = ours(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, **PART_TOL)
    if masked:  # the mask reaches the output
        with torch.no_grad():
            assert not np.allclose(ours(torch.from_numpy(x)).numpy(), ref, **PART_TOL)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("hw", [(14, 21), (11, 17), (5, 6)])
def test_swin_block_matches_jax(rng, shift, hw):
    """Shifted and unshifted, at window multiples, padded, and a map
    smaller than one window (padded to one window, rolled all the same)."""
    dim, heads, w = 32, 2, 7
    x = rng.randn(2, *hw, dim).astype(np.float32)
    jmod = jswin.SwinBlock(dim, heads, w, shift, 4.0, True, None, 0.0)
    variables = _init_jax(jmod, rng, jnp.asarray(x))
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    ours = _load(swin.SwinBlock(dim, heads, w, shift), variables,
                 "backbone/stage0_block1", "backbone.layers.0.blocks.1")
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **PART_TOL)


@pytest.mark.parametrize("hw", [(8, 12), (7, 12), (8, 11), (5, 3)])
def test_patch_merging_matches_jax(rng, hw):
    dim = 16
    x = rng.randn(2, *hw, dim).astype(np.float32)
    jmod = jswin.PatchMerging(dim)
    variables = _init_jax(jmod, rng, jnp.asarray(x))
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    ours = _load(swin.PatchMerging(dim), variables, "backbone/downsample1",
                 "backbone.layers.1.downsample")
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 2 * dim)
    np.testing.assert_allclose(got.numpy(), ref, **PART_TOL)


# -- the small backbone ------------------------------------------------------


@pytest.fixture(scope="module", params=[(7, False), (12, False), (7, True), (12, True)],
                ids=["w7", "w12", "w7-ape", "w12-ape"])
def backbone_outputs(request):
    window, ape = request.param
    rng = np.random.RandomState(3)
    x = rng.randn(2, 90, 118, 3).astype(np.float32)
    kw = dict(SMALL_KW, window=window, ape=ape, pretrain_img_size=64)
    jmod = jswin.SwinTransformer(**kw)
    variables = _init_jax(jmod, rng, jnp.asarray(x))
    ref = to_numpy_tree(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    ours = _load(swin.SwinTransformer(**kw), variables, "backbone", "backbone")
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ref, got, ours


@pytest.mark.parametrize("name", ["res2", "res3", "res4", "res5"])
def test_small_backbone_matches_jax(backbone_outputs, name):
    ref, got, _ = backbone_outputs
    want = ref[name].transpose(0, 3, 1, 2)
    assert got[name].shape == want.shape
    assert got[name].is_contiguous()
    np.testing.assert_allclose(got[name].numpy(), want, **BACKBONE_TOL)


def test_small_backbone_shapes(backbone_outputs):
    """23x30 patches, then 12x15, 6x8 and 3x4 (the merging pads odd sides)."""
    _, got, model = backbone_outputs
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "res2": (2, 32, 23, 30), "res3": (2, 64, 12, 15), "res4": (2, 128, 6, 8),
        "res5": (2, 256, 3, 4)}
    assert [len(stage.blocks) for stage in model.layers] == [2, 2, 3, 2]
    assert model.layers[3].downsample is None


def test_checkpointed_blocks_give_the_same_gradients(rng):
    """`use_checkpoint` recomputes each block in the backward: the outputs
    and every gradient equal the stored-activation path's."""
    kw = dict(embed_dim=16, depths=(2, 1), num_heads=(1, 2), window=4,
              out_features=("res2", "res3"))
    x = torch.from_numpy(rng.randn(1, 3, 40, 36).astype(np.float32))
    grads = []
    for ckpt in (False, True):
        model = swin.SwinTransformer(**kw, use_checkpoint=ckpt)
        init_parameters(model, torch.Generator().manual_seed(0))
        out = model(x)
        sum(v.square().sum() for v in out.values()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)


def test_drop_path_only_when_asked(rng):
    """DropPath is the identity unless the backbone is called with
    deterministic=False (which `MaskFormer` never does, as in JAX)."""
    model = swin.SwinTransformer(embed_dim=16, depths=(2, 2), num_heads=(1, 2), window=4,
                                 drop_path_rate=0.5, out_features=("res2", "res3")).train()
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(4, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        a, b = model(x)["res3"], model(x)["res3"]
        torch.manual_seed(7)
        dropped = model(x, deterministic=False)["res3"]
    assert torch.equal(a, b)
    assert not torch.allclose(a, dropped)
    assert [blk.drop_path.rate for stage in model.layers for blk in stage.blocks] == [
        0.0, 0.5 / 3, 1.0 / 3, 0.5]


def test_swin_variants_match_jax():
    assert swin.SWIN_VARIANTS == jswin.SWIN_VARIANTS


# -- presets and initialisation ------------------------------------------------


def test_every_swin_preset_builds():
    """The 36 Swin presets build a model in the port, with the pixel
    decoder's input projections sized from the embedding width."""
    names = [k for k in PRESETS if "swin" in k]
    assert len(names) == 36 and set(names) == {k for k in JAX_PRESETS if "swin" in k}
    for name in names:
        cfg = get_config(name).model
        with torch.device("meta"):
            model = MaskFormer(cfg)
        assert isinstance(model.backbone, swin.SwinTransformer), name
        ed = cfg.backbone.swin.embed_dim
        projs = model.sem_seg_head.pixel_decoder.input_proj
        assert sorted(p[0].in_channels for p in projs) == [2 * ed, 4 * ed, 8 * ed], name
        assert [len(s.blocks) for s in model.backbone.layers] == list(cfg.backbone.swin.depths)


def test_swin_initialisation_follows_jax():
    """The JAX initialisers: flax's truncated normal (std 0.02, cut at 2
    of its unit normal) for the bias tables and `absolute_pos_embed`,
    torch's Linear default for the Linear layers and the patch conv, zero
    biases, LayerNorms at 1 and 0."""
    cfg = get_config("coco_instance_swin_t", {"model.backbone.swin.ape": True}).model
    model = MaskFormer(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    bb = model.backbone
    cut = 2 * 0.02 / TRUNC_NORMAL_STD
    tables = torch.cat([blk.attn.relative_position_bias_table.flatten()
                        for s in bb.layers for blk in s.blocks])
    for t in (tables, bb.absolute_pos_embed.flatten()):
        assert t.abs().max() <= cut and t.abs().max() > 0.9 * cut
        assert abs(t.std().item() - 0.02) < 0.002
    for name, p in bb.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        elif ".norm" in name or name.startswith("norm"):
            assert torch.all(p == 1), name
        elif p.dim() >= 2 and "table" not in name and "pos_embed" not in name:
            fan_in = p[0].numel()
            bound = fan_in ** -0.5
            assert p.abs().max() <= bound and p.abs().max() > 0.95 * bound, name
