"""The span and counters of Swin's window attention (`models/swin.py`):
"swin.window_attn" once a block under the open root, and the counters
"swin.attn_flops" and "swin.attn_bytes" equal to the padded windows' shape
arithmetic, counted here from the image size alone; with tracing off no
root and no counter, and outputs bitwise those of tracing on.

The small backbone: embed 32, depths (2, 2, 2, 2), heads (1, 2, 4, 8),
window 4. Its input (2, 3, 100, 140) pads at every stage: the patch grid
25x35 to 28x36, then 13x18 to 16x20, 7x9 to 8x12 and 4x5 to 4x8; every
odd block shifts over more than one window."""

from __future__ import annotations

import math

import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import swin
from bm2f_tpu_torch.models.maskformer import MaskFormer
from bm2f_tpu_torch.utils import tracing

SMALL_KW = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window=4)
SIZE = (2, 3, 100, 140)


def expected(size, embed, depths, window, patch=4, element=4):
    """(flops, bytes, windows of each block) from the image size: each
    stage's token grid (the patch grid, then halved rounding up), padded to
    the window; a block's attention does 4 nW N^2 C FLOPs and moves 4 nW N C
    elements (q, k, v read, the output written)."""
    B, _, H, W = size
    h, w = math.ceil(H / patch), math.ceil(W / patch)
    N = window * window
    flops = nbytes = 0
    windows = []
    for s, depth in enumerate(depths):
        C = embed * 2 ** s
        nW = B * math.ceil(h / window) * math.ceil(w / window)
        windows += [nW] * depth
        flops += depth * 4 * nW * N * N * C
        nbytes += depth * 4 * nW * N * C * element
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return flops, nbytes, windows


def small_swin(dtype=torch.float32):
    torch.manual_seed(0)
    m = swin.SwinTransformer(**SMALL_KW, dtype=dtype).eval()
    with torch.no_grad():
        for blk in (b for st in m.layers for b in st.blocks):
            blk.attn.relative_position_bias_table.normal_(0, 0.05)
    return m


def image():
    return torch.randn(*SIZE, generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_span_a_block_and_counters_equal_the_shape_arithmetic(dtype):
    m, x = small_swin(dtype), image()
    with torch.no_grad(), tracing.collect():
        with tracing.span("root", "cpu"):
            m(x)
    root = tracing.records()[-1]
    assert root["name"] == "root"
    attn = [s for s in root["spans"] if s["name"] == "swin.window_attn"]
    assert len(attn) == sum(SMALL_KW["depths"]) == 8
    assert all(s["parent"] == 0 for s in attn)  # under the open root, one a call
    flops, nbytes, windows = expected(SIZE, 32, SMALL_KW["depths"], 4,
                                      element=torch.empty((), dtype=dtype).element_size())
    assert root["counters"] == {"swin.attn_flops": flops, "swin.attn_bytes": nbytes}
    assert all(isinstance(v, int) for v in root["counters"].values())
    assert windows == [2 * 7 * 9] * 2 + [2 * 4 * 5] * 2 + [2 * 2 * 3] * 2 + [2 * 1 * 2] * 2


def test_spans_nest_under_the_backbone_of_a_model():
    cfg = get_config("coco_instance_swin_t", {
        "model.backbone.swin.embed_dim": 32, "model.backbone.swin.depths": (2, 2, 2, 2),
        "model.backbone.swin.num_heads": (1, 2, 4, 8), "model.backbone.swin.window_size": 4,
        "model.pixel_decoder.conv_dim": 32, "model.pixel_decoder.mask_dim": 32,
        "model.pixel_decoder.transformer_enc_layers": 1,
        "model.pixel_decoder.transformer_dim_feedforward": 64, "model.decoder.hidden_dim": 32,
        "model.decoder.mask_dim": 32, "model.decoder.dim_feedforward": 64,
        "model.decoder.dec_layers": 2, "model.decoder.num_queries": 6})
    torch.manual_seed(0)
    m = MaskFormer(cfg.model).eval()
    x = torch.randn(1, 96, 160, 3, generator=torch.Generator().manual_seed(2))  # NHWC
    with torch.no_grad(), tracing.collect():
        with tracing.span("root", "cpu"):
            m(x)
    root = tracing.records()[-1]
    backbone = [i for i, s in enumerate(root["spans"]) if s["name"] == "net.backbone"]
    assert len(backbone) == 1
    attn = [s for s in root["spans"] if s["name"] == "swin.window_attn"]
    assert len(attn) == 8 and {s["parent"] for s in attn} == set(backbone)
    flops, nbytes, _ = expected((1, 3, 96, 160), 32, (2, 2, 2, 2), 4)
    assert root["counters"]["swin.attn_flops"] == flops
    assert root["counters"]["swin.attn_bytes"] == nbytes


def test_without_an_open_root_each_span_holds_its_own_counts():
    m, x = small_swin(), image()
    with torch.no_grad(), tracing.collect():
        m(x)
    roots = tracing.records()[-8:]
    assert [r["name"] for r in roots] == ["swin.window_attn"] * 8
    flops, nbytes, _ = expected(SIZE, 32, SMALL_KW["depths"], 4)
    assert sum(r["counters"]["swin.attn_flops"] for r in roots) == flops
    assert sum(r["counters"]["swin.attn_bytes"] for r in roots) == nbytes


def test_off_no_root_no_counter_and_the_same_bits():
    m, x = small_swin(), image()
    last = lambda: [r["id"] for r in tracing.records()][-1:]
    before = last()
    with torch.no_grad():
        off = m(x)
    assert not tracing.enabled() and last() == before
    with torch.no_grad(), tracing.collect():
        with tracing.span("root", "cpu"):
            on = m(x)
    assert last() != before and tracing.records()[-1]["name"] == "root"
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_a_span_per_block_and_call_in_training():
    """The backward replays no span: the forward's attention is timed once."""
    m, x = small_swin(), image()
    m.train()
    with tracing.collect():
        with tracing.span("root", "cpu"):
            out = m(x)
            sum(v.float().square().mean() for v in out.values()).backward()
    root = tracing.records()[-1]
    assert sum(s["name"] == "swin.window_attn" for s in root["spans"]) == 8
    assert root["counters"]["swin.attn_flops"] == expected(SIZE, 32, (2, 2, 2, 2), 4)[0]
