"""The box matcher's pairwise cost: `csrc/pairwise_cost.cu` (through
`ops/pairwise_cost.py`) against its plain version `losses.weaksup.
log_same_sum`, and `weaksup_matcher_costs` on the card against the CPU.
On the CPU: the wrapper's refusals and the counters that
`train.pairwise_kernel_pct` reads. Imports no JAX, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pairwise_cost.py

Without a card the tests marked `cuda` skip (decided inside the test).

Tolerances, S and the costs against the plain path: rtol 1e-5, atol 1e-5.
Each lsp term is one exp and one log, each within an ulp or two of exact in
both versions, and every term has the same sign (a log-probability), so
sums in another order keep the terms' relative error.
"""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.losses import weaksup as tw
from bm2f_tpu_torch.losses.target_prep import build_weaksup_targets
from bm2f_tpu_torch.losses.weaksup_criterion import weaksup_matcher_costs
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import PAD_COST
from bm2f_tpu_torch.ops.pairwise_cost import log_same_sum_cuda, n_edges
from bm2f_tpu_torch.utils import tracing
from port_bench import manifest

RTOL, ATOL = 1e-5, 1e-5
THRESH = 0.3


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def logits(rng, Q, H, W, saturate=40.0):
    """Ordinary logits with a fifth at +saturate and a fifth at -saturate."""
    x = rng.randn(Q, H, W).astype(np.float32) * 3
    x[rng.rand(*x.shape) < 0.2] = saturate
    x[rng.rand(*x.shape) < 0.2] = -saturate
    return torch.from_numpy(x)


def similarity(rng, H, W, kernel_size, dilation):
    """The colour similarity of a blocky LAB image: edges inside a block
    pass the threshold, most across blocks do not."""
    lab = np.repeat(np.repeat(rng.rand(1, -(-H // 8), -(-W // 8), 3) * 100, 8, 1), 8, 2)
    lab = lab[:, :H, :W] + rng.randn(1, H, W, 3)
    return tw.get_images_color_similarity(torch.from_numpy(lab.astype(np.float32)),
                                          kernel_size, dilation)[0]


def boxes(rng, G, H, W, real):
    """(G, H, W): `real` random rectangles, one of them touching two
    borders, then empty slots, as the padded targets hold."""
    b = np.zeros((G, H, W), np.float32)
    b[0, : H // 2, W // 3:] = 1.0
    for g in range(1, real):
        y0, x0 = rng.randint(0, H - 1), rng.randint(0, W - 1)
        b[g, y0:y0 + rng.randint(1, H - y0), x0:x0 + rng.randint(1, W - x0)] = 1.0
    return torch.from_numpy(b)


def weak_batch(seed, B=2, Q=20, G=10, real=3, H=96, W=160):
    """Seeded matcher inputs: class logits, mask logits at stride 4 and the
    targets `build_weaksup_targets` makes of blocky images and rectangles."""
    rng = np.random.RandomState(seed)
    h, w = H // 4, W // 4
    images = np.repeat(np.repeat(rng.randint(0, 256, (B, H // 16, W // 16, 3)), 16, 1), 16, 2)
    images = np.clip(images + rng.uniform(-2, 2, images.shape), 0, 255).astype(np.float32)
    masks = torch.stack([boxes(rng, G, H, W, real) for _ in range(B)])
    valid = torch.zeros(B, G, dtype=torch.bool)
    valid[:, :real] = True
    labels = torch.from_numpy(rng.randint(0, 80, (B, G)))
    targets = build_weaksup_targets(torch.from_numpy(images), labels, masks, valid)
    pred_logits = torch.from_numpy(rng.randn(B, Q, 81).astype(np.float32))
    pred_masks = torch.stack([logits(rng, Q, h, w) for _ in range(B)])
    return pred_logits, pred_masks, targets


COST_KW = dict(cost_class=2.0, cost_projection=5.0, cost_pairwise=1.0, color_thresh=THRESH,
               kernel_size=3, dilation=2, warmup_factor=0.5)


# -- on the CPU --------------------------------------------------------------


def test_the_matcher_counts_its_pairwise_calls_and_no_kernel_on_the_cpu():
    """Every call counts "costs.pairwise_calls"; the CPU path launches no
    kernel, so `train.pairwise_kernel_pct` reads 0."""
    pred_logits, pred_masks, targets = weak_batch(0)
    with tracing.collect():
        with tracing.span("train.step"):
            weaksup_matcher_costs(pred_logits, pred_masks, targets, **COST_KW)
    counters = tracing.records()[-1]["counters"]
    assert counters["costs.pairwise_calls"] == 2
    assert "costs.pairwise_kernel" not in counters
    assert manifest.reader("train.pairwise_kernel_pct")({"kind": "train"}) == 0.0


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """Each refusal comes before any build, so it shows on the CPU too."""
    x = torch.zeros(2, 8, 8)
    cs = torch.zeros(8, 8, 8)
    with pytest.raises(TypeError):
        log_same_sum_cuda(x.double(), cs, THRESH, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        log_same_sum_cuda(x.transpose(1, 2), cs, THRESH, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        log_same_sum_cuda(x, cs, THRESH, 3, 2)
    assert n_edges(3) == 8 and n_edges(5) == 24 and n_edges(7) == 48


# -- on the card -------------------------------------------------------------


# (Q, H, W, kernel_size, dilation): the box cell's shape, one that is no
# multiple of the 16 x 32 tile, the other neighbourhoods
CARD_CASES = {
    "cell": (100, 216, 352, 3, 2),
    "ragged": (100, 213, 349, 3, 2),
    "k5_d2": (16, 213, 349, 5, 2),
    "k3_d1": (16, 45, 70, 3, 1),
    "inside_the_halo": (7, 3, 4, 3, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_plain_sums_and_costs(case):
    dev = require_cuda()
    Q, H, W, ks, dil = CARD_CASES[case]
    rng = np.random.RandomState(1)
    x = logits(rng, Q, H, W)
    cs = similarity(rng, H, W, ks, dil)
    box = boxes(rng, 100, H, W, 7) if min(H, W) > 4 else torch.ones(3, H, W)
    kw = dict(color_thresh=THRESH, kernel_size=ks, dilation=dil)
    want = tw.log_same_sum(x.to(dev), cs.to(dev), **kw)
    got = log_same_sum_cuda(x.to(dev), cs.to(dev), **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)

    n = log_same_sum_cuda.launches
    got_c = tw.pairwise_cost_matrix(x.to(dev), cs.to(dev), box.to(dev), warmup_factor=0.5,
                                    **kw)
    assert log_same_sum_cuda.launches == n + 1
    want_c = tw.pairwise_cost_matrix(x, cs, box, warmup_factor=0.5, **kw)
    torch.testing.assert_close(got_c.cpu(), want_c, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_two_launches_are_bitwise_equal():
    dev = require_cuda()
    rng = np.random.RandomState(2)
    x, cs = logits(rng, 100, 216, 352).to(dev), similarity(rng, 216, 352, 3, 2).to(dev)
    a = log_same_sum_cuda(x, cs, THRESH, 3, 2)
    b = log_same_sum_cuda(x, cs, THRESH, 3, 2)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_wrapper_refuses_a_wrong_dtype_or_layout_on_the_card():
    dev = require_cuda()
    x = torch.zeros(2, 8, 8, device=dev)
    cs = torch.zeros(8, 8, 8, device=dev)
    with pytest.raises(TypeError):
        log_same_sum_cuda(x.half(), cs, THRESH, 3, 2)
    with pytest.raises(TypeError):
        log_same_sum_cuda(x, cs.double(), THRESH, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        log_same_sum_cuda(x.transpose(1, 2), cs, THRESH, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        log_same_sum_cuda(x, cs.transpose(0, 1), THRESH, 3, 2)
    with pytest.raises(ValueError, match="similarity must be"):
        log_same_sum_cuda(x, cs[..., :7].contiguous(), THRESH, 3, 2)
    with pytest.raises(ValueError, match="kernel_size"):
        log_same_sum_cuda(x, torch.zeros(8, 8, 80, device=dev), THRESH, 9, 1)


@pytest.mark.cuda
def test_weaksup_matcher_costs_on_the_card_match_the_cpu():
    """The same PAD_COST slots, costs within the tolerance and the same
    assignment as on the CPU, for a seeded batch; every call launched the
    kernel."""
    dev = require_cuda()
    pred_logits, pred_masks, targets = weak_batch(3)
    want = weaksup_matcher_costs(pred_logits, pred_masks, targets, **COST_KW)
    with tracing.collect():
        with tracing.span("train.step", dev):
            got = weaksup_matcher_costs(pred_logits.to(dev), pred_masks.to(dev),
                                        {k: v.to(dev) for k, v in targets.items()},
                                        **COST_KW)
    counters = tracing.records()[-1]["counters"]
    assert counters["costs.pairwise_calls"] == counters["costs.pairwise_kernel"] == 2
    got = got.cpu()
    assert torch.equal(got == PAD_COST, want == PAD_COST)
    assert (want == PAD_COST).any() and (want != PAD_COST).any()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(assign(got), assign(want))
