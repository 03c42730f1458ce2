"""The port on the card: its hand-written CUDA kernels against their plain
PyTorch versions, and the full-width R50 Mask2Former on the card against the
from-scratch torch reference forward of tests/torch_oracle.py (run on the
CPU) on one detectron2-named state dict. Imports no JAX, so that it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (decided inside the test, never at import).
"""

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.ops import ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain
from bm2f_tpu_torch.utils.convert_weights import load_d2_state_dict
from torch_oracle import make_r50_m2f_state_dict, torch_mask2former_forward

# (B, M, D, P, Q, spatial shapes): ordinary levels, levels of height 1 and
# width 1, a 1x1 level, D over one warp, Q not a power of two
CASES = [
    (1, 2, 32, 4, 20, ((8, 8), (4, 4))),
    (2, 2, 32, 3, 29, ((1, 7), (5, 1), (4, 6))),
    (1, 8, 64, 4, 333, ((1, 1), (3, 9), (16, 12))),
]


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ms_deform_attn_kernel_matches_plain(case):
    dev = require_cuda()
    B, M, D, P, Q, shapes = case
    rng = np.random.RandomState(0)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(dev)
    loc = torch.from_numpy(
        (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)).to(dev)
    attn = torch.from_numpy(
        (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)).to(dev)
    before = ms_deform_attn_cuda.launches
    got = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 1
    want = ms_deform_attn_plain(value, shapes, loc, attn)
    # f32, at most 4*L*P weighted terms summed in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ms_deform_attn_kernel_rejects_what_it_does_not_take():
    dev = require_cuda()
    shapes = ((4, 4),)
    value = torch.zeros(1, 16, 2, 16, device=dev)  # D = 16: not a warp multiple
    loc = torch.zeros(1, 3, 2, 1, 4, 2, device=dev)
    attn = torch.zeros(1, 3, 2, 1, 4, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        ms_deform_attn(value, shapes, loc, attn)
    with pytest.raises(TypeError, match="float32"):
        ms_deform_attn(torch.zeros(1, 16, 2, 32, device=dev, dtype=torch.float64),
                       shapes, loc, attn)


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_full_r50_on_card_matches_torch_oracle(no_tf32):
    """coco_instance_r50 at full width (d2 weights through
    `load_d2_state_dict`, K1 in every encoder layer) against the reference
    forward; tolerances of tests/test_full_model_golden.py:58-75."""
    dev = require_cuda()
    rng = np.random.RandomState(3)
    sd = make_r50_m2f_state_dict(rng, 80, 100)
    images = rng.randn(2, 96, 128, 3).astype(np.float32)  # already normalized
    with torch.no_grad():
        ref = torch_mask2former_forward(
            sd, torch.from_numpy(images.transpose(0, 3, 1, 2)).contiguous(), 80, 100)
        model = build_model(get_config("coco_instance_r50"), device=dev)
        model.load_state_dict(load_d2_state_dict(sd), strict=True)
        before = ms_deform_attn_cuda.launches
        ours = model(torch.from_numpy(images).to(dev))
        torch.cuda.synchronize()
    assert ms_deform_attn_cuda.launches == before + 6
    for key, atol in (("pred_logits", 1e-3), ("pred_masks", 1.5e-3),
                      ("aux_logits", 1e-3), ("aux_masks", 1.5e-3)):
        np.testing.assert_allclose(ours[key].cpu().numpy(), ref[key].numpy(),
                                   rtol=1e-3, atol=atol, err_msg=key)
