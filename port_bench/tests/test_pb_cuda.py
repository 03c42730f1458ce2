"""On the card (each test decides inside whether one is there, and skips
without): the controls at each cell's own size, on three seeds. The
reference in the precision below each configuration's, put in the
program's place, comes out not correct under the cell's limits (the
whole step in fp8 for the bf16 train cells, TF32 products for the f32 served cell),
and the program itself correct. `python3 -m port_bench.calibrate` takes the
same readings on more seeds. About three minutes on an H100."""

import pytest
import torch

from port_bench import calibrate, check, harness, manifest

SEEDS = (2 ** 34 + 1, 2 ** 34 + 2, 2 ** 34 + 3)


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r50_train_mask", "boxsup_train", "r50_serve"])
def test_control_is_not_correct_on_the_card(workload):
    require_cuda()
    c = manifest.cell(workload)
    for seed in SEEDS:
        drv = harness.DRIVERS[c.mix["driver"]](c, seed, "cuda")
        fn = calibrate.train_readings if c.mix["driver"] == "train" else calibrate.serve_readings
        readings = dict(fn(drv, True))
        control = next(v for k, v in readings.items() if k.startswith("control_"))
        ok, rows = check.judge(control, c.limits)
        assert not ok, ("control", seed, rows)
        ok, rows = check.judge(readings["program"], c.limits)
        assert ok, ("program", seed, rows)
        del drv
        harness.free("cuda")


@pytest.mark.cuda
def test_fp8_scope_rounds_the_backward_on_the_card():
    """The autograd engine runs a card's backward on a thread of its own;
    the fp8 control's rounding reaches it there too."""
    require_cuda()
    from port_bench.reference.numerics import Numerics, fp8

    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(64, 32, generator=g, device="cuda")
    w = torch.randn(32, 8, generator=g, device="cuda", requires_grad=True)
    with Numerics("fp8").scope():
        y = (x @ w).sigmoid()
        (gw,) = torch.autograd.grad(y.square().sum(), [w])
    for t in (y.detach(), gw):
        assert torch.equal(fp8(t), t)
    assert not torch.equal(fp8(x), x)  # the rounding does bite
