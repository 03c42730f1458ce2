"""The port's three profilers (`profile_forward`, `profile_kernel`,
`profile_criterion`) against the JAX package's tools of those names
(loaded from their paths under tools/): on the CPU at a smoke size (their
--batch / --size flags, which default to the JAX tools' sizes) each prints
the JAX tool's lines, in its order, after a first line saying that it runs
the plain versions on the CPU; its inputs are the JAX tool's where the JAX
tool draws them from a numpy seed; and without a card and without
--device cpu each raises (a non-zero exit from the command line). Times on
the CPU are host-clock times and are not checked."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.tools import profile_criterion, profile_forward, profile_kernel

ROOT = Path(__file__).resolve().parent.parent


def jax_printed_labels(name: str):
    """The leading words of each line the JAX tool prints (the f-strings of
    its `print` calls, up to their first placeholder), in its order."""
    tree = ast.parse((ROOT / "tools" / f"{name}.py").read_text())
    labels = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print":
            first = node.args[0]
            if isinstance(first, ast.JoinedStr):
                first = first.values[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                labels.append((node.lineno, first.value))
    return [s for _, s in sorted(labels) if not s.startswith("devices")]


def _lines_follow(out: str, labels):
    lines = out.splitlines()
    assert lines[0].endswith("the plain versions of the kernels; times are host-clock "
                             "times of the CPU, not of the card"), lines[0]
    it = iter(lines[1:])
    for label in labels:
        assert any(line.startswith(label) for line in it), (label, lines)


def test_profile_forward_smoke(capsys):
    res = profile_forward.main(["--device", "cpu", "--batch", "1", "--size", "64",
                                "--iters", "1"])
    _lines_follow(capsys.readouterr().out, jax_printed_labels("profile_forward"))
    assert set(res["ms"]) == {"full", "backbone", "pixel_decoder", "pixel_decoder_0",
                              "ms_deform_attn", "head"}
    # no K1 on the CPU: the plain version ran
    assert set(res["launches"].values()) == {0}
    value, shapes, loc, attn, out = res["raw_op"]
    assert value.dtype == torch.bfloat16 and shapes == ((8, 8), (4, 4), (2, 2))
    assert out.shape == (1, 84, 256) and torch.isfinite(out).all()


def test_profile_kernel_smoke(capsys):
    res = profile_kernel.main(["--device", "cpu", "--batch", "1", "--size", "64",
                               "--iters", "1"])
    out = capsys.readouterr().out
    _lines_follow(out, ["query tile: RUN=64", "full call:", "prep (layout, plan):",
                        "launch alone:", "launch alone bitwise the full call: True"])
    assert "(kWarpsPerBlock)" in out and res["bitwise"]
    assert res["ndesc"] == 1 * 84 * 8 * 3 * 4


def test_profile_criterion_inputs_are_the_jax_tools():
    """The JAX tool's draws (tools/profile_criterion.py :48-61), in order,
    from RandomState(0): the port's synthetic inputs are those arrays."""
    outputs, targets = profile_criterion.synthetic_inputs(64, 2, torch.device("cpu"))
    rng = np.random.RandomState(0)
    B, Q, h, w, G, K, L, Hg = 2, 100, 16, 16, 8, 80, 2, 64
    want = {"pred_logits": rng.randn(B, Q, K + 1), "pred_masks": rng.randn(B, Q, h, w),
            "aux_logits": rng.randn(L, B, Q, K + 1), "aux_masks": rng.randn(L, B, Q, h, w)}
    for k, v in want.items():
        np.testing.assert_array_equal(outputs[k].detach().numpy(), v.astype(np.float32))
        assert outputs[k].requires_grad
    np.testing.assert_array_equal(targets["labels"].numpy(), rng.randint(0, K, (B, G)))
    np.testing.assert_array_equal(targets["masks"].numpy(),
                                  (rng.rand(B, G, Hg, Hg) > 0.8).astype(np.float32))
    assert targets["valid"].all()


def test_profile_criterion_smoke(capsys, tmp_path):
    res = profile_criterion.main(["--device", "cpu", "--size", "64", "--layers", "2",
                                  "--iters", "1", "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    _lines_follow(out, ["first step", "criterion fwd+bwd:"])
    assert np.isfinite(res["loss"]) and res["ms"] > 0
    assert (tmp_path / "profile_criterion.pt.trace.json").stat().st_size > 0


@pytest.mark.parametrize("tool", [profile_forward, profile_kernel, profile_criterion])
def test_no_card_raises_without_device_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--iters", "1"])


def test_no_card_exits_non_zero_from_the_command_line():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "-m", "bm2f_tpu_torch.tools.profile_kernel"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
