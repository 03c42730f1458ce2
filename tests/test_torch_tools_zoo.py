"""`tools/zoo_parity` of the port against the JAX package's
(tools/zoo_parity.py, loaded from its path), mirroring
tests/test_eval_e2e.py::test_zoo_parity_runner_gate on a synthetic
COCO-format split registered on both sides. Its instances are the JAX
tool's own predictions from a set of JAX variables
(`data.synthetic.write_predicted_instances`), so the AP depends on the
weights: those variables score AP 100, the port's random init 41.18, and
a wrong load cannot pass as a right one.

- random weights against the zoo's AP 43.7 fail the gate, and a tolerance
  of 1000 passes it, through `zoo_parity` and through the CLI's exit code
  (0 only within tolerance; always 0 with --no-assert);
- the same JAX variables, saved by the JAX `Checkpointer` as an orbax
  directory, read by both tools (the port through `load_weights`): the
  metrics agree as tests/test_torch_eval_e2e.py holds `run_eval` (equal
  when no prediction moved; here a moved mask pixel leaves IoU far above
  the thresholds, and none moves), and the port's random init fails the
  gate at the AP they give;
- `ZOO_EXPECTED` is the JAX tool's table;
- without a card and without --device cpu the CLI raises.
"""

import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.data.datasets import register_all_builtin_datasets as jax_register
from bm2f_tpu.evaluation import coco_eval as jax_coco
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.synthetic import (
    STUFF,
    THINGS,
    write_predicted_instances,
    write_synthetic_coco,
)
from bm2f_tpu_torch.tools import zoo_parity as port_zoo
from torch_port_utils import to_numpy_tree

ROOT = Path(__file__).resolve().parent.parent
TINY = {"model.backbone.resnet.depth": 14, "model.decoder.dec_layers": 1,
        "model.decoder.num_queries": 8, "model.pixel_decoder.transformer_enc_layers": 1,
        "model.num_classes": THINGS + STUFF,
        "input.min_size_test": 64, "input.max_size_test": 128}
SIZES = ((128, 256), (256, 128), (128, 128))
DATASET = "coco_2017_val"


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_tool_zoo_parity",
                                                  ROOT / "tools" / "zoo_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def register(root):
    register_all_builtin_datasets(str(root), force=True)
    jax_register(str(root), force=True)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """An orbax directory of TINY variables (seeded noise on the init, so
    that the deformable sampling leaves its grid), and the split whose
    instances are the JAX tool's predictions from it, registered for both
    packages."""
    root = tmp_path_factory.mktemp("zoo")
    write_synthetic_coco(str(root / "data"), SIZES, seed=4)
    register(root / "data")
    jcfg = jax_get_config("coco_instance_r50", TINY)
    variables = to_numpy_tree(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.RandomState(0)
    variables = jax.tree.map(lambda x: (x + rng.randn(*x.shape) * 0.01).astype(x.dtype),
                             variables)
    JaxCheckpointer(str(root / "orbax")).save(3, variables, force=True)
    seen = []
    process = jax_coco.COCOMaskAPEvaluator.process

    def recorded(self, pred, gt):
        seen.append((pred["labels"], pred["masks"]))
        return process(self, pred, gt)

    with mock.patch.object(jax_coco.COCOMaskAPEvaluator, "process", recorded):
        jax_tool().zoo_parity("coco_instance_r50", DATASET, weights=str(root / "orbax"),
                              expected={}, cfg_overrides=TINY)
    write_predicted_instances(str(root / "pred"), str(root / "data"), seen, THINGS + STUFF)
    register(root / "pred")
    return root


def test_zoo_table_is_the_jax_tools():
    assert port_zoo.ZOO_EXPECTED == jax_tool().ZOO_EXPECTED


def test_random_weights_fail_the_gate_and_a_wide_tolerance_passes(split):
    res, ok = port_zoo.zoo_parity("coco_instance_r50", DATASET, weights="",
                                  expected={"AP": 43.7}, tolerance=0.3,
                                  cfg_overrides=TINY, device="cpu")
    assert "AP" in res and not ok  # random weights are nowhere near the zoo
    _, ok2 = port_zoo.zoo_parity("coco_instance_r50", DATASET, weights="",
                                 expected={"AP": 43.7}, tolerance=1000.0,
                                 cfg_overrides=TINY, device="cpu")
    assert ok2


def test_cli_exit_codes(split, capsys):
    argv = ["--config", "coco_instance_r50", "--dataset", DATASET, "--device", "cpu",
            "--weights", str(split / "orbax")] + [
        a for k, v in TINY.items() for a in ("--set", f"{k}={v!r}")]
    assert port_zoo.main(argv) == 1  # the zoo's 43.7 against random weights
    out = capsys.readouterr().out
    assert out.startswith("zoo_parity: device cpu, the plain versions")
    assert "verify_results FAIL: AP: expected 43.7" in out
    assert port_zoo.main(argv + ["--no-assert"]) == 0
    ap = eval(out.strip().splitlines()[-1])["AP"]
    assert port_zoo.main(argv + ["--expected", f"AP={ap}", "--tolerance", "0.01"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_zoo.main([a for a in argv if a not in ("--device", "cpu")])


def test_orbax_weights_read_by_both_tools_agree(split):
    mod = jax_tool()
    orbax = str(split / "orbax")
    ref, ref_ok = mod.zoo_parity("coco_instance_r50", DATASET, weights=orbax,
                                 expected={"AP": 90.0}, tolerance=10.0, do_assert=False,
                                 cfg_overrides=TINY)
    ours, ok = port_zoo.zoo_parity("coco_instance_r50", DATASET, weights=orbax,
                                   expected={"AP": 90.0}, tolerance=10.0,
                                   cfg_overrides=TINY, device="cpu")
    assert ref_ok, ref  # the variables that made the instances score high
    assert ours.keys() == ref.keys() and ok == ref_ok
    for k in ref:
        assert ours[k] == ref[k], (k, ours[k], ref[k])
    # other weights, the port's random init, fail the gate at that AP
    other, other_ok = port_zoo.zoo_parity("coco_instance_r50", DATASET, weights="",
                                          expected={"AP": ref["AP"]}, tolerance=0.3,
                                          cfg_overrides=TINY, device="cpu")
    assert not other_ok and other["AP"] < ref["AP"] - 25, (other, ref)
