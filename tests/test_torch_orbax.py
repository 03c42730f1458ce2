"""Weights from the JAX package into the port: a checkpoint written by the
JAX `Checkpointer` (orbax), holding a whole TrainState or bare variables, is
read without orbax (`bm2f_tpu_torch.utils.orbax`, tensorstore) into the
port's `state_dict` key for key and bitwise equal to what
`jax_variables_to_state_dict` gives from the variables in memory; the reader
names tensorstore when it is missing; `tools/convert_orbax` round-trips;
`Predictor.setup` and the eval load every kind of weights by what the path
holds and refuse anything else."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from bm2f_tpu.train.optim import make_optimizer
from bm2f_tpu.train.trainer import TrainState
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.tools import convert_orbax
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from bm2f_tpu_torch.utils import orbax
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict, load_weights
from torch_port_utils import SMALL, to_numpy_tree


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """The SMALL model's variables, and two JAX checkpoint directories: a
    TrainState (with AdamW moments) at step 7, bare variables at step 3."""
    jcfg = jax_get_config("coco_instance_r50", SMALL)
    model = jax_build_model(jcfg)
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3))))
    rng = np.random.RandomState(0)
    variables = jax.tree.map(lambda x: (x + rng.randn(*x.shape) * 0.01).astype(x.dtype),
                             variables)
    root = tmp_path_factory.mktemp("orbax")
    params = variables["params"]
    state = TrainState(step=jnp.int32(7), params=params, frozen=variables["frozen"],
                       opt_state=make_optimizer(jcfg.train.optimizer, params).init(params),
                       rng=jax.random.PRNGKey(3))
    JaxCheckpointer(str(root / "train_state")).save(7, state, force=True)
    JaxCheckpointer(str(root / "variables")).save(3, variables, force=True)
    return variables, root


@pytest.mark.parametrize("kind, step", [("train_state", 7), ("variables", 3)])
def test_orbax_checkpoint_reads_bitwise(jax_checkpoints, kind, step):
    variables, root = jax_checkpoints
    cfg = get_config("coco_instance_r50", SMALL)
    assert orbax.orbax_steps(root / kind) == [step]
    got = jax_variables_to_state_dict(orbax.read_orbax_variables(root / kind), cfg)
    want = jax_variables_to_state_dict(variables, cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    same = load_weights(str(root / kind), cfg)
    assert all(torch.equal(same[k], want[k]) for k in want)


def test_orbax_reader_names_tensorstore_when_missing(jax_checkpoints, monkeypatch):
    _, root = jax_checkpoints
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import raises
    with pytest.raises(ImportError, match="tensorstore.*convert_orbax"):
        orbax.read_orbax(root / "variables")


def test_convert_orbax_round_trips(jax_checkpoints, tmp_path):
    variables, root = jax_checkpoints
    set_args = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]
    assert convert_orbax.main([str(root / "train_state"), str(tmp_path / "port"),
                               *set_args]) == 0
    ckpt = Checkpointer(tmp_path / "port")
    assert ckpt.all_steps() == [7]
    cfg = get_config("coco_instance_r50", SMALL)
    want = jax_variables_to_state_dict(variables, cfg)
    got = load_weights(str(tmp_path / "port"), cfg)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert convert_orbax.main([str(tmp_path / "empty"), str(tmp_path / "x")]) == 2


@pytest.mark.parametrize("kind", ["orbax", "port_checkpoint", "pth", "trainer_checkpoint"])
def test_predictor_loads_every_kind_of_weights(jax_checkpoints, tmp_path, kind):
    """`Predictor.setup(weights=...)` gives the same model whatever holds
    the weights: the JAX orbax directory, its conversion, a .pth of the
    state_dict, and a trainer's checkpoint directory."""
    variables, root = jax_checkpoints
    cfg = get_config("coco_instance_r50", SMALL)
    want = jax_variables_to_state_dict(variables, cfg)
    if kind == "orbax":
        path = root / "train_state"
    elif kind == "port_checkpoint":
        path = tmp_path / "port"
        convert_orbax.convert(str(root / "variables"), str(path), cfg)
    elif kind == "pth":
        path = tmp_path / "model.pth"
        torch.save({"model": want}, path)
    else:
        from bm2f_tpu_torch.train.trainer import Trainer

        trainer = Trainer(cfg, device="cpu", seed=0)
        trainer.model.load_state_dict(want)
        path = tmp_path / "ckpt"
        Checkpointer(path).save(0, trainer)
    pred = Predictor()
    pred.setup("coco_instance_r50", str(path), device="cpu", overrides=SMALL)
    got = pred.model.state_dict()
    assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in want)


def test_unknown_weights_raise(tmp_path):
    cfg = get_config("coco_instance_r50", SMALL)
    (tmp_path / "empty").mkdir()
    for path in (tmp_path / "empty", tmp_path / "missing", tmp_path / "w.npz"):
        with pytest.raises(ValueError, match="holds no weights"):
            load_weights(str(path), cfg)


def test_eval_entry_point_loads_orbax_weights(jax_checkpoints, monkeypatch):
    """`python -m bm2f_tpu_torch.eval --weights ORBAX_DIR` evaluates the JAX
    checkpoint's weights, key for key bitwise."""
    from bm2f_tpu_torch import eval as port_eval

    variables, root = jax_checkpoints
    want = jax_variables_to_state_dict(variables, get_config("coco_instance_r50", SMALL))
    seen = {}
    monkeypatch.setattr(port_eval, "run_eval",
                        lambda cfg, model, *a, **k: seen.setdefault("model", model))
    port_eval.main(["--config", "coco_instance_r50", "--dataset", "any", "--device", "cpu",
                    "--weights", str(root / "train_state"),
                    *[a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]])
    got = seen["model"].state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
