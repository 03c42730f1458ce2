"""Data parallelism of the port, its process model on the CPU: `parallel/`
without a group and as one of two ranks, the writers off rank 0, every
parameter of the other models getting a gradient (DDP without
`find_unused_parameters`), and the per-rank batches (the entry point's
loader against the JAX package's per-host loaders, the synthetic loader
sliced, a batch the ranks do not divide). The entry point under
`torch.distributed.run` is tests/test_torch_ddp_entry.py."""

import numpy as np
import pytest
import torch

from bm2f_tpu.config import InputConfig as JaxInputConfig
from bm2f_tpu.data import loader as jax_loader
from bm2f_tpu.data import mappers as jax_mappers
from bm2f_tpu.data.datasets import register_all_builtin_datasets as jax_register
from bm2f_tpu_torch import parallel
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.synthetic import write_synthetic_coco
from bm2f_tpu_torch.parallel import mesh
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.train.loop import synthetic_loader
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils import events
from test_torch_train_data import SIZES, TINY
from test_torch_v1 import TINY_V1
from torch_port_utils import SMALL, SMALL_SWIN
from torch_ddp_cases import free_port
CONFIG = "coco_instance_r50"


def _sets(over):
    return [a for k, v in over.items() for a in ("--set", f"{k}={v!r}")]


def _two_ranks(monkeypatch, r):
    """`parallel` as rank r of 2, without a group."""
    monkeypatch.setattr(mesh, "rank", lambda: r)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)


# -- parallel/ --------------------------------------------------------------------------


def test_without_a_group_every_function_is_the_one_process_identity():
    t = torch.arange(6.0).reshape(3, 2)
    assert parallel.rank() == 0 and parallel.world_size() == 1
    assert parallel.global_sum(t) is t
    assert parallel.local_rows(t) is not None and torch.equal(parallel.local_rows(t), t)
    parallel.barrier()


def test_local_rows_takes_the_rank_s_contiguous_block(monkeypatch):
    """JAX's `shard_batch` places rows [r k, (r+1) k) on rank r of the data
    axis; a batch the ranks do not divide raises."""
    batch = {"a": np.arange(8).reshape(4, 2), "b": torch.arange(12).reshape(3, 4).T}
    for r in (0, 1):
        _two_ranks(monkeypatch, r)
        got = parallel.local_rows(batch)
        np.testing.assert_array_equal(got["a"], batch["a"][2 * r:2 * r + 2])
        assert torch.equal(got["b"], batch["b"][2 * r:2 * r + 2])
        assert torch.equal(parallel.local_rows(torch.arange(8).reshape(2, 4), axis=1),
                           torch.arange(8).reshape(2, 4)[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="does not divide"):
        parallel.local_rows(np.zeros((3, 1)))


def test_init_distributed_names_what_is_missing_and_never_falls_back(monkeypatch):
    for k in mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        parallel.init_distributed("cpu")
    for k, v in zip(mesh.LAUNCH_ENV, ("0", "1", "0", "127.0.0.1", str(free_port()))):
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():
        # on the card NCCL; here no card, and no gloo in its place
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.init_distributed("cuda")
    with pytest.raises(ValueError, match="cuda \\(NCCL\\) or cpu \\(gloo\\)"):
        parallel.init_distributed("meta")
    assert not torch.distributed.is_initialized()


def test_tensor_parallelism_raises_citing_item_20():
    """ROADMAP item 20, tensor parallelism, is ported: `mesh.model` 2 no
    longer refuses as unported (the refusal cited item 20). Without a group
    of ranks it divides it raises naming the mesh and the world
    (tests/test_torch_tp*.py train it)."""
    cfg = get_config(CONFIG, {**TINY, "mesh.model": 2})
    with pytest.raises(ValueError, match="mesh.model=2 does not divide the world of 1") as e:
        Trainer(cfg, device="cpu")
    assert "item 20" not in str(e.value)


def test_writers_do_nothing_off_rank_0(monkeypatch, tmp_path, capsys):
    """Off rank 0 no writer opens a file or prints (several ranks appending
    to one metrics.json would interleave their lines)."""
    monkeypatch.setattr(events, "rank", lambda: 1)
    storage = events.EventStorage()
    storage.put_scalars(1, total_loss=1.0)
    writers = [events.ConsoleWriter(1), events.JSONWriter(str(tmp_path / "m.json"), 1),
               events.TensorBoardWriter(str(tmp_path / "tb"), 1), events.WandBWriter()]
    for w in writers:
        w.write(storage, force=True)
    assert not list(tmp_path.iterdir()) and capsys.readouterr().out == ""


def _clip_batch(B=1, T=2, size=64, G=3, seed=0):
    rng = np.random.RandomState(seed)
    valid = np.ones((B, G), bool)
    valid[0, -1] = False
    return {"images": torch.from_numpy(rng.rand(B, T, size, size, 3).astype(np.float32) * 255),
            "labels": torch.from_numpy(rng.randint(0, 40, (B, G))),
            "masks": torch.from_numpy((rng.rand(B, G, T, size, size) > 0.7).astype(np.float32)),
            "valid": torch.from_numpy(valid)}


@pytest.mark.parametrize("preset,over", [
    ("coco_instance_r50", {**TINY_V1, "model.pixel_decoder.name": "fpn",
                           "model.decoder.name": "multi_scale_masked"}),
    ("coco_instance_r50", {**TINY_V1, "model.pixel_decoder.name": "transformer_fpn",
                           "model.decoder.name": "standard"}),
    ("coco_instance_swin_t", {**SMALL_SWIN, "model.decoder.dec_layers": 2}),
    ("ytvis2021_video_r50", {**SMALL, "model.decoder.dec_layers": 2}),
], ids=["v1_fpn_masked", "v1_transformer_fpn_standard", "swin", "video"])
def test_every_parameter_gets_a_gradient(preset, over):
    """DDP without `find_unused_parameters` needs a gradient for every
    parameter in every step: the MaskFormer-v1, Swin and video models (the
    image mask, box and temporal steps are held in the two-rank tests)."""
    cfg = get_config(preset, {**over, "model.loss.train_num_points": 64})
    trainer = Trainer(cfg, device="cpu")
    if cfg.task == "video":
        batch = _clip_batch()
    else:
        batch = synthetic_batch(1, 64, 3, seed=0, num_classes=cfg.model.num_classes,
                                device="cpu")
    trainer.step(batch)
    missing = [n for n, p in trainer.model.named_parameters() if p.grad is None]
    assert not missing, missing[:8]


# -- the per-rank batches -----------------------------------------------------------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    write_synthetic_coco(str(root), sizes=SIZES, seed=1)
    register_all_builtin_datasets(str(root), force=True)
    jax_register(str(root), force=True)
    return root


class _Args:
    synthetic = False
    dataset = "coco_2017_val"


def test_entry_point_loaders_are_the_jax_per_host_loaders(data_root, monkeypatch):
    """The entry point's loader on each of 2 ranks takes ims_per_batch / 2
    images a step, bitwise the JAX package's per-host loader of that rank
    (root train.py:206-213); the two ranks' images together are 4 images."""
    cfg = get_config(CONFIG, {**TINY, "train.ims_per_batch": 4, "input.max_instances": 4})
    jcfg = JaxInputConfig(**{k.split(".", 1)[1]: v for k, v in TINY.items()
                             if k.startswith("input.")} | {"max_instances": 4})
    for r in (0, 1):
        monkeypatch.setattr(train_main, "rank", lambda: r)
        monkeypatch.setattr(train_main, "world_size", lambda: 2)
        ours = train_main.train_loader(cfg, _Args, 0)
        ref = jax_loader.build_train_loader(
            "coco_2017_val", jax_mappers.MAPPERS[cfg.input.dataset_mapper](jcfg, seed=0), 2,
            seed=cfg.train.seed, rank=r, world_size=2)
        for _ in range(2):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys() and a["images"].shape[0] == 2
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_synthetic_loader_ranks_read_what_one_process_reads(monkeypatch):
    one = synthetic_loader(4, 32, 3, seed=7, start=2)
    want = [next(one) for _ in range(2)]
    got = []
    for r in (0, 1):
        _two_ranks(monkeypatch, r)
        it = synthetic_loader(4, 32, 3, seed=7, start=2)
        got.append([next(it) for _ in range(2)])
    for i in range(2):
        for k, v in want[i].items():
            np.testing.assert_array_equal(np.concatenate([got[0][i][k], got[1][i][k]]), v)


def test_entry_point_refuses_a_batch_the_world_does_not_divide(monkeypatch, tmp_path):
    monkeypatch.setattr(train_main, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        train_main.main(["--device", "cpu", "--synthetic", "--batch", "2", "--max-iter", "1",
                         "--output", str(tmp_path)] + _sets(TINY))

