"""Training on a registered dataset, with evaluation during training, on the
CPU: `python -m bm2f_tpu_torch.train --dataset --eval-dataset` on a tiny
synthetic COCO split (`data/synthetic.py`) through the config's mapper and
`build_train_loader`; the eval's metrics in metrics.json at their
iteration; an eval mid-run leaving the training state bitwise as it was;
`--eval-only`; and which presets `Trainer` takes.

A tiny model (depth-14 ResNet, 2 encoder and 2 decoder layers, 10 queries)
on 64x96 crops, so that a step takes well under a second."""

import json

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.data import build_train_loader
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.mappers import MAPPERS
from bm2f_tpu_torch.data.synthetic import write_synthetic_coco
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from bm2f_tpu_torch.train.loop import run_train_loop
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils import events
from torch_port_utils import SMALL

WEAK = "coco_instance_r50_wo_lsj_projpair"
TINY = {**SMALL, "model.decoder.dec_layers": 2, "model.loss.train_num_points": 128,
        "input.image_size": 64, "input.crop_width": 96, "input.short_edge_choices": (64,),
        "input.max_size_train": 128, "input.min_size_test": 64, "input.max_size_test": 96,
        "input.max_instances": 8, "train.ims_per_batch": 2,
        "model.loss.weak.pairwise.warmup_iters": 1,
        "model.loss.weak.mask_update_enabled": True}
SIZES = ((48, 64), (64, 48), (56, 72))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    write_synthetic_coco(str(root), sizes=SIZES, seed=1)
    register_all_builtin_datasets(str(root), force=True)
    return root


def _state(trainer):
    """Every tensor of `Trainer.state_dict()`, flattened by key."""
    sd = trainer.state_dict()
    flat = {f"model.{k}": v for k, v in sd["model"].items()}
    for m in ("mu", "nu"):
        flat.update({f"{m}.{k}": v for k, v in sd["optimizer"][m].items()})
    flat["generator"] = sd["generator"]
    return sd["step"], sd["optimizer"]["count"], flat


@pytest.mark.parametrize("preset", ["coco_instance_r50_wo_lsj", WEAK])
def test_eval_mid_run_leaves_the_training_state_bitwise(preset, data_root, tmp_path):
    """3 steps on the dataset's batches with an eval at 1 and 2, against 3
    steps without, mask-supervised (the criterion draws its points from the
    trainer's generator) and weak: the whole state is bitwise equal, the
    model is back in train mode, and the eval's metrics are in the storage
    as eval/<key>."""
    cfg = get_config(preset, {**TINY, "train.eval_period": 1, "train.optimizer.max_iter": 3})
    res = {}
    for eval_dataset in ("coco_2017_val", ""):
        trainer = Trainer(cfg, device="cpu", seed=3)
        mapper = MAPPERS[cfg.input.dataset_mapper](cfg.input, seed=cfg.train.seed)
        loader = build_train_loader("coco_2017_val", mapper, cfg.train.ims_per_batch,
                                    seed=cfg.train.seed)
        storage = events.EventStorage()
        it = run_train_loop(cfg, trainer, loader, next(loader),
                            Checkpointer(str(tmp_path / (eval_dataset or "none"))),
                            storage, [], eval_dataset=eval_dataset)
        assert it == 3 and trainer.model.training
        res[eval_dataset] = (_state(trainer), storage)
    (step_a, count_a, a), storage_a = res["coco_2017_val"]
    (step_b, count_b, b), storage_b = res[""]
    assert step_a == step_b == count_a == count_b == 3
    assert a.keys() == b.keys()
    differing = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differing, differing[:8]
    evals = [k for k in storage_a.latest() if k.startswith("eval/")]
    assert "eval/AP" in evals and not any(k.startswith("eval/") for k in storage_b.latest())
    assert len(storage_a._hist["eval/AP"]) == 2  # at iterations 1 and 2, not 3


def test_entry_point_trains_on_a_dataset_and_evaluates(data_root, tmp_path, capsys):
    """`python -m bm2f_tpu_torch.train --dataset coco_2017_val --eval-dataset
    coco_2017_val --max-iter 2` with an eval every step: the loss scalars
    and eval/ metrics in metrics.json at iteration 1 (log_period 20: the
    eval's line is forced), checkpoints at 1 and 2; then `--eval-only
    --resume` on the checkpoint at 2 prints its metrics."""
    args = ["--config", WEAK, "--device", "cpu", "--dataset", "coco_2017_val",
            "--data-root", str(data_root), "--output", str(tmp_path)]
    for k, v in {**TINY, "train.eval_period": 1, "train.checkpoint_period": 1}.items():
        args += ["--set", f"{k}={v!r}"]
    assert train_main.main(args + ["--eval-dataset", "coco_2017_val", "--max-iter", "2"]) == 0
    assert "training done at iter 2" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path / "checkpoints")).all_steps() == [1, 2]
    lines = [json.loads(ln) for ln in (tmp_path / "metrics.json").read_text().splitlines()]
    assert [ln["iteration"] for ln in lines] == [1]
    keys = set(lines[0])
    assert {"eval/AP", "eval/AP50", "total_loss", "loss_mask_projection", "loss_pairwise",
            "loss_ce", "grad_norm", "lr"} <= keys
    assert all(np.isfinite(v) for v in lines[0].values())

    assert train_main.main(args + ["--eval-only", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    rec = json.loads(next(ln for ln in out.splitlines() if ln.startswith("eval "))[5:])
    assert rec["iteration"] == 2 and "eval/AP" in rec


@pytest.mark.parametrize("preset", ["coco_instance_r50_proj", "coco_instance_r50_wo_lsj_proj",
                                    WEAK])
def test_trainer_takes_the_image_weak_presets(preset):
    """One step of each image weak preset (SMALL, 64x64): finite losses
    under the names of its sup_type, the pairwise one only with pairs."""
    trainer = Trainer(get_config(preset, {**SMALL, "model.decoder.dec_layers": 2}),
                      device="cpu")
    metrics = trainer.step(synthetic_batch(2, 64, 3, seed=0, device="cpu"))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert "loss_mask_projection" in metrics and "loss_mask" not in metrics
    assert ("loss_pairwise" in metrics) == preset.endswith("projpair")


@pytest.mark.parametrize("preset", ["ytvis2021_video_r50_proj",
                                    "ytvis2021_video_r50_proj_spatpair_temppair"])
def test_trainer_refuses_video_weak_types(preset):
    """The video weak presets train (the video model and criterion,
    tests/test_torch_weaksup_video.py); on an image task a video-only
    sup_type is refused."""
    over = {**SMALL, "model.decoder.dec_layers": 2}
    trainer = Trainer(get_config(preset, over), device="cpu")
    assert trainer.video and trainer.model.sem_seg_head.predictor.__class__.__name__ == \
        "VideoMultiScaleMaskedTransformerDecoder"
    cfg = get_config("coco_instance_r50",
                     {"model.loss.sup_type": get_config(preset).model.loss.sup_type})
    if cfg.model.loss.sup_type != "mask_projection":
        with pytest.raises(ValueError, match="sup_type .* for task 'instance'"):
            Trainer(cfg, device="cpu")
