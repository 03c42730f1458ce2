"""The port's YouTube-VIS data layer, track-AP evaluator, video eval and
video training entry point against the JAX package's, on a seeded synthetic
split (`data.synthetic.write_synthetic_ytvis`: moving objects, per-frame
RLE with null where an object is absent, a crowd track a video):

- `load_ytvis_json` and the three video mappers (`ytvis`,
  `ytvis_with_feats` with its DINO grids resized to the patch grid,
  `coco_clip`) against the JAX package's with the same seed: bitwise, the
  resized features within 1e-6 (the same bilinear weights; the port's
  resize and JAX's sum the two taps in another order);
- `YTVISEvaluator` and `_track_area`: bitwise, and the ground truth as
  predictions scoring 100;
- `run_video_eval` of a tiny model against root `eval_video.run_video_eval`
  on shared weights, as tests/test_torch_eval_e2e.py holds the image eval:
  the same tracks (labels equal, scores within the forward's error, mask
  pixels equal except where the port's logit lies within that error of the
  threshold) and, when no pixel moved, the same metrics;
- `python -m bm2f_tpu_torch.train` training a video preset 2 steps with an
  eval and a checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import eval_video as jax_eval_video
from bm2f_tpu.config import InputConfig as JaxInputConfig
from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.data import DatasetCatalog as JaxDatasetCatalog
from bm2f_tpu.data import ytvis as jax_ytvis
from bm2f_tpu.data.mappers import MAPPERS as JAX_MAPPERS
from bm2f_tpu.evaluation import ytvis_eval as jax_ytvis_eval
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu_torch import eval as port_eval
from bm2f_tpu_torch import eval_video
from bm2f_tpu_torch.config import InputConfig, get_config
from bm2f_tpu_torch.data import DatasetCatalog
from bm2f_tpu_torch.data import ytvis
from bm2f_tpu_torch.data.mappers import MAPPERS
from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
from bm2f_tpu_torch.data.synthetic import write_synthetic_ytvis
from bm2f_tpu_torch.evaluation import ytvis_eval
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.video import build_video_model
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from test_torch_data import _instance_dict, same_tree
from torch_port_utils import SMALL, to_numpy_tree

FRAME_HW, LENGTHS, FEAT_GRID = (64, 96), (3, 5), (5, 7)
TINY = {**SMALL, "model.decoder.dec_layers": 2}
# the eval: short edge 32 (frames 32x48), one spatial bucket of 64
EVAL = dict(short_edge=32, max_size=64, bucket=64)
NAME = "synthetic_ytvis_val"


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The val split (registered as NAME in both packages) and a train split
    with DINO grids, under one root."""
    root = str(tmp_path_factory.mktemp("synthetic_ytvis"))
    write_synthetic_ytvis(root, "ytvis_2019_val", LENGTHS, FRAME_HW, seed=3)
    feats_root = write_synthetic_ytvis(root, "ytvis_2021_train", (4, 6), FRAME_HW, seed=4,
                                       feats=True, feat_grid=FEAT_GRID)
    json_file, frames = (f"{root}/{p}" for p in ytvis.YTVIS_SPLITS["ytvis_2019_val"])
    for catalog, register in ((DatasetCatalog, ytvis.register_ytvis_instances),
                              (JaxDatasetCatalog, jax_ytvis.register_ytvis_instances)):
        if NAME in catalog:
            catalog.remove(NAME)
        register(NAME, json_file, frames)
    return root, feats_root


def test_load_ytvis_json_matches_jax(split):
    root, _ = split
    for name in ("ytvis_2019_val", "ytvis_2021_train"):
        json_file, frames = (f"{root}/{p}" for p in ytvis.YTVIS_SPLITS[name])
        ours = ytvis.load_ytvis_json(json_file, frames)
        same_tree(ours, jax_ytvis.load_ytvis_json(json_file, frames))
    # a crowd track and absent frames are in the split
    anns = [a for dd in ours for a in dd["annotations"]]
    assert any(a["iscrowd"] for a in anns)
    assert any(s is None for a in anns for s in a["segmentations"])


@pytest.mark.parametrize("name", ["ytvis", "ytvis_with_feats"])
def test_video_mappers_match_jax(split, name):
    root, feats_root = split
    json_file, frames = (f"{root}/{p}" for p in ytvis.YTVIS_SPLITS["ytvis_2021_train"])
    dicts = ytvis.load_ytvis_json(json_file, frames)
    kw = dict(image_size=64, max_instances=5, sampling_frame_num=3)
    # short edges near the frames' own 64, so that the 64x64 crop holds objects
    extra = {"short_edge_choices": (64, 80)}
    if name == "ytvis_with_feats":
        extra["feats_root"] = feats_root
    ours = MAPPERS[name](InputConfig(**kw), seed=7, **extra)
    ref = JAX_MAPPERS[name](JaxInputConfig(**kw), seed=7, **extra)
    n_valid = 0
    for dd in dicts + dicts:
        a, b = ours(dict(dd)), ref(dict(dd))
        if name == "ytvis_with_feats":
            assert a["dino_feats"].shape == (3, 16, 16, 384)
            assert np.abs(a["dino_feats"]).max() > 0
            np.testing.assert_allclose(a.pop("dino_feats"), b.pop("dino_feats"), rtol=0,
                                       atol=1e-6)
        same_tree(a, b)
        assert a["masks"].shape == (5, 3, 64, 64)
        n_valid += int(a["valid"].sum())
    assert n_valid > 0


def test_coco_clip_mapper_matches_jax():
    kw = dict(image_size=64, max_instances=6, min_scale=0.5, max_scale=1.5,
              sampling_frame_num=2)
    ours = MAPPERS["coco_clip"](InputConfig(**kw), seed=7)
    ref = JAX_MAPPERS["coco_clip"](JaxInputConfig(**kw), seed=7)
    rng = np.random.RandomState(1)
    for i, (h, w) in enumerate(((70, 90), (96, 64))):
        dd = _instance_dict(rng, h, w, i)
        same_tree(ours(dict(dd)), ref(dict(dd)))


# -- the evaluator ---------------------------------------------------------------------------


def _tracks(rng, n, T=4, h=16, w=20):
    m = np.zeros((n, T, h, w), bool)
    for i in range(n):
        for t in range(T):
            if rng.rand() < 0.8:
                y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
                m[i, t, y:y + rng.randint(2, h - y), x:x + rng.randint(2, w - x)] = True
    return m


def test_ytvis_evaluator_matches_jax():
    rng = np.random.RandomState(0)
    ours, ref = ytvis_eval.YTVISEvaluator(5), jax_ytvis_eval.YTVISEvaluator(5)
    for vid in range(4):
        gt_m = _tracks(rng, 3)
        pred_m = np.concatenate([gt_m[:2] ^ (rng.rand(*gt_m[:2].shape) > 0.9), _tracks(rng, 3)])
        pred = {"video_id": vid, "scores": rng.rand(5), "labels": rng.randint(0, 5, 5),
                "masks": pred_m}
        gt = {"labels": rng.randint(0, 5, 3), "masks": gt_m,
              "iscrowd": np.array([False, False, vid == 1])}
        ours.process(pred, gt)
        ref.process(pred, gt)
        np.testing.assert_array_equal(ytvis_eval._track_area(pred_m),
                                      jax_ytvis_eval._track_area(pred_m))
    a, b = ours.evaluate(), ref.evaluate()
    assert a == b and 0 < a["AP"] < 100


def test_ground_truth_scores_100(split):
    """The split's tracks as predictions (crowd tracks left out: they are
    ignored): AP 100."""
    ev = ytvis_eval.YTVISEvaluator(40)
    for dd in DatasetCatalog.get(NAME):
        h, w, T = dd["height"], dd["width"], dd["length"]
        masks = np.stack([np.stack([np.zeros((h, w), bool) if s is None else
                                    segmentation_to_mask(s, h, w) > 0
                                    for s in a["segmentations"]]) for a in dd["annotations"]])
        labels = np.asarray([a["category_id"] for a in dd["annotations"]])
        crowd = np.asarray([bool(a["iscrowd"]) for a in dd["annotations"]])
        ev.process({"scores": np.ones(int((~crowd).sum())), "labels": labels[~crowd],
                    "masks": masks[~crowd]},
                   {"labels": labels, "masks": masks, "iscrowd": crowd})
        assert masks.shape[1] == T
    assert ev.evaluate()["AP"] == 100.0


# -- run_video_eval against the JAX eval --------------------------------------------------------


def test_buckets_match_jax():
    """The frame ladder (and its x1.5 growth above 40) and the spatial
    buckets, as root eval_video.py computes them inline."""
    assert [eval_video.frame_bucket(t) for t in (1, 4, 5, 19, 36, 40, 41, 64, 65, 97, 200)] == \
        [4, 4, 8, 24, 40, 40, 64, 64, 96, 144, 216]
    assert eval_video.spatial_buckets(360, 1333) == (640, 736, 1344)


def test_run_video_eval_matches_jax(split, monkeypatch):
    rng = np.random.RandomState(2)
    jcfg = jax_get_config("ytvis2019_video_r50", TINY)
    jmodel = jax_build_video_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 2, 64, 64, 3))))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.randn(*v.shape) * 0.05).astype(np.float32)
        if "sampling_offsets" in str(p) else v, variables)
    cfg = get_config("ytvis2019_video_r50", TINY)
    model = build_video_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)

    seen = {"jax": [], "port": [], "resized": [], "eps": []}
    for cls, store in ((jax_ytvis_eval.YTVISEvaluator, seen["jax"]),
                       (ytvis_eval.YTVISEvaluator, seen["port"])):
        def process(self, pred, gt, _orig=cls.process, _store=store):
            _store.append((pred, gt))
            return _orig(self, pred, gt)

        monkeypatch.setattr(cls, "process", process)
    to_original, predict = port_eval._to_original, eval_video.predict_clip

    def recorded_to_original(*args):
        seen["resized"].append(to_original(*args))
        return seen["resized"][-1]

    def recorded_predict(*args):
        out = predict(*args)
        seen["eps"].append(1.5e-3 + 1e-3 * out[2].abs().max().item())
        return out

    monkeypatch.setattr(port_eval, "_to_original", recorded_to_original)
    monkeypatch.setattr(eval_video, "predict_clip", recorded_predict)
    ref = jax_eval_video.run_video_eval(jcfg, jmodel, variables, NAME, **EVAL)
    timings = []
    ours = eval_video.run_video_eval(cfg, model, NAME, **EVAL, timings=timings)
    assert [t["frames"] for t in timings] == [4, 8] and {t["size"] for t in timings} == {64}
    assert len(seen["port"]) == len(seen["jax"]) == len(LENGTHS)
    moved = 0
    for (a, ga), (b, gb), r, eps in zip(seen["port"], seen["jax"], seen["resized"],
                                        seen["eps"]):
        same_tree(ga, gb)
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=3 * eps)
        diff = a["masks"] != b["masks"]
        assert not (diff & ~(r.abs() <= eps).reshape(diff.shape).numpy()).any()
        moved += int(diff.sum())
    assert ours.keys() == ref.keys()
    if moved == 0:
        for k in ours:
            assert ours[k] == ref[k], (k, ours[k], ref[k])


# -- the train entry point on video ---------------------------------------------------------------


def test_entry_point_trains_video_with_an_eval(split, tmp_path, capsys):
    """`python -m bm2f_tpu_torch.train` on the temporal-pairwise preset: the
    train split through `ytvis_with_feats` (no features root, as the JAX
    entry point builds it), an eval of the val split at step 1 (track AP
    in metrics.json) and a checkpoint at 2."""
    root, _ = split
    out = tmp_path / "out"
    argv = ["--config", "ytvis2021_video_r50_proj_spatpair_temppair", "--device", "cpu",
            "--dataset", "ytvis_2021_train", "--eval-dataset", "ytvis_2019_val",
            "--data-root", root, "--output", str(out), "--max-iter", "2"]
    for k, v in {**TINY, "input.max_instances": 10, "input.image_size": 64,
                 "train.ims_per_batch": 2, "input.min_size_test": 32,
                 "input.max_size_test": 64, "train.eval_period": 1,
                 "train.checkpoint_period": 2}.items():
        argv += ["--set", f"{k}={v}"]
    assert train_main.main(argv) == 0
    assert "training done at iter 2" in capsys.readouterr().out
    lines = [json.loads(ln) for ln in (out / "metrics.json").read_text().splitlines()]
    at1 = [ln for ln in lines if ln["iteration"] == 1]
    assert at1 and {"eval/AP", "loss_mask_temporal_pairwise", "temp_pair_valid_prop",
                    "loss_mask_spatial_pairwise"} <= set(at1[-1])
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert (out / "checkpoints" / "2").is_dir()
