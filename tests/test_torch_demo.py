"""The port's demo and predictor visualization against the root `demo.py`
and `predict.py`.

1. The drawing helpers (`color_palette`, `draw_instances`, `draw_semantic`,
   `draw_panoptic`) are copies: the same arrays bit for bit on the same
   numpy inputs, `RandomState(7)`'s palette and PIL's text included.
2. `AsyncPredictor`: results in order, an error in the loader or in the
   prediction surfaces in the caller, and a consumer that abandons the
   generator early leaves no loader thread behind.
3. `python -m bm2f_tpu_torch.demo` on a tiny config on the CPU writes one
   PNG per input for each task.
4. The `Predictor`'s "visualization" against the root `Predictor`'s on
   shared tiny weights (one class made confident, so that instances are
   drawn and panoptic segments kept). Error model, as
   tests/test_torch_eval_e2e.py's: the network outputs differ by at most
   FWD_EPS = 1.5e-3 + 1e-3 max|logit|, so a drawn pixel may differ only
   where a mask logit lies within FWD_EPS of 0, the top two semantic
   probabilities (or the two best panoptic owners) within 2 FWD_EPS, or
   inside a label's text, which a moved mask edge can move.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import demo as root_demo
import predict as root_predict
from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize
from bm2f_tpu_torch import demo
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.utils.async_predictor import AsyncPredictor
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_port_utils import to_numpy_tree

NAMES = ["person", "bicycle", "car"]


@pytest.mark.parametrize("n", [1, 7, 134])
def test_color_palette_is_the_roots(n):
    ours, ref = demo.color_palette(n), root_demo.color_palette(n)
    assert ours.dtype == ref.dtype == np.uint8 and np.array_equal(ours, ref)


def _scene(seed, n=5, h=40, w=56):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    masks = np.zeros((n, h, w), bool)
    for i in range(n - 1):  # the last mask is empty: skipped by the text pass
        y, x = rng.randint(0, h - 10), rng.randint(0, w - 10)
        masks[i, y:y + rng.randint(3, 10), x:x + rng.randint(3, 10)] = True
    labels = rng.randint(0, 5, n)  # labels past the names print as numbers
    scores = np.array([0.9, 0.3, 0.5, 0.75, 0.95], np.float32)[:n]
    return img, masks, labels, scores


@pytest.mark.parametrize("names", [None, NAMES])
@pytest.mark.parametrize("seed", [0, 1])
def test_draw_instances_is_the_roots(names, seed):
    img, masks, labels, scores = _scene(seed)
    for thr in (0.5, 0.8):
        ours = demo.draw_instances(img, masks, labels, scores, class_names=names, score_thr=thr)
        ref = root_demo.draw_instances(img, masks, labels, scores, class_names=names,
                                       score_thr=thr)
        assert ours.dtype == np.uint8 and np.array_equal(ours, ref)
    assert not np.array_equal(ours, img)  # something was drawn


def test_draw_semantic_is_the_roots():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (30, 44, 3)).astype(np.uint8)
    sem = rng.rand(30, 44, 9).astype(np.float32)
    sem[:, :5] = 0.5  # ties: the first class, as numpy's argmax
    assert np.array_equal(demo.draw_semantic(img, sem), root_demo.draw_semantic(img, sem))


@pytest.mark.parametrize("names", [None, NAMES])
def test_draw_panoptic_is_the_roots(names):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (36, 48, 3)).astype(np.uint8)
    seg_map = np.zeros((36, 48), np.int32)
    seg_map[:18, :20], seg_map[18:, 10:40], seg_map[2:10, 30:46] = 1, 2, 3
    segments = [{"id": 1, "category_id": 0, "isthing": True},
                {"id": 2, "category_id": 2, "isthing": False},
                {"id": 3, "category_id": 7, "isthing": True},
                {"id": 4, "category_id": 1, "isthing": True}]  # no pixels
    ours = demo.draw_panoptic(img, seg_map, segments, names)
    assert np.array_equal(ours, root_demo.draw_panoptic(img, seg_map, segments, names))


# -- AsyncPredictor ---------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_async_predictor_keeps_order(depth):
    def pre(i):
        time.sleep(0.002 * (i % 3))
        return i * 10

    pipe = AsyncPredictor(lambda x: x + 1, pre, lambda item, out: (item, out), depth=depth,
                          queue_size=2)
    assert list(pipe(range(12))) == [(i, (i, i * 10 + 1)) for i in range(12)]


def test_async_predictor_surfaces_errors():
    def bad_pre(i):
        if i == 3:
            raise ValueError("cannot read item 3")
        return i

    got = []
    with pytest.raises(ValueError, match="item 3"):
        for item, out in AsyncPredictor(lambda x: x, bad_pre)(range(6)):
            got.append(item)
    assert got == [0, 1, 2]

    def bad_predict(x):
        if x == 2:
            raise RuntimeError("device fault on 2")
        return x

    with pytest.raises(RuntimeError, match="device fault"):
        list(AsyncPredictor(bad_predict, lambda i: i)(range(6)))


def test_async_predictor_drains_when_abandoned():
    before = threading.active_count()
    gen = AsyncPredictor(lambda x: x, lambda i: i, queue_size=1)(range(1000))
    assert next(gen) == (0, 0)
    gen.close()  # the consumer walks away: the loader must not block forever
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# -- the entry point ---------------------------------------------------------------

TINY = {"model.backbone.resnet.depth": 14, "model.decoder.dec_layers": 1,
        "model.decoder.num_queries": 8, "model.pixel_decoder.transformer_enc_layers": 1}


@pytest.mark.parametrize("task", ["instance", "semantic", "panoptic"])
def test_demo_main_writes_one_png_per_input(task, tmp_path):
    rng = np.random.RandomState(5)
    inputs = []
    for i, (h, w) in enumerate([(50, 70), (64, 40)]):
        inputs.append(str(tmp_path / f"img{i}.jpg"))
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(inputs[-1])
    out = tmp_path / "out"
    res = demo.main(["--config", "coco_panoptic_r50", "--input", *inputs, "--output",
                     str(out), "--task", task, "--device", "cpu", "--confidence", "0.0"]
                    + [a for k, v in TINY.items() for a in ("--set", f"{k}={v}")])
    assert res["written"] == [str(out / f"img{i}.jpg.viz.png") for i in range(2)]
    for path, (h, w) in zip(res["written"], [(50, 70), (64, 40)]):
        with Image.open(path) as im:
            assert im.size == (w, h) and im.mode == "RGB"
    assert set(res["stage_s"]) == {"preprocess", "predict", "postprocess"}


# -- the predictor's visualization ----------------------------------------------------


@pytest.fixture(scope="module")
def predictors():
    """The root and the port `Predictor` on the same tiny coco_panoptic_r50
    weights, class 3 made confident through `class_embed`'s bias, and no
    overlap pruning (random masks overlap), so that segments survive."""
    over = {**TINY, "model.test.overlap_threshold": 0.0}
    jcfg = jax_get_config("coco_panoptic_r50", over)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    cls = variables["params"]["sem_seg_head"]["predictor"]["class_embed"]
    cls["bias"] = cls["bias"] + 9.0 * (np.arange(len(cls["bias"])) == 3)
    root = root_predict.Predictor()
    root.cfg, root.model, root.variables = jcfg, jmodel, variables
    root._predict = jax.jit(lambda x: jmodel.apply(variables, jax_normalize(x, jcfg.model)))
    port = Predictor()
    port.setup("coco_panoptic_r50", device="cpu", overrides=over)
    port.model.load_state_dict(jax_variables_to_state_dict(variables, port.cfg), strict=True)
    return root, port


def test_visualization_layout_matches_the_roots(predictors, monkeypatch):
    root, port = predictors
    image = np.random.RandomState(6).randint(0, 256, (52, 68, 3)).astype(np.uint8)
    raw = {}
    forward = port.model.forward

    def recorded(x, *a, **kw):
        raw.update(forward(x, *a, **kw))
        return raw

    monkeypatch.setattr(port.model, "forward", recorded)
    ours = port.predict(image)
    ref = root.predict(image)
    H, W = image.shape[:2]
    vis, vref = ours["visualization"], ref["visualization"]
    assert vis.shape == vref.shape == (H, 3 * W, 3) and vis.dtype == vref.dtype == np.uint8

    # the band where a threshold may flip, from the port's values
    from bm2f_tpu_torch.ops import resize_bilinear

    logits = raw["pred_logits"][0]
    ph, pw = raw["pred_masks"].shape[-2] * 4, raw["pred_masks"].shape[-1] * 4
    masks = resize_bilinear(raw["pred_masks"][0], ph, pw)[:, :H, :W]
    eps = 1.5e-3 + 1e-3 * max(logits.abs().max().item(), masks.abs().max().item())
    near_zero = (masks.abs() <= eps).any(0).numpy()
    sem = torch.from_numpy(ours["semantic"]).topk(2, dim=-1).values
    sem_tie = (sem[..., 0] - sem[..., 1] <= 2 * eps).numpy()
    probs = torch.softmax(logits, -1)
    owners = (probs.amax(-1)[:, None, None] * torch.sigmoid(masks)).topk(2, dim=0).values
    owner_tie = (owners[0] - owners[1] <= 2 * eps).numpy()

    pan, inst, semv = (slice(0, W), slice(W, 2 * W), slice(2 * W, 3 * W))
    seg_map, segments = ours["panoptic"]
    assert len(segments) > 0 and (seg_map > 0).any()  # the panoptic panel is not vacuous
    diff = (vis != vref).any(-1)
    assert not (diff[:, semv] & ~sem_tie).any()
    assert not (diff[:, pan] & ~(near_zero | owner_tie)).any()
    kept = int((ours["instances"]["scores"] >= 0.5).sum())
    assert kept > 0 and not np.array_equal(vis[:, inst], image)  # instances drawn
    # a label's text (at most ~8 x 11 pixels a character of "<id> 0.00")
    text_px = kept * 2 * 8 * 6 * 11
    assert int((diff[:, inst] & ~near_zero).sum()) <= text_px
    # the share that differs is no more than the error model's band allows
    assert diff.mean() <= (near_zero | sem_tie | owner_tie).mean() + text_px / diff.size
