"""Tensor-parallel training of the Swin and MaskFormer-v1 models at mesh
(data 1, model 2) against the port at world 1: SMALL `coco_instance_swin_t`
(embed 32, heads (1, 2, 4, 8): stage 0's single head cannot split, so its
attention stays replicated, the departure `parallel.tp.departures` lists;
the other stages' `qkv` by head, their bias tables' head columns, `proj`,
the MLPs and `PatchMerging`'s row-parallel `reduction` split) and the
tiny v1 `transformer_fpn` + `standard` model (the DETR encoder's and
decoder's attention and FFN). Inputs and tolerances: `torch_tp_cases`."""

import pytest

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models.maskformer import MaskFormer
from bm2f_tpu_torch.parallel import tp as tparallel
from bm2f_tpu_torch.train.trainer import synthetic_batch
from test_torch_v1 import TINY_V1
from torch_port_utils import SMALL_SWIN
from torch_tp_cases import check_against_world1, check_replicated_bitwise, run_case

CASES = {"swin": ("coco_instance_swin_t", SMALL_SWIN),
         "v1": ("coco_instance_r50", {**TINY_V1, "model.pixel_decoder.name": "transformer_fpn",
                                      "model.decoder.name": "standard"})}


def _batches():
    return [{k: v.numpy() for k, v in synthetic_batch(2, 64, 4, seed=s, num_classes=5,
                                                       device="cpu").items()} for s in (3, 4)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return run_case(*CASES[request.param], _batches())


def test_tp_swin_and_v1_steps_match_world1(case):
    check_against_world1(case)


def test_tp_swin_and_v1_replicated_leaves_bitwise(case):
    check_replicated_bitwise(case)


def test_small_swin_departure_is_stage0_attention():
    model = MaskFormer(get_config(*CASES["swin"]).model)
    dep = tparallel.departures(model, 2)
    assert set(dep) == {f"backbone.layers.0.blocks.{b}.attn.{n}" for b in (0, 1)
                        for n in ("qkv.weight", "qkv.bias", "proj.weight")}
    splits = tparallel.layout(model, 2)
    assert "backbone.layers.1.blocks.0.attn.qkv.weight" in splits
    assert "backbone.layers.0.downsample.reduction.weight" in splits
