"""Tensor-parallel training of the box-supervised image model and of the
video model with the temporal pairwise loss, at mesh (data 1, model 2)
against the port at world 1: SMALL `coco_instance_r50_wo_lsj_projpair`
(step 5 of 10: pairwise warmup 0.5, the pseudo-mask update on) and SMALL
`ytvis2021_video_r50_proj_spatpair_temppair` (clips of 2 frames, the
clip decoder through the same attention and FFN layers), each the whole
global batch on both ranks. Inputs and tolerances: `torch_tp_cases`."""

import numpy as np
import pytest

from test_torch_ddp_weak import weak_batch
from test_torch_weaksup import STEP as WEAK_STEP
from test_torch_weaksup import WEAK, WEAK_OVER
from test_torch_weaksup_video import STEP, STEP_OVER, TEMP, _clip_batch
from torch_tp_cases import check_against_world1, check_replicated_bitwise, run_case


@pytest.fixture(scope="module", params=["weak", "video_temporal"])
def case(request):
    if request.param == "weak":
        return run_case(WEAK, WEAK_OVER, [weak_batch(10), weak_batch(11)], WEAK_STEP)
    batches = [_clip_batch(np.random.RandomState(s)) for s in (10, 11)]
    return run_case(TEMP, STEP_OVER, batches, STEP)


def test_tp_weak_and_video_steps_match_world1(case):
    assert case["one"]["metrics"][0]["total_loss"] > 0
    check_against_world1(case)


def test_tp_weak_and_video_replicated_leaves_bitwise(case):
    check_replicated_bitwise(case)
