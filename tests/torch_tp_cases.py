"""What the tensor-parallel tests of the other models and steps
(tests/test_torch_tp_weak_video.py, tests/test_torch_tp_swin_v1.py) share:
the port's own seeded state with its deformable projections and
row-parallel biases drawn, and one case run at world 1 and at mesh (data
1, model 2) in two spawned gloo ranks. Tolerances: `torch_ddp_cases`."""

from __future__ import annotations

import numpy as np
import torch

from torch_ddp_cases import WORLD_REL, check_losses, check_update, run_ranks, train_steps

# parameters drawn from N(0, scale) over the seeded init: the deformable
# projections (zero at the init: the kernel then samples a grid) and the
# row-parallel layers' biases (zero at the init: a bias added on every rank
# would not show)
DRAWN = {"sampling_offsets.weight": 0.05, "attention_weights.weight": 0.05,
         "linear2.bias": 0.1, "output_proj.bias": 0.1, "out_proj.bias": 0.1,
         "mlp.fc2.bias": 0.1, "attn.proj.bias": 0.1}


def port_state(config: str, over: dict, seed: int = 5) -> dict:
    """The port model's seeded state with `DRAWN`'s parameters drawn."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models.maskformer import build_model
    from bm2f_tpu_torch.video import build_video_model

    cfg = get_config(config, over)
    build = build_video_model if cfg.task == "video" else build_model
    state = build(cfg, device="cpu", seed=0).state_dict()
    rng = np.random.RandomState(seed)
    for k in sorted(state):
        scale = next((s for suffix, s in DRAWN.items() if k.endswith(suffix)), None)
        if scale is not None:
            state[k] = torch.from_numpy((rng.randn(*state[k].shape) * scale)
                                        .astype(np.float32))
    return state


def run_case(config: str, over: dict, batches, step_count: int = 0) -> dict:
    """Two steps at world 1 and at mesh (1, 2) from `port_state`, each on
    its own draws from the seed."""
    state = port_state(config, over)
    points = [None] * len(batches)
    one = train_steps(config, over, state, batches, points, step_count=step_count)["ours"]
    two = run_ranks(train_steps, 2, config, {**over, "mesh.model": 2}, state, batches,
                    points, ("ours",), step_count)
    return {"one": one, "two": [r["ours"] for r in two]}


def check_against_world1(case: dict) -> None:
    """Both ranks: both steps' losses and grad_norm, the first step's whole
    gradients (within WORLD_REL of each tensor's norm) and update."""
    one = case["one"]
    for got in case["two"]:
        for want, have in zip(one["metrics"], got["metrics"]):
            check_losses(want, have, WORLD_REL, WORLD_REL)
        for name, g in one["grads"][0].items():
            err = np.abs(got["grads"][0][name] - g).max()
            assert err <= WORLD_REL * max(np.linalg.norm(g), 1e-12), (name, err)
        check_update(one, got["params"][0])


def check_replicated_bitwise(case: dict) -> None:
    r0, r1 = case["two"]
    assert r0["metrics"] == r1["metrics"]
    for step in range(len(r0["replicated"])):
        for name, p in r0["replicated"][step].items():
            np.testing.assert_array_equal(p, r1["replicated"][step][name], err_msg=name)
    assert not r0["no_grad"] and not case["one"]["no_grad"]
