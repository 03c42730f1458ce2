"""`Trainer.step` is deterministic whatever the caller's global settings, as
the JAX step is: it runs inside `utils.precision.deterministic_scope`, which
turns PyTorch's deterministic algorithms (without their filling of new
tensors) and cuDNN's deterministic mode on for the step and leaves the
caller's settings as they were. (On the card, two trainers from one seed
end a step bitwise equal with no global mode set: tests/test_torch_cuda.py.)"""

import pytest
import torch
import torch.utils.deterministic

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.precision import deterministic_scope

from torch_port_utils import SMALL


def _settings():
    cudnn = torch.backends.cudnn
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled,
            torch.utils.deterministic.fill_uninitialized_memory)


# (deterministic algorithms, warn only, cudnn.deterministic, cudnn.benchmark)
CALLERS = [(False, False, False, False), (False, False, False, True),
           (True, False, True, False), (True, True, False, True)]


@pytest.fixture
def caller_settings(request):
    saved = _settings()
    mode, warn_only, det, bench = request.param
    torch.use_deterministic_algorithms(mode, warn_only=warn_only)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    yield _settings()
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:4]


@pytest.mark.parametrize("caller_settings", CALLERS, indirect=True)
def test_scope_sets_and_restores(caller_settings):
    with deterministic_scope():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert not torch.utils.deterministic.fill_uninitialized_memory
        assert torch.backends.cudnn.allow_tf32 == caller_settings[4]
    assert _settings() == caller_settings
    with pytest.raises(RuntimeError, match="inside"):
        with deterministic_scope():
            raise RuntimeError("inside")
    assert _settings() == caller_settings


@pytest.mark.parametrize("caller_settings", CALLERS[:2], indirect=True)
def test_train_step_leaves_the_callers_settings(caller_settings):
    cfg = get_config("coco_instance_r50", {**SMALL, "model.decoder.dec_layers": 3})
    trainer = Trainer(cfg, device="cpu", seed=0)
    metrics = trainer.step(synthetic_batch(1, 64, 3, seed=0, device="cpu"))
    assert torch.isfinite(metrics["total_loss"])
    assert _settings() == caller_settings
