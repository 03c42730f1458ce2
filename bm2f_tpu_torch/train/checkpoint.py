"""Checkpointing of the whole train state: the counterpart of the JAX
package's orbax `Checkpointer` (bm2f_tpu/train/checkpoint.py:16-70, itself
detectron2's `resume_or_load`, reference train_net.py:310-321), in
PyTorch's own format: one directory per step, `<directory>/<step>/state.pt`
(`torch.save` of `Trainer.state_dict()`), the newest `max_to_keep` kept.
A directory of weights only (`save_state` of {"step", "model"}, as
`tools/convert_orbax.py` writes from a JAX checkpoint) is read by
`model_state` for evaluation and serving, and cannot be resumed.

Under data parallelism (`parallel/`) every rank holds the same state: rank
0 writes, and every rank waits at a barrier after each save, so that no
rank reads or lists a step before it is complete; every rank reads the
same step after a barrier. Under tensor parallelism the state written is
the whole one (`Trainer.state_dict` gathers the shares) and a rank cuts its
shares on loading, so that one file resumes at any mesh. The JAX package's
orbax manager writes from every process into one directory.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bm2f_tpu_torch.parallel import barrier, rank

STATE_FILE = "state.pt"


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        """The steps on disk, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer, force: bool = False) -> bool:
        """Writes `trainer.state_dict()` as `step` (through a temporary
        directory, renamed when complete), then deletes all but the newest
        `max_to_keep` steps. A step already on disk is kept as it is, unless
        `force`, which replaces it (the end of a run saves with force).
        Rank 0 writes and every rank waits for it. Returns whether this
        rank wrote."""
        # under tensor parallelism every rank takes part in the gather
        state = (trainer.state_dict() if rank() == 0 or trainer.shard is not None
                 else None)
        wrote = rank() == 0 and self.save_state(step, state, force)
        barrier()
        return wrote

    def save_state(self, step: int, state: Dict[str, object], force: bool = False) -> bool:
        """`save` of a state dict: a trainer's, or {"step", "model"} for
        weights only."""
        final = self.directory / str(step)
        if final.exists() and not force:
            return False
        tmp = self.directory / f".{step}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))
        return True

    def restore(self, trainer, step: Optional[int] = None) -> int:
        """Loads `step` (the latest when None) into `trainer`, bit for bit.
        Returns the step; raises FileNotFoundError when there is none.
        Every rank reads the same step, after a barrier."""
        barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self.directory / str(step) / STATE_FILE,
                           map_location=trainer.device, weights_only=True)
        # the generator state is a CPU byte tensor whatever the device
        state["generator"] = state["generator"].cpu()
        trainer.load_state_dict(state)
        return step

    def model_state(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The model's `state_dict` saved as `step` (the latest when None),
        on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self.directory / str(step) / STATE_FILE,
                           map_location="cpu", weights_only=True)
        return state["model"]

    def resume_or_load(self, trainer, resume: bool = True) -> Optional[int]:
        """Reference semantics: when `resume` and a checkpoint exists,
        restore the whole state (model, optimizer, step, generator) and
        return its step; otherwise leave the fresh trainer as it is and
        return None."""
        barrier()
        if resume and self.latest_step() is not None:
            return self.restore(trainer)
        return None
