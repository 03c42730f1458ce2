"""Convert an orbax checkpoint of the JAX package into a checkpoint
directory of the port.

    python -m bm2f_tpu_torch.tools.convert_orbax ORBAX_DIR PORT_DIR
        [--config coco_instance_r50] [--set KEY=VALUE ...] [--step N]

Reads step N (the latest by default) of ORBAX_DIR, a whole TrainState or
bare variables, with tensorstore (`utils/orbax.py`), maps it to the port's
`state_dict` for the model of `--config` (`jax_variables_to_state_dict`,
which raises on a leaf that maps nowhere or a shape that differs), and
writes it as step N of PORT_DIR, weights only ({"step", "model"}). Run it
where tensorstore is installed; `--weights PORT_DIR` of the eval and
`Predictor.setup` load the result without it.
"""

from __future__ import annotations

import argparse
import sys

from bm2f_tpu_torch.config import get_config, parse_override
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from bm2f_tpu_torch.utils.orbax import orbax_steps, read_orbax_variables


def convert(orbax_dir: str, out_dir: str, cfg, step=None) -> int:
    """Writes the converted weights; returns the step."""
    step = orbax_steps(orbax_dir)[-1] if step is None else step
    sd = jax_variables_to_state_dict(read_orbax_variables(orbax_dir, step), cfg)
    Checkpointer(out_dir).save_state(step, {"step": step, "model": sd}, force=True)
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("orbax_dir")
    ap.add_argument("port_dir")
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    if not orbax_steps(args.orbax_dir):
        print(f"convert_orbax: no orbax checkpoint in {args.orbax_dir}", file=sys.stderr)
        return 2
    step = convert(args.orbax_dir, args.port_dir, get_config(args.config, dict(args.set)),
                   args.step)
    print(f"convert_orbax: step {step} of {args.orbax_dir} -> {args.port_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
