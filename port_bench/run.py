"""Runs one cell of the benchmark of bm2f_tpu_torch once:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device,
with --trace 1 breakdown, and last the numbers compared with their limits
(which also end standard error). Exits non-zero, printing no result,
without as many CUDA devices as the cell asks for, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "bm2f_tpu")


def loaded_banned() -> list:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness, manifest

    c = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {c.chips} CUDA device(s); {n} visible",
              file=sys.stderr)
        return 2
    return emit(harness.run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START))


def emit(result) -> int:
    """Prints the result, unless JAX or the JAX package was loaded."""
    banned = loaded_banned()
    if banned:
        print(f"port_bench: loaded {banned}: the benchmark must not import JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
