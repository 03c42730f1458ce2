"""Data parallelism across processes (`mesh.py`)."""

from bm2f_tpu_torch.parallel.mesh import (  # noqa: F401
    barrier,
    check_mesh,
    global_sum,
    init_distributed,
    local_rows,
    rank,
    world_size,
)
