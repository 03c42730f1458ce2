"""Data and tensor parallelism across processes (`mesh.py`, `tp.py`)."""

from bm2f_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    barrier,
    current_mesh,
    data_rank,
    data_size,
    global_sum,
    init_distributed,
    init_mesh,
    local_rows,
    model_rank,
    model_size,
    rank,
    world_size,
)
