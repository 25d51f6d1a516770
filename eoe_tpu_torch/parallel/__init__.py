"""The (data, model) device mesh: the port of eoe_tpu/parallel/."""

from eoe_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshConfig,
    all_reduce_sum,
    gather_rows,
    init_distributed,
    local_rows,
    make_mesh,
)
