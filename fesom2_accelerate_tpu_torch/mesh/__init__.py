from fesom2_accelerate_tpu_torch.mesh.topology import (
    Mesh,
    build_mesh_from_elements,
)
from fesom2_accelerate_tpu_torch.mesh.fesom_io import (
    read_fesom_mesh,
    write_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.mesh.generate import (
    PRESETS,
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.mesh.ordering import (
    bandwidth,
    rcm_order,
    reorder_mesh,
)

__all__ = [
    "Mesh",
    "PRESETS",
    "bandwidth",
    "build_mesh_from_elements",
    "generate_cylinder_mesh",
    "generate_planar_mesh",
    "random_fields",
    "rcm_order",
    "read_fesom_mesh",
    "reorder_mesh",
    "write_fesom_mesh",
]
