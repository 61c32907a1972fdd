from fesom2_accelerate_tpu_torch.mesh.topology import (
    Mesh,
    build_mesh_from_elements,
)
from fesom2_accelerate_tpu_torch.mesh.generate import (
    PRESETS,
    generate_planar_mesh,
    random_fields,
)

__all__ = [
    "Mesh",
    "PRESETS",
    "build_mesh_from_elements",
    "generate_planar_mesh",
    "random_fields",
]
