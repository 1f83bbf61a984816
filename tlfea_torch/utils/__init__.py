"""Host-side utilities (NumPy): quadrature, mesh generation and IO, node
reordering, scene assembly, pressure fields, VTK/CSV/OBJ writers, the CLI
registry and step timing."""

from tlfea_torch.utils import (  # noqa: F401
    quadrature, tetmesh, reorder, ancf_mesh, cli, io_vtk, mesh_manager, pressure, profiling,
)
