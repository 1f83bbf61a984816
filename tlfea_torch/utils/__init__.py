"""Host-side utilities (NumPy): quadrature, mesh generation, node reordering."""

from tlfea_torch.utils import quadrature, tetmesh, reorder  # noqa: F401
