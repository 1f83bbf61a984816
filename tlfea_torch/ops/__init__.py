"""Device operations: 3x3 algebra, gather/scatter, and (in `fem_kernels`,
imported by the solvers) the FEM element kernels with their plain twins."""

from tlfea_torch.ops import linalg, segment  # noqa: F401
