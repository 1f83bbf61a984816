"""Implicit backward-Euler ALM solvers (port of `tlfea/solvers`): Newton-PCG
with the block-Jacobi and frozen coarse preconditioners so far."""

from tlfea_torch.solvers.common import System, StepState, grad_L, suggest_rho  # noqa: F401
from tlfea_torch.solvers import newton, coarse  # noqa: F401
