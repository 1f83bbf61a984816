"""Implicit backward-Euler ALM solvers (port of `tlfea/solvers`): Newton-PCG
with the block-Jacobi and frozen coarse preconditioners, and the
first-order solvers AdamW, Nesterov and coloured VBD."""

from tlfea_torch.solvers.common import System, StepState, grad_L, suggest_rho  # noqa: F401
from tlfea_torch.solvers import newton, coarse, adamw, nesterov, vbd  # noqa: F401
from tlfea_torch.solvers.adamw import AdamWParams  # noqa: F401
from tlfea_torch.solvers.nesterov import NesterovParams  # noqa: F401
from tlfea_torch.solvers.newton import NewtonParams  # noqa: F401
from tlfea_torch.solvers.vbd import VBDParams  # noqa: F401
