"""Shared machinery of the implicit stepper (port of `tlfea/solvers/common.py`).

One backward-Euler step x_{n+1} = x_n + h v_{n+1} is found as an
augmented-Lagrangian minimisation over the velocity v:

  g(v) = M (v - v_prev)/h + f_int(u_prev + h v) - f_ext
         + h J^T (lambda + rho c(u_prev + h v))

evaluated in displacement space u = x - x_ref (the primary state). The hot
path evaluates g and its Hessian products through the FEM kernels
(`tlfea_torch.ops.fem_kernels.g_and_hvp`); `grad_L` here is the plain
PyTorch form of the reference's fused XLA path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements.assembly import ElementBatch, _element_contrib_values, node_ref
from tlfea_torch.materials.svk import SVK
from tlfea_torch.ops.fem_kernels import FemOperator, element_fns, unpack_sym6

__all__ = [
    "System", "StepState", "grad_L", "constraint_values", "precond_blocks",
    "flat_norm", "suggest_rho",
]


@dataclass
class System:
    """Static problem definition: elements, material, constraints, and the
    element operator `fem` that holds the kernels' tables on the elements'
    device. plain=True routes the element work through the plain PyTorch
    twins on any device (the on-card reference for the kernels)."""

    elems: ElementBatch
    material: SVK
    constraints: FixedCoefs | None = None
    plain: bool = False
    fem: FemOperator = field(init=False, repr=False)

    def __post_init__(self):
        self.fem = FemOperator(self.elems, self.material)

    @property
    def n_coef(self) -> int:
        return self.elems.n_coef


@dataclass
class StepState:
    """Dynamic state. `u` (displacements x - x_ref) is the primary state; x
    is derived geometry. dv is the last step's velocity increment, which
    warm-starts the next Newton iterate."""

    x: torch.Tensor  # (n, 3)
    v: torch.Tensor  # (n, 3)
    lam: torch.Tensor  # (C, 3) duals of the pins
    u: torch.Tensor  # (n, 3)
    dv: torch.Tensor  # (n, 3)

    @staticmethod
    def rest(system: System, x0: torch.Tensor) -> "StepState":
        cons = system.constraints
        if cons is None:
            lam = torch.zeros((0,), dtype=x0.dtype, device=x0.device)
        else:
            lam = torch.zeros_like(cons.eval_c(x0))
        x_ref = node_ref(system.elems).to(x0.dtype)
        return StepState(x=x0, v=torch.zeros_like(x0), lam=lam, u=x0 - x_ref,
                         dv=torch.zeros_like(x0))


def constraint_values(cons, x_prev, v, dt, elems, u_prev=None):
    """c(u_prev + dt v), grouped in displacement space (see
    FixedCoefs.eval_c_u)."""
    x_ref = node_ref(elems)
    if u_prev is None:
        u_prev = x_prev - x_ref
    return cons.eval_c_u(u_prev + dt * v, x_ref).to(v.dtype)


def grad_L(v, x_prev, v_prev, lam, f_ext, dt, rho, system: System, u_prev=None):
    """ALM gradient g(v) (n, 3), plain PyTorch: the fused path of the
    reference (`common.py:183-203`), one gather and one scatter-add with
    the pin forces h (lam + rho c) folded in."""
    elems = system.elems
    x_ref = node_ref(elems)
    if u_prev is None:
        u_prev = x_prev - x_ref
    u = u_prev + dt * v
    contrib = _element_contrib_values(u, v, (v - v_prev) / dt, elems, system.material)
    idx = elems.conn.reshape(-1)
    vals = contrib.reshape(-1, 3)
    cons = system.constraints
    if cons is not None:
        c = cons.eval_c_u(u, x_ref)
        idx = torch.cat([idx, cons.idx])
        vals = torch.cat([vals, dt * (lam + rho * c)], dim=0)
    out = torch.zeros((elems.n_coef, 3), dtype=v.dtype, device=v.device)
    return out.index_add_(0, idx, vals) - f_ext


def precond_blocks(v, x_prev, dt, rho, system: System, u_prev=None) -> torch.Tensor:
    """Block-Jacobi 3x3 blocks of dg/dv -> (n, 3, 3):

        H_aa ~= m_aa/h I + h sum_(e,q) K_block(F_eq, gradN_eqa) dV
                + h^2 rho (J^T J)_aa,

    the elastic part from K3 + K4, scaled by the Kelvin-Voigt factor, then
    symmetrised and shifted by its Gershgorin deficit so PCG gets an SPD
    preconditioner (`common.py:284-320`)."""
    elems = system.elems
    op = system.fem
    if u_prev is None:
        u_prev = x_prev - node_ref(elems)
    u = (u_prev + dt * v).to(v.dtype).contiguous()
    _, _, k3, k4 = element_fns(system.plain)
    blocks = unpack_sym6(dt * k4(op, k3(op, u)))

    # Kelvin-Voigt tangent: same lam*A + mu*B structure as the elastic one
    # with (lam_d, eta) for (dt*lam, dt*mu), folded in as a scalar factor.
    mat = system.material
    blocks = blocks * (1.0 + (mat.eta_damp + mat.lam_damp) / (dt * (mat.lam + mat.mu)))

    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    blocks = blocks + (op.md / dt)[:, None, None] * eye
    cons = system.constraints
    if cons is not None:
        d = cons.jtj_diag(elems.n_coef, v.dtype)
        blocks = blocks + (dt * dt * rho) * d[:, None, None] * eye

    blocks = 0.5 * (blocks + blocks.transpose(-1, -2))
    diag = torch.diagonal(blocks, dim1=-2, dim2=-1)
    offdiag = blocks.abs().sum(-1) - diag.abs()
    lmin_lb = (diag - offdiag).min(dim=-1).values
    scale = blocks.abs().amax(dim=(-2, -1)).clamp_min(1e-30)
    shift = (-lmin_lb).clamp_min(0.0) + 1e-7 * scale
    return blocks + shift[:, None, None] * eye


def flat_norm(a: torch.Tensor) -> torch.Tensor:
    """L2 norm of a tensor viewed as a flat vector."""
    return torch.sqrt(torch.sum(a * a))


def suggest_rho(elems: ElementBatch, material, dt: float) -> float:
    """ALM penalty scaled to the problem stiffness: rho ~ E * h_elem / dt."""
    E_mod = float(material.mu) * 2.0 + float(material.lam)
    vol = float(elems.dV.sum()) / max(elems.n_elem, 1)
    h = vol ** (1.0 / 3.0)
    return E_mod * h / float(dt)
