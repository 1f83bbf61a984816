"""Shared machinery of the implicit stepper (port of `tlfea/solvers/common.py`).

One backward-Euler step x_{n+1} = x_n + h v_{n+1} is found as an
augmented-Lagrangian minimisation over the velocity v:

  g(v) = M (v - v_prev)/h + f_int(u_prev + h v) - f_ext
         + h J^T (lambda + rho c(u_prev + h v))

evaluated in displacement space u = x - x_ref (the primary state).
Newton-PCG evaluates g and its Hessian products through K1-K4
(`tlfea_torch.ops.fem_kernels.g_and_hvp`); the first-order solvers call
`grad_L` here, one K5 + K4 pass per gradient, whose `torch.func.jvp` runs
K5t + K4.

Accuracy mode (`System.accum_dtype=torch.float64` on a float32 problem,
with StepState.u carried in float64): g and its products run through the
float64 instantiations of the kernels on the tables cast up
(`System.fem_wide`), the pin forces and -f_ext are added in float64, and
only the sums are cast down; the preconditioner, the CG recurrences and the
duals stay float32 (the JAX package's XLA path, `common.py:183-201`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from dataclasses import replace as _dc_replace

import torch

from tlfea_torch.constraints import DensePins, FixedCoefs, LinearConstraints
from tlfea_torch.elements.assembly import ElementBatch, node_ref
from tlfea_torch.materials.mooney_rivlin import MooneyRivlin
from tlfea_torch.materials.svk import SVK
from tlfea_torch.ops.fem_kernels import (ElementContrib, FemOperator, element_fns,
                                         node_reduce_plain, tangent_blocks_plain, unpack_sym6)

__all__ = [
    "System", "StepState", "grad_L", "grad_fn", "eval_constraints", "constraint_values",
    "precond_blocks", "flat_norm", "suggest_rho", "alm_outer",
]


@dataclass
class System:
    """Static problem definition: elements, material (SVK or Mooney-Rivlin,
    in every element family), constraints (None, `FixedCoefs`, `DensePins`
    or `LinearConstraints`), and the element operator `fem` that holds the
    kernels' tables on the elements' device. plain=True routes the element
    work through the plain PyTorch twins on any device (the on-card
    reference for the kernels).

    accum_dtype=torch.float64 on a float32 batch is the accuracy mode
    (`tlfea/solvers/common.py:59-65`): `fem_wide`, a second operator whose
    tables are fem's cast up, carries the gradient and its products
    (`grad_op`); fem_wide is None otherwise."""

    elems: ElementBatch
    material: SVK | MooneyRivlin
    constraints: FixedCoefs | DensePins | LinearConstraints | None = None
    plain: bool = False
    accum_dtype: torch.dtype | None = None
    fem: FemOperator = field(init=False, repr=False)
    fem_wide: FemOperator | None = field(init=False, repr=False)

    def __post_init__(self):
        if self.accum_dtype not in (None, torch.float64):
            raise ValueError(f"accum_dtype must be None or torch.float64, got {self.accum_dtype}")
        self.fem = FemOperator(self.elems, self.material)
        self.fem_wide = None
        if self.accum_dtype is not None and self.elems.grad_N.dtype != self.accum_dtype:
            self.fem_wide = FemOperator(self.elems.to(dtype=self.accum_dtype), self.material)

    @property
    def n_coef(self) -> int:
        return self.elems.n_coef

    @property
    def grad_op(self) -> FemOperator:
        """The operator of the gradient and its products: fem_wide in the
        accuracy mode, else fem."""
        return self.fem if self.fem_wide is None else self.fem_wide

    def replace(self, **changes) -> "System":
        """A copy with `changes`. The element operators are rebuilt only
        when the elements, the material or accum_dtype change; a change of
        constraints or plain keeps them (what `Simulation` does every
        step of a prescribed motion)."""
        if changes.keys() & {"elems", "material", "accum_dtype"}:
            return _dc_replace(self, **changes)
        new = copy.copy(self)
        for k, val in changes.items():
            setattr(new, k, val)
        return new


@dataclass
class StepState:
    """Dynamic state. `u` (displacements x - x_ref) is the primary state; x
    is derived geometry. dv is the last step's velocity increment, which
    warm-starts the next Newton iterate."""

    x: torch.Tensor  # (n, 3)
    v: torch.Tensor  # (n, 3)
    lam: torch.Tensor  # duals, shaped like eval_constraints: (C, 3), (n, 3) or (n_rows,)
    u: torch.Tensor  # (n, 3)
    dv: torch.Tensor  # (n, 3)

    def replace(self, **changes) -> "StepState":
        """A copy with `changes` (e.g. u=state.u.double(), the accuracy
        mode's wide displacement)."""
        return _dc_replace(self, **changes)

    @staticmethod
    def rest(system: System, x0: torch.Tensor) -> "StepState":
        cons = system.constraints
        if cons is None:
            lam = torch.zeros((0,), dtype=x0.dtype, device=x0.device)
        else:
            lam = torch.zeros_like(eval_constraints(cons, x0))
        x_ref = node_ref(system.elems).to(x0.dtype)
        return StepState(x=x0, v=torch.zeros_like(x0), lam=lam, u=x0 - x_ref,
                         dv=torch.zeros_like(x0))


def eval_constraints(cons, x: torch.Tensor) -> torch.Tensor:
    """c(x): (C, 3) for FixedCoefs, (n, 3) for DensePins, (n_rows,) for
    LinearConstraints."""
    return cons.eval_c(x)


def constraint_values(cons, x_prev, v, dt, elems, u_prev=None):
    """c(u_prev + dt v), grouped in displacement space (see
    FixedCoefs.eval_c_u)."""
    x_ref = node_ref(elems)
    if u_prev is None:
        u_prev = x_prev - x_ref
    return cons.eval_c_u(u_prev + dt * v, x_ref).to(v.dtype)


def _pin_terms(system: System, lam: torch.Tensor, dt: float, rho: float, dtype):
    """The constraint forces dt J^T (lam + rho c) as (pin_aff, pin_lin),
    built once per inner solve so that the duals are never scattered inside
    an inner loop (`newton.py:183-233`): the forces are pin_aff + pin_lin *
    u and their Hessian term dt * pin_lin * p, with pin_lin (n, 1) for the
    pins (`FixedCoefs` expanded to dense fields, `DensePins` already dense),
    or pin_aff + pin_lin(u) and dt * pin_lin(p), with pin_lin(p) = dt rho
    J^T J p, for `LinearConstraints` (pin_aff = dt J^T (lam + rho c0), c0 =
    J x_ref - b)."""
    cons = system.constraints
    if cons is None:
        return None
    x_ref = node_ref(system.elems)
    n = x_ref.shape[0]
    if isinstance(cons, FixedCoefs):
        zero3 = torch.zeros((n, 3), dtype=dtype, device=x_ref.device)
        lam_dense = zero3.index_copy(0, cons.idx, lam.to(dtype))
        tgt_dense = zero3.index_copy(0, cons.idx, (cons.target - x_ref[cons.idx]).to(dtype))
        pinmask = torch.zeros((n, 1), dtype=dtype, device=x_ref.device)
        pinmask[cons.idx] = 1.0
        return dt * (lam_dense - rho * tgt_dense), dt * rho * pinmask
    if isinstance(cons, DensePins):
        mask = cons.mask.to(dtype)
        tgt_u = mask * (cons.target - x_ref).to(dtype)
        return dt * (mask * lam.to(dtype) - rho * tgt_u), dt * rho * mask
    if isinstance(cons, LinearConstraints):
        c0 = (cons._apply_j(x_ref) - cons.b).to(dtype)
        aff = dt * cons.apply_jt(lam.to(dtype) + rho * c0, n)

        def lin(p):
            return dt * rho * cons.apply_jt(cons._apply_j(p), n)

        return aff, lin
    raise TypeError(f"unsupported constraints {type(cons).__name__}")


def grad_fn(system: System, x_prev, v_prev, lam, f_ext, dt, rho, u_prev=None):
    """g(v) = grad_L(v, x_prev, v_prev, lam, f_ext, dt, rho, system, u_prev)
    as a function of v alone, with the pin fields (`_pin_terms`) and
    -f_ext folded once: what an inner loop calls. In the accuracy mode all
    of it runs in float64 on `System.fem_wide` (K5 + K4, and K5t + K4 under
    `torch.func.jvp`) and g is cast down to v's dtype. Per call: the packed
    [u | v | dv/dt], one K5 + K4 pass (`ElementContrib`: the twins on CPU
    tensors or when `system.plain`; on a CUDA tensor the kernels or an
    error), and the constraint terms (`_pin_terms`: node-wise operations
    for the pins, two fixed-order COO sums for linear rows). No atomics:
    every sum runs in a fixed order."""
    if u_prev is None:
        u_prev = x_prev - node_ref(system.elems)
    op = system.grad_op
    wd = op.gN_t.dtype  # float64 in the accuracy mode: the sums, then cast down
    pins = _pin_terms(system, lam, dt, rho, wd)
    aff = -f_ext.to(wd) if pins is None else pins[0] - f_ext.to(wd)

    def g(v):
        u = (u_prev + dt * v).to(wd)
        packed = torch.cat([u, v.to(wd), ((v - v_prev) / dt).to(wd)], dim=1)
        out = ElementContrib.apply(op, packed, system.plain)
        if pins is not None:
            lin = pins[1]
            out = out + (lin(u) if callable(lin) else lin * u)
        return (out + aff).to(v.dtype)

    return g


def grad_L(v, x_prev, v_prev, lam, f_ext, dt, rho, system: System, u_prev=None):
    """ALM gradient g(v) (n, 3): the `system.pallas` path of the reference
    (`common.py:162-181`), through `grad_fn`. Pure in v:
    `torch.func.jvp(grad_L)` gives the exact Hessian-vector product through
    K5t + K4."""
    return grad_fn(system, x_prev, v_prev, lam, f_ext, dt, rho, u_prev)(v)


def precond_blocks(v, x_prev, dt, rho, system: System, u_prev=None) -> torch.Tensor:
    """Block-Jacobi 3x3 blocks of dg/dv -> (n, 3, 3):

        H_aa ~= m_aa/h I + h sum_(e,q) K_block(F_eq, gradN_eqa) dV
                + h^2 rho (J^T J)_aa,

    the elastic part from K3 + K4 for SVK; for Mooney-Rivlin, which has no
    blocks kernel here or in the JAX package, the exact blocks of
    `MooneyRivlin.tangent_diag_block` in plain tensor code, summed onto the
    nodes in a fixed order (the XLA branch, `common.py:263-270`). Then the
    Kelvin-Voigt factor, from the material's small-strain `lam` and `mu`;
    symmetrised and shifted by its Gershgorin deficit so PCG gets an SPD
    preconditioner (`common.py:284-320`)."""
    elems = system.elems
    op = system.fem
    if u_prev is None:
        u_prev = x_prev - node_ref(elems)
    u = (u_prev + dt * v).to(v.dtype).contiguous()
    if op.kind == "svk":
        fns = element_fns(system.plain)
        blocks = unpack_sym6(dt * fns["node_reduce"](op, fns["svk_blocks"](op, u)))
    else:
        blocks = dt * node_reduce_plain(op, tangent_blocks_plain(op, u)).view(op.n, 3, 3)

    # Kelvin-Voigt tangent: same lam*A + mu*B structure as the elastic one
    # with (lam_d, eta) for (dt*lam, dt*mu), folded in as a scalar factor.
    mat = system.material
    blocks = blocks * (1.0 + (mat.eta_damp + mat.lam_damp) / (dt * (mat.lam + mat.mu)))

    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    blocks = blocks + (op.md / dt)[:, None, None] * eye
    cons = system.constraints
    if cons is not None:
        d = cons.jtj_diag(elems.n_coef, v.dtype)  # (n,) pins, (n, 3) linear rows
        if d.ndim == 1:
            blocks = blocks + (dt * dt * rho) * d[:, None, None] * eye
        else:
            blocks = blocks + torch.diag_embed((dt * dt * rho) * d)

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


def alm_outer(system: System, state: StepState, params, f_ext, inner, dual_scale: float):
    """The outer ALM loop of the first-order solvers (`adamw.py:91-124`,
    `nesterov.py:71-103`, `vbd.py:152-183`). inner(v, v_prev, lam) -> (v,
    inner iterations) runs one inner solve; after it v_prev = v, as in the
    reference, and the duals take lam += dual_scale * c. At most
    params.max_outer passes, the first always, then while ||c|| >=
    params.outer_tol. Returns (state, outer passes, inner iterations in
    all, ||c||): u = u_prev + dt v in displacement space, x = x_ref + u,
    dv zeros (the reference leaves it unset)."""
    x_ref = node_ref(system.elems)
    cons = system.constraints
    v = v_prev = state.v
    lam = state.lam
    outers = inner_tot = 0
    norm_c = float("inf")
    while outers < params.max_outer and (outers == 0 or norm_c >= params.outer_tol):
        v, n_it = inner(v, v_prev, lam)
        v_prev = v
        if cons is not None:
            c = constraint_values(cons, state.x, v, params.dt, system.elems, u_prev=state.u)
            lam = lam + dual_scale * c
            norm_c = float(flat_norm(c))
        else:
            norm_c = 0.0
        outers += 1
        inner_tot += n_it
    u = state.u + params.dt * v  # displacement-scale update: never x_prev + dt v
    x = (x_ref + u).to(state.x.dtype)
    return StepState(x=x, v=v, lam=lam, u=u, dv=torch.zeros_like(v)), outers, inner_tot, norm_c


def suggest_rho(elems: ElementBatch, material, dt: float) -> float:
    """ALM penalty scaled to the problem stiffness: rho ~ E * h_elem / dt."""
    E_mod = float(material.mu) * 2.0 + float(material.lam)
    vol = float(elems.dV.sum()) / max(elems.n_elem, 1)
    h = vol ** (1.0 / 3.0)
    return E_mod * h / float(dt)
