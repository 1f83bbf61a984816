"""Element batch and plain element assembly (port of
`tlfea/elements/assembly.py`).

Every element family reduces after host-side precomputation to the same
tables: conn (E, S), grad_N (E, Q, S, 3), dV (E, Q), mass_elem (E, S, S).
The functions here are the plain PyTorch element algebra; the hot path runs
the same arithmetic in the CUDA kernels of `tlfea_torch.ops.fem_kernels`.
`deformation_gradient` ... `assemble_mass_csr` are host helpers for
diagnostics and export (`tlfea/elements/assembly.py:128-205, 283-338`),
with no kernel behind them in either package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from tlfea_torch.ops.segment import coef_scatter_add, gather_coefs

__all__ = [
    "ElementBatch",
    "node_ref",
    "center_translation",
    "deformation_gradient",
    "velocity_gradient",
    "viscous_piola",
    "total_piola",
    "internal_force",
    "alm_residual_contributions",
    "mass_matvec",
    "mass_diag",
    "lumped_mass",
    "assemble_mass_csr",
]


@dataclass
class ElementBatch:
    """A batch of same-family elements as tensors on one device.

    xe_ref / x_ref are the reference positions per element slot and per node;
    the solver works in DISPLACEMENT space u = x - x_ref, since in float32
    absolute coordinates round the tiny increments dt*v away. trans_mask
    marks the slots whose shape gradients sum to zero (all ten for FEAT10),
    which makes element-local centring exact (see `center_translation`).
    """

    conn: torch.Tensor  # (E, S) int64
    grad_N: torch.Tensor  # (E, Q, S, 3)
    dV: torch.Tensor  # (E, Q)
    mass_elem: torch.Tensor  # (E, S, S)
    xe_ref: torch.Tensor  # (E, S, 3)
    n_coef: int
    x_ref: torch.Tensor  # (n_coef, 3)
    trans_mask: tuple | None = None

    @property
    def n_elem(self) -> int:
        return self.conn.shape[0]

    @property
    def n_shape(self) -> int:
        return self.conn.shape[1]

    @property
    def device(self) -> torch.device:
        return self.grad_N.device

    def to(self, device=None, dtype=None) -> "ElementBatch":
        """Copy onto `device` with floating tables cast to `dtype`."""

        def f(t):
            return t.to(device=device, dtype=dtype)

        return replace(
            self, conn=self.conn.to(device=device), grad_N=f(self.grad_N),
            dV=f(self.dV), mass_elem=f(self.mass_elem), xe_ref=f(self.xe_ref),
            x_ref=f(self.x_ref),
        )


def node_ref(elems: ElementBatch) -> torch.Tensor:
    """Node-level reference positions (n_coef, 3)."""
    return elems.x_ref


def center_translation(ae: torch.Tensor, elems: ElementBatch) -> torch.Tensor:
    """Element-local centring of gathered per-slot values (E, S, k).

    Subtracts the first translation slot's value from every translation
    slot. Exact, because their shape gradients sum to zero; it removes the
    rigid-motion common mode, so gradient contractions see element-relative
    operands and float32 loses no digits to |u| (an eps*E*theta residual
    floor without it)."""
    tm = elems.trans_mask
    if tm is None:
        return ae
    r = tm.index(True)
    mask = torch.tensor(tm, device=ae.device)
    return ae - torch.where(mask[None, :, None], ae[:, r:r + 1, :],
                            torch.zeros((), dtype=ae.dtype, device=ae.device))


def deformation_gradient(x: torch.Tensor, elems: ElementBatch) -> torch.Tensor:
    """F = I + sum_a (x_a - X_a) (x) gradN_a at every quadrature point, from
    positions x (n_coef, 3) -> (E, Q, 3, 3), displacement-based."""
    xe = gather_coefs(x, elems.conn)  # (E, S, 3)
    Du = torch.einsum("eai,eqaj->eqij", xe - elems.xe_ref, elems.grad_N)
    return Du + torch.eye(3, dtype=Du.dtype, device=Du.device)


def velocity_gradient(v: torch.Tensor, elems: ElementBatch) -> torch.Tensor:
    """Fdot at every quadrature point from velocities v (n_coef, 3)."""
    return torch.einsum("eai,eqaj->eqij", gather_coefs(v, elems.conn), elems.grad_N)


def viscous_piola(F: torch.Tensor, Fdot: torch.Tensor, eta: float,
                  lam_d: float) -> torch.Tensor:
    """Kelvin-Voigt viscous first Piola stress P_vis = F S_vis with
    S_vis = 2 eta Edot + lam_d tr(Edot) I, Edot = (Fdot^T F + F^T Fdot)/2."""
    FdotT_F = torch.einsum("...ki,...kj->...ij", Fdot, F)
    Edot = 0.5 * (FdotT_F + FdotT_F.transpose(-1, -2))
    trEdot = Edot[..., 0, 0] + Edot[..., 1, 1] + Edot[..., 2, 2]
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    S_vis = 2.0 * eta * Edot + (lam_d * trEdot)[..., None, None] * eye
    return torch.einsum("...ik,...kj->...ij", F, S_vis)


def total_piola(x: torch.Tensor, v: torch.Tensor | None, elems: ElementBatch,
                material) -> torch.Tensor:
    """Elastic plus Kelvin-Voigt first Piola stress at every quadrature
    point -> (E, Q, 3, 3); v None (or an undamped material) leaves the
    viscous part out."""
    xe = gather_coefs(x, elems.conn)
    Du = torch.einsum("eai,eqaj->eqij", xe - elems.xe_ref, elems.grad_N)
    P = material.first_piola_du(Du)
    if v is not None and material.damped:
        F = Du + torch.eye(3, dtype=Du.dtype, device=Du.device)
        P = P + viscous_piola(F, velocity_gradient(v, elems), material.eta_damp,
                              material.lam_damp)
    return P


def internal_force(x: torch.Tensor, v: torch.Tensor | None, elems: ElementBatch,
                   material) -> torch.Tensor:
    """f_int (n_coef, 3): f_a = sum_q P grad_N_a dV, summed onto the nodes
    in a fixed order."""
    P = total_piola(x, v, elems, material)
    fe = torch.einsum("eqij,eqaj,eq->eai", P, elems.grad_N, elems.dV)
    return coef_scatter_add(fe, elems.conn, elems.n_coef)


def alm_residual_contributions(u: torch.Tensor, v: torch.Tensor, dv_dt: torch.Tensor,
                               elems: ElementBatch, material) -> torch.Tensor:
    """The element contributions of the ALM gradient summed onto the nodes,
    M dv_dt + f_int(u, v) -> (n_coef, 3) (`assembly.py:205-228`), from
    node displacements u: K5 `contrib` and K4 `node_reduce` on a
    `FemOperator` of (elems, material) (their plain twins on CPU tensors)."""
    from tlfea_torch.ops import fem_kernels as fk

    op = fk.FemOperator(elems, material)
    packed = torch.cat([u, v, dv_dt], dim=1).to(op.gN_t.dtype).contiguous()
    return fk.node_reduce(op, fk.contrib(op, packed))


def mass_matvec(v: torch.Tensor, elems: ElementBatch) -> torch.Tensor:
    """Consistent-mass product M v (n_coef, 3) without assembling M."""
    mv = torch.einsum("eab,ebi->eai", elems.mass_elem, gather_coefs(v, elems.conn))
    return coef_scatter_add(mv, elems.conn, elems.n_coef)


def mass_diag(elems: ElementBatch) -> torch.Tensor:
    """Diagonal of the assembled consistent mass matrix -> (n_coef,)."""
    diag_e = torch.diagonal(elems.mass_elem, dim1=1, dim2=2)  # (E, S)
    return coef_scatter_add(diag_e[..., None], elems.conn, elems.n_coef)[:, 0]


def lumped_mass(elems: ElementBatch) -> torch.Tensor:
    """Row-sum lumped mass -> (n_coef,)."""
    rows = elems.mass_elem.sum(dim=2)  # (E, S)
    return coef_scatter_add(rows[..., None], elems.conn, elems.n_coef)[:, 0]


def assemble_mass_csr(elems: ElementBatch):
    """The assembled coefficient-level mass matrix in CSR form, (offsets
    (n+1,), columns (nnz,), values (nnz,)) as NumPy arrays: for inspection
    and export; the solvers never assemble it."""
    conn = elems.conn.cpu().numpy()
    me = elems.mass_elem.detach().cpu().numpy()
    S = conn.shape[1]
    rows = np.repeat(conn, S, axis=1).reshape(-1)
    cols = np.tile(conn, (1, S)).reshape(-1)
    vals = me.reshape(-1)
    order = np.lexsort((cols, rows))  # sum duplicates after a lexicographic sort
    rows, cols, vals = rows[order], cols[order], vals[order]
    new = np.ones(len(rows), dtype=bool)
    new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    group = np.cumsum(new) - 1
    u_vals = np.zeros(int(group[-1]) + 1 if len(group) else 0)
    np.add.at(u_vals, group, vals)
    offsets = np.zeros(elems.n_coef + 1, dtype=np.int64)
    np.add.at(offsets, rows[new] + 1, 1)
    return np.cumsum(offsets), cols[new], u_vals
