"""FEAT10: 10-node quadratic tetrahedron (port of `tlfea/elements/feat10.py`).

Host-side precomputation (NumPy, float64) of physical shape-function
gradients, quadrature volumes and consistent element mass, copied from the
reference module so that the arrays are identical, then packed into a torch
`ElementBatch` in the requested dtype.

Node ordering (canonical): corners [0..3], then edge midnodes
[(0,1), (1,2), (0,2), (0,3), (1,3), (2,3)].
"""

from __future__ import annotations

import numpy as np
import torch

from tlfea_torch.elements.assembly import ElementBatch
from tlfea_torch.utils.quadrature import keast5_tet, tet_duffy_rule

__all__ = [
    "T10_EDGES",
    "shape_functions",
    "shape_gradients_natural",
    "precompute",
    "element_mass",
    "build",
]

T10_EDGES = np.array([(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)], dtype=np.int64)

# dL_k / d(xi, eta, zeta) for barycentric L = (1-xi-eta-zeta, xi, eta, zeta).
_DL = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    dtype=np.float64,
)


def shape_functions(xi: np.ndarray) -> np.ndarray:
    """T10 shape functions at natural coordinates xi: (..., 3) -> (..., 10)."""
    xi = np.asarray(xi, dtype=np.float64)
    L1 = 1.0 - xi[..., 0] - xi[..., 1] - xi[..., 2]
    L = np.stack([L1, xi[..., 0], xi[..., 1], xi[..., 2]], axis=-1)  # (..., 4)
    corners = L * (2.0 * L - 1.0)
    edges = 4.0 * L[..., T10_EDGES[:, 0]] * L[..., T10_EDGES[:, 1]]
    return np.concatenate([corners, edges], axis=-1)


def shape_gradients_natural(xi: np.ndarray) -> np.ndarray:
    """dN/d(xi,eta,zeta) at natural coordinates: (..., 3) -> (..., 10, 3)."""
    xi = np.asarray(xi, dtype=np.float64)
    L1 = 1.0 - xi[..., 0] - xi[..., 1] - xi[..., 2]
    L = np.stack([L1, xi[..., 0], xi[..., 1], xi[..., 2]], axis=-1)  # (..., 4)
    corner = (4.0 * L - 1.0)[..., :, None] * _DL  # (..., 4, 3)
    i, j = T10_EDGES[:, 0], T10_EDGES[:, 1]
    edge = 4.0 * (L[..., i, None] * _DL[j] + L[..., j, None] * _DL[i])  # (..., 6, 3)
    return np.concatenate([corner, edge], axis=-2)


def precompute(nodes: np.ndarray, conn: np.ndarray):
    """Per-(element, QP) physical gradients and volumes.

    Returns (grad_N (E, 5, 10, 3), dV (E, 5), detJ (E, 5), weights (5,)).
    """
    bary, w = keast5_tet()
    qp_xyz = bary[:, 1:]  # natural coords = (L2, L3, L4)
    dN = shape_gradients_natural(qp_xyz)  # (5, 10, 3)

    Xe = nodes[conn]  # (E, 10, 3)
    J = np.einsum("eai,qaj->eqij", Xe, dN)  # (E, 5, 3, 3)
    detJ = np.linalg.det(J)
    # Solve J^T grad_N = dN  (physical gradients)
    JT = np.swapaxes(J, -1, -2)
    grad_N = np.linalg.solve(JT[:, :, None, :, :], dN[None, :, :, :, None])[..., 0]
    dV = detJ * w[None, :]
    return grad_N, dV, detJ, w


def element_mass(
    nodes: np.ndarray, conn: np.ndarray, rho: float, rule: str = "exact"
) -> np.ndarray:
    """Consistent element mass blocks Me[a,b] = rho * sum_q N_a N_b detJ w_q.

    rule="exact" (default): the degree-exact positive Duffy rule, so M is
    SPD. rule="keast5": the 5-point rule, whose negative weight makes M
    indefinite."""
    if rule == "keast5":
        bary, w = keast5_tet()
        qp = bary[:, 1:]
    elif rule == "exact":
        qp, w = tet_duffy_rule(4)
    else:
        raise ValueError(f"unknown mass rule {rule!r}")
    N = shape_functions(qp)  # (Qm, 10)
    dN = shape_gradients_natural(qp)  # (Qm, 10, 3)
    Xe = nodes[conn]
    detJ = np.linalg.det(np.einsum("eai,qaj->eqij", Xe, dN))  # (E, Qm)
    return rho * np.einsum("qa,qb,eq,q->eab", N, N, detJ, w)


def build(
    nodes: np.ndarray,
    conn: np.ndarray,
    rho: float,
    dtype: torch.dtype = torch.float64,
    mass_rule: str = "exact",
    device="cuda",
) -> ElementBatch:
    """The `ElementBatch` of a T10 mesh on `device`, tables in `dtype`, with
    the consistent mass of `element_mass`'s `mass_rule` (the SPD "exact" by
    default; "keast5" as the JAX build takes it). The tables are computed on
    the host in float64, then cast and moved; pass device="cpu" to keep them
    there."""
    nodes = np.asarray(nodes, dtype=np.float64)
    conn = np.asarray(conn, dtype=np.int32)
    grad_N, dV, detJ, _ = precompute(nodes, conn)
    if np.any(detJ <= 0):
        n_bad = int(np.sum(np.any(detJ <= 0, axis=1)))
        raise ValueError(f"{n_bad} elements have non-positive Jacobian determinant")
    me = element_mass(nodes, conn, rho, rule=mass_rule)

    device = torch.device(device)

    def t(a):
        return torch.as_tensor(a).to(dtype).to(device)

    return ElementBatch(
        conn=torch.as_tensor(conn.astype(np.int64), device=device),
        grad_N=t(grad_N),
        dV=t(dV),
        mass_elem=t(me),
        xe_ref=t(nodes[conn]),
        n_coef=int(nodes.shape[0]),
        x_ref=t(nodes),
        trans_mask=(True,) * 10,  # all Lagrange slots: sum_a grad_N_a = 0
    )
