"""Shared machinery of the ANCF (Absolute Nodal Coordinate Formulation)
elements (port of `tlfea/elements/ancf.py`).

ANCF elements interpolate the position field with monomial bases in local
coordinates (u, v, w) in [-L/2, L/2] x [-W/2, W/2] x [-H/2, H/2]; each node
carries 4 vector coefficients (position r and gradients r_u, r_v, r_w), and
the shape functions come from inverting the nodal-condition matrix B:
s(p) = B^{-T} b(p).

Everything is precomputed on the host once, in float64 NumPy copied from
the reference module so that the arrays are identical: physical
shape-function gradients at the stiffness QPs and consistent mass blocks at
the (denser) mass QPs, packed into the same `ElementBatch` the FEAT10 path
uses, then moved to the device. Device-side code is the same for every
family; only the kernels' (Q, S, translation mask) instantiation differs.
"""

from __future__ import annotations

import numpy as np
import torch

from tlfea_torch.elements.assembly import ElementBatch
from tlfea_torch.utils.quadrature import tensor_product_rule

__all__ = [
    "MONOMIALS_3243",
    "MONOMIALS_3443",
    "eval_basis",
    "eval_basis_grad",
    "nodal_condition_matrix",
    "build_ancf_batch",
]

# Monomial exponents (pu, pv, pw) for u^pu v^pv w^pw.
# ANCF3243 beam basis {1, u, v, w, uv, uw, u^2, u^3}.
MONOMIALS_3243 = np.array(
    [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (1, 0, 1), (2, 0, 0), (3, 0, 0),
    ],
    dtype=np.int64,
)

# ANCF3443 shell basis {1,u,v,w,uv,uw,vw,uvw,u^2,v^2,u^2v,uv^2,u^3,v^3,u^3v,uv^3}.
MONOMIALS_3443 = np.array(
    [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
        (2, 0, 0), (0, 2, 0), (2, 1, 0), (1, 2, 0),
        (3, 0, 0), (0, 3, 0), (3, 1, 0), (1, 3, 0),
    ],
    dtype=np.int64,
)


def _pow(base: np.ndarray, exp: np.ndarray) -> np.ndarray:
    """base**exp with 0**0 == 1."""
    return np.power(base[..., None], exp[None, :], where=True)


def eval_basis(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Monomial basis values at local points pts (..., 3) -> (..., n_shape)."""
    u, v, w = pts[..., 0], pts[..., 1], pts[..., 2]
    return _pow(u, exps[:, 0]) * _pow(v, exps[:, 1]) * _pow(w, exps[:, 2])


def eval_basis_grad(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """d(basis)/d(u, v, w) at local points -> (..., n_shape, 3)."""
    u, v, w = pts[..., 0], pts[..., 1], pts[..., 2]
    pu, pv, pw = exps[:, 0], exps[:, 1], exps[:, 2]
    du = pu * _pow(u, np.maximum(pu - 1, 0)) * _pow(v, pv) * _pow(w, pw)
    dv = pv * _pow(u, pu) * _pow(v, np.maximum(pv - 1, 0)) * _pow(w, pw)
    dw = pw * _pow(u, pu) * _pow(v, pv) * _pow(w, np.maximum(pw - 1, 0))
    return np.stack([du, dv, dw], axis=-1)


def nodal_condition_matrix(exps: np.ndarray, node_pts: np.ndarray) -> np.ndarray:
    """B matrix: rows = [b(p); db_du(p); db_dv(p); db_dw(p)] per node point.

    node_pts: (n_nodes_el, 3) local coordinates of the element's nodes.
    -> (4 * n_nodes_el, n_shape) square matrix.
    """
    vals = eval_basis(exps, node_pts)  # (n, S)
    grads = eval_basis_grad(exps, node_pts)  # (n, S, 3)
    rows = []
    for k in range(node_pts.shape[0]):
        rows.append(vals[k])
        rows.append(grads[k, :, 0])
        rows.append(grads[k, :, 1])
        rows.append(grads[k, :, 2])
    return np.stack(rows, axis=0)


def build_ancf_batch(
    coefs: np.ndarray,
    conn_nodes: np.ndarray,
    L,
    W,
    H,
    exps: np.ndarray,
    node_pts_fn,
    stiff_rule: tuple[int, int, int],
    mass_rule: tuple[int, int, int],
    rho: float,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> ElementBatch:
    """The `ElementBatch` of an ANCF family on `device`, tables in `dtype`.

    coefs: (n_coef, 3) reference coefficient values, node-major blocks of 4
      [r, r_u, r_v, r_w] per node.
    conn_nodes: (E, n_nodes_el) node indices per element.
    L, W, H: per-element local-frame extents (scalars broadcast).
    node_pts_fn(L, W, H) -> (n_nodes_el, 3) local node coordinates.
    stiff_rule / mass_rule: tensor-product Gauss orders (n_xi, n_eta, n_zeta).
    """
    coefs = np.asarray(coefs, dtype=np.float64)
    conn_nodes = np.asarray(conn_nodes, dtype=np.int64)
    E = conn_nodes.shape[0]
    n_nodes_el = conn_nodes.shape[1]
    S = 4 * n_nodes_el
    if exps.shape[0] != S:
        raise ValueError(f"basis size {exps.shape[0]} != 4 * nodes/elem {S}")

    L = np.broadcast_to(np.asarray(L, dtype=np.float64), (E,))
    W = np.broadcast_to(np.asarray(W, dtype=np.float64), (E,))
    H = np.broadcast_to(np.asarray(H, dtype=np.float64), (E,))

    # Coefficient connectivity: node-major blocks of 4.
    conn = (conn_nodes[:, :, None] * 4 + np.arange(4)[None, None, :]).reshape(E, S)

    # Per-element shape-function coefficient matrices: s(p) = Binv_T @ b(p),
    # Binv_T = inv(B)^T; identical (L, W, H) share one inversion.
    Binv_T = np.empty((E, S, S))
    key = np.stack([L, W, H], axis=1)
    uniq, inv_idx = np.unique(key, axis=0, return_inverse=True)
    inv_idx = inv_idx.reshape(-1)
    for u_i, (l_, w_, h_) in enumerate(uniq):
        B = nodal_condition_matrix(exps, np.asarray(node_pts_fn(l_, w_, h_)))
        Binv_T[inv_idx == u_i] = np.linalg.inv(B.T)

    def natural_to_local(pts_nat, Le, We, He):
        # (Q, 3) natural in [-1,1]^3 -> per-element local (E, Q, 3)
        scale = np.stack([Le / 2.0, We / 2.0, He / 2.0], axis=-1)  # (E, 3)
        return pts_nat[None, :, :] * scale[:, None, :]

    Xe = coefs[conn]  # (E, S, 3) reference coefficient values

    def grads_and_det(rule):
        pts_nat, wts = tensor_product_rule(*rule)
        local = natural_to_local(pts_nat, L, W, H)  # (E, Q, 3)
        db = eval_basis_grad(exps, local)  # (E, Q, S, 3) d/d(u,v,w)
        # chain rule to natural coords: d/d(xi) = d/du * L/2, etc.
        scale = np.stack([L / 2.0, W / 2.0, H / 2.0], axis=-1)  # (E, 3)
        db_nat = db * scale[:, None, None, :]
        ds_nat = np.einsum("eij,eqjd->eqid", Binv_T, db_nat)  # (E, Q, S, 3)
        # Reference Jacobian J_ij = sum_a X_a[i] ds_a[j]
        J = np.einsum("eai,eqaj->eqij", Xe, ds_nat)
        detJ = np.linalg.det(J)
        return ds_nat, J, detJ, wts

    # Stiffness-rule physical gradients.
    ds_nat, J, detJ, wts = grads_and_det(stiff_rule)
    if np.any(detJ <= 0):
        n_bad = int(np.sum(np.any(detJ <= 0, axis=1)))
        raise ValueError(f"{n_bad} ANCF elements have non-positive detJ")
    JT = np.swapaxes(J, -1, -2)
    grad_N = np.linalg.solve(JT[:, :, None, :, :], ds_nat[..., None])[..., 0]
    dV = detJ * wts[None, :]

    # Mass-rule consistent element mass.
    pts_nat_m, wts_m = tensor_product_rule(*mass_rule)
    local_m = natural_to_local(pts_nat_m, L, W, H)
    b_m = eval_basis(exps, local_m)  # (E, Qm, S)
    s_m = np.einsum("eij,eqj->eqi", Binv_T, b_m)  # (E, Qm, S)
    db_m = eval_basis_grad(exps, local_m)
    scale = np.stack([L / 2.0, W / 2.0, H / 2.0], axis=-1)
    ds_m = np.einsum("eij,eqjd->eqid", Binv_T, db_m * scale[:, None, None, :])
    detJ_m = np.linalg.det(np.einsum("eai,eqaj->eqij", Xe, ds_m))
    Me = rho * np.einsum("eqa,eqb,eq,q->eab", s_m, s_m, detJ_m, wts_m)

    device = torch.device(device)

    def t(a):
        return torch.as_tensor(a).to(dtype).to(device)

    return ElementBatch(
        conn=torch.as_tensor(conn.astype(np.int64), device=device),
        grad_N=t(grad_N),
        dV=t(dV),
        mass_elem=t(Me),
        xe_ref=t(Xe),
        n_coef=int(coefs.shape[0]),
        x_ref=t(coefs),
        # Position slots (every node's first coefficient) carry rigid
        # translation: their shape gradients sum to exactly zero.
        trans_mask=tuple(a % 4 == 0 for a in range(S)),
    )
