"""ANCF3243: 2-node fully-parameterised 3D beam element (port of
`tlfea/elements/ancf3243.py`).

8 shape functions from the monomial basis {1, u, v, w, uv, uw, u^2, u^3};
4 vector coefficients per node [r, r_u, r_v, r_w] -> n_coef = 4 * n_nodes.
Stiffness quadrature 3x2x2 (12 QPs), mass quadrature 6x2x2.
"""

from __future__ import annotations

import numpy as np
import torch

from tlfea_torch.elements.ancf import MONOMIALS_3243, build_ancf_batch
from tlfea_torch.elements.assembly import ElementBatch

__all__ = ["build", "straight_beam", "grid_mesh", "N_SHAPE"]

N_SHAPE = 8
STIFF_RULE = (3, 2, 2)
MASS_RULE = (6, 2, 2)


def _node_pts(L, W, H):
    """Local coordinates of the 2 beam nodes: endpoints on the beam axis."""
    return np.array([[-L / 2.0, 0.0, 0.0], [L / 2.0, 0.0, 0.0]])


def build(coefs, conn_nodes, L, W, H, rho, dtype: torch.dtype = torch.float64,
          device="cuda") -> ElementBatch:
    """The `ElementBatch` of ANCF3243 beams on `device` (tables computed on
    the host in float64, then cast to `dtype` and moved).

    coefs: (4 * n_nodes, 3) node-major [r, r_u, r_v, r_w] blocks.
    conn_nodes: (E, 2) node indices. L/W/H: per-element (or scalar) extents.
    """
    return build_ancf_batch(
        coefs, conn_nodes, L, W, H,
        exps=MONOMIALS_3243, node_pts_fn=_node_pts,
        stiff_rule=STIFF_RULE, mass_rule=MASS_RULE, rho=rho, dtype=dtype, device=device,
    )


def straight_beam(n_elem: int, L: float = 2.0, origin=(-1.0, 1.0, 0.0)):
    """Chain of n_elem beams along +x with identity directors.

    Returns (coefs (4*(n_elem+1), 3), conn (E, 2)). Default origin matches
    the reference's generator (first node at (-1, 1, 0), spacing L = 2:
    `cpu_utils.cc:443-474`).
    """
    n_nodes = n_elem + 1
    coefs = np.zeros((4 * n_nodes, 3))
    for i in range(n_nodes):
        b = 4 * i
        coefs[b + 0] = [origin[0] + i * L, origin[1], origin[2]]
        coefs[b + 1] = [1.0, 0.0, 0.0]  # r_u
        coefs[b + 2] = [0.0, 1.0, 0.0]  # r_v
        coefs[b + 3] = [0.0, 0.0, 1.0]  # r_w
    conn = np.stack([np.arange(n_elem), np.arange(1, n_nodes)], axis=1)
    return coefs, conn


def grid_mesh(
    X: float,
    Y: float,
    L: float,
    include_horizontal: bool = True,
    include_vertical: bool = True,
):
    """Structured beam grid/net in the z=0 plane with spacing L.

    Nodes at (i L, j L, 0); horizontal elements first (row-major), then
    vertical (column-major), mirroring the reference's `GridMeshGenerator`
    (`mesh_utils.cc:48-96`). Returns (coefs, conn (E,2), n_nodes).

    Directors are identity for horizontal members; vertical members share the
    same nodal coefficient set (ANCF gradient coefficients are per-node, not
    per-element).
    """
    nx = int(round(X / L))
    ny = int(round(Y / L))
    n_nodes = (nx + 1) * (ny + 1)

    def nid(i, j):
        return j * (nx + 1) + i

    coefs = np.zeros((4 * n_nodes, 3))
    for j in range(ny + 1):
        for i in range(nx + 1):
            b = 4 * nid(i, j)
            coefs[b + 0] = [i * L, j * L, 0.0]
            coefs[b + 1] = [1.0, 0.0, 0.0]
            coefs[b + 2] = [0.0, 1.0, 0.0]
            coefs[b + 3] = [0.0, 0.0, 1.0]

    elems = []
    if include_horizontal:
        for j in range(ny + 1):
            for i in range(nx):
                elems.append((nid(i, j), nid(i + 1, j)))
    if include_vertical:
        for i in range(nx + 1):
            for j in range(ny):
                elems.append((nid(i, j), nid(i, j + 1)))
    return coefs, np.asarray(elems, dtype=np.int64), n_nodes
