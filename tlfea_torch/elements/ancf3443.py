"""ANCF3443: 4-node fully-parameterised shell element (port of
`tlfea/elements/ancf3443.py`).

16 shape functions from the bicubic-in-(u,v) monomial basis
{1,u,v,w,uv,uw,vw,uvw,u^2,v^2,u^2v,uv^2,u^3,v^3,u^3v,uv^3}; 4 vector
coefficients per node -> 16 slots per element. Stiffness quadrature 4x4x3
(48 QPs), mass quadrature 7x7x3. Corner ordering (local u, v): (-,-), (+,-),
(+,+), (-,+), w = 0 midsurface.
"""

from __future__ import annotations

import numpy as np
import torch

from tlfea_torch.elements.ancf import MONOMIALS_3443, build_ancf_batch
from tlfea_torch.elements.assembly import ElementBatch

__all__ = ["build", "shell_strip", "shell_grid", "N_SHAPE"]

N_SHAPE = 16
STIFF_RULE = (4, 4, 3)
MASS_RULE = (7, 7, 3)


def _node_pts(L, W, H):
    return np.array(
        [
            [-L / 2.0, -W / 2.0, 0.0],
            [L / 2.0, -W / 2.0, 0.0],
            [L / 2.0, W / 2.0, 0.0],
            [-L / 2.0, W / 2.0, 0.0],
        ]
    )


def build(coefs, conn_nodes, L, W, H, rho, dtype: torch.dtype = torch.float64,
          device="cuda") -> ElementBatch:
    """The `ElementBatch` of ANCF3443 shells on `device` (tables computed on
    the host in float64, then cast to `dtype` and moved).

    coefs: (4 * n_nodes, 3) node-major [r, r_u, r_v, r_w] blocks.
    conn_nodes: (E, 4) node indices in corner order. L/W/H per-element.
    """
    return build_ancf_batch(
        coefs, conn_nodes, L, W, H,
        exps=MONOMIALS_3443, node_pts_fn=_node_pts,
        stiff_rule=STIFF_RULE, mass_rule=MASS_RULE, rho=rho, dtype=dtype, device=device,
    )


def shell_strip(n_elem: int, L: float = 1.0, W: float = 1.0):
    """Chain of n_elem shells along +x in the z=0 plane.

    Matches the reference's chain-of-shells generator topology
    (`cpu_utils.cc:476-520`: 4 + 2*(n-1) nodes, consecutive elements share an
    edge). Node k column at x = k*L; each column has bottom (y=0) and top
    (y=W) nodes. Returns (coefs, conn (E, 4)).
    """
    n_cols = n_elem + 1
    n_nodes = 2 * n_cols
    coefs = np.zeros((4 * n_nodes, 3))

    def nid(col, top):
        return 2 * col + (1 if top else 0)

    for col in range(n_cols):
        for top in (False, True):
            b = 4 * nid(col, top)
            coefs[b + 0] = [col * L, W if top else 0.0, 0.0]
            coefs[b + 1] = [1.0, 0.0, 0.0]  # r_u
            coefs[b + 2] = [0.0, 1.0, 0.0]  # r_v
            coefs[b + 3] = [0.0, 0.0, 1.0]  # r_w
    conn = np.asarray(
        [
            [nid(e, False), nid(e + 1, False), nid(e + 1, True), nid(e, True)]
            for e in range(n_elem)
        ],
        dtype=np.int64,
    )
    return coefs, conn


def shell_grid(nx: int, ny: int, L: float = 1.0, W: float = 1.0):
    """nx x ny structured plate of shells in the z=0 plane.

    2-D generalization of `shell_strip` (reference chain-of-shells generator,
    `cpu_utils.cc:476-520`): interior edges are shared, so the mesh is a
    conforming plate — the shape the reference's shell demos tile. Element
    (i, j) spans [i L, (i+1) L] x [j W, (j+1) W]; corner order matches
    `shell_strip` (counter-clockwise from the low corner). Returns
    (coefs (4*n_nodes, 3), conn (nx*ny, 4)).
    """
    n_nodes = (nx + 1) * (ny + 1)
    coefs = np.zeros((4 * n_nodes, 3))

    def nid(i, j):
        return j * (nx + 1) + i

    for j in range(ny + 1):
        for i in range(nx + 1):
            b = 4 * nid(i, j)
            coefs[b + 0] = [i * L, j * W, 0.0]
            coefs[b + 1] = [1.0, 0.0, 0.0]  # r_u
            coefs[b + 2] = [0.0, 1.0, 0.0]  # r_v
            coefs[b + 3] = [0.0, 0.0, 1.0]  # r_w
    conn = np.asarray(
        [
            [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)]
            for j in range(ny)
            for i in range(nx)
        ],
        dtype=np.int64,
    )
    return coefs, conn
