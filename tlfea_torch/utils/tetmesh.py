"""Structured T10 tetrahedral meshes (host-side NumPy).

A copy of `box_t10_mesh` (`tlfea/utils/tetmesh.py:137`) and `t10_from_t4`
(:111), so the port builds the same meshes without importing jax.
`tests/test_torch_setup.py` holds the arrays equal to the original.

Canonical T10 node order: corners [0..3], then edge midnodes
[(0,1), (1,2), (0,2), (0,3), (1,3), (2,3)].
"""

from __future__ import annotations

import numpy as np

__all__ = ["box_t10_mesh", "t10_from_t4"]

_T10_EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]


def t10_from_t4(nodes4: np.ndarray, conn4: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Promote a linear tet mesh to quadratic T10 by inserting edge midnodes."""
    nodes4 = np.asarray(nodes4, dtype=np.float64)
    conn4 = np.asarray(conn4, dtype=np.int64)
    edge_ids: dict[tuple[int, int], int] = {}
    mid_coords: list[np.ndarray] = []
    n0 = nodes4.shape[0]

    def mid(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        idx = edge_ids.get(key)
        if idx is None:
            idx = n0 + len(mid_coords)
            edge_ids[key] = idx
            mid_coords.append(0.5 * (nodes4[a] + nodes4[b]))
        return idx

    conn10 = np.empty((conn4.shape[0], 10), dtype=np.int64)
    for e, tet in enumerate(conn4):
        conn10[e, :4] = tet
        for k, (i, j) in enumerate(_T10_EDGES):
            conn10[e, 4 + k] = mid(int(tet[i]), int(tet[j]))
    nodes10 = np.vstack([nodes4, np.asarray(mid_coords)]) if mid_coords else nodes4
    return nodes10, conn10


def box_t10_mesh(
    lx: float,
    ly: float,
    lz: float,
    nx: int,
    ny: int,
    nz: int,
    origin=(0.0, 0.0, 0.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Structured T10 mesh of an (lx, ly, lz) box: each grid cell -> 6 tets.

    Returns (nodes (N,3), conn (E,10) canonical), E = 6 * nx * ny * nz, from
    the Kuhn (Freudenthal) 6-tet cube subdivision: conforming, all tets of
    positive volume.
    """
    xs = np.linspace(0.0, lx, nx + 1) + origin[0]
    ys = np.linspace(0.0, ly, ny + 1) + origin[1]
    zs = np.linspace(0.0, lz, nz + 1) + origin[2]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes4 = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    # Kuhn subdivision: 6 tets per cube around the main diagonal c0 -> c7.
    kuhn = [
        (0, 1, 3, 7),
        (0, 3, 2, 7),
        (0, 2, 6, 7),
        (0, 6, 4, 7),
        (0, 4, 5, 7),
        (0, 5, 1, 7),
    ]
    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = [
                    vid(i, j, k),
                    vid(i + 1, j, k),
                    vid(i, j + 1, k),
                    vid(i + 1, j + 1, k),
                    vid(i, j, k + 1),
                    vid(i + 1, j, k + 1),
                    vid(i, j + 1, k + 1),
                    vid(i + 1, j + 1, k + 1),
                ]
                for t in kuhn:
                    tet = [c[t[0]], c[t[1]], c[t[2]], c[t[3]]]
                    # Ensure positive volume (swap last two if needed).
                    v = nodes4[tet]
                    vol = np.linalg.det(v[1:] - v[0])
                    if vol < 0:
                        tet[2], tet[3] = tet[3], tet[2]
                    tets.append(tet)
    conn4 = np.asarray(tets, dtype=np.int64)
    return t10_from_t4(nodes4, conn4)
