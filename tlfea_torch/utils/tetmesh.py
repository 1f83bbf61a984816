"""T10 tetrahedral mesh IO and generation (host-side NumPy).

A copy of `tlfea/utils/tetmesh.py`, so the port reads and builds the same
meshes without importing jax: the TetGen `.node` / `.ele` reader (:37-80),
`t10_from_t4` (:111), `box_t10_mesh` (:137), `surface_triangles_t10`
(:167) and `hairpin_t10_mesh` (:186). `tests/test_torch_setup.py` and
`tests/test_torch_io.py` hold the arrays equal to the original's.

Canonical T10 node order: corners [0..3], then edge midnodes
[(0,1), (1,2), (0,2), (0,3), (1,3), (2,3)].
"""

from __future__ import annotations

import numpy as np

__all__ = ["TETGEN_TO_CANONICAL", "read_tetgen", "box_t10_mesh", "t10_from_t4",
           "surface_triangles_t10", "hairpin_t10_mesh"]

# TetGen order: [v0,v1,v2,v3, (3-4),(1-4),(1-2),(2-3),(2-4),(1-3)] (1-based
# vertex naming); canonical: [v0,v1,v2,v3, (0-1),(1-2),(0-2),(0-3),(1-3),(2-3)].
TETGEN_TO_CANONICAL = np.array([0, 1, 2, 3, 6, 7, 9, 5, 8, 4], dtype=np.int64)

_T10_EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]

# Faces of a tet by corner indices (outward for positive tets).
_T4_FACES = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            yield s.split()


def read_tetgen(node_path: str, ele_path: str) -> tuple[np.ndarray, np.ndarray]:
    """A TetGen T10 mesh -> (nodes (N, 3) float64, conn (E, 10) canonical),
    with 0- or 1-based indices (the smallest node id is the base)."""
    lines = _data_lines(node_path)
    n_nodes = int(next(lines)[0])
    ids = np.empty(n_nodes, dtype=np.int64)
    nodes = np.empty((n_nodes, 3), dtype=np.float64)
    for k in range(n_nodes):
        parts = next(lines)
        ids[k] = int(parts[0])
        nodes[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
    node_base = ids.min()

    lines = _data_lines(ele_path)
    header = next(lines)
    n_elem = int(header[0])
    nodes_per_elem = int(header[1]) if len(header) > 1 else 10
    if nodes_per_elem != 10:
        raise ValueError(f"expected 10-node tets, got {nodes_per_elem}-node elements")
    conn = np.empty((n_elem, 10), dtype=np.int64)
    eids = np.empty(n_elem, dtype=np.int64)
    for k in range(n_elem):
        parts = next(lines)
        eids[k] = int(parts[0])
        conn[k] = [int(p) for p in parts[1:1 + 10]]
    conn = conn[np.argsort(eids)]  # files may list elements in any order
    conn = conn - node_base
    return nodes, conn[:, TETGEN_TO_CANONICAL]


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


def surface_triangles_t10(conn: np.ndarray) -> np.ndarray:
    """Boundary corner triangles of a T10 mesh -> (T, 3) node ids: the faces
    that appear in exactly one element, corners only."""
    conn = np.asarray(conn)
    faces: dict[tuple[int, int, int], tuple[int, int, int] | None] = {}
    for tet in conn[:, :4]:
        for f in _T4_FACES:
            tri = (int(tet[f[0]]), int(tet[f[1]]), int(tet[f[2]]))
            key = tuple(sorted(tri))
            faces[key] = None if key in faces else tri  # a shared face is interior
    out = [tri for tri in faces.values() if tri is not None]
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def hairpin_t10_mesh(leg: float = 0.4, gap: float = 0.08, width: float = 0.05,
                     thick: float = 0.05, nx: int = 24, ny: int = 1,
                     nz: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """A T10 beam folded by 180 degrees so that its two legs run parallel,
    surfaces `gap` apart: a self-contact scene of one mesh. The straight box
    beam is bent isometrically around a half cylinder (every cross-section
    turned, never mirrored, so det J > 0); the lower leg's free end is at
    x = leg, the fold near x = 0. Returns (nodes (N, 3), conn (E, 10))."""
    r = 0.5 * (gap + thick)  # centreline turn radius
    arc = np.pi * r
    nodes, conn = box_t10_mesh(2 * leg + arc, width, thick, nx, ny, nz)
    s, y = nodes[:, 0], nodes[:, 1]
    d = nodes[:, 2] - 0.5 * thick  # offset from the centreline
    s1, s2 = leg, leg + arc
    out = np.empty_like(nodes)
    m = s <= s1  # lower leg: c = (s, 0, 0), n = +z
    out[m, 0], out[m, 1], out[m, 2] = s[m], y[m], d[m]
    m = (s > s1) & (s < s2)  # the turn: c = (s1 + r sin, 0, r - r cos)
    phi = (s[m] - s1) / r
    out[m, 0] = s1 + (r - d[m]) * np.sin(phi)
    out[m, 1] = y[m]
    out[m, 2] = r - (r - d[m]) * np.cos(phi)
    m = s >= s2  # upper leg: c = (s1 - (s - s2), 0, 2 r), n = -z
    out[m, 0], out[m, 1], out[m, 2] = s1 - (s[m] - s2), y[m], 2 * r - d[m]
    return out, conn
