"""Readers for the `.ancf3243mesh` / `.ancf3443mesh` text formats (port of
`tlfea/utils/ancf_mesh.py`; the rows go through the port's
`LinearConstraintBuilder`).

Format (reference: `lib_utils/mesh_utils.cc:444-880`, sample
`data/meshes/ANCF3243/net_pinned_nx20_ny20_L0.5.ancf3243mesh`):

    ancf3243_mesh 1
    [grid nx <nx> ny <ny> L <L> origin <ox> <oy> <oz>]
    nodes N
    <id> <family> x0 xu xv xw  y0 yu yv yw  z0 zu zv zw     (x N)
    elements E
    <id> <family> n0 n1                                     (3243)
    <id> <family> L W H n0 n1 n2 n3                         (3443)
    constraints C
    pinned a b                                  (position equality)
    welded a b q00 .. q22                       (+ gradient continuity via Q)

Constraint semantics (reference `mesh_utils.cc:700-880`): `pinned` adds 3
rows r_b - r_a = 0; `welded` adds those plus, for each gradient slot k in
{u, v, w}, 3 rows g_b - Q g_a = 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from tlfea_torch.constraints import LinearConstraintBuilder, LinearConstraints

__all__ = ["ANCFMesh", "read_ancf3243_mesh", "read_ancf3443_mesh"]


@dataclass
class ANCFMesh:
    coefs: np.ndarray  # (4 * n_nodes, 3)
    conn: np.ndarray  # (E, 2) or (E, 4) node indices
    node_family: list[str] = field(default_factory=list)
    elem_family: list[str] = field(default_factory=list)
    elem_L: np.ndarray | None = None  # (E,) — per-element extents (3443 file,
    elem_W: np.ndarray | None = None  # computed from geometry for 3243)
    elem_H: np.ndarray | None = None
    constraint_builder: LinearConstraintBuilder | None = None
    grid: dict | None = None

    @property
    def n_nodes(self) -> int:
        return self.coefs.shape[0] // 4

    def constraints(self, dtype=torch.float64, device="cuda") -> LinearConstraints | None:
        """The file's rows on `device` (pass device="cpu" to stay on the
        host), or None when it has none."""
        if self.constraint_builder is None or self.constraint_builder._n_rows == 0:
            return None
        return self.constraint_builder.build(dtype=dtype, device=device)


def _records(path: str):
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            yield s.split()


def _parse_nodes(rec_iter, n_nodes: int):
    coefs = np.zeros((4 * n_nodes, 3))
    families = [""] * n_nodes
    for _ in range(n_nodes):
        t = next(rec_iter)
        nid = int(t[0])
        families[nid] = t[1]
        vals = [float(v) for v in t[2:14]]
        # File layout: x0 xu xv xw  y0 yu yv yw  z0 zu zv zw; storage is
        # slot-major [r, r_u, r_v, r_w] vectors.
        for slot in range(4):
            coefs[4 * nid + slot] = [vals[slot], vals[4 + slot], vals[8 + slot]]
    return coefs, families


def _append_pinned(builder: LinearConstraintBuilder, a: int, b: int):
    for c in range(3):
        builder.add_row([(4 * b + 0) * 3 + c, (4 * a + 0) * 3 + c], [1.0, -1.0], 0.0)


def _append_welded(builder: LinearConstraintBuilder, a: int, b: int, Q: np.ndarray):
    _append_pinned(builder, a, b)
    for slot in (1, 2, 3):
        for row in range(3):
            cols = [(4 * b + slot) * 3 + row]
            vals = [1.0]
            for k in range(3):
                if Q[row, k] != 0.0:
                    cols.append((4 * a + slot) * 3 + k)
                    vals.append(-Q[row, k])
            builder.add_row(cols, vals, 0.0)


def _parse_constraints(rec_iter, n_cons: int, builder: LinearConstraintBuilder):
    for _ in range(n_cons):
        t = next(rec_iter)
        if t[0] == "pinned":
            _append_pinned(builder, int(t[1]), int(t[2]))
        elif t[0] == "welded":
            Q = np.array([float(v) for v in t[3:12]]).reshape(3, 3)
            _append_welded(builder, int(t[1]), int(t[2]), Q)
        else:
            raise ValueError(f"unknown constraint type {t[0]!r}")


def _read_common(path: str, magic: str):
    rec = _records(path)
    t = next(rec)
    if t[0] != magic:
        raise ValueError(f"{path}: expected header {magic!r}, got {t[0]!r}")
    grid = None
    t = next(rec)
    if t[0] == "grid":
        grid = {
            "nx": int(t[2]), "ny": int(t[4]), "L": float(t[6]),
            "origin": (float(t[8]), float(t[9]), float(t[10])),
        }
        t = next(rec)
    if t[0] != "nodes":
        raise ValueError(f"{path}: expected 'nodes N'")
    n_nodes = int(t[1])
    coefs, families = _parse_nodes(rec, n_nodes)
    return rec, coefs, families, grid


def read_ancf3243_mesh(path: str) -> ANCFMesh:
    rec, coefs, families, grid = _read_common(path, "ancf3243_mesh")
    t = next(rec)
    if t[0] != "elements":
        raise ValueError(f"{path}: expected 'elements E'")
    n_elem = int(t[1])
    conn = np.zeros((n_elem, 2), dtype=np.int64)
    efam = [""] * n_elem
    for _ in range(n_elem):
        t = next(rec)
        eid = int(t[0])
        efam[eid] = t[1]
        conn[eid] = [int(t[2]), int(t[3])]

    builder = LinearConstraintBuilder()
    try:
        t = next(rec)
        if t[0] == "constraints":
            _parse_constraints(rec, int(t[1]), builder)
    except StopIteration:
        pass

    # Per-element length from endpoint distance (the file stores none).
    p0 = coefs[4 * conn[:, 0]]
    p1 = coefs[4 * conn[:, 1]]
    L = np.linalg.norm(p1 - p0, axis=1)
    return ANCFMesh(
        coefs=coefs, conn=conn, node_family=families, elem_family=efam,
        elem_L=L, constraint_builder=builder, grid=grid,
    )


def read_ancf3443_mesh(path: str) -> ANCFMesh:
    rec, coefs, families, grid = _read_common(path, "ancf3443_mesh")
    t = next(rec)
    if t[0] != "elements":
        raise ValueError(f"{path}: expected 'elements E'")
    n_elem = int(t[1])
    conn = np.zeros((n_elem, 4), dtype=np.int64)
    efam = [""] * n_elem
    L = np.zeros(n_elem)
    W = np.zeros(n_elem)
    H = np.zeros(n_elem)
    for _ in range(n_elem):
        t = next(rec)
        eid = int(t[0])
        efam[eid] = t[1]
        L[eid], W[eid], H[eid] = float(t[2]), float(t[3]), float(t[4])
        conn[eid] = [int(v) for v in t[5:9]]

    builder = LinearConstraintBuilder()
    try:
        t = next(rec)
        if t[0] == "constraints":
            _parse_constraints(rec, int(t[1]), builder)
    except StopIteration:
        pass
    return ANCFMesh(
        coefs=coefs, conn=conn, node_family=families, elem_family=efam,
        elem_L=L, elem_W=W, elem_H=H, constraint_builder=builder, grid=grid,
    )
