"""VTK XML exporters (VTU / VTP) and CSV history writers (port of
`tlfea/utils/io_vtk.py`; each writer's file is byte for byte the JAX
package's on the same arrays, `tests/test_torch_io.py`).

Python equivalents of the reference's header-only exporters
(`lib_utils/visualization_utils.h`): T10 meshes as VTK_QUADRATIC_TETRA VTU
(plain and with displacement fields), contact patches as VTP polygons with
per-patch data, patch normals as line arrows, and ANCF beam/shell elements
expanded to solid hexahedra via the position field evaluated at cross-section
corners. ASCII XML output, dependency-free.

Note: VTK's quadratic-tetra midnode order [(0,1),(1,2),(0,2),(0,3),(1,3),
(2,3)] matches this framework's canonical T10 ordering exactly, so
connectivity is written verbatim.
"""

from __future__ import annotations

import numpy as np
import torch

from tlfea_torch.elements import ancf3243, ancf3443
from tlfea_torch.elements.ancf import (
    MONOMIALS_3243,
    MONOMIALS_3443,
    eval_basis,
    nodal_condition_matrix,
)

__all__ = [
    "write_vtu_t10",
    "write_vtp_patches",
    "write_vtp_normals",
    "write_vtu_ancf_hex",
    "write_csv_history",
    "write_patches_csv",
    "write_patches_json",
    "write_obj_surface",
]

_VTK_QUADRATIC_TETRA = 24
_VTK_HEXAHEDRON = 12


def _np(a, dtype=None) -> np.ndarray:
    """a as a NumPy array; a tensor is copied to the host first."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _data_array(f, name, data, n_comp):
    f.write(f'      <DataArray type="Float64" Name="{name}" ')
    if n_comp > 1:
        f.write(f'NumberOfComponents="{n_comp}" ')
    f.write('format="ascii">\n')
    flat = _np(data, dtype=np.float64).reshape(-1)
    f.write(" ".join(f"{v:.17g}" for v in flat))
    f.write("\n      </DataArray>\n")


def _write_unstructured(path, points, cells, cell_type, point_data=None, cell_data=None):
    points = _np(points, dtype=np.float64)
    cells = _np(cells, dtype=np.int64)
    n_pts, n_cells = points.shape[0], cells.shape[0]
    nodes_per_cell = cells.shape[1] if n_cells else 0
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">\n')
        f.write("      <Points>\n")
        _data_array(f, "Points", points, 3)
        f.write("      </Points>\n")
        if point_data:
            f.write("      <PointData>\n")
            for name, arr in point_data.items():
                arr = _np(arr)
                _data_array(f, name, arr, 1 if arr.ndim == 1 else arr.shape[1])
            f.write("      </PointData>\n")
        if cell_data:
            f.write("      <CellData>\n")
            for name, arr in cell_data.items():
                arr = _np(arr)
                _data_array(f, name, arr, 1 if arr.ndim == 1 else arr.shape[1])
            f.write("      </CellData>\n")
        f.write("      <Cells>\n")
        f.write('      <DataArray type="Int64" Name="connectivity" format="ascii">\n')
        f.write(" ".join(str(v) for v in cells.reshape(-1)))
        f.write("\n      </DataArray>\n")
        f.write('      <DataArray type="Int64" Name="offsets" format="ascii">\n')
        f.write(" ".join(str((i + 1) * nodes_per_cell) for i in range(n_cells)))
        f.write("\n      </DataArray>\n")
        f.write('      <DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write(" ".join(str(cell_type) for _ in range(n_cells)))
        f.write("\n      </DataArray>\n")
        f.write("      </Cells>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


def write_vtu_t10(path, nodes, conn, point_data=None, displacement=None):
    """T10 mesh as quadratic-tetra VTU (reference `ExportT10MeshToVTU`,
    `visualization_utils.h:491,718`)."""
    pd = dict(point_data or {})
    if displacement is not None:
        pd["displacement"] = _np(displacement)
    _write_unstructured(path, nodes, conn, _VTK_QUADRATIC_TETRA, point_data=pd)


def write_vtp_patches(path, patches):
    """Contact patches as VTP polygons with per-patch scalars
    (reference `ExportContactPatchesToVTP`, `visualization_utils.h:29`)."""
    verts = _np(patches.verts)
    counts = _np(patches.n_verts)
    use = _np(patches.valid & patches.valid_orientation)
    idx = np.nonzero(use)[0]

    pts = []
    polys = []
    scal = {"area": [], "p_eq": [], "g_A": [], "g_B": []}
    for p in idx:
        c = int(counts[p])
        start = len(pts)
        pts.extend(verts[p, :c].tolist())
        polys.append(list(range(start, start + c)))
        scal["area"].append(float(_np(patches.area)[p]))
        scal["p_eq"].append(float(_np(patches.p_eq)[p]))
        scal["g_A"].append(float(_np(patches.g_A)[p]))
        scal["g_B"].append(float(_np(patches.g_B)[p]))

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">\n')
        f.write("  <PolyData>\n")
        f.write(
            f'    <Piece NumberOfPoints="{len(pts)}" NumberOfPolys="{len(polys)}">\n'
        )
        f.write("      <Points>\n")
        _data_array(f, "Points", _np(pts).reshape(-1, 3) if pts else np.zeros((0, 3)), 3)
        f.write("      </Points>\n")
        f.write("      <CellData>\n")
        for name, vals in scal.items():
            _data_array(f, name, _np(vals), 1)
        f.write("      </CellData>\n")
        f.write("      <Polys>\n")
        f.write('      <DataArray type="Int64" Name="connectivity" format="ascii">\n')
        f.write(" ".join(str(i) for poly in polys for i in poly))
        f.write("\n      </DataArray>\n")
        f.write('      <DataArray type="Int64" Name="offsets" format="ascii">\n')
        off = 0
        offs = []
        for poly in polys:
            off += len(poly)
            offs.append(off)
        f.write(" ".join(str(o) for o in offs))
        f.write("\n      </DataArray>\n")
        f.write("      </Polys>\n")
        f.write("    </Piece>\n  </PolyData>\n</VTKFile>\n")


def write_vtp_normals(path, patches, scale=0.1):
    """Patch normals as line segments from centroids
    (reference `ExportContactNormalsToVTP`, `visualization_utils.h:591`)."""
    use = _np(patches.valid & patches.valid_orientation)
    idx = np.nonzero(use)[0]
    cent = _np(patches.centroid)[idx]
    nrm = _np(patches.normal)[idx]
    pts = np.concatenate([cent, cent + scale * nrm], axis=0) if len(idx) else np.zeros((0, 3))
    n = len(idx)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">\n')
        f.write("  <PolyData>\n")
        f.write(f'    <Piece NumberOfPoints="{2 * n}" NumberOfLines="{n}">\n')
        f.write("      <Points>\n")
        _data_array(f, "Points", pts, 3)
        f.write("      </Points>\n")
        f.write("      <Lines>\n")
        f.write('      <DataArray type="Int64" Name="connectivity" format="ascii">\n')
        f.write(" ".join(f"{i} {i + n}" for i in range(n)))
        f.write("\n      </DataArray>\n")
        f.write('      <DataArray type="Int64" Name="offsets" format="ascii">\n')
        f.write(" ".join(str(2 * (i + 1)) for i in range(n)))
        f.write("\n      </DataArray>\n")
        f.write("      </Lines>\n")
        f.write("    </Piece>\n  </PolyData>\n</VTKFile>\n")


def write_vtu_ancf_hex(path, coefs, conn_nodes, L, W, H, family: str, point_data=None):
    """ANCF beams/shells expanded to solid hexahedra using the position field
    at the 8 cross-section corners (reference `ExportANCF3243ToVTUSolid` /
    `...3443...`, `visualization_utils.h:848,974`).

    family: "3243" or "3443".
    """
    coefs = _np(coefs)
    conn_nodes = _np(conn_nodes)
    E = conn_nodes.shape[0]
    L = np.broadcast_to(_np(L, dtype=float), (E,))
    W = np.broadcast_to(_np(W, dtype=float), (E,))
    H = np.broadcast_to(_np(H, dtype=float), (E,))

    if family == "3243":
        exps, node_pts_fn = MONOMIALS_3243, ancf3243._node_pts
    elif family == "3443":
        exps, node_pts_fn = MONOMIALS_3443, ancf3443._node_pts
    else:
        raise ValueError(family)

    S = exps.shape[0]
    conn_coef = (conn_nodes[:, :, None] * 4 + np.arange(4)).reshape(E, S)

    # VTK hexahedron corner order: bottom CCW then top CCW.
    corners_nat = np.array(
        [
            (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
            (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
        ],
        dtype=float,
    )

    pts = np.zeros((E * 8, 3))
    cells = np.arange(E * 8, dtype=np.int64).reshape(E, 8)
    for e in range(E):
        B = nodal_condition_matrix(exps, _np(node_pts_fn(L[e], W[e], H[e])))
        Binv_T = np.linalg.inv(B.T)
        local = corners_nat * np.array([L[e] / 2, W[e] / 2, H[e] / 2])
        b = eval_basis(exps, local)  # (8, S)
        s = b @ Binv_T.T  # (8, S)
        pts[8 * e : 8 * e + 8] = s @ coefs[conn_coef[e]]
    _write_unstructured(path, pts, cells, _VTK_HEXAHEDRON, point_data=point_data)


def write_patches_csv(path, patches):
    """Contact patches as CSV (reference `ExportContactPatchesToCSV`,
    `visualization_utils.h:377`)."""
    use = _np(patches.valid & patches.valid_orientation)
    idx = np.nonzero(use)[0]
    with open(path, "w") as f:
        f.write("patch,tetA,tetB,area,p_eq,g_A,g_B,nx,ny,nz,cx,cy,cz,n_verts\n")
        for p in idx:
            n = _np(patches.normal)[p]
            c = _np(patches.centroid)[p]
            f.write(
                f"{p},{int(_np(patches.tetA)[p])},{int(_np(patches.tetB)[p])},"
                f"{float(_np(patches.area)[p]):.17g},{float(_np(patches.p_eq)[p]):.17g},"
                f"{float(_np(patches.g_A)[p]):.17g},{float(_np(patches.g_B)[p]):.17g},"
                f"{n[0]:.17g},{n[1]:.17g},{n[2]:.17g},{c[0]:.17g},{c[1]:.17g},{c[2]:.17g},"
                f"{int(_np(patches.n_verts)[p])}\n"
            )


def write_patches_json(path, patches):
    """Contact patches as JSON, including polygon vertices (reference
    `ExportContactPatchesToJSON`, `visualization_utils.h:420` — the format
    `compare_narrowphase.py` diffs against)."""
    import json

    use = _np(patches.valid & patches.valid_orientation)
    out = []
    for p in np.nonzero(use)[0]:
        c = int(_np(patches.n_verts)[p])
        out.append(
            {
                "tetA": int(_np(patches.tetA)[p]),
                "tetB": int(_np(patches.tetB)[p]),
                "area": float(_np(patches.area)[p]),
                "p_equilibrium": float(_np(patches.p_eq)[p]),
                "g_A": float(_np(patches.g_A)[p]),
                "g_B": float(_np(patches.g_B)[p]),
                "normal": _np(patches.normal)[p].tolist(),
                "centroid": _np(patches.centroid)[p].tolist(),
                "vertices": _np(patches.verts)[p, :c].tolist(),
            }
        )
    with open(path, "w") as f:
        json.dump({"patches": out}, f, indent=1)


def write_obj_surface(path, nodes, tris):
    """Surface triangle soup as OBJ (reference `surface_trimesh` OBJ writer,
    `lib_utils/surface_trimesh.h:14-23`)."""
    nodes = _np(nodes)
    tris = _np(tris)
    used = np.unique(tris.reshape(-1))
    remap = {int(g): i + 1 for i, g in enumerate(used)}
    with open(path, "w") as f:
        for g in used:
            p = nodes[g]
            f.write(f"v {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        for t in tris:
            f.write(f"f {remap[int(t[0])]} {remap[int(t[1])]} {remap[int(t[2])]}\n")


def write_csv_history(path, header: list[str], rows):
    """Simple CSV trajectory writer (reference: tip_z histories,
    `test_ancf3243.cc:210-218`)."""
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(f"{v:.17g}" for v in row) + "\n")
