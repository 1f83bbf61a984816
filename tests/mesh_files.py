"""Small meshes written in the reference's file formats, for the tests and
`chip_smoke.py` (NumPy only; no JAX).

- `write_tetgen`: a T10 mesh as TetGen `.node` / `.ele` files, the format
  `utils/tetmesh.read_tetgen` reads.
- `write_resolution_beams`: the beams `beam_3x2x1_res{r}.1.node/.ele` of
  `examples/feat10_resolution_study.py`, laid out under
  `<root>/meshes/T10/resolution/` as in the reference's `data/` folder.
- `write_ancf3243_net`: a pinned-joint ANCF3243 net in the
  `.ancf3243mesh` format (`utils/ancf_mesh._read_common`), as the reference's
  `net_pinned_nx20_ny20_L0.5` names it: nx x ny cells of side L, one beam
  node a crossing per direction, the two pinned together.
- `write_ancf3443_patch`: a flat ANCF3443 shell patch in the
  `.ancf3443mesh` format, its node columns duplicated at `seams` and welded
  there, centred on x = 0 so that `examples/ancf3443_tire.py`'s rim test
  (distance from the centre in x-z) fixes the middle columns.
"""

from __future__ import annotations

import os

import numpy as np

from tlfea_torch.utils.tetmesh import TETGEN_TO_CANONICAL, box_t10_mesh

__all__ = ["write_tetgen", "write_resolution_beams", "write_ancf3243_net",
           "write_ancf3443_patch"]


def write_tetgen(path, nodes, conn, base=1):
    """A T10 mesh as TetGen .node/.ele files (TetGen's midnode order,
    elements listed in reverse), indices from `base`. Returns the two paths."""
    to_tetgen = np.argsort(TETGEN_TO_CANONICAL)
    with open(f"{path}.node", "w") as f:
        f.write(f"# nodes\n{len(nodes)} 3 0 0\n")
        for i, p in enumerate(nodes):
            f.write(f"{i + base} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r}\n")
    with open(f"{path}.ele", "w") as f:
        f.write(f"{len(conn)} 10 0\n")
        for e in reversed(range(len(conn))):
            f.write(f"{e + base} " + " ".join(str(int(a) + base) for a in conn[e][to_tetgen])
                    + "\n")
    return f"{path}.node", f"{path}.ele"


def write_resolution_beams(root, resolutions):
    """The 3 x 2 x 1 beams of the resolution study, box_t10_mesh(3, 2, 1,
    3 (r + 1), 2 (r + 1), r + 1), as TetGen files under
    root/meshes/T10/resolution/. Returns {r: element count}."""
    folder = os.path.join(root, "meshes", "T10", "resolution")
    os.makedirs(folder, exist_ok=True)
    out = {}
    for r in resolutions:
        nodes, conn = box_t10_mesh(3.0, 2.0, 1.0, 3 * (r + 1), 2 * (r + 1), r + 1)
        write_tetgen(os.path.join(folder, f"beam_3x2x1_res{r}.1"), nodes, conn)
        out[r] = len(conn)
    return out


def _node_line(nid, family, r, ru, rv, rw):
    """<id> <family> x0 xu xv xw  y0 yu yv yw  z0 zu zv zw."""
    vals = [f"{float(v[c])!r}" for c in range(3) for v in (r, ru, rv, rw)]
    return f"{nid} {family} " + " ".join(vals)


def write_ancf3243_net(path, nx, ny, L):
    """A net of (ny + 1) beams along x and (nx + 1) along y, each of cells
    of length L, in the z = 0 plane: at every crossing an x-beam node
    (r_u = e_x) and a y-beam node (r_u = e_y, r_v = -e_x), pinned together.
    Returns (n_nodes, n_elements, n_joints)."""
    ex, ey, ez = np.eye(3)
    n_grid = (nx + 1) * (ny + 1)

    def xnode(i, j):
        return j * (nx + 1) + i

    def ynode(i, j):
        return n_grid + i * (ny + 1) + j

    lines = ["ancf3243_mesh 1", f"grid nx {nx} ny {ny} L {L!r} origin 0 0 0",
             f"nodes {2 * n_grid}"]
    nodes = {}
    for j in range(ny + 1):
        for i in range(nx + 1):
            p = np.array([i * L, j * L, 0.0])
            nodes[xnode(i, j)] = _node_line(xnode(i, j), "x", p, ex, ey, ez)
            nodes[ynode(i, j)] = _node_line(ynode(i, j), "y", p, ey, -ex, ez)
    lines += [nodes[k] for k in range(2 * n_grid)]
    elems = ([(xnode(i, j), xnode(i + 1, j)) for j in range(ny + 1) for i in range(nx)]
             + [(ynode(i, j), ynode(i, j + 1)) for i in range(nx + 1) for j in range(ny)])
    lines.append(f"elements {len(elems)}")
    lines += [f"{e} beam {a} {b}" for e, (a, b) in enumerate(elems)]
    lines.append(f"constraints {n_grid}")
    lines += [f"pinned {xnode(i, j)} {ynode(i, j)}"
              for j in range(ny + 1) for i in range(nx + 1)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 2 * n_grid, len(elems), n_grid


def write_ancf3443_patch(path, nu, nv, h, thickness, seams=()):
    """A flat patch of nu x nv shells of side h in the z = 0 plane, x
    centred on 0, y from 0 (r_u = e_x, r_v = e_y, r_w = e_z; corners
    counter-clockwise), each node column in `seams` (indices 1..nu-1)
    duplicated (the cells left of it use one copy, those right of it the
    other) and welded with Q = I. Returns (n_nodes, n_shells, n_welds)."""
    ex, ey, ez = np.eye(3)
    x0 = -0.5 * nu * h
    seams = sorted(seams)
    ids = {}  # (column, row, side) -> node id; side 1 is the right copy at a seam
    lines_nodes = []
    for i in range(nu + 1):
        for side in ((0, 1) if i in seams else (0,)):
            for j in range(nv + 1):
                nid = len(lines_nodes)
                ids[(i, j, side)] = nid
                lines_nodes.append(_node_line(nid, "s", np.array([x0 + i * h, j * h, 0.0]),
                                              ex, ey, ez))

    def node(i, j, right_of):
        """The node at column i, row j of a cell whose left column is right_of."""
        return ids[(i, j, 1 if (i in seams and i == right_of) else 0)]

    shells = []
    for j in range(nv):
        for i in range(nu):
            corners = [node(i, j, i), node(i + 1, j, i), node(i + 1, j + 1, i), node(i, j + 1, i)]
            shells.append(f"{len(shells)} shell {h!r} {h!r} {thickness!r} "
                          + " ".join(str(c) for c in corners))
    welds = [f"welded {ids[(i, j, 0)]} {ids[(i, j, 1)]} 1 0 0 0 1 0 0 0 1"
             for i in seams for j in range(nv + 1)]
    lines = (["ancf3443_mesh 1", f"nodes {len(lines_nodes)}"] + lines_nodes
             + [f"elements {len(shells)}"] + shells + [f"constraints {len(welds)}"] + welds)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines_nodes), len(shells), len(welds)
