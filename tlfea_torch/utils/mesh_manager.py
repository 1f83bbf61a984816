"""Multi-mesh scene assembly for T10 meshes (port of
`tlfea/utils/mesh_manager.py`, host-side NumPy).

Python equivalent of the reference's `MeshManager` (`lib_utils/
mesh_manager.h:67-235`): load TetGen meshes into unified node/element arrays
with offset-shifted connectivity, per-instance rigid transforms, per-mesh
scalar (pressure) fields from NPZ, and mesh-id lookups. NumPy's `np.load`
replaces the reference's built-in minimal ZIP/NPY parser
(`mesh_manager.cc:222-310`) — and unlike it, compressed NPZ works.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tlfea_torch.utils.reorder import apply_node_order, best_order
from tlfea_torch.utils.tetmesh import read_tetgen, surface_triangles_t10

__all__ = ["MeshInstance", "MeshManager", "Scene"]


@dataclass
class MeshInstance:
    """One loaded mesh (reference `MeshInstance`, `mesh_manager.h:51-57`)."""

    name: str
    node_offset: int
    elem_offset: int
    n_nodes: int
    n_elems: int
    scalar_field: np.ndarray | None = None


@dataclass(frozen=True)
class Scene:
    """Finalized scene arrays with a band-minimizing node relabeling applied.

    `MeshManager.scene()` snapshots the assembled scene with
    `utils.reorder.best_order` applied consistently to every node-indexed
    array: multi-mesh scenes assembled in load order (and TetGen's natural
    numbering) have node bandwidths in the tens of thousands, which the JAX
    package's banded kernels refuse, and the relabeling keeps the node sums
    of the port's K4 local. Element ORDER is unchanged (only node labels),
    so per-instance element ranges and `elem_mesh_ids` stay valid, and the
    scene equals the JAX package's array for array.

    Everything downstream (elements, fixed sets derived from `nodes`, VTU
    export of `conn`) is self-consistent in the new labeling; `to_old()`
    maps per-node rows back to assembly order when an export must match the
    original file numbering.
    """

    nodes: np.ndarray            # (n, 3) in scene (new) order
    conn: np.ndarray             # (E, S) new labels, element order unchanged
    pressures: np.ndarray        # (n,) per-node scalar field, new order
    elem_mesh_ids: np.ndarray    # (E,)
    node_mesh_ids: np.ndarray    # (n,) new order
    perm: np.ndarray             # perm[new] = old
    inv: np.ndarray              # inv[old] = new
    elem_ranges: tuple           # per-instance (start, stop) element ranges

    def surface_triangles(self, mesh_id: int | None = None) -> np.ndarray:
        """Boundary triangles (scene node ids) for one mesh or the scene."""
        if mesh_id is None:
            return surface_triangles_t10(self.conn)
        a, b = self.elem_ranges[mesh_id]
        return surface_triangles_t10(self.conn[a:b])

    def mesh_node_ids(self, mesh_id: int) -> np.ndarray:
        """Scene node ids belonging to one instance."""
        return np.nonzero(self.node_mesh_ids == mesh_id)[0]

    def to_old(self, per_node: np.ndarray) -> np.ndarray:
        """Reindex per-node rows back to the original assembly order."""
        return np.asarray(per_node)[self.inv]


@dataclass
class MeshManager:
    nodes: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    elements: np.ndarray = field(default_factory=lambda: np.zeros((0, 10), dtype=np.int64))
    instances: list[MeshInstance] = field(default_factory=list)

    # -- loading ---------------------------------------------------------
    def add_mesh(self, nodes: np.ndarray, conn: np.ndarray, name: str = "") -> int:
        """Append a mesh given arrays; returns mesh id."""
        nodes = np.asarray(nodes, dtype=np.float64)
        conn = np.asarray(conn, dtype=np.int64)
        inst = MeshInstance(
            name=name or f"mesh{len(self.instances)}",
            node_offset=self.nodes.shape[0],
            elem_offset=self.elements.shape[0],
            n_nodes=nodes.shape[0],
            n_elems=conn.shape[0],
        )
        self.nodes = np.vstack([self.nodes, nodes])
        self.elements = np.vstack([self.elements, conn + inst.node_offset])
        self.instances.append(inst)
        return len(self.instances) - 1

    def load_mesh(self, node_path: str, ele_path: str, name: str = "") -> int:
        """TetGen .node/.ele pair (reference `LoadMesh`)."""
        nodes, conn = read_tetgen(node_path, ele_path)
        return self.add_mesh(nodes, conn, name=name or node_path)

    # -- transforms ------------------------------------------------------
    def _node_slice(self, mesh_id: int) -> slice:
        inst = self.instances[mesh_id]
        return slice(inst.node_offset, inst.node_offset + inst.n_nodes)

    def translate_mesh(self, mesh_id: int, offset) -> None:
        self.nodes[self._node_slice(mesh_id)] += np.asarray(offset, dtype=np.float64)

    def transform_mesh(self, mesh_id: int, R, t=(0.0, 0.0, 0.0)) -> None:
        """x -> R x + t for one instance (reference `TransformMesh`)."""
        sl = self._node_slice(mesh_id)
        self.nodes[sl] = self.nodes[sl] @ np.asarray(R).T + np.asarray(t)

    # -- scalar fields ---------------------------------------------------
    def load_scalar_field_from_npz(self, mesh_id: int, path: str, key: str = "p_vertex"):
        """Per-vertex scalar field (hydroelastic pressure) from NPZ
        (reference `LoadScalarFieldFromNpz`, `mesh_manager.cc:222-310`)."""
        data = np.load(path)
        f = np.asarray(data[key], dtype=np.float64).reshape(-1)
        inst = self.instances[mesh_id]
        if f.shape[0] != inst.n_nodes:
            raise ValueError(
                f"scalar field has {f.shape[0]} entries, mesh has {inst.n_nodes} nodes"
            )
        inst.scalar_field = f

    def load_corner_pressures_from_npz(self, mesh_id: int, path: str, key: str = "p_vertex"):
        """Load the reference's NPZ scene assets (e.g. `data/meshes/T10/
        item_drop/dragon.npz`): `p_vertex` holds pressures at the CORNER
        vertices, which TetGen numbers first — exactly the values the
        hydroelastic narrowphase reads (it only uses the 4 tet corners).
        Midside nodes get zero (never read)."""
        data = np.load(path)
        p = np.asarray(data[key], dtype=np.float64).reshape(-1)
        inst = self.instances[mesh_id]
        if p.shape[0] > inst.n_nodes:
            raise ValueError(
                f"{p.shape[0]} corner pressures > {inst.n_nodes} mesh nodes"
            )
        field = np.zeros(inst.n_nodes)
        field[: p.shape[0]] = p
        inst.scalar_field = field

    def set_scalar_field(self, mesh_id: int, values: np.ndarray):
        inst = self.instances[mesh_id]
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        if values.shape[0] != inst.n_nodes:
            raise ValueError("scalar field size mismatch")
        inst.scalar_field = values

    def scalar_field(self) -> np.ndarray:
        """Concatenated per-node scalar field over the whole scene (0 where
        unset)."""
        out = np.zeros(self.nodes.shape[0])
        for inst in self.instances:
            if inst.scalar_field is not None:
                out[inst.node_offset : inst.node_offset + inst.n_nodes] = inst.scalar_field
        return out

    # -- lookups ---------------------------------------------------------
    def elem_mesh_ids(self) -> np.ndarray:
        """(E,) mesh id per element (reference `GetMeshIdFromElementIdx`)."""
        out = np.zeros(self.elements.shape[0], dtype=np.int32)
        for i, inst in enumerate(self.instances):
            out[inst.elem_offset : inst.elem_offset + inst.n_elems] = i
        return out

    def node_mesh_ids(self) -> np.ndarray:
        out = np.zeros(self.nodes.shape[0], dtype=np.int32)
        for i, inst in enumerate(self.instances):
            out[inst.node_offset : inst.node_offset + inst.n_nodes] = i
        return out

    def mesh_nodes(self, mesh_id: int) -> np.ndarray:
        return self.nodes[self._node_slice(mesh_id)]

    def surface_triangles(self, mesh_id: int | None = None) -> np.ndarray:
        """Boundary triangles (global node ids) for one mesh or the scene."""
        if mesh_id is None:
            return surface_triangles_t10(self.elements)
        inst = self.instances[mesh_id]
        conn = self.elements[inst.elem_offset : inst.elem_offset + inst.n_elems]
        return surface_triangles_t10(conn)

    # -- finalization ------------------------------------------------------
    def scene(self, reorder: bool = True) -> Scene:
        """Snapshot the assembled scene, optionally (default) relabeling
        nodes with the band-minimizing order (see `Scene`). Call AFTER all
        loads/transforms/pressure fields; derive fixed sets and loads from
        the returned arrays."""
        n = self.nodes.shape[0]
        if reorder and n:
            perm = np.asarray(best_order(self.nodes, self.elements))
        else:
            perm = np.arange(n, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=np.int64)
        nodes, conn = apply_node_order(self.nodes, self.elements, perm)
        return Scene(
            nodes=nodes,
            conn=conn,
            pressures=self.scalar_field()[perm],
            elem_mesh_ids=self.elem_mesh_ids(),
            node_mesh_ids=self.node_mesh_ids()[perm],
            perm=perm,
            inv=inv,
            elem_ranges=tuple(
                (i.elem_offset, i.elem_offset + i.n_elems) for i in self.instances
            ),
        )
