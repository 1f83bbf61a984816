"""Uniform-grid broadphase for self-collision (port of
`tlfea/collision/gridhash.py`).

Each element lands in the cell of its AABB centre; its candidates are the
elements of the 27 neighbouring cells, up to a fixed per-cell capacity:
cell keys -> stable argsort -> searchsorted per (element, neighbour cell)
-> masked candidate slots. The cell is sized at setup from the rest
configuration, so a neighbourhood query is exact while the capacity holds,
and a crowded cell reports overflow.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tlfea_torch.collision.broadphase import BroadphaseSetup, _aabbs, _is_neighbor

__all__ = ["GridSetup", "setup_grid", "find_pairs_grid"]

# 27-cell neighbourhood offsets.
_OFFSETS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int32,
)


@dataclass(frozen=True)
class GridSetup:
    origin: torch.Tensor  # (3,) float64, used in the positions' dtype
    inv_h: torch.Tensor  # () 1 / cell, float64, likewise
    dims: tuple  # (Gx, Gy, Gz)
    cell_cap: int


def setup_grid(nodes: np.ndarray, conn: np.ndarray, cell_scale: float = 1.1,
               cell_cap: int | None = None, slack: float = 0.5, margin: float = 0.0,
               device="cuda") -> GridSetup:
    """Host sizing from the rest configuration (`gridhash.py:46-92`): cell =
    cell_scale x (largest element AABB extent + 2 margin), a grid over the
    rest bounding box inflated by `slack` x its extent, and by default a
    per-cell capacity of twice the largest rest occupancy (at least 8)."""
    nodes = np.asarray(nodes)
    conn = np.asarray(conn)
    pts = nodes[conn]
    ext = pts.max(axis=1) - pts.min(axis=1)
    h = cell_scale * (float(ext.max()) + 2.0 * margin)
    lo = nodes.min(axis=0)
    hi = nodes.max(axis=0)
    span = hi - lo
    origin = lo - slack * span - h
    dims = np.maximum(np.ceil((span * (1 + 2 * slack) + 2 * h) / h).astype(int), 1)
    if cell_cap is None:
        centers = 0.5 * (pts.min(axis=1) + pts.max(axis=1))
        cell = np.clip(((centers - origin) / h).astype(int), 0, dims - 1)
        key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        occ = np.bincount(key).max() if key.size else 1
        cell_cap = int(max(8, 2 * occ))
    device = torch.device(device)
    return GridSetup(
        origin=torch.as_tensor(np.asarray(origin, dtype=np.float64), device=device),
        inv_h=torch.as_tensor(np.float64(1.0 / h), device=device),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        cell_cap=int(cell_cap),
    )


def find_pairs_grid(bp: BroadphaseSetup, grid: GridSetup, x: torch.Tensor,
                    enable_self_collision: bool = True):
    """Candidate pairs through the grid (`gridhash.py:95-162`): -> (pairs
    (E*27*cap, 2) int32, valid, overflow), overflow when a cell holds more
    than `cell_cap` elements."""
    lo, hi = _aabbs(bp, x)
    centers = 0.5 * (lo + hi)
    Gx, Gy, Gz = grid.dims
    dims = torch.tensor([Gx, Gy, Gz], dtype=torch.int32, device=x.device)
    origin = grid.origin.to(x.dtype)
    inv_h = grid.inv_h.to(x.dtype)
    cell = torch.floor((centers - origin) * inv_h).to(torch.int32)
    cell = torch.minimum(torch.maximum(cell, torch.zeros_like(dims)), dims - 1)

    def linkey(c):
        return (c[..., 0] * Gy + c[..., 1]) * Gz + c[..., 2]

    key = linkey(cell)
    E = key.shape[0]
    order = torch.argsort(key, stable=True)
    keys_s = key[order]

    left = torch.searchsorted(keys_s, key, side="left")
    right = torch.searchsorted(keys_s, key, side="right")
    overflow = torch.max(right - left) > grid.cell_cap

    off = torch.as_tensor(_OFFSETS, device=x.device)
    ncell = cell[:, None, :] + off[None, :, :]  # (E, 27, 3)
    in_grid = torch.all((ncell >= 0) & (ncell < dims), dim=-1)
    ncell = torch.minimum(torch.maximum(ncell, torch.zeros_like(dims)), dims - 1)
    nkey = linkey(ncell)  # (E, 27)

    starts = torch.searchsorted(keys_s, nkey.reshape(-1)).reshape(E, 27)
    C = grid.cell_cap
    slots = starts[..., None] + torch.arange(C, device=x.device)[None, None, :]
    slot_ok = slots < E
    slots_c = slots.clamp_max(E - 1)
    cand_key_ok = keys_s[slots_c] == nkey[..., None]
    b = order[slots_c]  # (E, 27, C) candidate element ids
    a = torch.arange(E, dtype=b.dtype, device=x.device)[:, None, None]
    valid = slot_ok & cand_key_ok & in_grid[..., None] & (b > a)
    box = torch.all((lo[b] <= hi[:, None, None, :]) & (hi[b] >= lo[:, None, None, :]), dim=-1)
    valid = valid & box

    a_b = a.expand(b.shape)
    same_mesh = bp.mesh_ids[a_b] == bp.mesh_ids[b]
    if enable_self_collision:
        valid = valid & ~(same_mesh & _is_neighbor(bp, a_b, b))
    else:
        valid = valid & ~same_mesh
    pairs = torch.stack([a_b.reshape(-1), b.reshape(-1)], dim=1).to(torch.int32)
    return pairs, valid.reshape(-1), overflow
