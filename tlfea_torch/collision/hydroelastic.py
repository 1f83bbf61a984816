"""Hydroelastic contact-patch collision (port of
`tlfea/collision/hydroelastic.py`): the `CollisionSystem` contract, bind a
scene's topology, then step(positions, velocities) -> per-node forces.

A step is three phases on the device, each exposed for timing:
broadphase (candidate pairs compacted to `max_pairs`), narrowphase (the
patches of the batched pairs) and forces. Nothing is read to the host: the
overflow flag stays a device tensor, which `Simulation` reads one step late.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tlfea_torch.collision.broadphase import (
    BroadphaseSetup,
    compact_pairs,
    find_pairs,
    find_pairs_block,
    find_pairs_dense,
    setup_block_cross,
    setup_broadphase,
    setup_dense_cross,
)
from tlfea_torch.collision.forces import patch_forces
from tlfea_torch.collision.gridhash import find_pairs_grid, setup_grid
from tlfea_torch.collision.narrowphase import ContactPatches, compute_patches

__all__ = ["HydroelasticParams", "HydroelasticCollision"]


@dataclass(frozen=True)
class HydroelasticParams:
    """Step parameters: the normal damping d of p (1 - d v_n), and the
    Coulomb friction coefficient (floats, or 0-d tensors)."""

    damping: float = 0.0
    friction: float = 0.0


class HydroelasticCollision:
    """Collision of a fixed multi-mesh scene, (conn, mesh_ids, per-node
    pressures), on `device` (the card unless device="cpu" is passed).
    Positions and velocities are passed per step.

    broadphase="auto" picks (`hydroelastic.py:80-128`): with self-collision,
    the uniform grid when rest_nodes are given, else sweep-and-prune;
    without, the exact dense cross-mesh test while the cross-pair count
    fits `dense_cross_cap`, past it the two-level block test when
    rest_nodes are given, else sweep-and-prune.
    """

    def __init__(
        self,
        conn: np.ndarray,
        mesh_ids: np.ndarray,
        pressures: np.ndarray,
        window: int = 32,
        max_pairs: int = 4096,
        margin: float = 0.0,
        enable_self_collision: bool = False,
        dense_cross_cap: int = 262_144,
        broadphase: str = "auto",
        rest_nodes: np.ndarray | None = None,
        cell_cap: int | None = None,
        block: int = 64,
        block_pair_cap: int = 256,
        device="cuda",
    ):
        device = torch.device(device)
        self._init_args = dict(
            conn=np.asarray(conn), mesh_ids=np.asarray(mesh_ids),
            pressures=np.asarray(pressures), window=window, max_pairs=max_pairs,
            margin=margin, enable_self_collision=enable_self_collision,
            dense_cross_cap=dense_cross_cap, broadphase=broadphase,
            rest_nodes=None if rest_nodes is None else np.asarray(rest_nodes),
            cell_cap=cell_cap, block=block, block_pair_cap=block_pair_cap, device=device,
        )
        self.device = device
        self.bp: BroadphaseSetup = setup_broadphase(conn, mesh_ids, window=window,
                                                    margin=margin, device=device)
        self.pressures = torch.as_tensor(np.asarray(pressures), device=device)
        self.enable_self_collision = bool(enable_self_collision)
        self.max_pairs = int(max_pairs)

        self.cross_pairs = None
        self.grid = None
        self.blk = None
        mode = broadphase
        if mode == "auto":
            if enable_self_collision:
                mode = "grid" if rest_nodes is not None else "sap"
            else:
                # The cross-pair count decides, before any list is built: past
                # the cap the list (6.1 M pairs at the item drop) is not needed.
                sizes = np.unique(np.asarray(mesh_ids), return_counts=True)[1]
                n_cross = (int(sizes.sum()) ** 2 - int((sizes.astype(np.int64) ** 2).sum())) // 2
                if n_cross and n_cross <= dense_cross_cap:
                    self.cross_pairs = setup_dense_cross(conn, mesh_ids, device=device)
                    mode = "dense"
                elif n_cross and rest_nodes is not None:
                    mode = "block"
                else:
                    mode = "sap"
        elif mode == "dense":
            self.cross_pairs = setup_dense_cross(conn, mesh_ids, device=device)
            if self.cross_pairs is None:
                raise ValueError("broadphase='dense' needs >=2 meshes")
        if mode == "block":
            if rest_nodes is None:
                raise ValueError("broadphase='block' requires rest_nodes= for the spatial "
                                 "element sort")
            self.blk = setup_block_cross(conn, mesh_ids, rest_nodes, block=block,
                                         block_pair_cap=block_pair_cap, device=device)
            if self.blk is None:
                raise ValueError("broadphase='block' needs >=2 meshes")
        if mode == "grid":
            if rest_nodes is None:
                raise ValueError("broadphase='grid' requires rest_nodes= for cell sizing")
            self.grid = setup_grid(rest_nodes, conn, cell_cap=cell_cap, margin=margin,
                                   device=device)
        self.mode = mode

    # The three phases, exposed for per-phase timing.
    def broadphase_fn(self, x: torch.Tensor):
        """-> (pairs (max_pairs, 2) int32, valid, overflow of the window,
        cell or block capacity, or of max_pairs)."""
        bp = self.bp
        if self.cross_pairs is not None:
            pairs, valid, win_overflow = find_pairs_dense(bp, x, self.cross_pairs)
        elif self.blk is not None:
            pairs, valid, win_overflow = find_pairs_block(bp, self.blk, x)
        elif self.grid is not None:
            pairs, valid, win_overflow = find_pairs_grid(bp, self.grid, x,
                                                         self.enable_self_collision)
        else:
            pairs, valid, win_overflow = find_pairs(bp, x, self.enable_self_collision)
        pairs, valid, cap_overflow = compact_pairs(pairs, valid, self.max_pairs)
        return pairs, valid, win_overflow | cap_overflow

    def narrowphase_fn(self, x: torch.Tensor, pairs: torch.Tensor,
                       valid: torch.Tensor) -> ContactPatches:
        return compute_patches(x, self.pressures, self.bp.corners, pairs, valid,
                               self.bp.mesh_ids, self.enable_self_collision)

    def forces_fn(self, patches: ContactPatches, x: torch.Tensor, v: torch.Tensor,
                  params: HydroelasticParams) -> torch.Tensor:
        return patch_forces(patches, x, v, self.bp.corners, damping=params.damping,
                            friction=params.friction)

    def step(self, x, v=None, params: HydroelasticParams | None = None):
        """-> (f_ext (n_nodes, 3), ContactPatches, overflow: bool tensor)."""
        if params is None:
            params = HydroelasticParams()
        x = torch.as_tensor(x, device=self.device)
        v = torch.zeros_like(x) if v is None else torch.as_tensor(v, device=self.device)
        pairs, valid, overflow = self.broadphase_fn(x)
        patches = self.narrowphase_fn(x, pairs, valid)
        return self.forces_fn(patches, x, v, params), patches, overflow

    def patches(self, x) -> ContactPatches:
        """The narrowphase's patches alone, for inspection."""
        _, patches, _ = self.step(x)
        return patches

    def grow(self, factor: int = 2) -> "HydroelasticCollision":
        """A rebuilt collision system with `factor` x the candidate capacity:
        the sweep window and max_pairs, and the grid's cell_cap or the
        block_pair_cap where they are in use (either can be the overflow's
        source). `Simulation` calls it on overflow."""
        args = dict(self._init_args)
        args["window"] = args["window"] * factor
        args["max_pairs"] = args["max_pairs"] * factor
        if self.grid is not None:
            args["cell_cap"] = self.grid.cell_cap * factor
        if self.blk is not None:
            args["block_pair_cap"] = self.blk.block_pair_cap * factor
        return HydroelasticCollision(**args)
