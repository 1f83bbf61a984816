"""The bridge to an external DEM engine behind the `CollisionSystem` step
contract (port of `tlfea/collision/dem_bridge.py`).

An external engine (the reference co-simulates with DEM-Engine) takes the
mesh state, advances its own dynamics and returns point contacts; the
bridge spreads each contact's force onto the K nearest surface nodes of
its own mesh by inverse-distance weights. This is host NumPy over the
port's `MeshManager`; the forces come back as a tensor on the positions'
device. For DEM that needs no external engine see `dem.NodeSphereDem` and
`dem.GranularDem`.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

__all__ = ["DemMeshCollision", "spread_point_forces"]


def spread_point_forces(points: np.ndarray, forces: np.ndarray, surface_nodes: np.ndarray,
                        k: int = 4, eps: float = 1e-9) -> np.ndarray:
    """Contact-point forces (C, 3) at points (C, 3) spread onto the K
    nearest of surface_nodes (S, 3) by inverse-distance weights -> (S, 3)."""
    out = np.zeros_like(surface_nodes)
    if len(points) == 0:
        return out
    d = np.linalg.norm(points[:, None, :] - surface_nodes[None, :, :], axis=-1)
    k = min(k, surface_nodes.shape[0])
    nearest = np.argpartition(d, k - 1, axis=1)[:, :k]
    for c in range(points.shape[0]):
        idx = nearest[c]
        w = 1.0 / (d[c, idx] + eps)
        w = w / w.sum()
        out[idx] += w[:, None] * forces[c]
    return out


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class DemMeshCollision:
    """`CollisionSystem` bridge to an external host-side DEM engine.

    backend implements `do_dynamics(meshes, x, v) -> (points, forces,
    mesh_ids)`, mesh_ids attributing each contact to one registered mesh,
    onto whose surface nodes alone it is spread, so Newton's third law holds
    across meshes. A backend that returns only (points, forces), or takes
    no velocities, is refused.
    """

    def __init__(self, mesh_manager, backend=None, k_nearest: int = 4):
        if backend is None:
            raise RuntimeError(
                "DemMeshCollision is the bridge for an EXTERNAL host-side DEM engine (the "
                "reference uses projectchrono/DEM-Engine). Provide backend= with "
                "do_dynamics(meshes, x, v) -> (points, forces, mesh_ids), or use the "
                "on-device backend: tlfea_torch.collision.dem.NodeSphereDem.")
        self.mm = mesh_manager
        self.backend = backend
        self.k_nearest = k_nearest

    def step(self, x, v=None, params=None):
        """One exchange: prescribe positions and velocities (zeros when v is
        None) to the engine, let it advance, spread the returned contact
        forces onto each contact's own mesh -> (f (n, 3) on x's device,
        None, False)."""
        x_np = _host(x)
        v_np = np.zeros_like(x_np) if v is None else _host(v)
        try:
            inspect.signature(self.backend.do_dynamics).bind(self.mm, x_np, v_np)
        except TypeError:
            raise TypeError(
                "DEM backend do_dynamics must accept (meshes, x, v): the bridge prescribes "
                "node velocities so contacts see the correct relative velocity (v is zeros "
                "when the caller has none). Update the backend signature.") from None
        except ValueError:
            pass  # an uninspectable callable (a C extension): call it as it is
        out = self.backend.do_dynamics(self.mm, x_np, v_np)
        if len(out) != 3:
            raise ValueError(
                "DEM backend must return (points, forces, mesh_ids): without per-contact "
                "mesh attribution the bridge cannot spread forces correctly across meshes")
        points, forces, mesh_ids = (np.asarray(a) for a in out)
        f = np.zeros_like(x_np)
        for mid in range(len(self.mm.instances)):
            sel = mesh_ids == mid
            if not sel.any():
                continue
            surf_ids = np.unique(self.mm.surface_triangles(mid).reshape(-1))
            f[surf_ids] += spread_point_forces(points[sel], forces[sel], x_np[surf_ids],
                                               k=self.k_nearest)
        device = x.device if isinstance(x, torch.Tensor) else None
        return torch.as_tensor(f, device=device), None, False
