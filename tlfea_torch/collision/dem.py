"""On-device DEM contact backends, sphere contacts in the manner of
DEM-Engine (port of `tlfea/collision/dem.py`).

- `NodeSphereDem`: mesh-against-mesh contact through a sphere on every
  surface node, its radius from the shortest incident surface edge;
  spheres of different meshes meet by a spring-dashpot normal force and
  regularized Coulomb friction, applied to the owning nodes, so Newton's
  third law holds exactly.
- `GranularDem`: a free sphere cloud advanced by symplectic-Euler substeps
  against the deformable surface triangles (closest point on the
  triangle, forces spread by its barycentric weights) and against each
  other; the mesh is held at its positions during the substeps.

Both keep the `CollisionSystem` step contract, step(x, v, params) ->
(f_ext (n, 3), info, overflow). Node sums are `index_put_` with accumulate
(a fixed order on the card as on the CPU); the substep loop is a Python
loop where the JAX package has `lax.fori_loop`.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["DemParams", "dem_params_from_material", "NodeSphereDem",
           "SphereCloud", "GranularDem", "node_sphere_radii"]


@dataclass(frozen=True)
class DemParams:
    """Contact-law parameters: normal stiffness kn [N/m], normal damping cn
    [N s/m], Coulomb coefficient mu and the friction regularization
    velocity v_reg [m/s]. `dem_params_from_material` derives kn and cn
    from material properties."""

    kn: float = 1e6
    cn: float = 1e2
    mu: float = 0.4
    v_reg: float = 1e-3


def dem_params_from_material(E, nu, cor, radius, mass, mu=0.4, overlap_frac=1e-2,
                             v_reg=1e-3) -> DemParams:
    """(E, nu, coefficient of restitution) -> (kn, cn) on the host, the
    linear-spring equivalent of Hertzian contact between like spheres
    (`dem.py:60-100`):
      E* = E / (2 (1 - nu^2)), R* = radius / 2,
      kn = (4/3) E* sqrt(R* d0) with d0 = overlap_frac R*,
      m* = mass / 2, cn = 2 beta sqrt(kn m*),
      beta = -ln(e) / sqrt(ln(e)^2 + pi^2) (e = 0: critical damping),
    so that a normal impact leaves with |v_out / v_in| = e."""
    E, nu, cor = float(E), float(nu), float(cor)
    radius, mass = float(radius), float(mass)
    if not (0.0 <= cor <= 1.0):
        raise ValueError(f"restitution must be in [0, 1], got {cor}")
    e_star = E / (2.0 * (1.0 - nu * nu))
    r_star = 0.5 * radius
    d0 = overlap_frac * r_star
    kn = (4.0 / 3.0) * e_star * np.sqrt(r_star * d0)
    m_star = 0.5 * mass
    if cor <= 0.0:
        beta = 1.0
    else:
        ln_e = np.log(cor)
        beta = -ln_e / np.sqrt(ln_e * ln_e + np.pi * np.pi)
    cn = 2.0 * beta * np.sqrt(kn * m_star)
    return DemParams(kn=float(kn), cn=float(cn), mu=float(mu), v_reg=float(v_reg))


def _contact_force(n_hat, delta, v_rel, kn, cn, mu, v_reg):
    """Spring-dashpot plus regularized Coulomb force on body A (n_hat points
    from B to A; delta > 0 is penetration). Shapes broadcast; the force has
    n_hat's shape."""
    vn = (v_rel * n_hat).sum(-1, keepdim=True)  # approach < 0
    fn_mag = kn * delta - cn * vn[..., 0]
    fn_mag = torch.where(delta > 0, torch.clamp_min(fn_mag, 0.0), 0.0)
    f_n = fn_mag[..., None] * n_hat
    v_t = v_rel - vn * n_hat
    vt_mag = torch.linalg.vector_norm(v_t, dim=-1, keepdim=True)
    f_t = -(mu * fn_mag)[..., None] * v_t / (vt_mag + v_reg)
    return f_n + f_t


def node_sphere_radii(nodes: np.ndarray, tris: np.ndarray, scale: float = 0.5) -> np.ndarray:
    """Per-node contact radius on the host: `scale` x the shortest incident
    surface edge; zero off the surface. nodes (n, 3); tris (T, 3) global
    node ids."""
    r = np.full(nodes.shape[0], np.inf)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        e = np.linalg.norm(nodes[tris[:, a]] - nodes[tris[:, b]], axis=1)
        np.minimum.at(r, tris[:, a], e)
        np.minimum.at(r, tris[:, b], e)
    r[~np.isfinite(r)] = 0.0
    return scale * r


class NodeSphereDem:
    """Mesh-against-mesh DEM contact through per-surface-node spheres, on
    `device` (the card unless device="cpu" is passed).

    surface_tris_per_mesh: one (T_i, 3) array of GLOBAL node ids per mesh
    (e.g. `MeshManager.surface_triangles`). Every pair of distinct meshes
    is tested as the dense cross product of their surface nodes. Forces
    engage at the skin distance (the sphere radii): kn should be stiff
    enough that the surfaces never cross.
    """

    def __init__(self, nodes: np.ndarray, surface_tris_per_mesh, radius_scale: float = 0.5,
                 device="cuda"):
        nodes = np.asarray(nodes)
        device = torch.device(device)
        surf_ids = [np.unique(np.asarray(tris).reshape(-1)) for tris in surface_tris_per_mesh]
        all_tris = np.concatenate([np.asarray(t) for t in surface_tris_per_mesh], axis=0)
        radii = node_sphere_radii(nodes, all_tris, scale=radius_scale)
        self._pairs = [
            (torch.as_tensor(surf_ids[i].astype(np.int64), device=device),
             torch.as_tensor(surf_ids[j].astype(np.int64), device=device))
            for i in range(len(surf_ids)) for j in range(i + 1, len(surf_ids))
        ]
        self._radii = torch.as_tensor(radii, device=device)
        self.device = device
        self.n_spheres = int(sum(len(s) for s in surf_ids))

    def step(self, x, v=None, params: DemParams | None = None):
        """-> (f (n, 3), info with n_contacts, overflow False). The radii
        are used in the positions' dtype."""
        if params is None or not isinstance(params, DemParams):
            params = DemParams()
        x = torch.as_tensor(x, device=self.device)
        v = torch.zeros_like(x) if v is None else torch.as_tensor(v, device=self.device)
        radii = self._radii.to(x.dtype)
        f = torch.zeros_like(x)
        n_active = torch.zeros((), dtype=torch.int64, device=x.device)
        for ia, ib in self._pairs:
            d = x[ia][:, None, :] - x[ib][None, :, :]  # (A, B, 3), from B to A
            dist = torch.linalg.vector_norm(d, dim=-1)
            delta = (radii[ia][:, None] + radii[ib][None, :]) - dist
            n_hat = d / (dist[..., None] + 1e-30)
            v_rel = v[ia][:, None, :] - v[ib][None, :, :]
            fab = _contact_force(n_hat, delta, v_rel, params.kn, params.cn, params.mu,
                                 params.v_reg)  # on the A spheres
            f.index_put_((ia,), fab.sum(1), accumulate=True)
            f.index_put_((ib,), -fab.sum(0), accumulate=True)
            n_active = n_active + (delta > 0).sum()
        overflow = torch.zeros((), dtype=torch.bool, device=x.device)
        return f, SimpleNamespace(n_contacts=n_active), overflow


@dataclass(frozen=True)
class SphereCloud:
    """Free granular spheres: positions, velocities, radii, masses."""

    x: torch.Tensor  # (P, 3)
    v: torch.Tensor  # (P, 3)
    r: torch.Tensor  # (P,)
    m: torch.Tensor  # (P,)

    @staticmethod
    def grid(center, extent, spacing, radius, density=2500.0, dtype=torch.float64,
             device="cuda") -> "SphereCloud":
        """A regular block of spheres centred at `center`, on `device`."""
        c = np.asarray(center, dtype=float)
        e = np.asarray(extent, dtype=float)
        counts = np.maximum(1, np.round(e / spacing).astype(int))
        axes = [(np.arange(k) - (k - 1) / 2.0) * spacing + cc for k, cc in zip(counts, c)]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        P = g.shape[0]
        m = density * 4.0 / 3.0 * np.pi * radius**3
        device = torch.device(device)
        return SphereCloud(
            x=torch.as_tensor(g, device=device).to(dtype),
            v=torch.zeros((P, 3), dtype=dtype, device=device),
            r=torch.full((P,), radius, dtype=dtype, device=device),
            m=torch.full((P,), m, dtype=dtype, device=device),
        )


def _closest_point_tri(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, all (..., 3) broadcast ->
    (point, barycentric (..., 3)); Ericson's regions as masks, vertex
    regions first."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    safe = torch.where(denom != 0, denom, 1.0)
    v = vb / safe
    w = vc / safe
    u_i, v_i = 1.0 - v - w, v

    def ratio(num, den):
        return torch.clamp(num / torch.where(den != 0, den, 1.0), 0.0, 1.0)

    t_ab = ratio(d1, d1 - d3)
    t_ac = ratio(d2, d2 - d6)
    t_bc = ratio(d4 - d3, (d4 - d3) + (d5 - d6))

    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    face = ~in_a & ~in_b & ~in_c
    on_ab = face & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = face & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = face & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    W = torch.where
    u = W(in_a, 1.0, W(in_b, 0.0, W(in_c, 0.0, W(on_ab, 1.0 - t_ab, W(on_ac, 1.0 - t_ac,
          W(on_bc, 0.0, u_i))))))
    vv = W(in_a, 0.0, W(in_b, 1.0, W(in_c, 0.0, W(on_ab, t_ab, W(on_ac, 0.0,
           W(on_bc, 1.0 - t_bc, v_i))))))
    ww = 1.0 - u - vv
    bary = torch.stack([u, vv, ww], dim=-1)
    point = u[..., None] * a + vv[..., None] * b + ww[..., None] * c
    return point, bary


class GranularDem:
    """A free sphere cloud contacting the deformable surface, on `device`.

    One `step` advances the cloud by n_sub symplectic-Euler substeps with
    the mesh held at its positions, and returns the time-averaged reaction
    on the mesh nodes (impulse-consistent with the FEA step) and the
    advanced cloud. Contacts are the dense (P, T) sphere-triangle and
    (P, P) sphere-sphere sets.
    """

    def __init__(self, tris: np.ndarray, n_sub: int = 8, gravity=(0.0, 0.0, -9.81),
                 device="cuda"):
        self.device = torch.device(device)
        self.tris = torch.as_tensor(np.asarray(tris, dtype=np.int64), device=self.device)
        self.n_sub = int(n_sub)
        self.gravity = tuple(float(g) for g in gravity)
        self.cloud: SphereCloud | None = None

    def _advance(self, cloud: SphereCloud, x_mesh, v_mesh, dt, params: DemParams):
        tris = self.tris
        h = dt / self.n_sub
        a_tri, b_tri, c_tri = x_mesh[tris[:, 0]], x_mesh[tris[:, 1]], x_mesh[tris[:, 2]]
        va_t, vb_t, vc_t = v_mesh[tris[:, 0]], v_mesh[tris[:, 1]], v_mesh[tris[:, 2]]
        g = torch.tensor(self.gravity, dtype=cloud.x.dtype, device=cloud.x.device)
        P = cloud.x.shape[0]
        eye = torch.eye(P, dtype=torch.bool, device=cloud.x.device)
        kw = dict(kn=params.kn, cn=params.cn, mu=params.mu, v_reg=params.v_reg)
        xs, vs = cloud.x, cloud.v
        f_acc = torch.zeros_like(x_mesh)
        for _ in range(self.n_sub):
            # Sphere-triangle contacts (P, T).
            cp, bary = _closest_point_tri(xs[:, None, :], a_tri[None], b_tri[None], c_tri[None])
            d = xs[:, None, :] - cp
            dist = torch.linalg.vector_norm(d, dim=-1)
            delta = cloud.r[:, None] - dist
            n_hat = d / (dist[..., None] + 1e-30)
            v_surf = (bary[..., 0:1] * va_t[None] + bary[..., 1:2] * vb_t[None]
                      + bary[..., 2:3] * vc_t[None])
            f_pt = _contact_force(n_hat, delta, vs[:, None, :] - v_surf, **kw)  # on the spheres
            f_s = f_pt.sum(1)
            w_r = -f_pt[..., None, :] * bary[..., :, None]  # (P, T, 3 nodes, 3)
            f_mesh = torch.zeros_like(x_mesh).index_put_(
                (tris.reshape(-1),), w_r.sum(0).reshape(-1, 3), accumulate=True)

            # Sphere-sphere contacts (P, P), self masked.
            dss = xs[:, None, :] - xs[None, :, :]
            dist_ss = torch.linalg.vector_norm(dss, dim=-1)
            delta_ss = (cloud.r[:, None] + cloud.r[None, :]) - dist_ss
            delta_ss = torch.where(eye, -1.0, delta_ss)
            n_ss = dss / (dist_ss[..., None] + 1e-30)
            f_ss = _contact_force(n_ss, delta_ss, vs[:, None, :] - vs[None, :, :], **kw)
            f_s = f_s + f_ss.sum(1)

            vs = vs + h * (f_s / cloud.m[:, None] + g[None, :])
            xs = xs + h * vs
            f_acc = f_acc + f_mesh
        return SphereCloud(x=xs, v=vs, r=cloud.r, m=cloud.m), f_acc / self.n_sub

    def bind_cloud(self, cloud: SphereCloud) -> None:
        self.cloud = cloud

    def step(self, x, v=None, params: DemParams | None = None, dt=1e-3):
        """-> (time-averaged f_mesh (n, 3), {"cloud": the advanced cloud},
        overflow False)."""
        if self.cloud is None:
            raise RuntimeError("bind_cloud() first")
        if params is None or not isinstance(params, DemParams):
            params = DemParams()
        x = torch.as_tensor(x, device=self.device)
        v = torch.zeros_like(x) if v is None else torch.as_tensor(v, device=self.device)
        self.cloud, f_mesh = self._advance(self.cloud, x, v, float(dt), params)
        return f_mesh, {"cloud": self.cloud}, torch.zeros((), dtype=torch.bool,
                                                           device=self.device)
