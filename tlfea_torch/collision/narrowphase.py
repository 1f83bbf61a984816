"""Hydroelastic contact-patch narrowphase, Drake's pressure-field convention
(port of `tlfea/collision/narrowphase.py`).

For each candidate tet pair: fit affine pressure fields p(x) = a.x + b to
the four corner pressures, intersect the equal-pressure plane with tet A,
clip the polygon against tet B's four halfspaces (Sutherland-Hodgman),
take the patch's area and centroid, orient the normal so that g_A > 0 and
g_B > 0 (flipping it where that helps), and evaluate the equilibrium
pressure at the centroid.

Every function here works on a batch of pairs, the leading dimension P,
where the JAX package `vmap`s a function of one pair. Each polygon lives in
a fixed (MAX_VERTS, 3) buffer with a vertex count; all branches are masks,
so the patch count never changes a shape. The angle sort is stable (the
masked slots all carry inf), the duplicate filter is a sequential loop of
10 over the batched mask, and the clip's scatters write the dropped
emissions into a dump slot that is sliced away.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tlfea_torch.ops.linalg import det3x3, solve3x3

__all__ = ["ContactPatches", "compute_patches", "MAX_VERTS", "NP_EPS"]

MAX_VERTS = 8
NP_EPS = 1e-10

# Tet edges, as in the reference's plane intersection.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_EI = [e[0] for e in _TET_EDGES]
_EJ = [e[1] for e in _TET_EDGES]
# Tet faces (i, j, k, opposite) for clipping.
_TET_FACES = [(0, 1, 2, 3), (0, 1, 3, 2), (0, 2, 3, 1), (1, 2, 3, 0)]


@dataclass(frozen=True)
class ContactPatches:
    """Fixed-capacity contact patches, one row per candidate pair."""

    verts: torch.Tensor  # (P, MAX_VERTS, 3)
    n_verts: torch.Tensor  # (P,) int32
    normal: torch.Tensor  # (P, 3)
    centroid: torch.Tensor  # (P, 3)
    area: torch.Tensor  # (P,)
    g_A: torch.Tensor  # (P,)
    g_B: torch.Tensor  # (P,)
    p_eq: torch.Tensor  # (P,)
    tetA: torch.Tensor  # (P,) int32
    tetB: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool
    valid_orientation: torch.Tensor  # (P,) bool

    @property
    def n_contacts(self) -> torch.Tensor:
        return torch.sum(self.valid & self.valid_orientation)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _affine_from_tet(v: torch.Tensor, p: torch.Tensor):
    """Affine fields (a, b) with a.v_i + b = p_i; v (P, 4, 3), p (P, 4) ->
    (a (P, 3), b (P,), ok (P,))."""
    TT = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], dim=-2)
    ok = det3x3(TT).abs() > 1e-30
    rhs = torch.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], dim=-1)
    a = solve3x3(TT, rhs, eps=1e-30)
    b = p[:, 0] - _dot(a, v[:, 0])
    return a, b, ok


def _order_by_angle(pts: torch.Tensor, mask: torch.Tensor, n_ref: torch.Tensor):
    """Masked points sorted CCW around their centroid in the plane of normal
    n_ref, the invalid slots last; pts (P, K, 3), mask (P, K) -> (P, K, 3),
    count (P,)."""
    cnt = mask.sum(-1)
    safe_cnt = cnt.clamp_min(1)
    centroid = torch.where(mask[..., None], pts, 0.0).sum(-2) / safe_cnt[:, None]
    n_hat = n_ref / _norm(n_ref).clamp_min(NP_EPS)[:, None]

    # The first valid in-plane direction (argmax of the mask: its first
    # valid slot, or slot 0); falls back to the x, then the y axis.
    first_idx = torch.argmax(mask.to(torch.int32), dim=-1)
    v0 = torch.take_along_dim(pts, first_idx[:, None, None], dim=1)[:, 0] - centroid
    v0 = v0 - _dot(v0, n_hat)[:, None] * n_hat

    def fallback(axis):
        vec = torch.zeros_like(n_hat)
        vec[:, axis] = 1.0
        return vec - _dot(vec, n_hat)[:, None] * n_hat

    v0 = torch.where((_norm(v0) < NP_EPS)[:, None], fallback(0), v0)
    v0 = torch.where((_norm(v0) < NP_EPS)[:, None], fallback(1), v0)
    u = v0 / _norm(v0).clamp_min(NP_EPS)[:, None]
    w = _cross(n_hat, u)

    rel = pts - centroid[:, None, :]
    ang = torch.atan2(_dot(rel, w[:, None, :]), _dot(rel, u[:, None, :]))
    ang = torch.where(mask, ang, torch.inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    return torch.take_along_dim(pts, order[..., None], dim=1), cnt


def _plane_tet_intersection(v: torch.Tensor, n: torch.Tensor, c: torch.Tensor):
    """Plane {n.x + c = 0} cut with tets v (P, 4, 3) -> ordered polygons
    (P, MAX_VERTS, 3), counts (P,) int32: the on-plane corners and the edge
    crossings, a later point dropped when an earlier kept one lies within
    10 NP_EPS, then sorted by angle."""
    P = v.shape[0]
    g = _dot(v, n[:, None, :]) + c[:, None]  # (P, 4)
    any_cross = ~((g.amax(-1) < -NP_EPS) | (g.amin(-1) > NP_EPS))

    on_plane = g.abs() <= NP_EPS
    gi, gj = g[:, _EI], g[:, _EJ]
    crossing = gi * gj < -NP_EPS * NP_EPS
    den = gi - gj
    t = gi / torch.where(den == 0, 1.0, den)
    pts_e = (1.0 - t)[..., None] * v[:, _EI] + t[..., None] * v[:, _EJ]  # (P, 6, 3)
    pts = torch.cat([v, pts_e], dim=1)  # (P, 10, 3)
    mask = torch.cat([on_plane, crossing], dim=1)  # (P, 10)

    # Sequential dedup: step i reads the mask that steps < i left.
    d2 = ((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)  # (P, 10, 10)
    tol2 = (NP_EPS * 10) ** 2
    keep = mask.clone()
    for i in range(1, 10):
        dup = torch.any(keep[:, :i] & (d2[:, i, :i] < tol2), dim=-1)
        keep[:, i] = keep[:, i] & ~dup

    ordered, cnt = _order_by_angle(pts, keep, n)
    cnt = torch.where(any_cross, cnt, 0)
    cnt = torch.where(cnt >= 3, cnt.clamp_max(MAX_VERTS), 0)
    idx = torch.arange(10, device=v.device).expand(P, 10)
    out = torch.where((idx < cnt[:, None])[..., None], ordered, 0.0)[:, :MAX_VERTS]
    return out, cnt.to(torch.int32)


def _clip_halfspace(verts: torch.Tensor, m: torch.Tensor, n: torch.Tensor, p0: torch.Tensor):
    """Sutherland-Hodgman clip of polygons (P, K, 3) with counts m against
    the halfspaces {n.(x - p0) <= 0}, capped at K = MAX_VERTS vertices: each
    edge emits its points at their prefix-sum positions; the emissions at K
    or beyond, and the non-emissions, go to a dump slot at K."""
    P, K = verts.shape[0], MAX_VERTS
    idx = torch.arange(K, device=verts.device).expand(P, K)
    mm = m[:, None]
    active = idx < mm
    nxt = torch.where(idx + 1 >= mm, 0, idx + 1)
    A = verts
    B = torch.take_along_dim(verts, nxt[..., None], dim=1)
    sA = _dot(A - p0[:, None, :], n[:, None, :])
    sB = _dot(B - p0[:, None, :], n[:, None, :])
    inA = sA <= NP_EPS
    inB = sB <= NP_EPS

    den = sA - sB
    t = sA / torch.where(den == 0, 1.0, den)
    X = (1.0 - t)[..., None] * A + t[..., None] * B

    emit1 = active & (inA | inB)  # every case but out-out emits one point
    first = torch.where((inA & inB)[..., None], B, X)  # in-in: B; else X
    emit2 = active & ~inA & inB  # out-in also emits B

    c1 = emit1.to(torch.int32)
    c2 = emit2.to(torch.int32)
    before = torch.cumsum(c1 + c2, dim=-1) - (c1 + c2)  # exclusive prefix
    pos1 = torch.where(emit1, before, K).clamp_max(K)
    pos2 = torch.where(emit2, before + c1, K).clamp_max(K)

    out = verts.new_zeros((P, K + 1, 3))
    out.scatter_(1, pos1[..., None].expand(P, K, 3).long(), first)
    out.scatter_(1, pos2[..., None].expand(P, K, 3).long(), B)
    m_out = (c1 + c2).sum(-1).clamp_max(K)
    return out[:, :K], m_out


def _clip_with_tet(verts: torch.Tensor, m: torch.Tensor, tet: torch.Tensor, n_ref: torch.Tensor):
    """Polygons clipped against the 4 faces of tets (P, 4, 3), then sorted by
    angle -> (P, MAX_VERTS, 3), counts int32."""
    for (i, j, k, o) in _TET_FACES:
        p0 = tet[:, i]
        n_raw = _cross(tet[:, j] - tet[:, i], tet[:, k] - tet[:, i])
        flip = _dot(n_raw, tet[:, o] - p0) > 0
        n_face = torch.where(flip[:, None], -n_raw, n_raw)
        verts, m = _clip_halfspace(verts, m, n_face, p0)
    mask = torch.arange(MAX_VERTS, device=verts.device)[None, :] < m[:, None]
    ordered, cnt = _order_by_angle(verts, mask, n_ref)
    return ordered, cnt.clamp_max(MAX_VERTS).to(torch.int32)


def _polygon_area_centroid(verts: torch.Tensor, m: torch.Tensor):
    """Fan-triangulated area and area-weighted centroid (the vertex mean
    where the area is below NP_EPS) of polygons (P, K, 3) with counts m."""
    K = MAX_VERTS
    i = torch.arange(1, K - 1, device=verts.device)
    tri_ok = (i + 1)[None, :] < m[:, None]
    v0 = verts[:, 0:1]
    v1 = verts[:, 1:K - 1]
    v2 = verts[:, 2:K]
    cr = _cross(v1 - v0, v2 - v0)
    tri_area = 0.5 * _norm(cr) * tri_ok
    tri_cent = (v0 + v1 + v2) / 3.0
    area = tri_area.sum(-1)
    vmask = torch.arange(K, device=verts.device)[None, :] < m[:, None]
    centroid = torch.where(
        (area > NP_EPS)[:, None],
        (tri_area[..., None] * tri_cent).sum(-2) / area.clamp_min(NP_EPS)[:, None],
        torch.where(vmask[..., None], verts, 0.0).sum(-2) / m.clamp_min(1)[:, None],
    )
    return area, centroid


def _patch_one(vA: torch.Tensor, pA: torch.Tensor, vB: torch.Tensor, pB: torch.Tensor):
    """The narrowphase of a batch of candidate pairs: tets vA, vB (P, 4, 3),
    corner pressures pA, pB (P, 4) -> dict of patch fields, as the JAX
    function returns for one pair."""
    aA, bA, okA = _affine_from_tet(vA, pA)
    aB, bB, okB = _affine_from_tet(vB, pB)

    n = aA - aB
    c = bA - bB
    n_norm = _norm(n)
    ok = okA & okB & (n_norm >= NP_EPS)

    poly, cntA = _plane_tet_intersection(vA, n, c)
    poly, cnt = _clip_with_tet(poly, cntA, vB, n)
    area, centroid = _polygon_area_centroid(poly, cnt)

    valid = ok & (cntA >= 3) & (cnt >= 3) & (area >= NP_EPS * NP_EPS)

    nhat0 = n / n_norm.clamp_min(NP_EPS)[:, None]
    g_A0 = -_dot(aA, nhat0)
    g_B0 = _dot(aB, nhat0)
    need_flip = (g_A0 <= 0) | (g_B0 <= 0)
    g_A1, g_B1 = -g_A0, -g_B0
    flip_ok = (g_A1 > 0) & (g_B1 > 0)
    valid_orientation = ~need_flip | flip_ok
    use_flipped = need_flip & flip_ok
    nhat = torch.where(use_flipped[:, None], -nhat0, nhat0)
    g_A = torch.where(use_flipped, g_A1, g_A0)
    g_B = torch.where(use_flipped, g_B1, g_B0)

    p_eq = _dot(aA, centroid) + bA
    return dict(
        verts=poly.to(vA.dtype),
        n_verts=cnt,
        normal=nhat,
        centroid=centroid,
        area=area,
        g_A=g_A,
        g_B=g_B,
        p_eq=p_eq,
        valid=valid,
        valid_orientation=valid_orientation,
    )


def compute_patches(x: torch.Tensor, pressures: torch.Tensor, corners: torch.Tensor,
                    pairs: torch.Tensor, pair_valid: torch.Tensor, mesh_ids: torch.Tensor,
                    enable_self_collision: bool = False) -> ContactPatches:
    """Narrowphase over a fixed-capacity pair array (`narrowphase.py:
    273-314`). x (n_nodes, 3); pressures (n_nodes,); corners (E, 4);
    pairs (P, 2) element ids; pair_valid (P,); mesh_ids (E,). The normal
    points from the lower mesh id to the higher."""
    tetA = pairs[:, 0].long()
    tetB = pairs[:, 1].long()
    swap = mesh_ids[tetA] > mesh_ids[tetB]
    tetA, tetB = torch.where(swap, tetB, tetA), torch.where(swap, tetA, tetB)
    if not enable_self_collision:
        pair_valid = pair_valid & (mesh_ids[tetA] != mesh_ids[tetB])

    cA, cB = corners[tetA], corners[tetB]
    fields = _patch_one(x[cA], pressures[cA], x[cB], pressures[cB])
    return ContactPatches(
        verts=fields["verts"],
        n_verts=fields["n_verts"],
        normal=fields["normal"],
        centroid=fields["centroid"],
        area=fields["area"],
        g_A=fields["g_A"],
        g_B=fields["g_B"],
        p_eq=fields["p_eq"],
        tetA=tetA.to(torch.int32),
        tetB=tetB.to(torch.int32),
        valid=fields["valid"] & pair_valid,
        valid_orientation=fields["valid_orientation"],
    )
