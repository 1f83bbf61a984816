"""Hydroelastic pressure-field construction (port of
`tlfea/utils/pressure.py`, host-side NumPy).

Per-vertex pressure = hydroelastic_modulus * (signed) distance to the mesh
surface: interior vertices carry positive pressure growing with depth,
surface vertices zero. This is how the reference generates its `p_vertex`
NPZ assets (`test-scripts/hydropatch_proto/harmonic_field.py:237-335`,
distance-to-surface x modulus); here it is a first-class host utility
instead of an offline script.
"""

from __future__ import annotations

import numpy as np

from tlfea_torch.utils.tetmesh import surface_triangles_t10

__all__ = ["point_triangle_distance", "distance_pressure_field"]


def point_triangle_distance(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Distance from points p (N, 3) to triangles tri (T, 3, 3) -> (N, T).

    Vectorized Eberly-style closest-point-on-triangle.
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]  # (T, 3)
    ab = b - a
    ac = c - a
    ap = p[:, None, :] - a[None, :, :]  # (N, T, 3)

    d1 = np.einsum("tj,ntj->nt", ab, ap)
    d2 = np.einsum("tj,ntj->nt", ac, ap)
    bp = p[:, None, :] - b[None, :, :]
    d3 = np.einsum("tj,ntj->nt", ab, bp)
    d4 = np.einsum("tj,ntj->nt", ac, bp)
    cp = p[:, None, :] - c[None, :, :]
    d5 = np.einsum("tj,ntj->nt", ab, cp)
    d6 = np.einsum("tj,ntj->nt", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = np.where(vb + vc + va == 0, 1.0, va + vb + vc)
    v = vb / denom
    w = vc / denom
    closest = (
        a[None, :, :]
        + v[..., None] * ab[None, :, :]
        + w[..., None] * ac[None, :, :]
    )

    # Vertex regions
    closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a[None], closest)
    closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b[None], closest)
    closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c[None], closest)
    # Edge AB
    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1.0, d1 - d3), 0.0, 1.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    closest = np.where(on_ab[..., None], a[None] + t_ab[..., None] * ab[None], closest)
    # Edge AC
    t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1.0, d2 - d6), 0.0, 1.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    closest = np.where(on_ac[..., None], a[None] + t_ac[..., None] * ac[None], closest)
    # Edge BC
    t_bc = np.clip(
        (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1.0, (d4 - d3) + (d5 - d6)),
        0.0,
        1.0,
    )
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    closest = np.where(
        on_bc[..., None], b[None] + t_bc[..., None] * (c - b)[None], closest
    )

    return np.linalg.norm(p[:, None, :] - closest, axis=-1)


def distance_pressure_field(
    nodes: np.ndarray,
    conn: np.ndarray,
    modulus: float = 1.0,
    chunk: int = 512,
) -> np.ndarray:
    """Per-node pressure = modulus * distance-to-surface for a T10 mesh."""
    tris_idx = surface_triangles_t10(conn)
    tri = nodes[tris_idx]  # (T, 3, 3)
    surface_nodes = set(tris_idx.reshape(-1).tolist())
    out = np.zeros(nodes.shape[0])
    for start in range(0, nodes.shape[0], chunk):
        sl = slice(start, min(start + chunk, nodes.shape[0]))
        d = point_triangle_distance(nodes[sl], tri).min(axis=1)
        out[sl] = d
    for n in surface_nodes:
        out[n] = 0.0
    return modulus * out
