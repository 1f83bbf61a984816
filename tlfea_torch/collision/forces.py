"""Contact-patch forces and their spread onto the nodes (port of
`tlfea/collision/forces.py`).

Per valid patch: F = p_eq A n_hat, with Drake's normal damping p (1 - d v_n)
(clamped at 0) and regularized Coulomb friction mu |N| v_t / (|v_t| +
V_REG), spread onto the 4 + 4 corner nodes of the two tets by the
barycentric weights of the patch centroid: tet A receives -F, tet B +F.
The node sums are `index_put_` with accumulate, which adds each node's
terms in a fixed order on the card as on the CPU.
"""

from __future__ import annotations

import torch

from tlfea_torch.collision.narrowphase import ContactPatches
from tlfea_torch.ops.linalg import solve3x3

__all__ = ["patch_forces", "V_REG"]

V_REG = 1e-3  # friction regularization velocity


def _barycentric(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates of points x (P, 3) in tets v (P, 4, 3) -> (P, 4)."""
    M = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], dim=-1)
    lam123 = solve3x3(M, x - v[:, 0], eps=1e-30)
    lam0 = 1.0 - lam123.sum(-1, keepdim=True)
    return torch.cat([lam0, lam123], dim=-1)


def patch_forces(patches: ContactPatches, x: torch.Tensor, v: torch.Tensor | None,
                 corners: torch.Tensor, damping=0.0, friction=0.0) -> torch.Tensor:
    """Per-node contact forces (n_nodes, 3) (`forces.py:37-83`). The
    velocity terms are computed whenever v is given; a zero damping or
    friction makes them exact no-ops."""
    use = patches.valid & patches.valid_orientation & (patches.area > 1e-18)
    nodesA = corners[patches.tetA.long()]  # (P, 4)
    nodesB = corners[patches.tetB.long()]
    N_A = _barycentric(patches.centroid, x[nodesA])
    N_B = _barycentric(patches.centroid, x[nodesB])

    p_damped = patches.p_eq
    F_t = torch.zeros_like(patches.normal)
    if v is not None:
        velA = (N_A[..., None] * v[nodesA]).sum(-2)
        velB = (N_B[..., None] * v[nodesB]).sum(-2)
        v_rel = velB - velA
        v_rel_n = (v_rel * patches.normal).sum(-1)
        factor = torch.clamp_min(1.0 - damping * v_rel_n, 0.0)
        p_damped = patches.p_eq * factor
        v_t = v_rel - v_rel_n[:, None] * patches.normal
        v_t_norm = torch.linalg.vector_norm(v_t, dim=-1)
        slip = v_t_norm / (v_t_norm + V_REG)
        N_mag = torch.abs(p_damped * patches.area)
        Ft_mag = friction * N_mag * slip
        t_hat = v_t / v_t_norm.clamp_min(1e-30)[:, None]
        F_t = -Ft_mag[:, None] * t_hat

    F_patch = (p_damped * patches.area)[:, None] * patches.normal + F_t
    F_patch = torch.where(use[:, None], F_patch, 0.0)

    # The unused rows (most of a fixed capacity: padding pairs all name
    # element 0) add zeros; each goes to a dump row of its own, sliced away,
    # since thousands of duplicates of one node serialize the card's sorted
    # accumulation (6.6 ms a call on an H100 at 65,536 pairs, most unused).
    n = x.shape[0]
    dump = n + torch.arange(nodesA.numel(), device=x.device).view(nodesA.shape)
    f = torch.zeros((n + nodesA.numel(), 3), dtype=x.dtype, device=x.device)
    f.index_put_((torch.where(use[:, None], nodesA, dump).reshape(-1),),
                 (N_A[..., None] * (-F_patch)[:, None, :]).reshape(-1, 3).to(x.dtype),
                 accumulate=True)
    f.index_put_((torch.where(use[:, None], nodesB, dump).reshape(-1),),
                 (N_B[..., None] * F_patch[:, None, :]).reshape(-1, 3).to(x.dtype),
                 accumulate=True)
    return f[:n]
