"""Frozen two-level coarse correction for Newton-PCG (port of the dense mode
of `tlfea/solvers/coarse.py`).

The block-Jacobi preconditioner handles the high-frequency end of the
spectrum; long-wavelength modes of slender or stiff structures stall CG
without a coarse space. Nodes are grouped into spatial-grid aggregates, each
carrying the six rigid modes (3 translations + 3 rotations about its
centroid), and the Galerkin operator A_c = R^T H(x0) R is assembled and
inverted once, at the build configuration. Each CG iteration then adds

    z_c = R A_c^{-1} R^T r,

with R^T r one dense (n_agg, n) one-hot matmul (`Agg`, deterministic, the
JAX dense mode's restrict) and R w one gather of the aggregate values.
The JAX package's range-factored and bf16 modes exist to avoid TPU
gathers and MXU passes, and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CoarsePrecond", "build_aggregates", "build_coarse_precond"]

K_MODES = 6  # rigid modes per aggregate
_CHUNK = 4096  # most elements per assembly pass (the JAX dense mode's chunk)
_CHUNK_BYTES = 1 << 30  # about what one pass's temporaries may take


def _viscous_factor(material, dt: float) -> float:
    """Proportional-damping scale of the elastic tangent (`coarse.py:33`):
    the Kelvin-Voigt tangent has the same lam*A + mu*B structure with
    (lam_d, eta) in place of (dt*lam, dt*mu)."""
    return 1.0 + (material.eta_damp + material.lam_damp) / (dt * (material.lam + material.mu))


def build_aggregates(x_ref: np.ndarray, target_cluster: int = 48) -> tuple[np.ndarray, int]:
    """Spatial-grid aggregation of nodes into clusters of about
    target_cluster nodes (host NumPy, `coarse.py:51`). Returns (agg (n,)
    int64 aggregate id per node, n_agg)."""
    x_ref = np.asarray(x_ref, dtype=np.float64)
    n = x_ref.shape[0]
    n_agg_target = max(1, n // target_cluster)
    lo = x_ref.min(axis=0)
    ext = np.maximum(x_ref.max(axis=0) - lo, 1e-12)
    rel = ext / ext.max()
    k = (n_agg_target / max(rel.prod(), 1e-12)) ** (1.0 / 3.0)
    dims = np.maximum(1, np.round(k * rel)).astype(int)
    cell = np.minimum(((x_ref - lo) / (ext / dims)).astype(int), dims - 1)
    keys = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    uniq, agg = np.unique(keys, return_inverse=True)
    return agg.astype(np.int64), int(len(uniq))


def _svk_pair_blocks(F, grad_N, dV, lam, mu, dt):
    """Per-element tangent blocks K[e, a, b] (3x3) = sum_q dt dV
    svk_tangent(F_q; h_a, h_b), for every node pair (`coarse.py:72`)."""
    Fh = torch.einsum("eqij,eqaj->eqai", F, grad_N)
    hij = torch.einsum("eqaj,eqbj->eqab", grad_N, grad_N)
    FhFh = torch.einsum("eqai,eqbi->eqab", Fh, Fh)
    trE = 0.5 * ((F * F).sum((-2, -1)) - 3.0)
    FFT = torch.einsum("eqik,eqjk->eqij", F, F)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    w = dt * dV
    K = lam * torch.einsum("xq,xqad,xqbc->xabdc", w, Fh, Fh)
    K = K + mu * torch.einsum("xq,xqbd,xqac->xabdc", w, Fh, Fh)
    K = K + mu * torch.einsum("xq,xqab,xqdc->xabdc", w, hij, FFT)
    scal = torch.einsum("xq,xqab->xab", w * (lam * trE - mu), hij)
    scal = scal + mu * torch.einsum("xq,xqab->xab", w, FhFh)
    return K + scal[..., None, None] * eye


def _phi(u0_e: torch.Tensor) -> torch.Tensor:
    """Per-node rigid-mode matrix Phi (..., 3, 6) = [I | -skew(u0)], so a
    coarse vector w gives the node value Phi @ w (`coarse.py:285`)."""
    shape = u0_e.shape[:-1]
    eye = torch.eye(3, dtype=u0_e.dtype, device=u0_e.device).expand(*shape, 3, 3)
    ux, uy, uz = u0_e[..., 0], u0_e[..., 1], u0_e[..., 2]
    zero = torch.zeros_like(ux)
    msk = torch.stack(
        [
            torch.stack([zero, uz, -uy], dim=-1),
            torch.stack([-uz, zero, ux], dim=-1),
            torch.stack([uy, -ux, zero], dim=-1),
        ],
        dim=-2,
    )
    return torch.cat([eye, msk], dim=-1)


@dataclass
class CoarsePrecond:
    """The frozen coarse correction: Agg (n_agg, n) one-hot restrict, agg
    (n,) aggregate of each node, u0 (n, 3) lever arms about the aggregate
    centroids, Ainv (6 n_agg, 6 n_agg) the inverse of the regularised SPD
    Galerkin operator."""

    Agg: torch.Tensor
    agg: torch.Tensor
    u0: torch.Tensor
    Ainv: torch.Tensor
    n_agg: int

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """R^T r: translations and moments about each centroid -> (6 n_agg,)."""
        r6 = torch.cat([r, torch.linalg.cross(self.u0, r, dim=1)], dim=1)
        return (self.Agg @ r6).reshape(-1)

    def prolong(self, w: torch.Tensor) -> torch.Tensor:
        """R w: each node's rigid motion of its aggregate -> (n, 3)."""
        z6 = w.reshape(self.n_agg, K_MODES)[self.agg]
        return z6[:, :3] + torch.linalg.cross(z6[:, 3:], self.u0, dim=1)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.prolong(self.Ainv @ self.restrict(r)).to(r.dtype)


def build_coarse_precond(system, x0: torch.Tensor, dt: float, rho: float,
                         target_cluster: int = 48, max_agg: int = 512) -> CoarsePrecond:
    """Assemble and invert the frozen coarse correction at configuration x0
    (`coarse.py:314`, dense mode, six rigid modes per aggregate), on x0's
    device and dtype. max_agg caps the number of aggregates."""
    dev, dtype = x0.device, x0.dtype
    x0np = x0.detach().cpu().numpy()
    n = x0np.shape[0]
    target_cluster = max(target_cluster, int(np.ceil(n / max_agg)))
    agg_np, na = build_aggregates(x0np, target_cluster=target_cluster)
    counts = np.zeros(na)
    np.add.at(counts, agg_np, 1.0)
    cent = np.zeros((na, 3))
    np.add.at(cent, agg_np, x0np)
    cent /= counts[:, None]
    u0 = torch.as_tensor((x0np - cent[agg_np]).astype(x0np.dtype), device=dev)
    agg = torch.as_tensor(agg_np, device=dev)
    Agg = torch.zeros((na, n), dtype=dtype, device=dev)
    Agg[agg, torch.arange(n, device=dev)] = 1.0

    elems, mat = system.elems, system.material
    k = K_MODES
    K = k * na
    vf = _viscous_factor(mat, dt)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Ac = torch.zeros((na * na, k, k), dtype=dtype, device=dev)
    S, Q = elems.n_shape, elems.dV.shape[1]
    # Per element, a pass holds the (Q, S, S) pair tables of _svk_pair_blocks
    # (hij, FhFh and their weighted products) and the (S, S, 3, 3) and
    # (S, S, 6, 6) blocks: size the chunk so that they stay near 1 GB (the
    # 48-point shell takes about a thousand elements a pass in float64).
    per_elem = (4 * Q * S * S + 4 * S * S * 9 + 2 * S * S * k * k) * x0.element_size()
    chunk = max(1, min(_CHUNK, _CHUNK_BYTES // per_elem))
    for s0 in range(0, elems.n_elem, chunk):
        sl = slice(s0, s0 + chunk)
        conn = elems.conn[sl]
        gN = elems.grad_N[sl]
        # Displacement-based F, as the JAX assembly computes it.
        Du = torch.einsum("eai,eqaj->eqij", x0[conn] - elems.xe_ref[sl], gN)
        F = Du + eye3
        Kb = _svk_pair_blocks(F, gN, elems.dV[sl], mat.lam, mat.mu, dt) * vf
        Hb = Kb + (elems.mass_elem[sl] / dt)[..., None, None] * eye3
        Phi = _phi(u0[conn])  # (e, S, 3, k)
        Ac6 = torch.einsum("eadf,eabdc,ebcg->eabfg", Phi, Hb, Phi)
        ca = agg[conn]
        rows = ca.repeat_interleave(S, dim=1).reshape(-1)
        cols = ca.repeat(1, S).reshape(-1)
        Ac.index_put_((rows * na + cols,), Ac6.reshape(-1, k, k), accumulate=True)
    Ac = Ac.view(na, na, k, k)

    # Constraint penalty dt^2 rho R^T diag(J^T J) R (exact for pins, the
    # diagonal of J^T J for linear rows).
    cons = system.constraints
    if cons is not None:
        d = cons.jtj_diag(n, dtype)  # (n,) pins, (n, 3) linear rows
        if d.ndim == 1:
            d = d[:, None].expand(n, 3)
        Phi_n = _phi(u0)
        pen = torch.einsum("ndf,nd,ndg->nfg", Phi_n, (dt * dt * rho) * d, Phi_n)
        # index_put_ with accumulate sums in sorted-index order on the card
        # (index_add_ would use atomics): the same bits on every run.
        pen_a = torch.zeros((na, k, k), dtype=dtype, device=dev).index_put_(
            (agg,), pen, accumulate=True)
        ar = torch.arange(na, device=dev)
        Ac[ar, ar] += pen_a

    Ad = Ac.permute(0, 2, 1, 3).reshape(K, K)
    diag_scale = torch.diagonal(Ad).abs().max().clamp_min(1e-30)
    Ad = 0.5 * (Ad + Ad.T) + (1e-5 * diag_scale) * torch.eye(K, dtype=dtype, device=dev)
    L = torch.linalg.cholesky(Ad)
    Ainv = torch.cholesky_solve(torch.eye(K, dtype=dtype, device=dev), L)
    return CoarsePrecond(Agg=Agg, agg=agg, u0=u0, Ainv=Ainv, n_agg=na)
