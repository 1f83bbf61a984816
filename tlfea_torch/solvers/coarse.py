"""Two-level (aggregation) coarse correction for Newton-PCG (port of
`tlfea/solvers/coarse.py`).

The block-Jacobi preconditioner handles the high-frequency end of the
spectrum; long-wavelength modes of slender or stiff structures stall CG
without a coarse space. Nodes are grouped into spatial-grid aggregates, each
carrying k modes about its centroid: the 3 translations (`modes="trans"`),
plus the 3 rotations (`"rigid"`, k = 6, the default), or the full affine
family (`"affine"`, k = 12: translations and the 9 linear-gradient modes).
The Galerkin operator A_c = R^T H(x0) R is assembled once, at the build
configuration, and each CG iteration adds

    z_c = R A_c^{-1} R^T r,

with R^T r one dense (n_agg, n) one-hot product (`Agg`, deterministic) and
R w one gather of the aggregate values. A_c^{-1} is stored as the explicit
inverse, or (`mm_dtype="bfloat16"`) as the bfloat16 inverse Cholesky factor
`Li`, applied as Li^T (Li rhs), which stays positive semi-definite under any
rounding; the one-hot `Agg` is exact in bfloat16. `rank=r` keeps the r
smallest-eigenvalue modes, whitened (`W`). `ranges=True` builds the same
aggregates: the JAX package factors its restrict through contiguous node
ranges to avoid TPU gathers, an implementation that equals the dense one by
construction, so the port keeps the dense restrict for it.

`CoarseSetup`, `coarse_operator` and `make_two_level_precond` are the legacy
per-solve form: the 3-mode Galerkin operator assembled and factored at every
inner solve (`newton.py:309-321`), kept for validation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tlfea_torch.elements.assembly import deformation_gradient
from tlfea_torch.ops.linalg import solve3x3

__all__ = ["CoarseSetup", "CoarsePrecond", "build_aggregates", "build_coarse_precond",
           "coarse_operator", "make_two_level_precond", "MODES"]

MODES = {"trans": 3, "rigid": 6, "affine": 12}  # modes per aggregate
_CHUNK_BYTES = 1 << 30  # about what one assembly pass's temporaries may take


def _viscous_factor(material, dt: float) -> float:
    """Proportional-damping scale of the elastic tangent (`coarse.py:33`):
    the Kelvin-Voigt tangent has the same lam*A + mu*B structure with
    (lam_d, eta) in place of (dt*lam, dt*mu)."""
    return 1.0 + (material.eta_damp + material.lam_damp) / (dt * (material.lam + material.mu))


@dataclass
class CoarseSetup:
    """Node aggregates of the legacy two-level preconditioner: agg (n,)
    int64 aggregate id per node, n_agg aggregates."""

    agg: torch.Tensor
    n_agg: int


def _grid_aggregates(x_ref: np.ndarray, target_cluster: int) -> tuple[np.ndarray, int]:
    """Spatial-grid aggregation (host NumPy, `coarse.py:51-69`): (agg (n,)
    int64, n_agg)."""
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
    return agg.astype(np.int64).reshape(-1), int(len(uniq))


def build_aggregates(x_ref, target_cluster: int = 48, device=None) -> CoarseSetup:
    """Spatial-grid aggregation of nodes into clusters of about
    target_cluster nodes. x_ref: (n, 3) array or tensor; the aggregate ids
    land on `device` (default: x_ref's device for a tensor, else the card)."""
    if isinstance(x_ref, torch.Tensor):
        device = x_ref.device if device is None else device
        x_ref = x_ref.detach().cpu().numpy()
    agg, na = _grid_aggregates(x_ref, target_cluster)
    return CoarseSetup(agg=torch.as_tensor(agg, device=device or "cuda"), n_agg=na)


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


def coarse_operator(x, elems, material, cons, setup: CoarseSetup, dt, rho):
    """The legacy Galerkin operator A_c = R^T H(x) R over the 3 translations
    of each aggregate, dense (3 n_agg, 3 n_agg), symmetrised and shifted by
    1e-6 of its largest diagonal entry (`coarse.py:97-125`)."""
    F = deformation_gradient(x, elems)
    Kb = _svk_pair_blocks(F, elems.grad_N, elems.dV, material.lam, material.mu, dt)
    Kb = Kb * _viscous_factor(material, dt)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    Hb = Kb + (elems.mass_elem / dt)[..., None, None] * eye  # (E, S, S, 3, 3)

    agg, na = setup.agg, setup.n_agg
    ca = agg[elems.conn]  # (E, S)
    S = ca.shape[1]
    rows = ca.repeat_interleave(S, dim=1).reshape(-1)
    cols = ca.repeat(1, S).reshape(-1)
    A = torch.zeros((na, na, 3, 3), dtype=x.dtype, device=x.device)
    A.index_put_((rows, cols), Hb.reshape(-1, 3, 3), accumulate=True)

    if cons is not None and hasattr(cons, "idx"):
        pen = torch.zeros((na,), dtype=x.dtype, device=x.device).index_put_(
            (agg[cons.idx],), torch.full(cons.idx.shape, dt * dt * rho, dtype=x.dtype,
                                         device=x.device), accumulate=True)
        ar = torch.arange(na, device=x.device)
        A[ar, ar] += pen[:, None, None] * eye

    Ad = A.permute(0, 2, 1, 3).reshape(3 * na, 3 * na)
    diag_scale = torch.diagonal(Ad).abs().max().clamp_min(1e-30)
    return 0.5 * (Ad + Ad.T) + (1e-6 * diag_scale) * torch.eye(3 * na, dtype=x.dtype,
                                                               device=x.device)


def make_two_level_precond(blocks, chol, setup: CoarseSetup):
    """Additive two-level apply r -> B_j^{-1} r + R A_c^{-1} R^T r
    (`coarse.py:540-557`): blocks (n, 3, 3) SPD block-Jacobi blocks, chol the
    lower Cholesky factor of `coarse_operator`'s matrix."""
    agg, na = setup.agg, setup.n_agg

    def apply(r):
        z = solve3x3(blocks, r, eps=1e-30)
        rc = torch.zeros((na, 3), dtype=r.dtype, device=r.device).index_put_(
            (agg,), r, accumulate=True)  # R^T r, summed in a fixed order
        zc = torch.cholesky_solve(rc.reshape(-1, 1), chol).reshape(na, 3)
        return z + zc[agg]  # + R zc

    return apply


def _phi(u0_e: torch.Tensor, k_modes: int) -> torch.Tensor:
    """Per-node mode matrix Phi (..., 3, k), so a coarse vector w gives the
    node value Phi @ w (`coarse.py:285-311`): k=3 I; k=6 [I | -skew(u0)];
    k=12 [I | u_x I | u_y I | u_z I] (column 3 + 3a + c is the mode u_a e_c,
    the restrict's channel layout)."""
    shape = u0_e.shape[:-1]
    eye = torch.eye(3, dtype=u0_e.dtype, device=u0_e.device).expand(*shape, 3, 3)
    if k_modes == 3:
        return eye
    if k_modes == 12:
        return torch.cat([eye] + [u0_e[..., a, None, None] * eye for a in range(3)], dim=-1)
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


def _torch_dtype(mm_dtype):
    """mm_dtype as a torch dtype: None, a torch dtype, or its name
    ("bfloat16", as the JAX package takes it)."""
    if mm_dtype is None or isinstance(mm_dtype, torch.dtype):
        return mm_dtype
    return getattr(torch, str(mm_dtype))


@dataclass
class CoarsePrecond:
    """The frozen coarse correction (`coarse.py:128-282`).

    Agg (n_agg, n) one-hot restrict; agg (n,) aggregate of each node; u0
    (n, 3) lever arms about the aggregate centroids; k_modes modes per
    aggregate. The solve is one of: Ainv (K, K) the inverse of the
    regularised SPD Galerkin operator (K = k n_agg); Li (K, K) its inverse
    Cholesky factor in mm_dtype; W (K, r) the whitened eigenvectors of its r
    smallest eigenvalues. With mm_dtype (torch.bfloat16) Agg, Li and W are
    stored in it and the per-iteration vectors round to it before each
    product, as the JAX package's `_mm` rounds them; the result comes back in
    the residual's dtype. ranges records the build flag (same aggregates)."""

    Agg: torch.Tensor
    agg: torch.Tensor
    u0: torch.Tensor
    Ainv: torch.Tensor | None
    n_agg: int
    k_modes: int = 6
    mm_dtype: torch.dtype | None = None
    Li: torch.Tensor | None = None
    W: torch.Tensor | None = None
    ranges: bool = False

    def _mm(self, a: torch.Tensor) -> torch.Tensor:
        return a if self.mm_dtype is None else a.to(self.mm_dtype)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """R^T r -> (k n_agg,): per aggregate the sums of r and, for k = 6,
        of the moments u0 x r, for k = 12 of u0[a] r[b] in channel 3 + 3a + b."""
        if self.k_modes == 6:
            r = torch.cat([r, torch.linalg.cross(self.u0, r, dim=1)], dim=1)
        elif self.k_modes == 12:
            outer = (self.u0[:, :, None] * r[:, None, :]).reshape(-1, 9)
            r = torch.cat([r, outer], dim=1)
        return (self.Agg @ self._mm(r)).reshape(-1)

    def prolong(self, w: torch.Tensor) -> torch.Tensor:
        """R w -> (n, 3): each node's motion of its aggregate's modes. The
        gather w[agg] equals the one-hot product Agg^T w exactly (one term a
        node), in any dtype."""
        z = self._mm(w).reshape(self.n_agg, self.k_modes)[self.agg].to(self.u0.dtype)
        if self.k_modes == 3:
            return z
        if self.k_modes == 6:
            return z[:, :3] + torch.linalg.cross(z[:, 3:], self.u0, dim=1)
        return z[:, :3] + torch.einsum("na,nab->nb", self.u0, z[:, 3:].reshape(-1, 3, 3))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        rhs = self.restrict(r)
        if self.W is not None:
            w = self.W @ (self.W.T @ rhs)  # truncated spectral solve, SPSD
        elif self.Li is not None:
            w = self.Li.T @ (self.Li @ rhs)  # factored solve, SPSD under rounding
        else:
            w = self.Ainv @ rhs
        return self.prolong(w).to(r.dtype)


def build_coarse_precond(system, x0, dt: float, rho: float, target_cluster: int = 48,
                         rotations: bool = True, modes: str | None = None, max_agg: int = 512,
                         chunk: int = 16384, ranges: bool = False, mm_dtype=None,
                         rank: int | None = None) -> CoarsePrecond:
    """Assemble and factor the frozen coarse correction at configuration x0
    (`coarse.py:314-537`), on x0's device and dtype (x0 an (n, 3) tensor, or
    an array, which goes to the elements' device).

    modes: "trans", "rigid" or "affine" (default "rigid", or "trans" when
    rotations is False). max_agg caps the number of aggregates. chunk: the
    JAX assembly chunk at k = 3 (scaled by 9 / k^2); the port further caps a
    pass's temporaries at about 1 GB. ranges: accepted, same aggregates and
    the same restrict (module docstring). mm_dtype ("bfloat16"): the apply
    tables in it and the solve through the inverse Cholesky factor. rank=r
    < K: the whitened r smallest-eigenvalue modes of A_c, from a float64
    eigendecomposition."""
    if modes is None:
        modes = "rigid" if rotations else "trans"
    k = MODES[modes]
    if not isinstance(x0, torch.Tensor):
        x0 = torch.as_tensor(np.asarray(x0), device=system.elems.device)
    dev, dtype = x0.device, x0.dtype
    mm = _torch_dtype(mm_dtype)
    x0np = x0.detach().cpu().numpy()
    n = x0np.shape[0]
    target_cluster = max(target_cluster, int(np.ceil(n / max_agg)))
    agg_np, na = _grid_aggregates(x0np, target_cluster)
    counts = np.zeros(na)
    np.add.at(counts, agg_np, 1.0)
    cent = np.zeros((na, 3))
    np.add.at(cent, agg_np, x0np)
    cent /= counts[:, None]
    u0 = torch.as_tensor((x0np - cent[agg_np]).astype(x0np.dtype), device=dev)
    agg = torch.as_tensor(agg_np, device=dev)
    # Built in the stored dtype: exact ones and zeros, and a bfloat16 table
    # never passes through float32 (598 MB at 146k nodes, max_agg 1024).
    Agg = torch.zeros((na, n), dtype=mm or dtype, device=dev)
    Agg[agg, torch.arange(n, device=dev)] = 1.0

    elems, mat = system.elems, system.material
    K = k * na
    vf = _viscous_factor(mat, dt)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Ac = torch.zeros((na * na, k, k), dtype=dtype, device=dev)
    S, Q = elems.n_shape, elems.dV.shape[1]
    # Per element, a pass holds the (Q, S, S) pair tables of _svk_pair_blocks
    # (hij, FhFh and their weighted products) and the (S, S, 3, 3) and
    # (S, S, k, k) blocks: size the chunk so that they stay near 1 GB (the
    # 48-point shell takes about a thousand elements a pass in float64, the
    # affine modes of FEAT10 about 3,600).
    per_elem = (4 * Q * S * S + 4 * S * S * 9 + 2 * S * S * k * k) * x0.element_size()
    step = max(1, min(max(512, chunk * 9 // (k * k)), _CHUNK_BYTES // per_elem))
    for s0 in range(0, elems.n_elem, step):
        sl = slice(s0, s0 + step)
        conn = elems.conn[sl]
        gN = elems.grad_N[sl]
        # Displacement-based F, as the JAX assembly computes it.
        Du = torch.einsum("eai,eqaj->eqij", x0[conn] - elems.xe_ref[sl], gN)
        F = Du + eye3
        Kb = _svk_pair_blocks(F, gN, elems.dV[sl], mat.lam, mat.mu, dt) * vf
        Hb = Kb + (elems.mass_elem[sl] / dt)[..., None, None] * eye3
        Phi = _phi(u0[conn], k)  # (e, S, 3, k)
        Ack = torch.einsum("eadf,eabdc,ebcg->eabfg", Phi, Hb, Phi)
        ca = agg[conn]
        rows = ca.repeat_interleave(S, dim=1).reshape(-1)
        cols = ca.repeat(1, S).reshape(-1)
        Ac.index_put_((rows * na + cols,), Ack.reshape(-1, k, k), accumulate=True)
    Ac = Ac.view(na, na, k, k)

    # Constraint penalty dt^2 rho R^T diag(J^T J) R (exact for pins, the
    # diagonal of J^T J for linear rows).
    cons = system.constraints
    if cons is not None:
        d = cons.jtj_diag(n, dtype)  # (n,) pins, (n, 3) linear rows
        if d.ndim == 1:
            d = d[:, None].expand(n, 3)
        Phi_n = _phi(u0, k)
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
    Ainv = Li = W = None
    if rank is not None and rank < K:
        # Truncated spectral solve: float64 eigh, one-time build cost.
        lam_c, Vc = torch.linalg.eigh(Ad.to(torch.float64))
        W = (Vc[:, :rank] / lam_c[:rank].sqrt()).to(mm or dtype)
    elif mm is None:
        Ainv = torch.cholesky_solve(torch.eye(K, dtype=dtype, device=dev),
                                    torch.linalg.cholesky(Ad))
    else:
        # The inverse Cholesky factor, rounded: M_c^-1 = Li^T Li stays SPSD
        # under any rounding, where the rounded explicit inverse turns
        # indefinite on stiff problems (CG breaks down, `coarse.py:192-199`).
        L = torch.linalg.cholesky(Ad)
        Li = torch.linalg.solve_triangular(L, torch.eye(K, dtype=dtype, device=dev),
                                           upper=False).to(mm)
    return CoarsePrecond(Agg=Agg, agg=agg, u0=u0, Ainv=Ainv, n_agg=na, k_modes=k,
                         mm_dtype=mm, Li=Li, W=W, ranges=bool(ranges))
