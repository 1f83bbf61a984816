"""Compressible Mooney-Rivlin hyperelastic material with Kelvin-Voigt damping
(port of `tlfea/materials/mooney_rivlin.py`).

Strain energy W = mu10 (I1bar - 3) + mu01 (I2bar - 3) + kappa/2 (J - 1)^2,
whose first Piola-Kirchhoff stress is

  P = 2 mu10 J^{-2/3} (F - I1/3 F^{-T})
    + 2 mu01 J^{-4/3} (I1 F - F C - 2 I2/3 F^{-T})
    + kappa (J - 1) J F^{-T}.

PyTorch has no cube root, so J^{1/3} is `ops.linalg.cbrt`, sign(J)
|J|^{1/3}: the real root, negative at an inverted point (J < 0) as the JAX
package's `jnp.cbrt` and the kernels' CUDA `cbrt` give it, so the stress
stays finite there. The CUDA form of the same algebra, with the exact
J - 1 and a hand-derived directional tangent, is `tlfea_torch/csrc/mr.cuh`;
its plain twins are in `tlfea_torch/ops/fem_kernels.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tlfea_torch.ops.linalg import cbrt, det3x3, inv_transpose3x3

__all__ = ["MooneyRivlin"]


def _invariants(F: torch.Tensor):
    """(C = F^T F, I1, I2) of (..., 3, 3)."""
    C = torch.einsum("...ki,...kj->...ij", F, F)
    I1 = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    trC2 = (C * C.transpose(-1, -2)).sum((-2, -1))
    return C, I1, 0.5 * (I1 * I1 - trC2)


@dataclass(frozen=True)
class MooneyRivlin:
    """Mooney-Rivlin parameters as Python floats; eta_damp and lam_damp are
    the Kelvin-Voigt viscosities (zero disables damping)."""

    mu10: float
    mu01: float
    kappa: float
    eta_damp: float = 0.0
    lam_damp: float = 0.0

    @property
    def mu(self) -> float:
        """Small-strain shear modulus 2 (mu10 + mu01): the Lame-scale stand-in
        of the preconditioner's viscous fold, the coarse space and
        `suggest_rho`. The stress never reads it."""
        return 2.0 * (self.mu10 + self.mu01)

    @property
    def lam(self) -> float:
        """Small-strain first Lame equivalent kappa - 4/3 (mu10 + mu01),
        clamped at 0: its consumers need a non-negative stiffness scale."""
        return max(self.kappa - (4.0 / 3.0) * (self.mu10 + self.mu01), 0.0)

    @property
    def damped(self) -> bool:
        return self.eta_damp != 0.0 or self.lam_damp != 0.0

    def _piola(self, F, J, Jm1):
        C, I1, I2 = _invariants(F)
        FinvT = inv_transpose3x3(F, det=J)
        Jm23 = cbrt(J).pow(-2.0)
        FC = F @ C
        t1 = (2.0 * self.mu10 * Jm23)[..., None, None]
        t2 = (2.0 * self.mu01 * Jm23 * Jm23)[..., None, None]
        t3 = (self.kappa * Jm1 * J)[..., None, None]
        term1 = F - (I1 / 3.0)[..., None, None] * FinvT
        term2 = I1[..., None, None] * F - FC - (2.0 * I2 / 3.0)[..., None, None] * FinvT
        return t1 * term1 + t2 * term2 + t3 * FinvT

    def first_piola(self, F: torch.Tensor) -> torch.Tensor:
        """Elastic first Piola stress for F of shape (..., 3, 3)."""
        J = det3x3(F)
        return self._piola(F, J, J - 1.0)

    def first_piola_du(self, Du: torch.Tensor) -> torch.Tensor:
        """P from the displacement gradient Du = F - I, with the exact
        (cancellation-free) J - 1 = tr(Du) + c2(Du) + det(Du), c2 the sum of
        the principal 2x2 minors. The isochoric terms cancel to O(strain)
        as in `first_piola` (structural to the Mooney-Rivlin form)."""
        d = torch.diagonal(Du, dim1=-2, dim2=-1)
        c2 = (d[..., 0] * d[..., 1] - Du[..., 0, 1] * Du[..., 1, 0]
              + d[..., 0] * d[..., 2] - Du[..., 0, 2] * Du[..., 2, 0]
              + d[..., 1] * d[..., 2] - Du[..., 1, 2] * Du[..., 2, 1])
        Jm1 = d.sum(-1) + c2 + det3x3(Du)
        F = Du + torch.eye(3, dtype=Du.dtype, device=Du.device)
        return self._piola(F, 1.0 + Jm1, Jm1)

    def energy_density(self, F: torch.Tensor) -> torch.Tensor:
        """W = mu10 (I1bar - 3) + mu01 (I2bar - 3) + kappa/2 (J - 1)^2."""
        _, I1, I2 = _invariants(F)
        J = det3x3(F)
        Jm23 = cbrt(J).pow(-2.0)
        return (self.mu10 * (I1 * Jm23 - 3.0) + self.mu01 * (I2 * Jm23 * Jm23 - 3.0)
                + 0.5 * self.kappa * (J - 1.0) ** 2)

    def tangent_diag_block(self, F: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """3x3 block K[d, e] = A[d, J, e, L] h_J h_L through three forward
        derivatives of `first_piola`: column e is (dP/dF : (e_e (x) h)) h.
        F (..., 3, 3) is broadcast to h's batch shape (..., 3) first (the
        JAX package's `jax.jvp` refuses a broadcast F, so its
        `precond_blocks` raises for this material)."""
        F = F.expand(*h.shape[:-1], 3, 3).contiguous()
        eye = torch.eye(3, dtype=F.dtype, device=F.device)
        cols = []
        for e in range(3):
            dF = eye[e][:, None] * h[..., None, :]  # e_e (x) h
            _, dP = torch.func.jvp(self.first_piola, (F,), (dF,))
            cols.append(torch.einsum("...dl,...l->...d", dP, h))
        return torch.stack(cols, dim=-1)
