"""St. Venant-Kirchhoff hyperelastic material with Kelvin-Voigt damping
(port of `tlfea/materials/svk.py`).

P(F) = F S with S = lam tr(E) I + 2 mu E, E = (F^T F - I)/2, evaluated
strain-safe from the displacement gradient Du = F - I. The CUDA form of the
same algebra is `tlfea_torch/csrc/svk.cuh`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SVK", "lame_from_E_nu"]


def lame_from_E_nu(E: float, nu: float) -> tuple[float, float]:
    """Lame parameters (lambda, mu) from Young's modulus and Poisson ratio."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


@dataclass(frozen=True)
class SVK:
    """SVK parameters as Python floats; eta_damp and lam_damp are the
    Kelvin-Voigt viscosities (zero disables damping)."""

    lam: float
    mu: float
    eta_damp: float = 0.0
    lam_damp: float = 0.0

    @property
    def damped(self) -> bool:
        return self.eta_damp != 0.0 or self.lam_damp != 0.0

    def first_piola_du(self, Du: torch.Tensor) -> torch.Tensor:
        """Elastic P from Du = F - I, shape (..., 3, 3).

        E = (Du + Du^T + Du^T Du)/2 is formed without F^T F, so small strains
        lose no digits to cancellation in float32."""
        DtD = torch.einsum("...ki,...kj->...ij", Du, Du)
        E = 0.5 * (Du + Du.transpose(-1, -2) + DtD)
        trE = E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2]
        eye = torch.eye(3, dtype=Du.dtype, device=Du.device)
        S = 2.0 * self.mu * E + (self.lam * trE)[..., None, None] * eye
        return S + torch.einsum("...ik,...kj->...ij", Du, S)

    def energy_density(self, F: torch.Tensor) -> torch.Tensor:
        """W(F) = lam/2 tr(E)^2 + mu E:E, E = (F^T F - I)/2."""
        eye = torch.eye(3, dtype=F.dtype, device=F.device)
        E = 0.5 * (torch.einsum("...ki,...kj->...ij", F, F) - eye)
        trE = E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2]
        return 0.5 * self.lam * trE ** 2 + self.mu * (E * E).sum((-2, -1))

    def tangent_diag_block(self, F: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Closed-form 3x3 block K[d,e] = A[d,J,e,L] h_J h_L for one node.

        F: (..., 3, 3), h: (..., 3) shape-function gradient -> (..., 3, 3)."""
        Fh = torch.einsum("...ij,...j->...i", F, h)
        hij = (h * h).sum(-1)
        trE = 0.5 * ((F * F).sum((-2, -1)) - 3.0)
        FhFh = (Fh * Fh).sum(-1)
        FFT = torch.einsum("...ik,...jk->...ij", F, F)
        eye = torch.eye(3, dtype=F.dtype, device=F.device)
        outer = torch.einsum("...d,...e->...de", Fh, Fh)
        return (
            self.lam * outer
            + (self.lam * trE * hij)[..., None, None] * eye
            + (self.mu * FhFh)[..., None, None] * eye
            + self.mu * outer
            + self.mu * hij[..., None, None] * FFT
            - (self.mu * hij)[..., None, None] * eye
        )
