"""Simulation diagnostics: energies and momentum (port of
`tlfea/diagnostics.py`).

Plain tensor reductions on the state's device, usable inside a stepping
loop or offline; `strain_energy` is differentiable by `torch.autograd`, and
its gradient in x is `assembly.internal_force` (tested).
"""

from __future__ import annotations

import torch

from tlfea_torch.elements.assembly import ElementBatch, deformation_gradient, mass_matvec

__all__ = ["kinetic_energy", "strain_energy", "linear_momentum", "energy_report"]


def kinetic_energy(v: torch.Tensor, elems: ElementBatch) -> torch.Tensor:
    """(1/2) v^T M v with the consistent mass."""
    return 0.5 * torch.sum(v * mass_matvec(v, elems))


def strain_energy(x: torch.Tensor, elems: ElementBatch, material) -> torch.Tensor:
    """Total strain energy sum_qp W(F) dV (`material.energy_density`)."""
    W = material.energy_density(deformation_gradient(x, elems))
    return torch.sum(W * elems.dV)


def linear_momentum(v: torch.Tensor, elems: ElementBatch) -> torch.Tensor:
    """Total linear momentum, M v summed over the coefficients -> (3,)."""
    return torch.sum(mass_matvec(v, elems), dim=0)


def energy_report(x, v, elems, material) -> dict:
    return {
        "kinetic": kinetic_energy(v, elems),
        "strain": strain_energy(x, elems, material),
        "momentum": linear_momentum(v, elems),
    }
