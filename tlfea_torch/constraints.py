"""Pin constraints for the augmented-Lagrangian stepper (port of
`FixedCoefs`, `tlfea/constraints.py:30`).

c = x[idx] - target, three rows per pinned node; J is an identity
selection, so J and J^T never materialise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["FixedCoefs"]


@dataclass
class FixedCoefs:
    """Pin coefficients `idx` (C,) int64 to `target` positions (C, 3)."""

    idx: torch.Tensor
    target: torch.Tensor

    @staticmethod
    def from_indices(idx, x0: torch.Tensor) -> "FixedCoefs":
        """Pin coefficients at their current positions in x0."""
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=x0.device)
        return FixedCoefs(idx=idx, target=x0[idx])

    def eval_c(self, x: torch.Tensor) -> torch.Tensor:
        """Constraint values, shape (C, 3)."""
        return x[self.idx] - self.target

    def eval_c_u(self, u: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        """c from displacements u = x - x_ref, grouped as u[idx] - (target -
        x_ref[idx]): the bracket is displacement-scale, so float32 never
        rounds the small increments inside u against coordinates."""
        return u[self.idx] - (self.target - x_ref[self.idx])

    def jtj_diag(self, n_coef: int, dtype) -> torch.Tensor:
        """diag(J^T J) over coefficients -> (n_coef,) of {0, 1}."""
        out = torch.zeros((n_coef,), dtype=dtype, device=self.idx.device)
        return out.index_put_((self.idx,), torch.ones_like(self.idx, dtype=dtype),
                              accumulate=True)
