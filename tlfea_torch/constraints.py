"""Constraint families of the augmented-Lagrangian stepper (port of
`tlfea/constraints.py`).

- `FixedCoefs`: pin coefficients `idx` to target positions; c = x[idx] -
  target, three rows per pinned coefficient. J is an identity selection,
  so J and J^T never materialise.
- `DensePins`: the same pins as dense per-coefficient fields, a mask (n, 1)
  and targets (n, 3); J = diag(mask), so all its algebra is elementwise and
  changing which coefficients are pinned, or where, changes data only.
- `LinearConstraints`: general sparse linear rows over the flattened DOFs,
  c_r = sum_k J[r, k] x_flat[k] - b_r, in COO arrays (built on the host by
  `LinearConstraintBuilder`).

Each exposes `eval_c`, `eval_c_u`, `apply_jt`, `jtj_diag` and
`n_constraints`, so the solvers are agnostic to the family. Every scatter
sums in a fixed order (`index_put` with accumulate, which sorts the indices
on the card; never `index_add_`, which sums with atomics there) and is
out of place, so `torch.func.jvp` and `torch.func.linearize` see through it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["FixedCoefs", "DensePins", "LinearConstraints", "LinearConstraintBuilder",
           "no_constraints"]


def _scatter_sum(n: int, idx: torch.Tensor, vals: torch.Tensor, dtype) -> torch.Tensor:
    """out[i] = sum of vals[k] over idx[k] == i, out (n, *vals.shape[1:]) in
    `dtype`, summed in a fixed order and out of place."""
    out = torch.zeros((n, *vals.shape[1:]), dtype=dtype, device=vals.device)
    return out.index_put((idx,), vals.to(dtype), accumulate=True)


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

    @property
    def n_constraints(self) -> int:
        return 3 * self.idx.shape[0]

    def eval_c(self, x: torch.Tensor) -> torch.Tensor:
        """Constraint values, shape (C, 3)."""
        return x[self.idx] - self.target

    def eval_c_u(self, u: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        """c from displacements u = x - x_ref, grouped as u[idx] - (target -
        x_ref[idx]): the bracket is displacement-scale, so float32 never
        rounds the small increments inside u against coordinates."""
        return u[self.idx] - (self.target - x_ref[self.idx])

    def apply_jt(self, y: torch.Tensor, n_coef: int) -> torch.Tensor:
        """J^T y for y of shape (C, 3) -> (n_coef, 3)."""
        return _scatter_sum(n_coef, self.idx, y, y.dtype)

    def jtj_diag(self, n_coef: int, dtype) -> torch.Tensor:
        """diag(J^T J) over coefficients -> (n_coef,) of {0, 1}."""
        return _scatter_sum(n_coef, self.idx, torch.ones_like(self.idx, dtype=dtype), dtype)

    def with_targets(self, target) -> "FixedCoefs":
        """Prescribe new target positions (C, 3)."""
        return FixedCoefs(idx=self.idx, target=torch.as_tensor(target, device=self.idx.device))


@dataclass
class DensePins:
    """Pins as dense per-coefficient fields: `mask` (n, 1) in {0, 1} selects
    the pinned coefficients, `target` (n, 3) their positions (inert where
    mask = 0). J = diag(mask): no gather or scatter anywhere, and which
    coefficients are pinned (`with_mask`, `pinning`) or where
    (`with_targets`) is data of fixed shape. The duals are dense too:
    StepState.lam is (n, 3), zero and staying zero at unpinned
    coefficients (c is masked)."""

    mask: torch.Tensor
    target: torch.Tensor

    @staticmethod
    def from_indices(idx, x0: torch.Tensor) -> "DensePins":
        """Pin coefficients `idx` at their current positions in x0."""
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=x0.device)
        mask = torch.zeros((x0.shape[0], 1), dtype=x0.dtype, device=x0.device)
        return DensePins(mask=mask.index_fill(0, idx, 1.0), target=x0.clone())

    @property
    def n_constraints(self) -> int:
        return 3 * self.mask.shape[0]

    def eval_c(self, x: torch.Tensor) -> torch.Tensor:
        """Masked constraint values, shape (n, 3)."""
        return self.mask * (x - self.target)

    def eval_c_u(self, u: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        """c from displacements, grouped for float32 as
        `FixedCoefs.eval_c_u` is."""
        return self.mask.to(u.dtype) * (u - (self.target - x_ref).to(u.dtype))

    def apply_jt(self, y: torch.Tensor, n_coef: int) -> torch.Tensor:
        """J^T y = mask * y."""
        return self.mask.to(y.dtype) * y

    def jtj_diag(self, n_coef: int, dtype) -> torch.Tensor:
        """diag(J^T J) over coefficients -> (n_coef,) of {0, 1}."""
        return self.mask[:, 0].to(dtype)

    def with_targets(self, target) -> "DensePins":
        """Prescribe new targets: a full (n, 3) field, inert at unpinned
        coefficients."""
        return DensePins(mask=self.mask, target=torch.as_tensor(target, device=self.mask.device))

    def with_mask(self, mask) -> "DensePins":
        """Replace the membership mask (n, 1)."""
        return DensePins(mask=torch.as_tensor(mask, device=self.mask.device), target=self.target)

    def pinning(self, idx, pinned: bool, x0=None) -> "DensePins":
        """Pin or release coefficients `idx`. Pinning with x0 given moves
        their targets to their positions in x0: newly pinned coefficients
        hold where they are."""
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.mask.device)
        mask = self.mask.index_fill(0, idx, 1.0 if pinned else 0.0)
        target = self.target
        if pinned and x0 is not None:
            x0 = torch.as_tensor(x0, device=target.device)
            target = target.index_copy(0, idx, x0[idx].to(target.dtype))
        return DensePins(mask=mask, target=target)


@dataclass
class LinearConstraints:
    """Sparse linear rows over the flattened DOFs, c = J x_flat - b. COO
    `rows`, `cols` (int64, cols index x.reshape(-1)), `vals` (nnz,), `b`
    (n_rows,)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    b: torch.Tensor
    n_rows: int

    @property
    def n_constraints(self) -> int:
        return self.n_rows

    def eval_c(self, x: torch.Tensor) -> torch.Tensor:
        """Constraint values, shape (n_rows,)."""
        return self._apply_j(x) - self.b

    def eval_c_u(self, u: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        """c from displacements, J u + (J x_ref - b): the constant part at
        coordinate scale once, the small increments in J u at full
        resolution."""
        return self._apply_j(u) + (self._apply_j(x_ref) - self.b)

    def _apply_j(self, x: torch.Tensor) -> torch.Tensor:
        """J x_flat -> (n_rows,) in x's dtype."""
        return _scatter_sum(self.n_rows, self.rows, self.vals * x.reshape(-1)[self.cols], x.dtype)

    def apply_jt(self, y: torch.Tensor, n_coef: int) -> torch.Tensor:
        """J^T y for y of shape (n_rows,) -> (n_coef, 3)."""
        return _scatter_sum(n_coef * 3, self.cols, self.vals * y[self.rows],
                            y.dtype).view(n_coef, 3)

    def jtj_diag(self, n_coef: int, dtype) -> torch.Tensor:
        """Per-DOF diag(J^T J) -> (n_coef, 3) (pins give (n_coef,))."""
        return _scatter_sum(n_coef * 3, self.cols, self.vals * self.vals, dtype).view(n_coef, 3)


class LinearConstraintBuilder:
    """Host-side accumulation of linear constraint rows (NumPy)."""

    def __init__(self):
        self._rows: list[int] = []
        self._cols: list[int] = []
        self._vals: list[float] = []
        self._b: list[float] = []
        self._n_rows = 0

    def add_row(self, cols, vals, rhs: float = 0.0) -> int:
        """Append the row sum_k vals[k] x_flat[cols[k]] = rhs; returns its index."""
        r = self._n_rows
        for c, v in zip(cols, vals):
            self._rows.append(r)
            self._cols.append(int(c))
            self._vals.append(float(v))
        self._b.append(float(rhs))
        self._n_rows += 1
        return r

    def fix_dof(self, coef: int, dof: int, value: float) -> int:
        """x[coef, dof] = value."""
        return self.add_row([coef * 3 + dof], [1.0], value)

    def equate_dofs(self, coef_a: int, coef_b: int) -> None:
        """Weld all 3 components of two coefficients together."""
        for d in range(3):
            self.add_row([coef_a * 3 + d, coef_b * 3 + d], [1.0, -1.0], 0.0)

    def build(self, dtype=torch.float64, device="cuda") -> LinearConstraints:
        """The rows as `LinearConstraints` on `device` (pass device="cpu" to
        stay on the host)."""

        def t(a, dt):
            return torch.as_tensor(np.asarray(a, dtype=np.float64 if dt.is_floating_point
                                              else np.int64), device=device).to(dt)

        return LinearConstraints(rows=t(self._rows, torch.int64), cols=t(self._cols, torch.int64),
                                 vals=t(self._vals, dtype), b=t(self._b, dtype),
                                 n_rows=self._n_rows)


def no_constraints() -> None:
    """Sentinel for unconstrained systems (Python None)."""
    return None
