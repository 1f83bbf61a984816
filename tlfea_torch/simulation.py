"""Simulation driver: a time-step solver coupled with collision and
external forces, plus checkpoint and resume (port of `tlfea/simulation.py`).

`save_state` writes the JAX package's NumPy `.npz` keys (x, v, lam, u, dv,
step_count), so a checkpoint written by either package loads in the other.
A `collision` object (`tlfea_torch.collision`: `HydroelasticCollision`,
`NodeSphereDem`, `GranularDem`, `DemMeshCollision`) is called as the JAX
`Simulation` calls it, `.step(x, v, params) -> (f_col, patches, overflow)`, at
the start-of-step state; its overflow flag stays on the device and is read
one step late, and an overflow regrows the capacity (`.grow()`).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import numpy as np
import torch

from tlfea_torch.constraints import DensePins
from tlfea_torch.elements.assembly import lumped_mass, node_ref
from tlfea_torch.solvers.common import StepState, System

__all__ = ["Simulation", "gravity_force"]


def gravity_force(system: System, g=(0.0, 0.0, -9.81)) -> torch.Tensor:
    """Lumped gravity load (n_coef, 3) of the whole system."""
    m = lumped_mass(system.elems)
    return m[:, None] * torch.as_tensor(g, dtype=m.dtype, device=m.device)[None, :]


class Simulation:
    """Composable stepping loop.

    solver_step: callable (system, state, f_ext) -> (state, diag), e.g.
      `newton.stepper(params)` or `vbd.stepper(params, structures)`; the
      system passes per call, so retargeted constraints and changed pins
      take effect at the next step.
    collision: optional object with `.step(x, v, params) -> (f_col,
      patches, overflow)`.
    """

    def __init__(self, system: System, state: StepState, solver_step: Callable,
                 base_f_ext: torch.Tensor | None = None, collision: Any = None,
                 collision_params: Any = None):
        self.system = system
        self.state = state
        self.solver_step = solver_step
        x = state.x
        self.base_f_ext = (torch.zeros((system.n_coef, 3), dtype=x.dtype, device=x.device)
                           if base_f_ext is None else torch.as_tensor(base_f_ext))
        self.collision = collision
        self.collision_params = collision_params
        self.step_count = 0
        self.last_patches = None
        self.last_diag: dict = {}
        # The collision-capacity check is deferred by one step, so the host
        # never waits on the device for the flag; on overflow the capacity
        # is regrown (collision.grow()) and the overflowed step is logged.
        self._pending_overflow = None
        self.overflow_events = 0

    def _check_overflow(self) -> None:
        if self._pending_overflow is None:
            return
        flag, step_no = self._pending_overflow
        self._pending_overflow = None
        if not bool(flag):
            return
        self.overflow_events += 1
        if hasattr(self.collision, "grow"):
            self.collision = self.collision.grow()
            warnings.warn(
                f"collision capacity overflow at step {step_no} (candidate pairs exceeded the "
                "broadphase window or max_pairs); capacity regrown automatically — that step "
                "ran with dropped pairs", stacklevel=3)
        else:
            raise RuntimeError(f"collision capacity overflow at step {step_no} — increase "
                               "the collision window or max_pairs")

    def step(self) -> dict:
        f_ext = self.base_f_ext
        overflow = None
        if self.collision is not None:
            self._check_overflow()
            f_col, patches, overflow = self.collision.step(self.state.x, self.state.v,
                                                           self.collision_params)
            f_ext = f_ext + f_col
            self.last_patches = patches
            self._pending_overflow = (overflow, self.step_count)
        self.state, diag = self.solver_step(self.system, self.state, f_ext)
        if overflow is not None:
            diag["collision_overflow"] = overflow  # a device flag: no host sync here
        self.step_count += 1
        self.last_diag = diag
        return diag

    def run(self, n_steps: int, callback: Callable | None = None) -> StepState:
        for k in range(n_steps):
            diag = self.step()
            if callback is not None:
                callback(self, k, diag)
        return self.state

    # -- state injection (the reference's UpdatePositions /
    # UpdateConstraintTargets) ------------------------------------------------
    def set_positions(self, x) -> None:
        """Move the coefficients to x; the displacements are derived from it
        (as the JAX solvers derive them from a state whose u is None) and
        the next step starts without a warm-start increment."""
        x = torch.as_tensor(x, dtype=self.state.x.dtype, device=self.state.x.device)
        u = (x - node_ref(self.system.elems)).to(self.state.u.dtype)
        self.state = StepState(x=x, v=self.state.v, lam=self.state.lam, u=u,
                               dv=torch.zeros_like(self.state.v))

    def set_constraint_targets(self, target) -> None:
        cons = self.system.constraints
        if cons is None or not hasattr(cons, "with_targets"):
            raise ValueError("system has no retargetable constraints")
        target = torch.as_tensor(target, device=self.state.x.device)
        self.system = self.system.replace(constraints=cons.with_targets(target))

    def set_pinned(self, idx, pinned: bool = True) -> None:
        """Change which coefficients are pinned mid-run (the reference's
        UpdateNodalFixed). Needs `DensePins`; newly pinned coefficients hold
        their current positions, and the duals of `idx` are zeroed so that
        stale multipliers do not kick them."""
        cons = self.system.constraints
        if not isinstance(cons, DensePins):
            raise ValueError("set_pinned requires DensePins constraints (FixedCoefs has static "
                             "membership — rebuild the system, or use DensePins.from_indices)")
        self.system = self.system.replace(constraints=cons.pinning(idx, pinned,
                                                                   x0=self.state.x))
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.state.lam.device)
        self.state = self.state.replace(lam=self.state.lam.index_fill(0, idx, 0.0))

    # -- checkpoint / resume ---------------------------------------------------
    def save_state(self, path: str) -> None:
        st = self.state
        np.savez(path, x=st.x.cpu().numpy(), v=st.v.cpu().numpy(), lam=st.lam.cpu().numpy(),
                 step_count=self.step_count, u=st.u.cpu().numpy(), dv=st.dv.cpu().numpy())

    def load_state(self, path: str) -> None:
        """Resume from a checkpoint of either package; a JAX checkpoint
        without u or dv gets u = x - x_ref and dv = 0, what its solvers
        take for None."""
        data = np.load(path)
        dev = self.state.x.device

        def t(key):
            return torch.as_tensor(data[key], device=dev)

        x = t("x")
        self.state = StepState(
            x=x, v=t("v"), lam=t("lam"),
            u=t("u") if "u" in data else x - node_ref(self.system.elems).to(x.dtype),
            dv=t("dv") if "dv" in data else torch.zeros_like(x))
        self.step_count = int(data["step_count"])
