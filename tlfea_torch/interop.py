"""Build the port's objects from the JAX package's.

`from_numpy_system` reads the fields of a `tlfea` `ElementBatch`, `SVK`,
`FixedCoefs`, `StepState` and `NewtonParams` through `np.asarray` (duck
typed: any object with those attribute names will do, so this module never
imports jax or tlfea) and returns the matching `tlfea_torch` objects on the
given device and dtype. The parity tests use it to run both packages on the
same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements.assembly import ElementBatch
from tlfea_torch.materials.svk import SVK
from tlfea_torch.solvers.common import StepState, System
from tlfea_torch.solvers.newton import NewtonParams

__all__ = ["from_numpy_system"]

_PARAM_FLOATS = ("dt", "rho", "inner_atol", "inner_rtol", "outer_tol", "cg_rtol",
                 "predict", "ew_eta_max")
_PARAM_INTS = ("max_outer", "max_inner", "cg_max_iter", "ls_max")


def _scalar(a) -> float:
    return float(np.asarray(a))


def from_numpy_system(elems, material, constraints=None, state=None, params=None, *,
                      device="cuda", dtype=torch.float64):
    """(System, StepState or None, NewtonParams or None) from the JAX
    package's objects, on `device` (pass device="cpu" to stay on the host).
    Floating arrays are cast to `dtype`, index arrays to int64;
    NewtonParams fields become Python numbers. Raises on what the
    port does not carry: a non-zero `max_dv`, or a batch without x_ref."""

    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    def idx(a):
        return torch.as_tensor(np.array(a, dtype=np.int64), device=device)

    if elems.x_ref is None:
        raise ValueError("element batch has no x_ref (node reference positions)")
    eb = ElementBatch(
        conn=idx(elems.conn), grad_N=t(elems.grad_N), dV=t(elems.dV),
        mass_elem=t(elems.mass_elem), xe_ref=t(elems.xe_ref),
        n_coef=int(elems.n_coef), x_ref=t(elems.x_ref),
        trans_mask=None if elems.trans_mask is None else tuple(elems.trans_mask),
    )
    mat = SVK(lam=_scalar(material.lam), mu=_scalar(material.mu),
              eta_damp=_scalar(material.eta_damp), lam_damp=_scalar(material.lam_damp))
    cons = None
    if constraints is not None:
        cons = FixedCoefs(idx=idx(constraints.idx), target=t(constraints.target))
    system = System(elems=eb, material=mat, constraints=cons)

    st = None
    if state is not None:
        x = t(state.x)
        st = StepState(
            x=x, v=t(state.v), lam=t(state.lam),
            u=x - eb.x_ref if state.u is None else t(state.u),
            dv=torch.zeros_like(x) if state.dv is None else t(state.dv),
        )

    prm = None
    if params is not None:
        if _scalar(params.max_dv) != 0.0:
            raise ValueError("max_dv is not ported; use the ls_max safeguard")
        prm = NewtonParams(**{k: _scalar(getattr(params, k)) for k in _PARAM_FLOATS},
                           **{k: int(getattr(params, k)) for k in _PARAM_INTS})
    return system, st, prm
