"""Build the port's objects from the JAX package's.

`from_numpy_system` reads the fields of a `tlfea` `ElementBatch`, `SVK` or
`MooneyRivlin`, `FixedCoefs`, `DensePins` or `LinearConstraints`,
`StepState` and solver parameters (`NewtonParams`,
`AdamWParams`, `NesterovParams`, `VBDParams`) through `np.asarray` (duck
typed: any object with those attribute names will do, so this module never
imports jax or tlfea) and returns the matching `tlfea_torch` objects on the
given device and dtype; `from_numpy_collision` does the same for the
collision state (`HydroelasticParams`, `DemParams`, `SphereCloud`). The
collision setups themselves are built in each package from the same NumPy
arrays. The parity tests use it to run both packages on the same problem.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np
import torch

from tlfea_torch.collision.dem import DemParams, SphereCloud
from tlfea_torch.collision.hydroelastic import HydroelasticParams
from tlfea_torch.constraints import DensePins, FixedCoefs, LinearConstraints
from tlfea_torch.elements.assembly import ElementBatch
from tlfea_torch.materials.mooney_rivlin import MooneyRivlin
from tlfea_torch.materials.svk import SVK
from tlfea_torch.solvers.adamw import AdamWParams
from tlfea_torch.solvers.common import StepState, System
from tlfea_torch.solvers.nesterov import NesterovParams
from tlfea_torch.solvers.newton import NewtonParams
from tlfea_torch.solvers.vbd import VBDParams

__all__ = ["from_numpy_system", "from_numpy_collision"]

# A field only one solver's parameters have -> that solver's parameters.
_PARAM_KINDS = (("lr", AdamWParams), ("alpha", NesterovParams), ("omega", VBDParams),
                ("cg_rtol", NewtonParams))
# A material's dataclass fields -> the port's material.
_MATERIAL_KINDS = (({"mu10", "mu01", "kappa", "eta_damp", "lam_damp"}, MooneyRivlin),
                   ({"lam", "mu", "eta_damp", "lam_damp"}, SVK))

# A constraint family's dataclass fields -> the port's family.
_CONSTRAINT_KINDS = (({"idx", "target"}, FixedCoefs), ({"mask", "target"}, DensePins),
                     ({"rows", "cols", "vals", "b", "n_rows"}, LinearConstraints))


def _scalar(a) -> float:
    return float(np.asarray(a))


def _material(material):
    """The port's SVK or MooneyRivlin with the same fields, told apart by
    the material's dataclass fields (mu10 ... means Mooney-Rivlin: its
    small-strain `lam` and `mu` properties must not make it an SVK). Raises
    on any other material."""
    names = {f.name for f in fields(material)} if is_dataclass(material) else set()
    for keys, cls in _MATERIAL_KINDS:
        if names == keys:
            return cls(**{f.name: _scalar(getattr(material, f.name)) for f in fields(cls)})
    raise TypeError(f"no counterpart in the port for material {type(material).__name__} "
                    f"(fields {sorted(names)}); it has SVK and MooneyRivlin")


def _constraints(constraints, t, idx):
    """The port's FixedCoefs, DensePins or LinearConstraints with the same
    fields, told apart by the object's dataclass fields (index arrays through
    idx, floating ones through t, n_rows as an int). Raises on any other
    constraints object."""
    names = {f.name for f in fields(constraints)} if is_dataclass(constraints) else set()
    for keys, cls in _CONSTRAINT_KINDS:
        if names == keys:
            conv = {"idx": idx, "rows": idx, "cols": idx, "n_rows": int}
            return cls(**{k: conv.get(k, t)(getattr(constraints, k)) for k in sorted(keys)})
    raise TypeError(f"no counterpart in the port for constraints {type(constraints).__name__} "
                    f"(fields {sorted(names)}); it has FixedCoefs, DensePins and "
                    f"LinearConstraints")


def from_numpy_system(elems, material, constraints=None, state=None, params=None, *,
                      device="cuda", dtype=torch.float64, accum_dtype=None):
    """(System, StepState or None, solver parameters or None) from the JAX
    package's objects, on `device` (pass device="cpu" to stay on the host).
    Floating arrays are cast to `dtype`, index arrays to int64, except a
    float64 `state.u`, which stays float64 (the accuracy mode's wide
    displacement); accum_dtype, the JAX `System.accum_dtype` ("float64",
    a torch dtype or None), becomes the port's. The
    parameters (Newton, AdamW, Nesterov or VBD, told apart by their
    fields) become the port's dataclass of Python numbers, and the material
    the port's SVK or MooneyRivlin (`_material`), the constraints the
    port's family of the same fields (`_constraints`). Raises on what the
    port does not carry: another material or constraints object, a non-zero
    `max_dv`, or a batch without x_ref."""

    def t(a, keep_f64=False):
        a = np.array(a)
        wide = keep_f64 and a.dtype == np.float64
        return torch.as_tensor(a, device=device).to(torch.float64 if wide else dtype)

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
    mat = _material(material)
    cons = None if constraints is None else _constraints(constraints, t, idx)
    if isinstance(accum_dtype, str):
        accum_dtype = getattr(torch, accum_dtype)
    system = System(elems=eb, material=mat, constraints=cons, accum_dtype=accum_dtype)

    st = None
    if state is not None:
        x = t(state.x)
        st = StepState(
            x=x, v=t(state.v), lam=t(state.lam),
            u=x - eb.x_ref if state.u is None else t(state.u, keep_f64=True),
            dv=torch.zeros_like(x) if state.dv is None else t(state.dv),
        )

    prm = None
    if params is not None:
        cls = next((c for attr, c in _PARAM_KINDS if hasattr(params, attr)), None)
        if cls is None:
            raise TypeError(f"unknown solver parameters {type(params).__name__}")
        if cls is NewtonParams and _scalar(params.max_dv) != 0.0:
            raise ValueError("max_dv is not ported; use the ls_max safeguard")
        prm = cls(**{f.name: int(getattr(params, f.name)) if f.type == "int"
                     else _scalar(getattr(params, f.name)) for f in fields(cls)})
    return system, st, prm


# A collision object's dataclass fields -> the port's class, and whether its
# fields are tensors (else Python floats).
_COLLISION_KINDS = (({"damping", "friction"}, HydroelasticParams, False),
                    ({"kn", "cn", "mu", "v_reg"}, DemParams, False),
                    ({"x", "v", "r", "m"}, SphereCloud, True))


def from_numpy_collision(obj, *, device="cuda", dtype=torch.float64):
    """The port's HydroelasticParams, DemParams (fields as floats) or
    SphereCloud (tensors in `dtype` on `device`) with the fields of the
    JAX package's object, told apart by its dataclass fields. Raises on any
    other object."""
    names = {f.name for f in fields(obj)} if is_dataclass(obj) else set()
    for keys, cls, tensors in _COLLISION_KINDS:
        if names == keys:
            conv = ((lambda a: torch.as_tensor(np.array(a), device=device).to(dtype))
                    if tensors else _scalar)
            return cls(**{k: conv(getattr(obj, k)) for k in sorted(keys)})
    raise TypeError(f"no counterpart in the port for {type(obj).__name__} (fields "
                    f"{sorted(names)}); it has HydroelasticParams, DemParams and SphereCloud")
