"""Shared helpers of the example scripts (port of `examples/_common.py`):
solver construction from CLI arguments, output directories, the device and
dtype options."""

from __future__ import annotations

import os
from dataclasses import fields, replace

import torch

from tlfea_torch.elements.assembly import node_ref
from tlfea_torch.solvers import adamw, nesterov, newton, suggest_rho, vbd
from tlfea_torch.solvers.coarse import build_coarse_precond
from tlfea_torch.solvers.common import System

# A directory laid out as the reference's `data/` (TetGen meshes under
# meshes/T10/); unset, the scripts take their fallback meshes, as the JAX
# scripts do where the reference data is absent.
REF_DATA = os.environ.get("TLFEA_REF_DATA", "")
BIG = 50_000  # nodes above which the coarse correction takes its large-mesh form


def add_device_options(cli):
    """The options every port script adds to the JAX script's."""
    return (cli.add("device", "cuda", "torch device (cuda | cpu)")
            .add("dtype", "float32", "float32 | float64"))


def device_dtype(args) -> tuple[torch.device, torch.dtype]:
    dtype = {"float32": torch.float32, "float64": torch.float64}.get(args["dtype"])
    if dtype is None:
        raise SystemExit(f"unknown dtype {args['dtype']!r} (float32|float64)")
    return torch.device(args["device"]), dtype


def _moved(obj, device):
    """A dataclass copy with its tensor fields on `device`."""
    return replace(obj, **{f.name: getattr(obj, f.name).to(device) for f in fields(obj)
                           if isinstance(getattr(obj, f.name), torch.Tensor)})


def accelerate(system: System, device) -> System:
    """The system on `device`: the port picks each kernel or its plain twin
    by the device of its tensors, so this is all the JAX script's
    `accelerate` (routing through the Pallas kernels) becomes."""
    device = torch.device(device)
    if system.elems.conn.device == device:
        return system
    cons = None if system.constraints is None else _moved(system.constraints, device)
    return System(elems=system.elems.to(device), material=system.material, constraints=cons,
                  plain=system.plain, accum_dtype=system.accum_dtype)


def coarse_options(n_nodes: int) -> dict:
    """The coarse correction's production form (bench.py): above BIG nodes
    the bfloat16 apply tables, the range flag and 1,024 aggregates; else the
    dense full-precision form with 512."""
    big = n_nodes > BIG
    return dict(ranges=big, max_agg=1024 if big else 512,
                mm_dtype="bfloat16" if big else None)


def _auto_coarse(system: System, dt, rho):
    """The frozen two-level coarse correction at the rest configuration
    (`examples/_common.py:46-62`). None for a material without the
    small-strain moduli the build reads (`lam`, `mu`: SVK's, and
    Mooney-Rivlin's equivalents), where the JAX build fails; any other
    failure raises."""
    mat = system.material
    if not (hasattr(mat, "lam") and hasattr(mat, "mu")):
        return None
    x0 = node_ref(system.elems)
    return build_coarse_precond(system, x0, float(dt), float(rho),
                                **coarse_options(x0.shape[0]))


def make_solver(name: str, system: System, dt: float, rho: float | None):
    """Per-solver parameter sets of the reference's unified beam-sag program
    (`examples/_common.py:65-108`). rho=None derives the ALM penalty from
    the problem stiffness (`suggest_rho`)."""
    if rho is None:
        rho = suggest_rho(system.elems, system.material, dt)
    if name == "newton":
        # One outer per step, the duals carried across steps; inner_rtol
        # carries the convergence, with Eisenstat-Walker forcing and the
        # frozen coarse correction.
        params = newton.NewtonParams(
            dt=dt, rho=rho, inner_atol=1e-7, inner_rtol=1e-4, outer_tol=0.0,
            max_outer=1, max_inner=6, cg_rtol=1e-3, cg_max_iter=50,
        )
        return newton.stepper(params, coarse=_auto_coarse(system, dt, rho))
    if name == "nesterov":
        params = nesterov.NesterovParams(
            dt=dt, rho=rho, alpha=1e-7, inner_tol=1e-9, outer_tol=1e-8,
            max_outer=3, max_inner=20000,
        )
        return nesterov.stepper(params)
    if name == "adamw":
        params = adamw.AdamWParams(
            dt=dt, rho=rho, lr=1e-3, inner_tol=1e-8, inner_rtol=1e-8,
            outer_tol=1e-8, max_outer=3, max_inner=20000,
            convergence_check_interval=50,
        )
        return adamw.stepper(params)
    if name == "vbd":
        params = vbd.VBDParams(
            dt=dt, rho=rho, omega=1.0, inner_tol=1e-7, outer_tol=1e-8,
            max_outer=3, max_sweeps=200, convergence_check_interval=8,
        )
        structures = vbd.prepare(system, group_size=params.color_group_size)
        return vbd.stepper(params, structures)
    raise SystemExit(f"unknown solver {name!r} (newton|nesterov|adamw|vbd)")


def out_dir(name: str) -> str:
    d = os.path.join("out", name)
    os.makedirs(d, exist_ok=True)
    return d


def tip_coef_3243(n_elem: int) -> int:
    """Position-coefficient index of the last beam node."""
    return 4 * n_elem  # node (n_elem), slot 0
