"""ANCF3243 cantilever beam sag with a unified 4-solver front end (port of
`examples/beam_sag_ancf3243.py`).

Workload parity with the reference's `lib_bin/beam_sag/test_ancf3243.cc`:
30-element beam, first node's 4 coefficient vectors fixed, constant tip
force, SVK E=7e8 nu=0.33 rho=2700, CSV tip-z history + periodic VTU export.

Run: python -m tlfea_torch.examples.beam_sag_ancf3243 --solver=newton --steps=100
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import ancf3243
from tlfea_torch.examples._common import (
    add_device_options, device_dtype, make_solver, out_dir, tip_coef_3243,
)
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.cli import Cli


def main(argv=None):
    """Run the script; returns (Simulation, [(t, tip_z)])."""
    args = add_device_options(
        Cli("ANCF3243 beam sag (reference: lib_bin/beam_sag/test_ancf3243.cc)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("n_elem", 30, "number of beam elements")
        .add("steps", 100, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("tip_force", 3100.0, "tip load in -z [N]")
        .add("E", 7e8, "Young's modulus")
        .add("nu", 0.33, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e5, "Kelvin-Voigt eta = lambda damping")
        .add("rho_alm", 1e9, "ALM penalty")
        .add("L", 2.0, "element length")
        .add("W", 1.0, "section width")
        .add("H", 1.0, "section height")
        .add("vtk_every", 20, "VTU export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    coefs, conn = ancf3243.straight_beam(args["n_elem"], L=args["L"])
    elems = ancf3243.build(coefs, conn, args["L"], args["W"], args["H"], rho=args["rho0"],
                           dtype=dtype, device=device)
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])

    # Fix all 4 coefficient vectors of node 0 (reference: 4 fixed coefs).
    x0 = torch.as_tensor(coefs, dtype=dtype, device=device)
    cons = FixedCoefs.from_indices(np.arange(4), x0)
    system = System(elems=elems, material=mat, constraints=cons)
    state = StepState.rest(system, x0)

    tip = tip_coef_3243(args["n_elem"])
    f_ext = torch.zeros_like(state.x)
    f_ext[tip, 2] = -args["tip_force"]

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=f_ext)

    d = out_dir("beam_sag_ancf3243")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        diag = sim.step()
        tip_z = float(sim.state.x[tip, 2])
        hist.append((k * args["dt"], tip_z))
        if k % 10 == 0:
            print(f"step {k:4d} tip_z={tip_z:+.6f} |c|={float(diag['norm_c']):.2e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_ancf_hex(
                os.path.join(d, f"beam_{k:05d}.vtu"),
                sim.state.x.cpu().numpy(), conn, args["L"], args["W"], args["H"], "3243",
            )
    dt_wall = time.time() - t0
    io_vtk.write_csv_history(os.path.join(d, f"tip_z_{args['solver']}.csv"), ["t", "tip_z"], hist)
    print(f"{args['steps']} steps in {dt_wall:.1f}s ({args['steps']/dt_wall:.2f} steps/s)")
    print(f"final tip_z = {hist[-1][1]:+.6f}; outputs in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
