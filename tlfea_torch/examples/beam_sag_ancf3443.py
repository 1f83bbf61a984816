"""ANCF3443 shell cantilever chain sag with the unified 4-solver front end
(port of `examples/beam_sag_ancf3443.py`).

Workload parity: reference `lib_bin/beam_sag/test_ancf3443.cc` (shell chain
clamped at one edge, tip loads on the far-edge nodes found from
connectivity, `test_ancf3443.cc:269-315`).

Run: python -m tlfea_torch.examples.beam_sag_ancf3443 --solver=newton --steps=50
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import ancf3443
from tlfea_torch.examples._common import add_device_options, device_dtype, make_solver, out_dir
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.cli import Cli


def main(argv=None):
    """Run the script; returns (Simulation, [(t, tip_z)])."""
    args = add_device_options(
        Cli("ANCF3443 shell sag (reference: lib_bin/beam_sag/test_ancf3443.cc)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("n_elem", 10, "number of shell elements in the chain")
        .add("steps", 50, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("tip_force", 500.0, "total tip load in -z [N]")
        .add("E", 7e8, "Young's modulus")
        .add("nu", 0.33, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e5, "Kelvin-Voigt damping")
        .add("rho_alm", 1e9, "ALM penalty")
        .add("L", 1.0, "element length")
        .add("W", 1.0, "element width")
        .add("H", 0.1, "shell thickness")
        .add("vtk_every", 20, "VTU export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    coefs, conn = ancf3443.shell_strip(args["n_elem"], L=args["L"], W=args["W"])
    elems = ancf3443.build(coefs, conn, args["L"], args["W"], args["H"], rho=args["rho0"],
                           dtype=dtype, device=device)
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])

    # Clamp the first column's two nodes (all 4 coefficient vectors each).
    clamp_nodes = [0, 1]
    fixed_coefs = np.concatenate([4 * np.asarray(clamp_nodes) + k for k in range(4)])
    x0 = torch.as_tensor(coefs, dtype=dtype, device=device)
    cons = FixedCoefs.from_indices(np.sort(fixed_coefs), x0)
    system = System(elems=elems, material=mat, constraints=cons)
    state = StepState.rest(system, x0)

    # Tip nodes = far edge found from connectivity (last element's n1/n2).
    tip_nodes = [int(conn[-1][1]), int(conn[-1][2])]
    f_ext = torch.zeros_like(state.x)
    for n in tip_nodes:
        f_ext[4 * n, 2] += -args["tip_force"] / len(tip_nodes)

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=f_ext)

    d = out_dir("beam_sag_ancf3443")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        diag = sim.step()
        tip_z = float(sim.state.x[4 * tip_nodes[0], 2])
        hist.append((k * args["dt"], tip_z))
        if k % 10 == 0:
            print(f"step {k:4d} tip_z={tip_z:+.6f} |c|={float(diag['norm_c']):.2e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_ancf_hex(
                os.path.join(d, f"shell_{k:05d}.vtu"),
                sim.state.x.cpu().numpy(), conn, args["L"], args["W"], args["H"], "3443",
            )
    wall = time.time() - t0
    io_vtk.write_csv_history(os.path.join(d, f"tip_z_{args['solver']}.csv"), ["t", "tip_z"], hist)
    print(f"{args['steps']} steps in {wall:.1f}s; final tip_z = {hist[-1][1]:+.6f}; out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
