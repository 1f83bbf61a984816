"""T10 tetrahedral beam sag with the unified 4-solver front end (port of
`examples/beam_sag_feat10.py`).

Workload parity: reference `lib_bin/beam_sag/test_feat10_{nesterov,adamw}`
(plus Newton/VBD through the same front end). Uses the reference TetGen beam
meshes when `TLFEA_REF_DATA` points at them, otherwise the native
structured mesher (--res=16: 176,868 elements, 248,745 nodes, where
make_solver's coarse correction takes its bfloat16 form).

Run: python -m tlfea_torch.examples.beam_sag_feat10 --solver=adamw --steps=50
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import feat10
from tlfea_torch.examples._common import (
    REF_DATA, accelerate, add_device_options, device_dtype, make_solver, out_dir,
)
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation, gravity_force
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.cli import Cli
from tlfea_torch.utils.tetmesh import box_t10_mesh, read_tetgen


def load_mesh(res: int):
    node = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.node")
    ele = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.ele")
    if REF_DATA and os.path.exists(node):
        return read_tetgen(node, ele)
    return box_t10_mesh(3.0, 2.0, 1.0, 3 * (res + 1), 2 * (res + 1), res + 1)


def main(argv=None):
    """Run the script; returns (Simulation, [(t, tip_z)])."""
    args = add_device_options(
        Cli("T10 beam sag (reference: lib_bin/beam_sag/test_feat10_*)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("res", 0, "beam mesh resolution {0,2,4,8,16}")
        .add("steps", 50, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 5e6, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e3, "Kelvin-Voigt damping")
        .add("rho_alm", 1e9, "ALM penalty")
        .add("vtk_every", 20, "VTU export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    nodes, conn = load_mesh(args["res"])
    print(f"mesh: {conn.shape[0]} elems, {nodes.shape[0]} nodes")
    elems = feat10.build(nodes, conn, rho=args["rho0"], dtype=dtype, device="cpu")
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    fixed = np.nonzero(nodes[:, 0] < nodes[:, 0].min() + 1e-9)[0]
    x0 = torch.as_tensor(nodes, dtype=dtype)
    system = System(elems=elems, material=mat, constraints=FixedCoefs.from_indices(fixed, x0))
    system = accelerate(system, device)  # the kernels on the card
    state = StepState.rest(system, x0.to(device))
    f_ext = gravity_force(system)

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=f_ext)

    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    d = out_dir("beam_sag_feat10")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        sim.step()
        tz = float(sim.state.x[tip, 2])
        hist.append((k * args["dt"], tz))
        if k % 10 == 0:
            print(f"step {k:4d} tip_z={tz:+.6f}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            x = sim.state.x.cpu().numpy()
            io_vtk.write_vtu_t10(os.path.join(d, f"beam_{k:05d}.vtu"), x, conn,
                                 displacement=x - nodes)
    wall = time.time() - t0
    io_vtk.write_csv_history(
        os.path.join(d, f"tip_z_{args['solver']}_res{args['res']}.csv"), ["t", "tip_z"], hist
    )
    print(f"{args['steps']} steps in {wall:.1f}s ({args['steps']/wall:.2f} steps/s); out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
