"""T10 beam convergence/validation study across mesh resolutions (port of
`examples/feat10_resolution_study.py`).

Workload parity: reference `lib_bin/beam_sag/test_feat10_resolution.cc`
(beam_3x2x1 at res in {0,2,4,8,16}, target-node x-history CSVs for
comparison against the FEniCSx backward-Euler ground truth,
`test-scripts/validation/fenics/beam_dynamic_backward_euler.py`). The
TetGen meshes `meshes/T10/resolution/beam_3x2x1_res{r}.1.node/.ele` are read
under `TLFEA_REF_DATA`; a resolution whose mesh is absent is skipped, as in
the JAX script.

Run: python -m tlfea_torch.examples.feat10_resolution_study --res=0,2,4 --steps=50
"""

import os

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
from tlfea_torch.utils.tetmesh import read_tetgen


def main(argv=None):
    """Run the script; returns (the last resolution's Simulation or None,
    {res: [(t, x, y, z)] of the tracked node})."""
    args = add_device_options(
        Cli("T10 beam resolution study (reference: test_feat10_resolution.cc)")
        .add("res", "0,2,4", "comma-separated resolutions {0,2,4,8,16}")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 50, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 1e7, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e3, "Kelvin-Voigt damping")
        .add("rho_alm", 1e9, "ALM penalty")
    ).parse(argv)
    device, dtype = device_dtype(args)

    d = out_dir("feat10_resolution")
    sim, hists = None, {}
    for res in [int(r) for r in args["res"].split(",")]:
        node = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.node")
        ele = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.ele")
        if not (REF_DATA and os.path.exists(node)):
            print(f"res {res}: mesh not found, skipping")
            continue
        nodes, conn = read_tetgen(node, ele)
        print(f"res {res}: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

        elems = feat10.build(nodes, conn, rho=args["rho0"], dtype=dtype, device="cpu")
        lam, mu = lame_from_E_nu(args["E"], args["nu"])
        mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
        fixed = np.nonzero(nodes[:, 0] < nodes[:, 0].min() + 1e-9)[0]
        x0 = torch.as_tensor(nodes, dtype=dtype)
        system = System(elems=elems, material=mat,
                        constraints=FixedCoefs.from_indices(fixed, x0))
        system = accelerate(system, device)  # the kernels on the card
        state = StepState.rest(system, x0.to(device))
        step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
        sim = Simulation(system, state, step, base_f_ext=gravity_force(system))

        # Track the node closest to the beam tip center (the reference tracks
        # a fixed target point, `test_feat10_resolution.cc:246-253`).
        target = np.array([nodes[:, 0].max(), 1.0, 0.5])
        track = int(np.argmin(np.linalg.norm(nodes - target, axis=1)))

        hist = []
        for k in range(args["steps"]):
            sim.step()
            p = sim.state.x[track].tolist()
            hist.append((k * args["dt"], p[0], p[1], p[2]))
        io_vtk.write_csv_history(os.path.join(d, f"track_res{res}.csv"), ["t", "x", "y", "z"],
                                 hist)
        hists[res] = hist
        print(f"  final track position: {hist[-1][1:]} -> {d}/track_res{res}.csv")
    return sim, hists


if __name__ == "__main__":
    main()
