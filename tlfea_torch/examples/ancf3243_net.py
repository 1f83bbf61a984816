"""ANCF3243 beam net with general linear (pinned-joint) constraints (port of
`examples/ancf3243_net.py`).

Workload parity: reference `lib_bin/mesh_deform/test_ancf3243_net_newton.cc`
(20x20 net from `.ancf3243mesh` with pinned or welded joints expressed as
general linear-CSR constraints, corner nodes fixed, gravity load). The mesh
is `--mesh`, by default the reference's net under `TLFEA_REF_DATA`.

Run: python -m tlfea_torch.examples.ancf3243_net --mesh=net.ancf3243mesh --steps=20
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.elements import ancf3243
from tlfea_torch.examples._common import (
    REF_DATA, accelerate, add_device_options, device_dtype, make_solver, out_dir,
)
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation, gravity_force
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.ancf_mesh import read_ancf3243_mesh
from tlfea_torch.utils.cli import Cli


def main(argv=None):
    """Run the script; returns (Simulation, [(t, center_z)] every step, as
    `center_z.csv`)."""
    args = add_device_options(
        Cli("ANCF3243 net (reference: test_ancf3243_net_newton.cc)")
        .add("mesh", os.path.join(REF_DATA, "meshes/ANCF3243/net_pinned_nx20_ny20_L0.5"
                                            ".ancf3243mesh"), "")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 20, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 2e7, "Young's modulus")
        .add("nu", 0.33, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e3, "Kelvin-Voigt damping")
        .add("rho_alm", 1e8, "ALM penalty")
        .add("W", 0.02, "beam section width")
        .add("H", 0.02, "beam section height")
        .add("vtk_every", 10, "VTU export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    mesh = read_ancf3243_mesh(args["mesh"])
    print(f"net: {mesh.n_nodes} nodes, {mesh.conn.shape[0]} elements, "
          f"{mesh.constraint_builder._n_rows} joint constraint rows")

    # Fix the corner nodes' position coefficients at their reference values
    # (added to the same linear-constraint system as the joints).
    pos = mesh.coefs[0::4]
    xmin, xmax = pos[:, 0].min(), pos[:, 0].max()
    ymin, ymax = pos[:, 1].min(), pos[:, 1].max()
    corner = np.nonzero((np.isclose(pos[:, 0], xmin) | np.isclose(pos[:, 0], xmax))
                        & (np.isclose(pos[:, 1], ymin) | np.isclose(pos[:, 1], ymax)))[0]
    print(f"fixing {len(corner)} corner nodes")
    for n in corner:
        for c in range(3):
            mesh.constraint_builder.fix_dof(4 * n, c, mesh.coefs[4 * n, c])

    cons = mesh.constraints(dtype=dtype, device="cpu")
    elems = ancf3243.build(mesh.coefs, mesh.conn, mesh.elem_L, args["W"], args["H"],
                           rho=args["rho0"], dtype=dtype, device="cpu")
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    system = accelerate(System(elems=elems, material=mat, constraints=cons), device)
    state = StepState.rest(system, torch.as_tensor(mesh.coefs, dtype=dtype, device=device))

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=gravity_force(system))

    center = int(np.argmin(np.linalg.norm(pos[:, :2] - [(xmin + xmax) / 2, (ymin + ymax) / 2],
                                          axis=1)))
    d = out_dir("ancf3243_net")
    t0 = time.time()
    hist = []
    for k in range(args["steps"]):
        diag = sim.step()
        cz = float(sim.state.x[4 * center, 2])
        hist.append((k * args["dt"], cz))
        if k % 5 == 0:
            print(f"step {k:4d} center_z={cz:+.6f} |c|={float(diag['norm_c']):.2e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_ancf_hex(os.path.join(d, f"net_{k:05d}.vtu"),
                                      sim.state.x.cpu().numpy(), mesh.conn, mesh.elem_L,
                                      args["W"], args["H"], "3243")
    wall = time.time() - t0
    io_vtk.write_csv_history(os.path.join(d, "center_z.csv"), ["t", "z"], hist)
    print(f"{args['steps']} steps in {wall:.1f}s; out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
