"""Airless tire: ANCF3443 shell mesh from `.ancf3443mesh` with welded-joint
linear constraints (port of `examples/ancf3443_tire.py`).

Workload parity: reference `lib_bin/mesh_deform/test_ancf3443_mesh_newton.cc`
(airless tire, 1120 nodes / 720 shells / 160 welded joints, rim fixed,
load applied). The mesh is `--mesh`, by default the reference's tire under
`TLFEA_REF_DATA`.

Run: python -m tlfea_torch.examples.ancf3443_tire --mesh=tire.ancf3443mesh --steps=10
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.elements import ancf3443
from tlfea_torch.examples._common import (
    REF_DATA, accelerate, add_device_options, device_dtype, make_solver, out_dir,
)
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation, gravity_force
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.ancf_mesh import read_ancf3443_mesh
from tlfea_torch.utils.cli import Cli


def main(argv=None):
    """Run the script; returns (Simulation, [(step, max |dz|)] every 2 steps)."""
    args = add_device_options(
        Cli("ANCF3443 airless tire (reference: test_ancf3443_mesh_newton.cc)")
        .add("mesh", os.path.join(REF_DATA, "meshes/ANCF3443/airless_tire.ancf3443mesh"), "")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 10, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 1e7, "Young's modulus")
        .add("nu", 0.33, "Poisson ratio")
        .add("rho0", 1100.0, "density")
        .add("damping", 1e3, "Kelvin-Voigt damping")
        .add("rho_alm", 1e8, "ALM penalty")
        .add("rim_radius", 0.16, "nodes within this radius of the axis are fixed")
        .add("vtk_every", 5, "VTU export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    mesh = read_ancf3443_mesh(args["mesh"])
    print(f"tire: {mesh.n_nodes} nodes, {mesh.conn.shape[0]} shells, "
          f"{mesh.constraint_builder._n_rows} joint rows")

    # Fix nodes near the rim (small radius about the tire axis, here y-axis).
    pos = mesh.coefs[0::4]
    center = pos.mean(axis=0)
    r = np.linalg.norm(pos[:, [0, 2]] - center[[0, 2]], axis=1)
    rim = np.nonzero(r < args["rim_radius"])[0]
    print(f"fixing {len(rim)} rim nodes")
    for n in rim:
        for slot in range(4):
            for c in range(3):
                mesh.constraint_builder.fix_dof(4 * n + slot, c, mesh.coefs[4 * n + slot, c])

    cons = mesh.constraints(dtype=dtype, device="cpu")
    elems = ancf3443.build(mesh.coefs, mesh.conn, mesh.elem_L, mesh.elem_W, mesh.elem_H,
                           rho=args["rho0"], dtype=dtype, device="cpu")
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    system = accelerate(System(elems=elems, material=mat, constraints=cons), device)
    state = StepState.rest(system, torch.as_tensor(mesh.coefs, dtype=dtype, device=device))

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=gravity_force(system))

    z0 = torch.as_tensor(pos[:, 2], dtype=dtype, device=device)
    d = out_dir("ancf3443_tire")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        diag = sim.step()
        if k % 2 == 0:
            dz = float((sim.state.x[0::4, 2] - z0).abs().max())
            hist.append((k, dz))
            print(f"step {k:3d} max_dz={dz:.6f} |c|={float(diag['norm_c']):.2e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_ancf_hex(os.path.join(d, f"tire_{k:05d}.vtu"),
                                      sim.state.x.cpu().numpy(), mesh.conn, mesh.elem_L,
                                      mesh.elem_W, mesh.elem_H, "3443")
    wall = time.time() - t0
    print(f"{args['steps']} steps in {wall:.1f}s; out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
