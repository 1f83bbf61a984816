"""Bunny mesh deform: clamp the base, pull the ears, large deformation
(port of `examples/bunny_deform.py`).

Workload parity: reference `lib_bin/mesh_deform/test_feat10_bunny_{newton,
adamw}.cc` (bunny 1,066 T10 elems / 2,095 nodes, base clamp, ear loads).
The bunny mesh is read from `TLFEA_REF_DATA` when set; otherwise a 1 x 1 x 2
box of 2 x 2 x 4 cells (96 elements) stands in, as in the JAX script.

Run: python -m tlfea_torch.examples.bunny_deform --solver=newton --steps=30
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
from tlfea_torch.materials import SVK, MooneyRivlin, lame_from_E_nu
from tlfea_torch.simulation import Simulation
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.cli import Cli
from tlfea_torch.utils.tetmesh import box_t10_mesh, read_tetgen


def main(argv=None):
    """Run the script; returns (Simulation, [(step, max |dx|)] every 5 steps)."""
    args = add_device_options(
        Cli("bunny deform (reference: lib_bin/mesh_deform/test_feat10_bunny_*)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 30, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 5e5, "Young's modulus")
        .add("nu", 0.4, "Poisson ratio")
        .add("rho0", 1000.0, "density")
        .add("damping", 50.0, "Kelvin-Voigt damping")
        .add("material", "svk", "svk|mooney_rivlin")
        .add("ear_force", 20.0, "pull force per ear node [N]")
        .add("rho_alm", 1e8, "ALM penalty")
        .add("vtk_every", 10, "VTU export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    node = os.path.join(REF_DATA, "meshes/T10/bunny_ascii_26.1.node")
    ele = os.path.join(REF_DATA, "meshes/T10/bunny_ascii_26.1.ele")
    if REF_DATA and os.path.exists(node):
        nodes, conn = read_tetgen(node, ele)
    else:
        nodes, conn = box_t10_mesh(1.0, 1.0, 2.0, 2, 2, 4)
    print(f"mesh: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

    elems = feat10.build(nodes, conn, rho=args["rho0"], dtype=dtype, device="cpu")
    if args["material"] == "mooney_rivlin":
        mu = args["E"] / (2 * (1 + args["nu"]))
        kappa = args["E"] / (3 * (1 - 2 * args["nu"]))
        mat = MooneyRivlin(
            mu10=0.4 * mu, mu01=0.1 * mu, kappa=kappa,
            eta_damp=args["damping"], lam_damp=args["damping"],
        )
    else:
        lam, mu = lame_from_E_nu(args["E"], args["nu"])
        mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])

    z = nodes[:, 2]
    zr = z.max() - z.min()
    base = np.nonzero(z < z.min() + 0.05 * zr)[0]
    ears = np.nonzero(z > z.max() - 0.1 * zr)[0]
    print(f"clamped {len(base)} base nodes, pulling {len(ears)} ear nodes")

    x0 = torch.as_tensor(nodes, dtype=dtype)
    system = System(elems=elems, material=mat, constraints=FixedCoefs.from_indices(base, x0))
    system = accelerate(system, device)  # the kernels on the card
    state = StepState.rest(system, x0.to(device))
    f_ext = torch.zeros_like(state.x)
    f_ext[torch.as_tensor(ears, device=device), 0] += args["ear_force"]  # sideways pull

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=f_ext)

    d = out_dir("bunny_deform")
    x_ref0 = torch.as_tensor(nodes[:, 0], dtype=dtype, device=device)
    dxs = []
    t0 = time.time()
    for k in range(args["steps"]):
        diag = sim.step()
        if k % 5 == 0:
            dx = float((sim.state.x[:, 0] - x_ref0).abs().max())
            dxs.append((k, dx))
            print(f"step {k:4d} max_dx={dx:.5f} |c|={float(diag['norm_c']):.1e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            x = sim.state.x.cpu().numpy()
            io_vtk.write_vtu_t10(os.path.join(d, f"bunny_{k:05d}.vtu"), x, conn,
                                 displacement=x - nodes)
    wall = time.time() - t0
    print(f"{args['steps']} steps in {wall:.1f}s ({args['steps']/wall:.2f} steps/s); out in {d}/")
    return sim, dxs


if __name__ == "__main__":
    main()
