"""Two deformable T10 spheres dropping under gravity with hydroelastic
contact + implicit Newton solve, with per-phase timing stats (port of
`examples/sphere_drop_collision.py`).

Workload parity: reference `lib_bin/collision_system/
test_sphere_drop_collision.cc:29-474` (2 x 256-element spheres, dt=5e-4,
per-phase collision timing printed at the end). The sphere mesh is read from
`TLFEA_REF_DATA` when set; otherwise two 0.5 m boxes of 2 x 2 x 2 cells (48
elements each) stand in, as in the JAX script.

Run: python -m tlfea_torch.examples.sphere_drop_collision --steps=200
"""

import os

import numpy as np
import torch

from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
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
from tlfea_torch.utils.mesh_manager import MeshManager
from tlfea_torch.utils.pressure import distance_pressure_field
from tlfea_torch.utils.profiling import StepTimer
from tlfea_torch.utils.tetmesh import box_t10_mesh


def main(argv=None):
    """Run the script; returns (Simulation, [(step, contacts)] every 20 steps)."""
    args = add_device_options(
        Cli("sphere drop with hydroelastic contact (reference: test_sphere_drop_collision.cc)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 200, "time steps")
        .add("dt", 5e-4, "time step [s]")
        .add("E", 1e6, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 1000.0, "density")
        .add("damping", 1e2, "material Kelvin-Voigt damping")
        .add("contact_damping", 0.0, "hydroelastic normal damping")
        .add("friction", 0.3, "Coulomb friction coefficient")
        .add("modulus", 1e6, "hydroelastic modulus for the pressure fields")
        .add("rho_alm", 1e8, "ALM penalty")
        .add("drop_height", 0.15, "initial gap between spheres")
        .add("window", 256, "broadphase window")
        .add("max_pairs", 4096, "narrowphase pair capacity")
        .add("vtk_every", 25, "export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    mm = MeshManager()
    node = os.path.join(REF_DATA, "meshes/T10/sphere.1.node")
    ele = os.path.join(REF_DATA, "meshes/T10/sphere.1.ele")
    if REF_DATA and os.path.exists(node):
        a = mm.load_mesh(node, ele, "sphere_a")
        b = mm.load_mesh(node, ele, "sphere_b")
    else:
        nodes1, conn1 = box_t10_mesh(0.5, 0.5, 0.5, 2, 2, 2)
        a = mm.add_mesh(nodes1, conn1, "box_a")
        b = mm.add_mesh(nodes1, conn1, "box_b")

    # Stack sphere b above a with a gap; pressure fields from the reference's
    # NPZ assets when available (corner-vertex pressures), else computed
    # distance-to-surface fields.
    za = mm.mesh_nodes(a)[:, 2]
    mm.translate_mesh(b, (0.0, 0.0, za.max() - za.min() + args["drop_height"]))
    npz = os.path.join(REF_DATA, "meshes/T10/sphere.1.uncompressed.npz")
    for mid in (a, b):
        if REF_DATA and os.path.exists(npz):
            mm.load_corner_pressures_from_npz(mid, npz)
        else:
            inst = mm.instances[mid]
            conn_local = (mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems]
                          - inst.node_offset)
            mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), conn_local,
                                                             args["modulus"]))

    # The JAX script's band-minimising relabelling, kept so both packages
    # number the scene's nodes alike.
    scene = mm.scene(reorder=True)
    nodes, conn = scene.nodes, scene.conn
    print(f"scene: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

    elems = feat10.build(nodes, conn, rho=args["rho0"], dtype=dtype, device="cpu")
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    # Clamp the bottom ring of sphere a as the "floor" anchor.
    zmin = nodes[:, 2].min()
    fixed = np.nonzero(nodes[:, 2] < zmin + 0.05 * (nodes[:, 2].max() - zmin))[0]
    x0 = torch.as_tensor(nodes, dtype=dtype)
    system = System(elems=elems, material=mat, constraints=FixedCoefs.from_indices(fixed, x0))
    system = accelerate(system, device)  # the kernels on the card
    state = StepState.rest(system, x0.to(device))

    collision = HydroelasticCollision(
        conn, scene.elem_mesh_ids, scene.pressures,
        window=args["window"], max_pairs=args["max_pairs"], device=device,
    )
    col_params = HydroelasticParams(damping=args["contact_damping"], friction=args["friction"])

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=gravity_force(system),
                     collision=collision, collision_params=col_params)

    d = out_dir("sphere_drop")
    timer = StepTimer()
    hist = []
    for k in range(args["steps"]):
        # Per-phase timing without double work: time the collision inside a
        # wrapped call, then the solver on top (reference prints the same
        # per-phase averages, test_sphere_drop_collision.cc:448-473).
        timer.start("collision")
        f_col, patches, overflow = collision.step(sim.state.x, sim.state.v, col_params)
        timer.stop("collision", block_on=f_col)
        sim.last_patches = patches
        timer.start("solve")
        sim.state, diag = sim.solver_step(sim.system, sim.state, sim.base_f_ext + f_col)
        timer.stop("solve", block_on=sim.state.x)
        sim.last_diag = diag
        sim.step_count += 1
        if k % 20 == 0:
            nc = int(patches.n_contacts)
            hist.append((k, nc))
            print(f"step {k:4d} contacts={nc:4d} |c|={float(diag['norm_c']):.1e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(os.path.join(d, f"scene_{k:05d}.vtu"),
                                 sim.state.x.cpu().numpy(), conn)
            io_vtk.write_vtp_patches(os.path.join(d, f"patches_{k:05d}.vtp"), patches)

    print(timer.report())
    print(f"outputs in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
