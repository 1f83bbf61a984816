"""Two soft bubble grippers clamp a deformable item via prescribed motion
(port of `examples/bubble_gripper.py`).

Workload parity: reference `lib_bin/collision_system/
test_bubble_gripper_bunny(_floor).cc` — gripper bodies driven by
`UpdatePositions` + `UpdateConstraintTargets` each step on a close/hold/
reopen schedule (`test_bubble_gripper_bunny.cc:420-459`), hydroelastic
contact with the grasped object. The item is the sphere mesh of
`TLFEA_REF_DATA` when set; otherwise a 0.25 m box of 2 x 2 x 2 cells, as in
the JAX script. The pads have two cells through their thickness (PAD_CELLS),
the JAX script's one: only so does hydroelastic contact fire on them.

Run: python -m tlfea_torch.examples.bubble_gripper --steps=120
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea_torch.constraints import DensePins
from tlfea_torch.elements import feat10
from tlfea_torch.examples._common import (
    REF_DATA, accelerate, add_device_options, device_dtype, make_solver, out_dir,
)
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation
from tlfea_torch.solvers import StepState, System
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.cli import Cli
from tlfea_torch.utils.mesh_manager import MeshManager
from tlfea_torch.utils.pressure import distance_pressure_field
from tlfea_torch.utils.tetmesh import box_t10_mesh


PAD_CELLS = (2, 3, 3)  # the pads' cells through x (the closing direction), y, z


def main(argv=None):
    """Run the script; returns (Simulation, [(step, contacts)] every 20 steps)."""
    args = add_device_options(
        Cli("bubble gripper (reference: test_bubble_gripper_bunny.cc)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 120, "time steps")
        .add("dt", 5e-4, "time step [s]")
        .add("E", 5e5, "Young's modulus")
        .add("nu", 0.4, "Poisson ratio")
        .add("rho0", 1000.0, "density")
        .add("damping", 1e2, "Kelvin-Voigt damping")
        .add("friction", 0.6, "Coulomb friction")
        .add("modulus", 5e5, "hydroelastic modulus")
        .add("rho_alm", 1e9, "ALM penalty")
        .add("close_frac", 0.4, "fraction of steps closing")
        .add("hold_frac", 0.3, "fraction of steps holding")
        .add("close_speed", 0.08, "gripper closing speed [m/s]")
        .add("vtk_every", 30, "export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    mm = MeshManager()
    # Two gripper pads (soft boxes) flanking a central item. Two cells
    # through the pad's thickness, where the JAX script has one: with one,
    # every corner node is on the surface, so the pads' per-tet affine
    # pressure fields are identically zero and hydro contact never fires.
    pad_nodes, pad_conn = box_t10_mesh(0.08, 0.3, 0.3, *PAD_CELLS)
    item_node = os.path.join(REF_DATA, "meshes/T10/sphere.1.node")
    if REF_DATA and os.path.exists(item_node):
        item = mm.load_mesh(item_node, item_node.replace(".node", ".ele"), "item")
    else:
        inodes, iconn = box_t10_mesh(0.25, 0.25, 0.25, 2, 2, 2)
        item = mm.add_mesh(inodes, iconn, "item")
    inodes = mm.mesh_nodes(item)
    ic = 0.5 * (inodes.max(axis=0) + inodes.min(axis=0))
    ext = inodes.max(axis=0) - inodes.min(axis=0)

    gap = 0.02
    left = mm.add_mesh(pad_nodes, pad_conn, "left_pad")
    mm.translate_mesh(left, (ic[0] - ext[0] / 2 - gap - 0.08, ic[1] - 0.15, ic[2] - 0.15))
    right = mm.add_mesh(pad_nodes, pad_conn, "right_pad")
    mm.translate_mesh(right, (ic[0] + ext[0] / 2 + gap, ic[1] - 0.15, ic[2] - 0.15))

    for mid in range(len(mm.instances)):
        inst = mm.instances[mid]
        local_conn = (mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems]
                      - inst.node_offset)
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), local_conn,
                                                         args["modulus"]))

    nodes, conn = mm.nodes, mm.elements
    print(f"scene: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

    elems = feat10.build(nodes, conn, rho=args["rho0"], dtype=dtype, device="cpu")
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])

    # Driven nodes: the outer faces of both pads (prescribed motion).
    ln = mm.mesh_nodes(left)
    rn = mm.mesh_nodes(right)
    l_ids = np.arange(mm.instances[left].node_offset, mm.instances[left].node_offset + ln.shape[0])
    r_ids = np.arange(mm.instances[right].node_offset,
                      mm.instances[right].node_offset + rn.shape[0])
    l_drive = l_ids[ln[:, 0] < ln[:, 0].min() + 1e-9]
    r_drive = r_ids[rn[:, 0] > rn[:, 0].max() - 1e-9]
    driven = np.concatenate([l_drive, r_drive])
    # DensePins: membership and targets as dense fields, so the per-step
    # retargeting (the close/hold/reopen schedule) is data of fixed shape.
    x0 = torch.as_tensor(nodes, dtype=dtype)
    system = System(elems=elems, material=mat, constraints=DensePins.from_indices(driven, x0))
    system = accelerate(system, device)  # the kernels on the card
    state = StepState.rest(system, x0.to(device))

    collision = HydroelasticCollision(conn, mm.elem_mesh_ids(), mm.scalar_field(), window=256,
                                      max_pairs=8192, device=device)
    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, collision=collision,
                     collision_params=HydroelasticParams(friction=args["friction"]))

    n_close = int(args["close_frac"] * args["steps"])
    n_hold = int(args["hold_frac"] * args["steps"])
    # Full-field target (DensePins): rows outside `driven` are inert.
    target = nodes.copy()
    d = out_dir("bubble_gripper")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        # Close / hold / reopen schedule (reference: :420+).
        if k < n_close:
            dx = args["close_speed"] * args["dt"]
        elif k < n_close + n_hold:
            dx = 0.0
        else:
            dx = -args["close_speed"] * args["dt"]
        target[l_drive, 0] += dx
        target[r_drive, 0] -= dx
        sim.set_constraint_targets(torch.as_tensor(target, dtype=dtype))
        diag = sim.step()
        if k % 20 == 0:
            nc = int(sim.last_patches.n_contacts) if sim.last_patches is not None else 0
            hist.append((k, nc))
            print(f"step {k:4d} contacts={nc:5d} |c|={float(diag['norm_c']):.1e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(os.path.join(d, f"grip_{k:05d}.vtu"),
                                 sim.state.x.cpu().numpy(), conn)
    wall = time.time() - t0
    print(f"{args['steps']} steps in {wall:.1f}s; out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
