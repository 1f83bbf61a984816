"""Deformable item dropped onto a deformable floor, switchable collision
backend (port of `examples/item_drop.py`).

Workload parity: reference `lib_bin/collision_system/test_item_drop.cc`
(dragon/armadillo/openbox onto a deformable floor, `--collision=hydro|deme`
switch behind the CollisionSystem interface; everything device-resident).
`--collision=deme` runs the on-device DEM-Engine-style backend
(`tlfea_torch.collision.dem.NodeSphereDem`). The item's mesh is read from
`TLFEA_REF_DATA` when set; otherwise a 0.3 m box of 2 x 2 x 2 cells stands
in, as in the JAX script.

Run: python -m tlfea_torch.examples.item_drop --item=dragon --steps=50
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.collision.dem import (
    DemParams, NodeSphereDem, dem_params_from_material, node_sphere_radii,
)
from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import feat10
from tlfea_torch.elements.assembly import lumped_mass, mass_diag
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
from tlfea_torch.utils.tetmesh import box_t10_mesh

ITEM_PATHS = {
    "dragon": ("meshes/T10/item_drop/dragon.node", "meshes/T10/item_drop/dragon.ele"),
    "armadillo": ("meshes/T10/item_drop/armadillo.node", "meshes/T10/item_drop/armadillo.ele"),
    "openbox": ("meshes/T10/item_drop/openbox.node", "meshes/T10/item_drop/openbox.ele"),
    "sphere": ("meshes/T10/sphere.1.node", "meshes/T10/sphere.1.ele"),
}


def hrz_lumped_mass(elems):
    """The consistent mass's diagonal scaled to the total mass (n_coef,):
    positive wherever the mass matrix is SPD, where the row sums of a T10
    mass are negative at the vertices."""
    diag = mass_diag(elems)
    return diag * (lumped_mass(elems).sum() / diag.sum())


def main(argv=None):
    """Run the script; returns (Simulation, [(step, contacts, {counts})]
    every 10 steps)."""
    args = add_device_options(
        Cli("item drop (reference: lib_bin/collision_system/test_item_drop.cc)")
        .add("item", "sphere", "sphere|dragon|armadillo|openbox|box")
        .add("collision", "hydro", "hydro|deme")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 50, "time steps")
        .add("dt", 2e-4, "time step [s]")
        .add("E", 1e6, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 1000.0, "density")
        .add("damping", 1e2, "Kelvin-Voigt damping")
        .add("friction", 0.4, "Coulomb friction")
        .add("modulus", 1e6, "hydroelastic modulus")
        .add("dem_E", 2e6, "DEM contact Young's modulus (collision=deme; "
                           "reference default DEME_CONTACT_E=2e6)")
        .add("dem_nu", 0.3, "DEM contact Poisson ratio (DEME_CONTACT_NU)")
        .add("dem_cor", 0.0, "DEM contact restitution (DEME_CONTACT_COR)")
        .add("dem_kn", 0.0, "raw DEM normal stiffness override (0 = derive "
                            "from dem_E/dem_nu/dem_cor)")
        .add("dem_cn", 0.0, "raw DEM normal damping override")
        .add("rho_alm", 1e8, "ALM penalty")
        .add("drop_height", 0.05, "initial gap above the floor")
        .add("window", 256, "broadphase window")
        .add("max_pairs", 8192, "narrowphase pair capacity")
        .add("vtk_every", 20, "export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)
    if args["collision"] not in ("hydro", "deme"):
        raise SystemExit("--collision must be hydro or deme")

    mm = MeshManager()
    node = ele = None
    if REF_DATA and args["item"] in ITEM_PATHS:
        node, ele = (os.path.join(REF_DATA, p) for p in ITEM_PATHS[args["item"]])
    if node and os.path.exists(node):
        item = mm.load_mesh(node, ele, args["item"])
    else:
        nodes_i, conn_i = box_t10_mesh(0.3, 0.3, 0.3, 2, 2, 2)
        item = mm.add_mesh(nodes_i, conn_i, "box_item")

    # Deformable floor sized to the item footprint.
    inodes = mm.mesh_nodes(item)
    ext = inodes.max(axis=0) - inodes.min(axis=0)
    fl_x, fl_y = 2.5 * ext[0], 2.5 * ext[1]
    fl_h = 0.2 * ext[2]
    # nz >= 2 is load-bearing: with one element through the thickness every
    # corner node is on the surface, so the floor's per-tet affine pressure
    # fields are identically zero and hydro contact never fires.
    floor_nodes, floor_conn = box_t10_mesh(fl_x, fl_y, fl_h, 6, 6, 2)
    floor = mm.add_mesh(floor_nodes, floor_conn, "floor")
    mm.translate_mesh(floor, (inodes[:, 0].min() - 0.75 * ext[0],
                              inodes[:, 1].min() - 0.75 * ext[1],
                              inodes[:, 2].min() - fl_h - args["drop_height"]))
    item_npz = (node or "").replace(".node", ".npz").replace(".1.npz", ".1.uncompressed.npz")
    for mid in (item, floor):
        if mid == item and node and os.path.exists(item_npz):
            # Reference NPZ scene asset: corner-vertex pressures.
            mm.load_corner_pressures_from_npz(mid, item_npz)
            continue
        inst = mm.instances[mid]
        local_conn = (mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems]
                      - inst.node_offset)
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), local_conn,
                                                         args["modulus"]))

    # The JAX script's band-minimising relabelling, kept so both packages
    # number the scene's nodes alike.
    scene = mm.scene(reorder=True)
    nodes, conn = scene.nodes, scene.conn
    print(f"scene: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

    elems = feat10.build(nodes, conn, rho=args["rho0"], dtype=dtype, device="cpu")
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    # Clamp the floor underside.
    zmin = nodes[:, 2].min()
    fixed = np.nonzero(nodes[:, 2] < zmin + 1e-9)[0]
    x0 = torch.as_tensor(nodes, dtype=dtype)
    system = System(elems=elems, material=mat, constraints=FixedCoefs.from_indices(fixed, x0))
    system = accelerate(system, device)  # the kernels on the card
    state = StepState.rest(system, x0.to(device))

    if args["collision"] == "hydro":
        collision = HydroelasticCollision(
            conn, scene.elem_mesh_ids, scene.pressures,
            window=args["window"], max_pairs=args["max_pairs"],
            rest_nodes=nodes,  # enables the two-level block broadphase
            device=device,
        )
        print(f"broadphase mode: {collision.mode}")
        col_params = HydroelasticParams(friction=args["friction"])
    else:
        # On-device DEM (DEM-Engine-style sphere contacts): every surface
        # vertex carries a contact sphere; spring-dashpot + regularized
        # Coulomb friction between meshes.
        surf_tris = [scene.surface_triangles(mid) for mid in range(len(mm.instances))]
        collision = NodeSphereDem(nodes, surf_tris, device=device)
        if args["dem_kn"] > 0:
            col_params = DemParams(kn=args["dem_kn"], cn=args["dem_cn"], mu=args["friction"])
        else:
            # Material-derived contact params (parameter-comparable to the
            # reference's DEME runs, DEME_CONTACT_E/NU/COR defaults):
            # characteristic sphere = median surface-node radius, node mass
            # = median over the contact spheres of the diagonally scaled
            # (HRZ) lumped mass. The JAX script takes the row-sum lumped
            # mass there, which is negative at every T10 vertex (the
            # spheres' nodes), so its cn = 2 beta sqrt(kn m*) is NaN.
            all_tris = np.concatenate([np.asarray(t) for t in surf_tris])
            radii = node_sphere_radii(nodes, all_tris)
            surf_ids = np.unique(all_tris.reshape(-1))
            m_node = hrz_lumped_mass(elems).cpu().numpy()[surf_ids]
            col_params = dem_params_from_material(
                args["dem_E"], args["dem_nu"], args["dem_cor"],
                radius=float(np.median(radii[surf_ids])),
                mass=float(np.median(m_node)), mu=args["friction"],
            )
            print(f"DEM material map: E={args['dem_E']:.3g} nu={args['dem_nu']}"
                  f" cor={args['dem_cor']} -> kn={float(col_params.kn):.4g}"
                  f" cn={float(col_params.cn):.4g}")
    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=gravity_force(system),
                     collision=collision, collision_params=col_params)

    d = out_dir("item_drop")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        if k == 1:  # steady-state rate: step 0 carries the setup's first calls
            t0 = time.time()
        sim.step()
        if k % 10 == 0:
            nc = int(sim.last_patches.n_contacts) if sim.last_patches is not None else 0
            it = {kk: int(sim.last_diag[kk]) for kk in ("outer_iters", "newton_iters",
                                                        "cg_iters") if kk in sim.last_diag}
            hist.append((k, nc, it))
            print(f"step {k:4d} contacts={nc:5d} {it}", flush=True)
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(os.path.join(d, f"scene_{k:05d}.vtu"),
                                 sim.state.x.cpu().numpy(), conn)
    wall = time.time() - t0
    n_timed = max(args["steps"] - 1, 1)
    print(f"{n_timed} steady-state steps in {wall:.1f}s "
          f"({n_timed/wall:.2f} steps/s; the first step carries the setup's first calls); "
          f"out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
