"""Self-contact demo: a hairpin-folded beam pressed onto itself (port of
`examples/self_contact_fold.py`).

The lower leg is clamped at its free end; the upper leg's free end is
prescribed to descend (constraint retargeting, as in the bubble-gripper
demo) until the legs make self-contact through the hydroelastic pipeline
with `enable_self_collision=True` and the grid-hash broadphase.

Exercises the reference capability `HydroelasticBroadphaseFunc.cuh:105-133`
(topological-neighbor-filtered self-collision). At the default --nx=24 the
hairpin has 576 elements: each inner solve runs in the persistent kernel
(`tlfea_torch.ops.resident`) on the card.

Run: python -m tlfea_torch.examples.self_contact_fold --steps=120
"""

import os
import time

import numpy as np
import torch

from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import feat10
from tlfea_torch.examples._common import accelerate, add_device_options, device_dtype, out_dir
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.simulation import Simulation
from tlfea_torch.solvers import StepState, System, newton
from tlfea_torch.utils import io_vtk
from tlfea_torch.utils.cli import Cli
from tlfea_torch.utils.pressure import distance_pressure_field
from tlfea_torch.utils.tetmesh import hairpin_t10_mesh


def main(argv=None):
    """Run the script; returns (Simulation, [(step, self-contacts)] every 10
    steps)."""
    args = add_device_options(
        Cli("hairpin self-contact fold (grid-hash broadphase, self-collision)")
        .add("steps", 120, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 2e6, "Young's modulus")
        .add("damping", 5e2, "Kelvin-Voigt damping")
        .add("press", 0.07, "total prescribed descent of the upper leg end")
        .add("friction", 0.3, "Coulomb friction")
        .add("modulus", 2e6, "hydroelastic modulus")
        .add("nx", 24, "elements along the beam")
        .add("vtk_every", 10, "export interval (0 = off)")
    ).parse(argv)
    device, dtype = device_dtype(args)

    nodes, conn = hairpin_t10_mesh(leg=0.4, gap=0.06, nx=args["nx"], ny=2, nz=2)
    lam, mu = lame_from_E_nu(args["E"], 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    low_end = np.nonzero((nodes[:, 0] > 0.39) & (nodes[:, 2] < 0.03))[0]
    up_end = np.nonzero((nodes[:, 0] > 0.39) & (nodes[:, 2] > 0.08))[0]
    pinned = np.concatenate([low_end, up_end])
    x0 = torch.as_tensor(nodes, dtype=dtype)
    system = System(elems=feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu"),
                    material=mat, constraints=FixedCoefs.from_indices(pinned, x0))
    system = accelerate(system, device)  # the kernels on the card
    print(f"{conn.shape[0]} elems, {nodes.shape[0]} nodes; "
          f"{len(low_end)} clamped, {len(up_end)} prescribed")

    collision = HydroelasticCollision(
        conn, np.zeros(conn.shape[0], np.int32),
        distance_pressure_field(nodes, conn, args["modulus"]),
        enable_self_collision=True, broadphase="grid", rest_nodes=nodes,
        max_pairs=32768, device=device,
    )
    params = newton.NewtonParams(
        dt=args["dt"], rho=1e8, inner_atol=1e-6, inner_rtol=1e-6,
        outer_tol=1e-8, max_outer=2, max_inner=8, cg_rtol=1e-4, cg_max_iter=300,
        # Default globalization (ls_max backtracking on ||g||) handles the
        # indefinite SVK tangent at contact onset — no per-scene knobs.
    )
    sim = Simulation(system, StepState.rest(system, x0.to(device)), newton.stepper(params),
                     collision=collision,
                     collision_params=HydroelasticParams(damping=2.0, friction=args["friction"]))

    d = out_dir("self_contact_fold")
    targets0 = nodes[pinned].copy()
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        t = targets0.copy()
        t[len(low_end):, 2] -= args["press"] * (k + 1) / args["steps"]
        sim.set_constraint_targets(torch.as_tensor(t, dtype=dtype))
        sim.step()
        if k % 10 == 0:
            nc = int(sim.last_patches.n_contacts)
            hist.append((k, nc))
            print(f"step {k:4d} self-contacts={nc:4d}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(os.path.join(d, f"fold_{k:05d}.vtu"),
                                 sim.state.x.cpu().numpy(), conn)
    wall = time.time() - t0
    print(f"{args['steps']} steps in {wall:.1f}s; out in {d}/")
    return sim, hist


if __name__ == "__main__":
    main()
