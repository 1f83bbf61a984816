"""The torch port's collision-coupled stepping against the JAX package, on
the CPU in float64, on `tests/test_coupled_rollout.py`'s contact problem
(two boxes overlapping from step 0, the lower one's floor pinned):
`Simulation` with collision (equal Newton and CG counts and force-carrying
contacts per step, positions within 1e-10), `make_coupled_rollout` against the port's own
`Simulation` loop (bitwise) and against JAX's with a frozen
preconditioner (1e-10), and the overflow flag at a tiny capacity."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.collision.hydroelastic import HydroelasticCollision as JCollision
from tlfea.collision.hydroelastic import HydroelasticParams as JParams
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.simulation import Simulation as JSimulation
from tlfea.simulation import gravity_force as j_gravity
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.utils.mesh_manager import MeshManager
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea_torch.interop import from_numpy_collision, from_numpy_system
from tlfea_torch.simulation import Simulation, gravity_force
from tlfea_torch.solvers import newton

torch.set_num_threads(2)

N_STEPS = 5


@pytest.fixture(scope="module")
def problem():
    """`tests/test_coupled_rollout.py:27-54`, in both packages."""
    mm = MeshManager()
    n1, c1 = box_t10_mesh(0.3, 0.3, 0.12, 2, 2, 2)
    a = mm.add_mesh(n1, c1, "lower")
    b = mm.add_mesh(n1, c1, "upper")
    mm.translate_mesh(b, (0.02, 0.02, 0.11))
    for mid in (a, b):
        inst = mm.instances[mid]
        lc = mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems]
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid),
                                                         lc - inst.node_offset, 5e5))
    nodes, conn = mm.nodes, mm.elements
    lam, mu = lame_from_E_nu(5e5, 0.3)
    floor = np.nonzero(nodes[:, 2] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0),
                   material=JSVK(lam=lam, mu=mu, eta_damp=2e2, lam_damp=2e2),
                   constraints=JFixedCoefs.from_indices(floor, nodes))
    jparams = j_newton.NewtonParams(dt=1e-3, rho=1e8, inner_atol=1e-8, max_outer=1,
                                    max_inner=8, cg_max_iter=100)
    jstate = JStepState.rest(jsys, nodes)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    scene = (conn, mm.elem_mesh_ids(), mm.scalar_field())
    return dict(nodes=nodes, scene=scene, jsys=jsys, jstate=jstate, jparams=jparams,
                tsys=tsys, tstate=tstate, tparams=tparams,
                jcol=JCollision(*scene, window=64, max_pairs=2048),
                tcol=HydroelasticCollision(*scene, window=64, max_pairs=2048, device="cpu"),
                jcp=JParams(friction=0.3))


def _force_fn(col, params):
    def force_fn(x, v):
        f, _, ovf = col.step(x, v, params)
        return f, ovf
    return force_fn


def _same_contacts(tp, jp, step):
    """The contacts of a step in both packages. Patches whose validity
    differs must be the degenerate ones at the area threshold (area
    NP_EPS^2 = 1e-20, rounding noise: the JAX CPU backend fuses products
    and sums into FMAs, the port does not), which carry no force (the
    force needs area > 1e-18 in both packages); the force-carrying
    contacts are equal in number and in which pairs they are."""
    ju = np.asarray(jp.valid & jp.valid_orientation)
    tu = (tp.valid & tp.valid_orientation).numpy()
    j_area, t_area = np.asarray(jp.area), tp.area.numpy()
    differ = ju != tu
    assert (j_area[differ] <= 1e-18).all() and (t_area[differ] <= 1e-18).all(), step
    force_j, force_t = ju & (j_area > 1e-18), tu & (t_area > 1e-18)
    assert (force_t == force_j).all() and force_j.sum() > 0, step


def test_simulation_with_collision_matches_jax(problem):
    p = problem
    tcp = from_numpy_collision(p["jcp"], device="cpu")
    jsim = JSimulation(p["jsys"], p["jstate"], j_newton.stepper(p["jparams"]),
                       base_f_ext=j_gravity(p["jsys"]), collision=p["jcol"],
                       collision_params=p["jcp"])
    tsim = Simulation(p["tsys"], p["tstate"], newton.stepper(p["tparams"]),
                      base_f_ext=gravity_force(p["tsys"]), collision=p["tcol"],
                      collision_params=tcp)
    for k in range(N_STEPS):
        jd, td = jsim.step(), tsim.step()
        assert (td["newton_iters"], td["cg_iters"]) == (int(jd["newton_iters"]),
                                                         int(jd["cg_iters"])), k
        _same_contacts(tsim.last_patches, jsim.last_patches, k)
    jx = np.asarray(jsim.state.x)
    scale = np.abs(jx - p["nodes"]).max()
    assert scale > 0 and np.abs(tsim.state.x.numpy() - jx).max() < 1e-10 * scale
    assert tsim.overflow_events == jsim.overflow_events == 0


def test_coupled_rollout_bitwise_simulation_loop(problem):
    p = problem
    tcp = from_numpy_collision(p["jcp"], device="cpu")
    f_base = gravity_force(p["tsys"])
    sim = Simulation(p["tsys"], p["tstate"], newton.stepper(p["tparams"]), base_f_ext=f_base,
                     collision=p["tcol"], collision_params=tcp)
    nits, cgits = [], []
    for _ in range(N_STEPS):
        d = sim.step()
        nits.append(d["newton_iters"])
        cgits.append(d["cg_iters"])
    roll = newton.make_coupled_rollout(p["tsys"], p["tparams"], N_STEPS,
                                       _force_fn(p["tcol"], tcp))
    s, (nit, cgit), ovf = roll(p["tstate"], f_base)
    assert not bool(ovf) and (nit, cgit) == (nits, cgits)
    for k in ("x", "v", "lam", "u", "dv"):
        assert torch.equal(getattr(s, k), getattr(sim.state, k)), k


def test_coupled_rollout_frozen_precond_matches_jax(problem):
    """precond_refresh=2 in both packages: equal counts, x within 1e-10."""
    p = problem
    tcp = from_numpy_collision(p["jcp"], device="cpu")
    jroll = j_newton.make_coupled_rollout(p["jsys"], p["jparams"], N_STEPS,
                                          _force_fn(p["jcol"], p["jcp"]), precond_refresh=2)
    js, (jnit, jcg), jovf = jroll(p["jstate"], j_gravity(p["jsys"]))
    troll = newton.make_coupled_rollout(p["tsys"], p["tparams"], N_STEPS,
                                        _force_fn(p["tcol"], tcp), precond_refresh=2)
    ts, (tnit, tcg), tovf = troll(p["tstate"], gravity_force(p["tsys"]))
    assert bool(tovf) == bool(jovf) is False
    assert (tnit, tcg) == (np.asarray(jnit).tolist(), np.asarray(jcg).tolist())
    jx = np.asarray(js.x)
    scale = np.abs(jx - p["nodes"]).max()
    assert np.abs(ts.x.numpy() - jx).max() < 1e-10 * scale


def test_coupled_rollout_reports_overflow(problem):
    """Window 2 and max_pairs 8 overflow in this contact scene; the flag is
    a device tensor OR-ed over the steps, as JAX's."""
    p = problem
    tiny = HydroelasticCollision(*p["scene"], window=2, max_pairs=8, device="cpu")
    roll = newton.make_coupled_rollout(p["tsys"], p["tparams"], 2,
                                       _force_fn(tiny, HydroelasticParams(friction=0.3)))
    _, (nit, _), ovf = roll(p["tstate"], gravity_force(p["tsys"]))
    assert isinstance(ovf, torch.Tensor) and ovf.dtype == torch.bool and bool(ovf)
    assert len(nit) == 2
    _, _, o_one = tiny.step(p["tstate"].x)
    jtiny = JCollision(*p["scene"], window=2, max_pairs=8)
    assert bool(o_one) == bool(np.asarray(jtiny.step(jnp.asarray(p["nodes"]))[2])) is True

