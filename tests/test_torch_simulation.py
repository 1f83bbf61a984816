"""The user layer of the torch port against the JAX package, on the CPU in
float64: `Simulation` with `newton.stepper`, checkpoint and resume (the
checkpoint format shared by both packages), prescribed motion and pins
changed mid-run, the diagnostics and the assembly host helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea import diagnostics as j_diag
from tlfea.constraints import DensePins as JDensePins
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import assembly as j_asm
from tlfea.elements import feat10 as j_feat10
from tlfea.materials import SVK as JSVK
from tlfea.materials import MooneyRivlin as JMooneyRivlin
from tlfea.materials import lame_from_E_nu
from tlfea.simulation import Simulation as JSimulation
from tlfea.simulation import gravity_force as j_gravity
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch import diagnostics
from tlfea_torch.constraints import DensePins, FixedCoefs
from tlfea_torch.elements import assembly, feat10
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import SVK, MooneyRivlin
from tlfea_torch.simulation import Simulation, gravity_force
from tlfea_torch.solvers import StepState, System, newton, suggest_rho

torch.set_num_threads(2)

LAM, MU = lame_from_E_nu(1e6, 0.3)


def _jax_box(cells=(0.5, 0.1, 0.1, 1, 1, 1), pins=JFixedCoefs, rho=1e8):
    """A damped SVK box pinned at its x = 0 face, in float64."""
    nodes, conn = box_t10_mesh(*cells)
    mat = JSVK(lam=jnp.asarray(LAM), mu=jnp.asarray(MU), eta_damp=jnp.asarray(1e2),
               lam_damp=jnp.asarray(1e2))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                     constraints=pins.from_indices(fixed, nodes))
    params = j_newton.NewtonParams(dt=1e-3, rho=rho, inner_atol=1e-8, max_outer=2, max_inner=8)
    return nodes, fixed, system, JStepState.rest(system, nodes), params


def _port(jsys, jstate, jparams):
    return from_numpy_system(jsys.elems, jsys.material, jsys.constraints, jstate, jparams,
                             device="cpu")


def test_simulation_stepper_matches_jax():
    """Simulation + stepper under gravity, 5 steps: equal Newton and CG
    counts and positions within 1e-10 of the displacement scale."""
    nodes, _, jsys, jstate, jparams = _jax_box()
    tsys, ts, tparams = _port(jsys, jstate, jparams)
    jsim = JSimulation(jsys, jstate, j_newton.stepper(jparams), base_f_ext=j_gravity(jsys))
    tsim = Simulation(tsys, ts, newton.stepper(tparams), base_f_ext=gravity_force(tsys))
    np.testing.assert_allclose(tsim.base_f_ext.numpy(), np.asarray(jsim.base_f_ext), rtol=1e-15)
    for _ in range(5):
        jd, td = jsim.step(), tsim.step()
        assert (td["newton_iters"], td["cg_iters"]) == (int(jd["newton_iters"]),
                                                         int(jd["cg_iters"]))
    jx = np.asarray(jsim.state.x)
    scale = np.abs(jx - nodes).max()
    assert np.abs(tsim.state.x.numpy() - jx).max() < 1e-10 * scale
    assert tsim.step_count == jsim.step_count == 5


def test_checkpoint_roundtrip_bitwise_and_from_jax(tmp_path):
    """save_state at step 3, load into a new Simulation, 2 more steps:
    bitwise the run that was not interrupted; a checkpoint written by the
    JAX package loads in the port with the same arrays and step count,
    and the port's loads in the JAX package."""
    _, _, jsys, jstate, jparams = _jax_box((0.5, 0.1, 0.1, 2, 1, 1))
    tsys, ts, tparams = _port(jsys, jstate, jparams)
    sim = Simulation(tsys, ts, newton.stepper(tparams), base_f_ext=gravity_force(tsys))
    sim.run(3)
    ckpt = str(tmp_path / "state.npz")
    sim.save_state(ckpt)
    x3 = sim.state.x.clone()
    sim.run(2)
    sim2 = Simulation(tsys, ts, newton.stepper(tparams), base_f_ext=gravity_force(tsys))
    sim2.load_state(ckpt)
    assert sim2.step_count == 3 and torch.equal(sim2.state.x, x3)
    sim2.run(2)
    for k in ("x", "v", "lam", "u", "dv"):
        assert torch.equal(getattr(sim2.state, k), getattr(sim.state, k)), k

    jsim = JSimulation(jsys, jstate, j_newton.stepper(jparams), base_f_ext=j_gravity(jsys))
    jsim.run(2)
    jpath = str(tmp_path / "jax.npz")
    jsim.save_state(jpath)
    sim3 = Simulation(tsys, ts, newton.stepper(tparams))
    sim3.load_state(jpath)
    assert sim3.step_count == 2
    for k in ("x", "v", "lam", "u", "dv"):
        np.testing.assert_array_equal(getattr(sim3.state, k).numpy(),
                                      np.asarray(getattr(jsim.state, k)))
    jsim2 = JSimulation(jsys, jstate, j_newton.stepper(jparams))
    jsim2.load_state(ckpt)
    assert jsim2.step_count == 3
    np.testing.assert_array_equal(np.asarray(jsim2.state.x), x3.numpy())


def test_prescribed_motion_retargeting():
    """`tests/test_scene_io.py`'s retargeting test in the port: moving the
    pins' targets drags the pinned face (5 steps of 1e-4 m up), as in the
    JAX package, whose positions the port's match within 1e-10 of the
    displacement scale with equal counts."""
    nodes, fixed, jsys, jstate, _ = _jax_box()
    jparams = j_newton.NewtonParams(dt=1e-3, rho=1e10, inner_atol=1e-8, max_outer=3,
                                    max_inner=10)
    tsys, ts, tparams = _port(jsys, jstate, jparams)
    jsim = JSimulation(jsys, jstate, j_newton.stepper(jparams))
    tsim = Simulation(tsys, ts, newton.stepper(tparams))
    fem = tsim.system.fem
    target = np.asarray(nodes[fixed])
    for _ in range(5):
        target = target + np.array([0.0, 0.0, 1e-4])
        jsim.set_constraint_targets(target)
        tsim.set_constraint_targets(target)
        jd, td = jsim.step(), tsim.step()
        assert (td["newton_iters"], td["cg_iters"]) == (int(jd["newton_iters"]),
                                                         int(jd["cg_iters"]))
    assert tsim.system.fem is fem  # retargeting keeps the element operator
    x = tsim.state.x.numpy()
    np.testing.assert_allclose(x[fixed, 2], nodes[fixed, 2] + 5e-4, atol=1e-6)
    jx = np.asarray(jsim.state.x)
    assert np.abs(x - jx).max() < 1e-10 * np.abs(jx - nodes).max()
    with pytest.raises(ValueError, match="retargetable"):
        Simulation(tsys.replace(constraints=None), ts, newton.stepper(tparams)) \
            .set_constraint_targets(target)


def test_set_pinned_release():
    """`tests/test_dense_pins.py`'s release test in the port, on its problem
    (box 1 x 0.3 x 0.3, 4 x 2 x 2 cells, 50 N down on every node): pinned
    nodes hold while pinned and fall once `set_pinned` releases them, their
    duals and mask zeroed; the JAX package's Simulation agrees step for
    step (equal counts, 1e-10 of the displacement scale)."""
    nodes, conn = box_t10_mesh(1.0, 0.3, 0.3, 4, 2, 2)
    mat = JSVK(lam=jnp.asarray(LAM), mu=jnp.asarray(MU), eta_damp=jnp.asarray(1e2),
               lam_damp=jnp.asarray(1e2))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JDensePins.from_indices(fixed, nodes))
    jstate = JStepState.rest(jsys, nodes)
    f_ext = np.zeros((len(nodes), 3))
    f_ext[:, 2] = -50.0
    tsys, ts, _ = _port(jsys, jstate, None)
    assert isinstance(tsys.constraints, DensePins)
    rho = suggest_rho(tsys.elems, tsys.material, 1e-3)
    jparams = j_newton.NewtonParams(dt=1e-3, rho=rho, inner_atol=1e-8, max_outer=3,
                                    max_inner=12, cg_rtol=1e-6, cg_max_iter=200)
    tparams = _port(jsys, jstate, jparams)[2]
    jsim = JSimulation(jsys, jstate, j_newton.stepper(jparams), base_f_ext=jnp.asarray(f_ext))
    tsim = Simulation(tsys, ts, newton.stepper(tparams), base_f_ext=torch.as_tensor(f_ext))

    def steps(n):
        for _ in range(n):
            jd, td = jsim.step(), tsim.step()
            assert (td["newton_iters"], td["cg_iters"]) == (int(jd["newton_iters"]),
                                                             int(jd["cg_iters"]))

    steps(3)
    x0 = torch.as_tensor(nodes)
    pin_disp = float((tsim.state.x[fixed] - x0[fixed]).abs().max())
    assert pin_disp < 1e-2 * float((tsim.state.x - x0).abs().max())
    z_before = float(tsim.state.x[fixed, 2].mean())
    jsim.set_pinned(fixed, False)
    tsim.set_pinned(fixed, False)
    assert not bool(tsim.state.lam[fixed].any())
    assert not bool(tsim.system.constraints.mask[fixed].any())
    steps(5)
    assert float(tsim.state.x[fixed, 2].mean()) < z_before - max(2e-3, 3 * pin_disp)
    jx = np.asarray(jsim.state.x)
    assert np.abs(tsim.state.x.numpy() - jx).max() < 1e-10 * np.abs(jx - nodes).max()
    with pytest.raises(ValueError, match="DensePins"):
        Simulation(tsys.replace(constraints=FixedCoefs.from_indices(fixed, x0)), ts,
                   newton.stepper(tparams)).set_pinned(fixed)


def test_f_int_is_gradient_of_energy_svk_and_mr():
    """`tests/test_diagnostics.py` in the port: internal_force equals the
    autograd gradient of strain_energy, for SVK and Mooney-Rivlin, and both
    equal the JAX package's."""
    nodes, conn = box_t10_mesh(0.6, 0.3, 0.3, 2, 1, 1)
    elems = feat10.build(nodes, conn, rho=1000.0, device="cpu")
    jelems = j_feat10.build(nodes, conn, rho=1000.0)
    rng = np.random.default_rng(0)
    x = nodes + 0.03 * rng.standard_normal(nodes.shape)
    for mat, jmat in ((SVK(LAM, MU), JSVK(lam=LAM, mu=MU)),
                      (MooneyRivlin(3e5, 1e5, 1e7),
                       JMooneyRivlin(mu10=3e5, mu01=1e5, kappa=1e7))):
        f = assembly.internal_force(torch.as_tensor(x), None, elems, mat)
        xt = torch.as_tensor(x).requires_grad_(True)
        (f_ad,) = torch.autograd.grad(diagnostics.strain_energy(xt, elems, mat), xt)
        scale = float(f_ad.abs().max())
        np.testing.assert_allclose(f.numpy(), f_ad.numpy(), rtol=1e-7, atol=1e-9 * scale)
        jf = np.asarray(j_asm.internal_force(jnp.asarray(x), None, jelems, jmat))
        np.testing.assert_allclose(f.numpy(), jf, rtol=1e-12, atol=1e-12 * scale)
        w = float(diagnostics.strain_energy(torch.as_tensor(x), elems, mat))
        assert w == pytest.approx(float(j_diag.strain_energy(jnp.asarray(x), jelems, jmat)),
                                  rel=1e-12)


def test_momentum_conservation_free_fall():
    """`tests/test_diagnostics.py`'s free fall in the port: after 3 steps of
    `newton.step` under gravity alone, p_z = m 3 g dt and p_x, p_y ~ 0;
    energy_report equals the JAX package's at that state strained by 1e-3."""
    nodes, conn = box_t10_mesh(0.4, 0.2, 0.2, 1, 1, 1)
    system = System(elems=feat10.build(nodes, conn, rho=1000.0, device="cpu"),
                    material=SVK(LAM, MU))
    state = StepState.rest(system, torch.as_tensor(nodes))
    params = newton.NewtonParams(dt=1e-3, inner_atol=1e-10, max_outer=1, max_inner=8)
    f_ext = gravity_force(system)
    total_mass = float(diagnostics.linear_momentum(torch.ones_like(state.v), system.elems)[2])
    for _ in range(3):
        state, _ = newton.step(system, state, params, f_ext)
    p = diagnostics.linear_momentum(state.v, system.elems).numpy()
    np.testing.assert_allclose(p[2], total_mass * 3 * (-9.81) * 1e-3, rtol=1e-6)
    np.testing.assert_allclose(p[:2], 0.0, atol=1e-10 * abs(p[2]))

    jelems = j_feat10.build(nodes, conn, rho=1000.0)
    x = state.x.numpy() + 1e-3 * np.random.default_rng(0).standard_normal(nodes.shape)
    rep = diagnostics.energy_report(torch.as_tensor(x), state.v, system.elems, system.material)
    jrep = j_diag.energy_report(jnp.asarray(x), jnp.asarray(state.v.numpy()), jelems,
                                JSVK(lam=LAM, mu=MU))
    for k in ("kinetic", "strain", "momentum"):
        np.testing.assert_allclose(rep[k].numpy(), np.asarray(jrep[k]), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(np.asarray(jrep[k])).max()))


def test_assembly_helpers_match_jax():
    """deformation_gradient, velocity_gradient, total_piola (damped),
    internal_force, mass_matvec (1e-12) and assemble_mass_csr (equal
    indices, values to 1e-15) against the JAX package's."""
    nodes, conn = box_t10_mesh(0.6, 0.3, 0.3, 2, 1, 1)
    elems = feat10.build(nodes, conn, rho=1000.0, device="cpu")
    jelems = j_feat10.build(nodes, conn, rho=1000.0)
    rng = np.random.default_rng(1)
    x = nodes + 0.02 * rng.standard_normal(nodes.shape)
    v = rng.standard_normal(nodes.shape)
    mat, jmat = SVK(LAM, MU, 1e2, 3e2), JSVK(lam=LAM, mu=MU, eta_damp=1e2, lam_damp=3e2)
    tx, tv, jx, jv = torch.as_tensor(x), torch.as_tensor(v), jnp.asarray(x), jnp.asarray(v)
    pairs = (
        (assembly.deformation_gradient(tx, elems), j_asm.deformation_gradient(jx, jelems)),
        (assembly.velocity_gradient(tv, elems), j_asm.velocity_gradient(jv, jelems)),
        (assembly.total_piola(tx, tv, elems, mat), j_asm.total_piola(jx, jv, jelems, jmat)),
        (assembly.internal_force(tx, tv, elems, mat),
         j_asm.internal_force(jx, jv, jelems, jmat)),
        (assembly.mass_matvec(tv, elems), j_asm.mass_matvec(jv, jelems)),
    )
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(want).max()))
    for got, want in zip(assembly.assemble_mass_csr(elems), j_asm.assemble_mass_csr(jelems)):
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
    assert jax.config.jax_enable_x64
