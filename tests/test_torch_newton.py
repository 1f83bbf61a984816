"""Newton-PCG step and rollout of the torch port (`tlfea_torch.solvers`)
against the JAX package, in float64 on the CPU.

The JAX side runs its XLA path (`system.pallas=None`, Hv from
`jax.linearize(grad_L)`); the port runs its kernel wrappers, which take the
plain twins on the CPU. Both start from the same arrays (built by JAX and
handed over through `tlfea_torch.interop.from_numpy_system`). Positions
must agree within 1e-10 of the displacement scale, with the same Newton
and CG counts: the two run the same algorithm, and differ only in the
summation order of float64 sums.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.materials import SVK as JSVK
from tlfea.materials import MooneyRivlin as JMooneyRivlin
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.solvers.coarse import build_coarse_precond as j_build_coarse
from tlfea.utils.reorder import apply_node_order, best_order
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import SVK, MooneyRivlin
from tlfea_torch.solvers import newton
from tlfea_torch.solvers.coarse import build_coarse_precond

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")


def _jax_problem(box, E=1e7, rho_pen=1e7, **kw):
    """The bench.py problem at a small size (float64): band-minimised box,
    damped SVK, the x=0 face pinned, gravity."""
    nodes, conn = box_t10_mesh(*box)
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
    lam, mu = lame_from_E_nu(E, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
               eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(1e3))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                     constraints=JFixedCoefs.from_indices(fixed, nodes))
    state = JStepState.rest(system, nodes)
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(system.elems) * -9.81)
    fs = float(jnp.linalg.norm(f_ext))
    prm = dict(dt=1e-3, rho=rho_pen, inner_atol=1e-3 * fs, inner_rtol=0.0, outer_tol=1e-9,
               max_outer=2, max_inner=6, cg_rtol=1e-3, cg_max_iter=50, ew_eta_max=0.5)
    prm.update(kw)
    params = j_newton.NewtonParams(**prm)
    return nodes, system, state, f_ext, params


@pytest.fixture(scope="module")
def prob():
    nodes, jsys, jstate, f_ext, jparams = _jax_problem((1.0, 0.2, 0.2, 4, 1, 1))
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    return nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext


def _assert_same_positions(t_x, j_x, nodes):
    j_x = np.asarray(j_x)
    scale = np.abs(j_x - nodes).max()
    assert scale > 0
    err = np.abs(t_x.numpy() - j_x).max() / scale
    assert err < 1e-10, err


def test_one_step_matches_jax(prob):
    nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext = prob
    js, jd = j_newton.make_step(jsys, jparams)(jstate, f_ext)
    ts, td = newton.make_step(tsys, tparams)(tstate, torch.as_tensor(np.array(f_ext)))
    _assert_same_positions(ts.x, js.x, nodes)
    for key in ("outer_iters", "newton_iters", "cg_iters"):
        assert td[key] == int(jd[key]), key
    assert td["cg_iters"] > 0
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(js.lam), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(td["norm_g_history"].numpy(), np.asarray(jd["norm_g_history"]),
                               rtol=1e-9)


@pytest.mark.parametrize("coarse", [False, True])
def test_rollout_matches_jax(prob, coarse):
    """3 steps with the block-Jacobi preconditioner refreshed every 2, with
    and without the frozen coarse correction."""
    nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext = prob
    jco = tco = None
    if coarse:
        jco = j_build_coarse(jsys, jstate.x, float(jparams.dt), float(jparams.rho))
        tco = build_coarse_precond(tsys, tstate.x, tparams.dt, tparams.rho)
        r = np.random.default_rng(2).normal(size=nodes.shape)
        np.testing.assert_allclose(tco.apply(torch.as_tensor(r)).numpy(),
                                   np.asarray(jco.apply(jnp.asarray(r))), rtol=1e-10,
                                   atol=1e-12 * np.abs(np.asarray(jco.apply(jnp.asarray(r)))).max())
    js, (jn, jc) = j_newton.make_rollout(jsys, jparams, 3, coarse=jco,
                                         precond_refresh=2)(jstate, f_ext)
    ts, (tn, tc) = newton.make_rollout(tsys, tparams, 3, coarse=tco,
                                       precond_refresh=2)(tstate,
                                                          torch.as_tensor(np.array(f_ext)))
    _assert_same_positions(ts.x, js.x, nodes)
    assert tn == np.asarray(jn).tolist()
    assert tc == np.asarray(jc).tolist()
    np.testing.assert_allclose(ts.u.numpy(), ts.x.numpy() - nodes, atol=1e-15)


def test_interop_round_trip(prob):
    nodes, (jsys, jstate, jparams), _, _ = prob
    for dtype in (torch.float64, torch.float32):
        tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                                  jstate, jparams, device="cpu", dtype=dtype)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        e, je = tsys.elems, jsys.elems
        for name in ("grad_N", "dV", "mass_elem", "xe_ref", "x_ref"):
            t = getattr(e, name)
            assert t.dtype == dtype and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(je, name)).astype(np_dtype))
        np.testing.assert_array_equal(e.conn.numpy(), np.asarray(je.conn))
        assert e.n_coef == je.n_coef and e.trans_mask == je.trans_mask
        np.testing.assert_array_equal(tsys.constraints.idx.numpy(), np.asarray(jsys.constraints.idx))
        for name in ("x", "v", "lam", "u", "dv"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                          np.asarray(getattr(jstate, name)).astype(np_dtype))
        for name in ("dt", "rho", "inner_atol", "cg_rtol", "predict", "ew_eta_max"):
            assert getattr(tparams, name) == float(np.asarray(getattr(jparams, name)))
        for name in ("max_outer", "max_inner", "cg_max_iter", "ls_max"):
            assert getattr(tparams, name) == getattr(jparams, name)
        m = tsys.material
        assert type(m) is SVK and tsys.fem.kind == "svk"
        assert (m.lam, m.mu, m.eta_damp, m.lam_damp) == tuple(
            float(getattr(jsys.material, k)) for k in ("lam", "mu", "eta_damp", "lam_damp"))
    with pytest.raises(ValueError, match="max_dv"):
        from_numpy_system(jsys.elems, jsys.material, params=jparams.replace(max_dv=1.0),
                          device="cpu")
    # A JAX MooneyRivlin has small-strain `lam` and `mu` properties; it must
    # come over as the port's MooneyRivlin with equal fields, not as an SVK.
    fields = ("mu10", "mu01", "kappa", "eta_damp", "lam_damp")
    jmr = JMooneyRivlin(mu10=jnp.asarray(1.5e6), mu01=jnp.asarray(4e5), kappa=jnp.asarray(8e6),
                        eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(2e3))
    tsys, _, _ = from_numpy_system(jsys.elems, jmr, jsys.constraints, device="cpu")
    m = tsys.material
    assert type(m) is MooneyRivlin and tsys.fem.kind == "mr"
    assert tuple(getattr(m, k) for k in fields) == tuple(float(getattr(jmr, k)) for k in fields)
    assert (m.lam, m.mu) == pytest.approx((float(jmr.lam), float(jmr.mu)), rel=1e-15)

    class NotAMaterial:
        lam, mu, eta_damp, lam_damp = 1.0, 1.0, 0.0, 0.0

    with pytest.raises(TypeError, match="no counterpart in the port for material NotAMaterial"):
        from_numpy_system(jsys.elems, NotAMaterial(), device="cpu")


def test_import_leaves_jax_out():
    code = ("import sys, tlfea_torch, tlfea_torch.ops.fem_kernels, tlfea_torch.interop, "
            "tlfea_torch.elements.ancf, tlfea_torch.elements.ancf3243, "
            "tlfea_torch.elements.ancf3443, tlfea_torch.solvers.coarse, "
            "tlfea_torch.ops.resident, tlfea_torch.solvers.adamw, tlfea_torch.solvers.nesterov, "
            "tlfea_torch.solvers.vbd, tlfea_torch.utils.coloring, "
            "tlfea_torch.materials.mooney_rivlin, tlfea_torch.ops.hv_phases, "
            "tlfea_torch.tools.ablate_hv, tlfea_torch.diagnostics, tlfea_torch.simulation, "
            "tlfea_torch.elements.assembly, tlfea_torch.utils.tetmesh, "
            "tlfea_torch.utils.profiling, tlfea_torch.utils.io_vtk, "
            "tlfea_torch.utils.mesh_manager, tlfea_torch.utils.pressure, "
            "tlfea_torch.utils.ancf_mesh, tlfea_torch.utils.cli; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tlfea.'))); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.slow
def test_beam_sag_trajectory_matches_fixture():
    """The 150-step damped cantilever of `tests/fixtures/generate.py` in
    float64 through the port: within 1e-9 of the displacement scale, the
    bar the JAX float64 trajectory is held to."""
    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.materials import SVK
    from tlfea_torch.solvers import StepState, System
    from tlfea_torch.utils import tetmesh

    nodes, conn = tetmesh.box_t10_mesh(1.0, 0.1, 0.1, 10, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    x0 = torch.as_tensor(nodes)
    system = System(elems=feat10.build(nodes, conn, rho=1000.0, device="cpu"),
                    material=SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    f_ext = torch.zeros_like(x0)
    f_ext[:, 2] = lumped_mass(system.elems) * -9.81
    step = newton.make_step(system, newton.NewtonParams(
        dt=1e-3, rho=1e8, inner_atol=1e-8, inner_rtol=1e-10, outer_tol=1e-10, max_outer=2,
        max_inner=10, cg_rtol=1e-6, cg_max_iter=500, ew_eta_max=0.0))
    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    state = StepState.rest(system, x0)
    rows = []
    for _ in range(150):
        state, _ = step(state, f_ext)
        rows.append(state.x[tip].numpy())
    ref = np.loadtxt(os.path.join(FIXDIR, "beam_sag_t10_tip.csv"), delimiter=",", skiprows=1)
    scale = np.abs(ref[:, 1:4] - nodes[tip]).max()
    assert np.abs(np.asarray(rows) - ref[:, 1:4]).max() < 1e-9 * scale
