"""The constraint families of the torch port (`tlfea_torch.constraints`:
`FixedCoefs`, `DensePins`, `LinearConstraints`, `LinearConstraintBuilder`,
`no_constraints`) and the solver paths that carry them, against the JAX
package in float64 on the CPU.

The JAX side runs its XLA path (`system.pallas=None`); the port's kernel
wrappers run their plain twins on CPU tensors. Each family's algebra
(`eval_c`, `eval_c_u`, `apply_jt`, `jtj_diag`, the target and mask
updates) agrees to 1e-14; a Newton step with `DensePins` (through the
resident entry, whose plain version runs here) and one with linear rows
(the composed path) agree with `newton.step` with identical Newton and CG
counts, positions within 1e-10 of the displacement scale; `g_and_hvp`
with linear rows against `jax.linearize(grad_L)` on the scene of
`tests/test_pallas_fem.py:199`, 1e-12; three VBD steps clamped by linear
rows on the scene of `tests/test_vbd.py:93`, 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.constraints import DensePins as JDensePins
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.constraints import LinearConstraintBuilder as JBuilder
from tlfea.constraints import no_constraints as j_no_constraints
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.solvers import vbd as j_vbd
from tlfea.solvers.coarse import build_coarse_precond as j_build_coarse
from tlfea.solvers.common import grad_L as j_grad_L
from tlfea.solvers.common import precond_blocks as j_precond_blocks
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.constraints import (DensePins, FixedCoefs, LinearConstraintBuilder,
                                     LinearConstraints, no_constraints)
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.ops import resident
from tlfea_torch.solvers import StepState, newton, vbd
from tlfea_torch.solvers.coarse import build_coarse_precond
from tlfea_torch.solvers.common import _pin_terms, grad_L, precond_blocks

torch.set_num_threads(2)

DT, RHO = 1e-3, 1e6
FAMILIES = ("fixed", "dense", "linear")


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _box():
    """The box of `tests/test_dense_pins.py` and `tests/test_pallas_fem.py`:
    1 x 0.3 x 0.3, 4 x 2 x 2 cells (96 FEAT10 elements), E 1e6, nu 0.3,
    eta = lam_d = 1e2."""
    nodes, conn = box_t10_mesh(1.0, 0.3, 0.3, 4, 2, 2)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu), eta_damp=jnp.asarray(1e2),
               lam_damp=jnp.asarray(1e2))
    return nodes, j_feat10.build(nodes, conn, rho=1000.0), mat


def _rows(builder, nodes, clamp=()):
    """`tests/test_pallas_fem.py:199`'s rows (a fixed DOF, a welded pair and
    a general row), after fix_dof rows clamping the coefficients `clamp`."""
    for i in clamp:
        for d in range(3):
            builder.fix_dof(int(i), d, float(nodes[i, d]))
    far = np.argsort(-nodes[:, 0], kind="stable")[:5]  # away from any clamp
    builder.fix_dof(int(far[0]), 2, float(nodes[far[0], 2]))
    builder.equate_dofs(int(far[1]), int(far[2]))
    builder.add_row([int(far[3]) * 3 + 0, int(far[4]) * 3 + 1], [0.5, -2.0], 0.1)
    return builder


def _both(family, nodes, idx):
    """The same constraints in both packages: (JAX, port)."""
    x0 = _t(nodes)
    if family == "fixed":
        return JFixedCoefs.from_indices(idx, nodes), FixedCoefs.from_indices(idx, x0)
    if family == "dense":
        return JDensePins.from_indices(idx, nodes), DensePins.from_indices(idx, x0)
    return (_rows(JBuilder(), nodes, idx[:2]).build(),
            _rows(LinearConstraintBuilder(), nodes, idx[:2]).build(device="cpu"))


@pytest.fixture(scope="module")
def box():
    return _box()


@pytest.mark.parametrize("family", FAMILIES)
def test_family_algebra_matches_jax(box, family):
    nodes, elems, _ = box
    n = len(nodes)
    rng = np.random.default_rng(7)
    idx = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jc, tc = _both(family, nodes, idx)
    x_ref = np.asarray(elems.x_ref)
    x = nodes + 0.01 * rng.normal(size=nodes.shape)
    u = x - x_ref
    y = rng.normal(size=np.asarray(jc.eval_c(x)).shape)
    checks = {
        "eval_c": (jc.eval_c(x), tc.eval_c(_t(x))),
        "eval_c_u": (jc.eval_c_u(u, x_ref), tc.eval_c_u(_t(u), _t(x_ref))),
        "apply_jt": (jc.apply_jt(jnp.asarray(y), n), tc.apply_jt(_t(y), n)),
        "jtj_diag": (jc.jtj_diag(n, jnp.float64), tc.jtj_diag(n, torch.float64)),
    }
    target = np.asarray(jc.target if family != "linear" else jc.b) + 1e-3
    if family != "linear":
        checks["with_targets"] = (jc.with_targets(target).eval_c(x),
                                  tc.with_targets(_t(target)).eval_c(_t(x)))
    for name, (want, got) in checks.items():
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float64, name
        assert np.abs(got.numpy() - want).max() <= 1e-14 * max(np.abs(want).max(), 1.0), name
    assert tc.n_constraints == jc.n_constraints


def test_dense_pins_updates_match_jax(box):
    """with_mask and pinning (pin with x0: the new pins hold where they are;
    release) against the JAX package's, exactly."""
    nodes, _, _ = box
    idx = np.nonzero(nodes[:, 0] < 1e-12)[0]
    far = np.nonzero(nodes[:, 0] > 1.0 - 1e-12)[0]
    jc, tc = _both("dense", nodes, idx)
    x1 = nodes + 0.02
    cases = [(jc.pinning(far, True, x0=x1), tc.pinning(far, True, x0=_t(x1))),
             (jc.pinning(far, True), tc.pinning(far, True)),
             (jc.pinning(idx[:3], False), tc.pinning(idx[:3], False))]
    mask = np.zeros((len(nodes), 1))
    mask[far] = 1.0
    cases.append((jc.with_mask(mask), tc.with_mask(_t(mask))))
    for jd, td in cases:
        np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
        np.testing.assert_array_equal(td.target.numpy(), np.asarray(jd.target))
    assert np.abs(cases[0][1].eval_c(_t(x1)).numpy()[far]).max() == 0.0


@pytest.mark.parametrize("family", FAMILIES + ("none",))
def test_rest_duals_and_no_constraints(box, family):
    """StepState.rest's duals take eval_c's shape: (C, 3), (n, 3), (n_rows,),
    or (0,) without constraints (`no_constraints()` is None in both)."""
    nodes, elems, mat = box
    idx = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jc, tc = (j_no_constraints(), no_constraints()) if family == "none" else _both(
        family, nodes, idx)
    assert (jc is None) == (tc is None) == (family == "none")
    jst = JStepState.rest(JSystem(elems=elems, material=mat, constraints=jc), nodes)
    tsys, _, _ = from_numpy_system(elems, mat, jc, device="cpu")
    tst = StepState.rest(tsys, _t(nodes))
    assert tuple(tst.lam.shape) == np.asarray(jst.lam).shape
    assert float(tst.lam.abs().sum()) == 0.0


@pytest.mark.parametrize("family", FAMILIES)
def test_interop_round_trip(box, family):
    nodes, elems, mat = box
    jc, _ = _both(family, nodes, np.nonzero(nodes[:, 0] < 1e-12)[0])
    tsys, _, _ = from_numpy_system(elems, mat, jc, device="cpu")
    tc = tsys.constraints
    cls = {"fixed": FixedCoefs, "dense": DensePins, "linear": LinearConstraints}[family]
    assert type(tc) is cls
    names = {"fixed": ("idx", "target"), "dense": ("mask", "target"),
             "linear": ("rows", "cols", "vals", "b")}[family]
    for name in names:
        t = getattr(tc, name)
        assert t.dtype == (torch.int64 if name in ("idx", "rows", "cols") else torch.float64)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jc, name)))
    if family == "linear":
        assert tc.n_rows == jc.n_rows

    class Welds:
        pairs = np.zeros((2, 2), np.int64)

    with pytest.raises(TypeError, match="no counterpart in the port for constraints Welds"):
        from_numpy_system(elems, mat, Welds(), device="cpu")


def test_resident_gate_admits_dense_pins_only(box):
    """The resident gate takes what the JAX gate's `cons_dense_ok` takes:
    constraint terms that are dense fields (FixedCoefs, DensePins), not the
    callable J^T J of linear rows."""
    nodes, elems, mat = box
    idx = np.nonzero(nodes[:, 0] < 1e-12)[0]
    for family, ok in (("fixed", True), ("dense", True), ("linear", False)):
        tsys, _, _ = from_numpy_system(elems, mat, _both(family, nodes, idx)[0], device="cpu")
        assert resident.eligible(tsys, None) is ok, family
        lam = StepState.rest(tsys, _t(nodes)).lam
        lin = _pin_terms(tsys, lam, DT, RHO, torch.float64)[1]
        assert callable(lin) is not ok, family


def _params(**kw):
    prm = dict(dt=DT, rho=RHO, inner_atol=1e-6, max_outer=2, max_inner=6, cg_rtol=1e-6,
               cg_max_iter=100)
    prm.update(kw)
    return j_newton.NewtonParams(**prm)


def _grav(nodes, f_z=-50.0):
    return jnp.zeros((len(nodes), 3)).at[:, 2].add(f_z)


def _step_both(jcons, box, f_z=-50.0, params=None):
    """One `newton.step` in JAX and one port `make_step` on the box under
    jcons (the port's from interop): ((JAX state, diag), (port system,
    state, diag))."""
    nodes, elems, mat = box
    jsys = JSystem(elems=elems, material=mat, constraints=jcons)
    jst = JStepState.rest(jsys, nodes)
    jprm = params or _params()
    f_ext = _grav(nodes, f_z)
    js, jd = j_newton.step(jsys, jst, jprm, f_ext)
    tsys, tst, tprm = from_numpy_system(elems, mat, jcons, jst, jprm, device="cpu")
    ts, td = newton.make_step(tsys, tprm)(tst, _t(f_ext))
    return (js, jd), (tsys, ts, td)


def _same_step(j, t, nodes):
    (js, jd), (_, ts, td) = j, t
    scale = np.abs(np.asarray(js.x) - nodes).max()
    assert scale > 0
    assert np.abs(ts.x.numpy() - np.asarray(js.x)).max() / scale < 1e-10
    for key in ("outer_iters", "newton_iters", "cg_iters"):
        assert td[key] == int(jd[key]), key
    assert td["cg_iters"] > 0


def test_newton_step_dense_pins(box):
    """DensePins through the resident entry (its plain version here) against
    `newton.step`, against the port's FixedCoefs on the same pins, and
    after retargeting (prescribed motion)."""
    nodes = box[0]
    idx = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jdp = JDensePins.from_indices(idx, nodes)
    j, t = _step_both(jdp, box)
    _same_step(j, t, nodes)
    tsys, ts, _ = t
    assert resident.eligible(tsys, None)
    unpinned = np.setdiff1d(np.arange(len(nodes)), idx)
    assert float(ts.lam[unpinned].abs().max()) == 0.0
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(j[0].lam), rtol=1e-8,
                               atol=1e-10 * float(ts.lam.abs().max()))
    fc = from_numpy_system(box[1], box[2], JFixedCoefs.from_indices(idx, nodes),
                           JStepState.rest(JSystem(elems=box[1], material=box[2],
                                                   constraints=JFixedCoefs.from_indices(
                                                       idx, nodes)), nodes),
                           _params(), device="cpu")
    tfc, _ = newton.make_step(fc[0], fc[2])(fc[1], _t(_grav(nodes)))
    scale = float((tfc.x - _t(nodes)).abs().max())
    assert float((ts.x - tfc.x).abs().max()) / scale < 1e-10
    np.testing.assert_allclose(ts.lam.numpy()[idx], tfc.lam.numpy(), rtol=1e-8,
                               atol=1e-10 * float(tfc.lam.abs().max()))
    moved = np.asarray(jdp.target) + np.array([0.0, 0.0, 1e-3])
    j2, t2 = _step_both(jdp.with_targets(moved), box)
    _same_step(j2, t2, nodes)
    assert float((t2[1].x - ts.x).abs().max()) > 1e-5


def test_newton_step_linear_rows(box):
    """Linear rows (fix_dof clamps of the x=0 face, a welded pair, a fixed
    DOF and a general row) through the composed path against `newton.step`;
    its block-Jacobi blocks against `precond_blocks` (per-DOF J^T J)."""
    nodes, elems, mat = box
    jcons = _rows(JBuilder(), nodes, np.nonzero(nodes[:, 0] < 1e-12)[0]).build()
    j, t = _step_both(jcons, box)
    _same_step(j, t, nodes)
    tsys, ts, _ = t
    assert not resident.eligible(tsys, None)
    assert tuple(ts.lam.shape) == (jcons.n_rows,)
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(j[0].lam), rtol=1e-8,
                               atol=1e-10 * float(ts.lam.abs().max()))
    jsys = JSystem(elems=elems, material=mat, constraints=jcons)
    v = np.random.default_rng(3).normal(size=nodes.shape) * 0.1
    want = jax.jit(lambda vv, xx: j_precond_blocks(vv, xx, DT, RHO, jsys))(jnp.asarray(v),
                                                                          jnp.asarray(nodes))
    got = precond_blocks(_t(v), _t(nodes), DT, RHO, tsys)
    assert _rel(got.numpy(), want) < 1e-12


def test_coarse_with_linear_rows(box):
    """The frozen coarse correction takes the per-DOF penalty of linear rows."""
    nodes, elems, mat = box
    jcons = _rows(JBuilder(), nodes, np.nonzero(nodes[:, 0] < 1e-12)[0]).build()
    jsys = JSystem(elems=elems, material=mat, constraints=jcons)
    tsys, _, _ = from_numpy_system(elems, mat, jcons, device="cpu")
    jco = j_build_coarse(jsys, jnp.asarray(nodes), DT, RHO)
    tco = build_coarse_precond(tsys, _t(nodes), DT, RHO)
    r = np.random.default_rng(2).normal(size=nodes.shape)
    assert _rel(tco.apply(_t(r)).numpy(), jco.apply(jnp.asarray(r))) < 1e-10


def _linearize_inputs(nodes, n_rows):
    rng = np.random.default_rng(5)
    x_prev = nodes + 0.01 * rng.standard_normal(nodes.shape)
    v_prev, v, p, f_ext = (rng.standard_normal(nodes.shape) for _ in range(4))
    return x_prev, v_prev, v, p, f_ext, rng.standard_normal((n_rows,))


def test_g_and_hvp_linear_rows_matches_jax(box):
    """`tests/test_pallas_fem.py:199`'s rows: g_and_hvp (K1 + K4 and K2 + K4
    twins, the rows through `_pin_terms`) against jax.linearize(grad_L),
    and grad_L with its torch.func.jvp (K5 + K4, K5t + K4 twins) against
    jax.jvp."""
    nodes, elems, mat = box
    jcons = _rows(JBuilder(), nodes).build()
    jsys = JSystem(elems=elems, material=mat, constraints=jcons)
    tsys, _, _ = from_numpy_system(elems, mat, jcons, device="cpu")
    x_prev, v_prev, v, p, f_ext, lam = _linearize_inputs(nodes, jcons.n_rows)

    @jax.jit
    def linearized(vv, pp):
        g_of = lambda w: j_grad_L(w, jnp.asarray(x_prev), jnp.asarray(v_prev), jnp.asarray(lam),
                                  jnp.asarray(f_ext), DT, RHO, jsys)
        g, hvp_of = jax.linearize(g_of, vv)
        return g, hvp_of(pp)

    g_ref, h_ref = linearized(jnp.asarray(v), jnp.asarray(p))
    x_ref = tsys.elems.x_ref
    pins = _pin_terms(tsys, _t(lam), DT, RHO, torch.float64)
    g, hvp = fk.g_and_hvp(_t(v), _t(x_prev) - x_ref, _t(v_prev), _t(f_ext), DT, tsys.fem, pins)
    assert _rel(g.numpy(), g_ref) < 1e-12
    assert _rel(hvp(_t(p)).numpy(), h_ref) < 1e-12
    g2, h2 = torch.func.jvp(lambda vv: grad_L(vv, _t(x_prev), _t(v_prev), _t(lam), _t(f_ext),
                                              DT, RHO, tsys), (_t(v),), (_t(p),))
    assert _rel(g2.numpy(), g_ref) < 1e-12
    assert _rel(h2.numpy(), h_ref) < 1e-12


def test_dense_pins_gradient_and_jvp_match_jax(box):
    """grad_L and its torch.func.jvp with DensePins and dense random duals
    against the JAX package's."""
    nodes, elems, mat = box
    jcons = JDensePins.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], nodes)
    jsys = JSystem(elems=elems, material=mat, constraints=jcons)
    tsys, _, _ = from_numpy_system(elems, mat, jcons, device="cpu")
    x_prev, v_prev, v, p, f_ext, _ = _linearize_inputs(nodes, 0)
    lam = np.random.default_rng(6).normal(size=nodes.shape) * np.asarray(jcons.mask)
    g_ref, h_ref = jax.jit(lambda vv, pp: jax.jvp(
        lambda w: j_grad_L(w, jnp.asarray(x_prev), jnp.asarray(v_prev), jnp.asarray(lam),
                           jnp.asarray(f_ext), DT, RHO, jsys), (vv,), (pp,)))(
        jnp.asarray(v), jnp.asarray(p))
    g, h = torch.func.jvp(lambda vv: grad_L(vv, _t(x_prev), _t(v_prev), _t(lam), _t(f_ext),
                                            DT, RHO, tsys), (_t(v),), (_t(p),))
    assert _rel(g.numpy(), g_ref) < 1e-12
    assert _rel(h.numpy(), h_ref) < 1e-12


def test_vbd_linear_rows_match_jax():
    """`tests/test_vbd.py:93`'s clamped beam (fix_dof rows at x=0): three VBD
    steps in both packages, identical outer and sweep counts, positions
    within 1e-9 of the displacement scale."""
    nodes, conn = box_t10_mesh(0.6, 0.2, 0.2, 3, 1, 1)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = JSVK(lam=lam, mu=mu, eta_damp=1e2, lam_damp=1e2)
    b = JBuilder()
    for i in np.nonzero(nodes[:, 0] < 1e-12)[0]:
        for d in range(3):
            b.fix_dof(int(i), d, float(nodes[i, d]))
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=b.build())
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    jprm = j_vbd.VBDParams(dt=2e-3, rho=1e7, inner_tol=1e-8, max_outer=3, max_sweeps=200)
    jstate = JStepState.rest(jsys, nodes)
    tsys, tstate, tprm = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, jstate,
                                           jprm, device="cpu")
    jstep, tstep = j_vbd.make_step(jsys, jprm), vbd.make_step(tsys, tprm)
    for _ in range(3):
        jstate, jd = jstep(jstate, f_ext)
        tstate, td = tstep(tstate, _t(f_ext))
        assert td["outer_iters"] == int(jd["outer_iters"])
        assert td["sweeps"] == int(jd["sweeps"])
    scale = np.abs(np.asarray(jstate.x) - nodes).max()
    assert np.abs(tstate.x.numpy() - np.asarray(jstate.x)).max() / scale < 1e-9
    clamped = np.nonzero(nodes[:, 0] < 1e-12)[0]
    assert np.abs(tstate.x.numpy()[clamped] - nodes[clamped]).max() < 5e-4
