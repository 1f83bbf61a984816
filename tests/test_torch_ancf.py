"""ANCF elements through the torch port (`tlfea_torch.elements.ancf*`, and
the FEM kernels' ANCF3243 and ANCF3443 instantiations), in float64 on the
CPU against the JAX package.

The JAX side runs its XLA path (`system.pallas=None`): its Pallas ANCF
kernels take more than an hour in interpret mode on a 2-element strip
(`tests/test_pallas_ancf.py`), and they match the XLA path to about 2e-16.
The port's wrappers run their plain twins on the CPU. Tolerances: tables to
1e-14 (the same NumPy code), kernel twins to 1e-12 relative (the same
float64 arithmetic in another summation order), steps and rollouts to 1e-10
of the coordinate scale with identical Newton and CG counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements import ancf3443 as j_ancf3443
from tlfea.elements.assembly import _element_contrib_values
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.solvers.coarse import build_coarse_precond as j_build_coarse
from tlfea.solvers.common import grad_L, precond_blocks as j_precond_blocks
from tlfea_torch.elements import ancf3243, ancf3443
from tlfea_torch.elements.assembly import ElementBatch
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers import System, newton
from tlfea_torch.solvers.coarse import build_coarse_precond
from tlfea_torch.solvers.common import precond_blocks
from tlfea_torch.solvers.newton import _pin_terms

torch.set_num_threads(2)

DT, RHO = 1e-3, 1e7
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _mesh(family):
    """(coefs, conn, extents, JAX module) of the small meshes."""
    if family == "ancf3443":
        coefs, conn = j_ancf3443.shell_grid(3, 2, L=0.05, W=0.05)
        return coefs, conn, (0.05, 0.05, 0.01), j_ancf3443
    coefs, conn = j_ancf3243.straight_beam(4, L=0.5)
    return coefs, conn, (0.5, 0.05, 0.05), j_ancf3243


def _clamped_system(family):
    """JAX system of the bench.py shell problem at a small size: damped SVK,
    the first node column clamped (all 4 coefficient rows), float64."""
    coefs, conn, (L, W, H), jmod = _mesh(family)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
               eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(1e3))
    pos = coefs[0::4, 0]
    edge = np.nonzero(pos < pos.min() + 1e-12)[0]
    fixed = (4 * edge[:, None] + np.arange(4)[None, :]).reshape(-1)
    jsys = JSystem(elems=jmod.build(coefs, conn, L, W, H, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, coefs))
    return coefs, jsys


@pytest.fixture(scope="module", params=["ancf3243", "ancf3443"])
def prob(request):
    coefs, jsys = _clamped_system(request.param)
    tsys, _, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, device="cpu")
    n = len(coefs)
    rng = np.random.default_rng(5)
    d = dict(
        u_prev=rng.normal(size=(n, 3)) * 1e-3, v=rng.normal(size=(n, 3)) * 0.1,
        v_prev=rng.normal(size=(n, 3)) * 0.1, p=rng.normal(size=(n, 3)),
        lam=rng.normal(size=(int(jsys.constraints.idx.shape[0]), 3)),
        f_ext=rng.normal(size=(n, 3)),
    )
    return jsys, tsys, coefs, d


@pytest.mark.parametrize("family", ["ancf3243", "ancf3443"])
def test_ancf_tables_equal_jax(family):
    if family == "ancf3443":
        coefs, conn = j_ancf3443.shell_grid(2, 2)
        t_mesh = ancf3443.shell_grid(2, 2)
        jmod, tmod, ext = j_ancf3443, ancf3443, (1.0, 1.0, 0.02)
    else:
        coefs, conn = j_ancf3243.straight_beam(4)
        t_mesh = ancf3243.straight_beam(4)
        jmod, tmod, ext = j_ancf3243, ancf3243, (2.0, 0.1, 0.1)
    for a, b in zip(t_mesh, (coefs, conn)):
        np.testing.assert_array_equal(a, b)
    je = jmod.build(coefs, conn, *ext, rho=1000.0)
    te = tmod.build(coefs, conn, *ext, rho=1000.0, device="cpu")
    for name in ("grad_N", "dV", "mass_elem", "xe_ref", "x_ref"):
        t = getattr(te, name)
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        assert _rel(t.numpy(), getattr(je, name)) <= 1e-14, name
    np.testing.assert_array_equal(te.conn.numpy(), np.asarray(je.conn))
    assert te.n_coef == je.n_coef and te.trans_mask == je.trans_mask
    assert te.trans_mask == tuple(a % 4 == 0 for a in range(te.n_shape))
    if family == "ancf3243":
        for a, b in zip(ancf3243.grid_mesh(1.0, 0.5, 0.25), j_ancf3243.grid_mesh(1.0, 0.5, 0.25)):
            np.testing.assert_array_equal(a, b)
    else:
        for a, b in zip(ancf3443.shell_strip(3), j_ancf3443.shell_strip(3)):
            np.testing.assert_array_equal(a, b)


def _packed(d):
    u = d["u_prev"] + DT * d["v"]
    return u, np.concatenate([u, d["v"], (d["v"] - d["v_prev"]) / DT], axis=1)


def _jax_grad_L(jsys, coefs, d):
    def g(v):
        return grad_L(v, jnp.asarray(coefs + d["u_prev"]), jnp.asarray(d["v_prev"]),
                      jnp.asarray(d["lam"]), jnp.asarray(d["f_ext"]), DT, RHO, jsys,
                      u_prev=jnp.asarray(d["u_prev"]))
    return g


def _slots(ref, op, C=3):
    """JAX per-element values (E, S, C) -> the kernels' (S*C, E) layout."""
    return np.transpose(np.asarray(ref), (1, 2, 0)).reshape(op.S * C, op.E)


def test_primal_prep_twin_matches_jax(prob):
    jsys, tsys, coefs, d = prob
    op = tsys.fem
    u, packed = _packed(d)
    fe, _ = fk.primal_prep_plain(op, _t(packed))
    ref = _element_contrib_values(jnp.asarray(u), jnp.asarray(d["v"]),
                                  jnp.asarray((d["v"] - d["v_prev"]) / DT), jsys.elems,
                                  jsys.material)
    assert _rel(fe.numpy(), _slots(ref, op)) < RTOL
    pins = _pin_terms(tsys, _t(d["lam"]), DT, RHO, torch.float64)
    g, _ = fk.g_and_hvp(_t(d["v"]), _t(d["u_prev"]), _t(d["v_prev"]), _t(d["f_ext"]), DT,
                        op, pins)
    assert _rel(g.numpy(), _jax_grad_L(jsys, coefs, d)(jnp.asarray(d["v"]))) < RTOL


def test_hv_twin_matches_jax_linearize(prob):
    jsys, tsys, coefs, d = prob
    op = tsys.fem
    pins = _pin_terms(tsys, _t(d["lam"]), DT, RHO, torch.float64)
    _, hvp = fk.g_and_hvp(_t(d["v"]), _t(d["u_prev"]), _t(d["v_prev"]), _t(d["f_ext"]), DT,
                          op, pins)
    _, f_jvp = jax.linearize(_jax_grad_L(jsys, coefs, d), jnp.asarray(d["v"]))
    assert _rel(hvp(_t(d["p"])).numpy(), f_jvp(jnp.asarray(d["p"]))) < RTOL

    def contrib(v):
        return _element_contrib_values(jnp.asarray(d["u_prev"]) + DT * v, v,
                                       (v - jnp.asarray(d["v_prev"])) / DT, jsys.elems,
                                       jsys.material)

    _, ref = jax.jvp(contrib, (jnp.asarray(d["v"]),), (jnp.asarray(d["p"]),))
    _, packed = _packed(d)
    _, prep = fk.primal_prep_plain(op, _t(packed))
    assert _rel(fk.hv_plain(op, _t(d["p"]), prep, DT).numpy(), _slots(ref, op)) < RTOL


def test_svk_blocks_twin_matches_precond_blocks(prob):
    jsys, tsys, coefs, d = prob
    x_prev = coefs + d["u_prev"]
    want = j_precond_blocks(jnp.asarray(d["v"]), jnp.asarray(x_prev), DT, RHO, jsys,
                            u_prev=jnp.asarray(d["u_prev"]))
    got = precond_blocks(_t(d["v"]), _t(x_prev), DT, RHO, tsys, u_prev=_t(d["u_prev"]))
    assert _rel(got.numpy(), want) < RTOL

    # Per element and slot: K3 against the einsum branch before its scatter,
    # which does not centre at all (centring translation slots is exact).
    op = tsys.fem
    u = jnp.asarray(d["u_prev"] + DT * d["v"])
    F = jnp.einsum("eai,eqaj->eqij", u[jsys.elems.conn], jsys.elems.grad_N) + jnp.eye(3)
    Kb = jsys.material.tangent_diag_block(F[:, :, None], jsys.elems.grad_N)
    Kb = (Kb * jsys.elems.dV[:, :, None, None, None]).sum(axis=1)  # (E, S, 3, 3)
    ref = np.stack([Kb[..., a, b] for a, b in fk.SYM6], axis=-1)
    got = fk.svk_blocks_plain(op, _t(d["u_prev"] + DT * d["v"]))
    assert _rel(got.numpy(), _slots(ref, op, 6)) < RTOL

    vals = np.random.default_rng(9).normal(size=(op.E, op.S, 6))
    want = jnp.zeros((op.n, 6)).at[jsys.elems.conn.reshape(-1)].add(vals.reshape(-1, 6))
    assert _rel(fk.node_reduce_plain(op, _t(_slots(vals, op, 6))).numpy(), want) < RTOL


def test_twins_leave_gradient_slots_uncentred(prob):
    """A rigid translation moves only the position coefficients; the
    gradient coefficients (r_u, r_v, r_w) stay. It strains nothing: zero
    force and zero stiffness response. Centring the gradient slots on the
    position of slot 0 as well would strain it."""
    _, tsys, coefs, _ = prob
    op = tsys.fem
    n = len(coefs)
    t = np.zeros((n, 3))
    t[0::4] = [0.3, -0.2, 0.5]  # every node's position row
    zero = np.zeros((n, 3))
    fe, prep = fk.primal_prep_plain(op, _t(np.concatenate([t, zero, zero], axis=1)))
    stretch = t.copy()
    stretch[1::4, 0] = 0.01  # r_u grows by 1 %: a real strain
    fe_s, _ = fk.primal_prep_plain(op, _t(np.concatenate([stretch, zero, zero], axis=1)))
    assert float(fe_s.abs().max()) > 0
    assert float(fe.abs().max()) < 1e-12 * float(fe_s.abs().max())
    # K2 along a translation: only the mass term (1/dt) Me p is left.
    Me = op.Me_t.view(op.S, op.S, op.E)
    pe = _t(t)[op.conn].permute(1, 2, 0)
    want = (torch.einsum("abe,bie->aie", Me, pe) / DT).reshape(op.S * 3, op.E)
    got = fk.hv_plain(op, _t(t), prep, DT)
    assert _rel(got.numpy(), want.numpy()) < RTOL
    blocks = fk.svk_blocks_plain(op, _t(t))
    rest = fk.svk_blocks_plain(op, _t(zero))
    assert _rel(blocks.numpy(), rest.numpy()) < RTOL


@pytest.fixture(scope="module")
def shell_run():
    """The clamped shell_grid(3, 2) with the bench.py solver settings and
    gravity, float64, with the frozen coarse correction on."""
    coefs, jsys = _clamped_system("ancf3443")
    jstate = JStepState.rest(jsys, coefs)
    f_ext = jnp.zeros((len(coefs), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    fs = float(jnp.linalg.norm(f_ext))
    jparams = j_newton.NewtonParams(dt=1e-3, rho=1e7, inner_atol=1e-3 * fs, inner_rtol=0.0,
                                    outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                    cg_max_iter=50, ew_eta_max=0.5)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    jco = j_build_coarse(jsys, jstate.x, 1e-3, 1e7, target_cluster=8)
    tco = build_coarse_precond(tsys, tstate.x, 1e-3, 1e7, target_cluster=8)
    return coefs, (jsys, jstate, jparams, jco), (tsys, tstate, tparams, tco), f_ext


def _assert_same_positions(t_x, j_x):
    j_x = np.asarray(j_x)
    err = np.abs(t_x.numpy() - j_x).max() / np.abs(j_x).max()
    assert err < 1e-10, err


def test_shell_coarse_matches_jax(shell_run):
    coefs, (_, _, _, jco), (_, _, _, tco), _ = shell_run
    assert tco.n_agg == jco.n_agg > 1
    r = np.random.default_rng(2).normal(size=coefs.shape)
    want = np.asarray(jco.apply(jnp.asarray(r)))
    np.testing.assert_allclose(tco.apply(_t(r)).numpy(), want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_shell_step_matches_jax(shell_run):
    coefs, (jsys, jstate, jparams, jco), (tsys, tstate, tparams, tco), f_ext = shell_run
    js, jd = j_newton.make_step(jsys, jparams, coarse=jco)(jstate, f_ext)
    ts, td = newton.make_step(tsys, tparams, coarse=tco)(tstate, _t(f_ext))
    _assert_same_positions(ts.x, js.x)
    for key in ("outer_iters", "newton_iters", "cg_iters"):
        assert td[key] == int(jd[key]), key
    assert td["cg_iters"] > 0


def test_shell_rollout_matches_jax(shell_run):
    coefs, (jsys, jstate, jparams, jco), (tsys, tstate, tparams, tco), f_ext = shell_run
    js, (jn, jc) = j_newton.make_rollout(jsys, jparams, 5, coarse=jco,
                                         precond_refresh=2)(jstate, f_ext)
    ts, (tn, tc) = newton.make_rollout(tsys, tparams, 5, coarse=tco,
                                       precond_refresh=2)(tstate, _t(f_ext))
    _assert_same_positions(ts.x, js.x)
    assert tn == np.asarray(jn).tolist()
    assert tc == np.asarray(jc).tolist()
    assert float((ts.x - tstate.x).abs().max()) > 0


def test_fem_operator_rejects_uninstantiated_shapes(prob):
    _, tsys, _, _ = prob
    e = tsys.elems
    cut = ElementBatch(conn=e.conn, grad_N=e.grad_N[:, :-1], dV=e.dV[:, :-1],
                       mass_elem=e.mass_elem, xe_ref=e.xe_ref, n_coef=e.n_coef,
                       x_ref=e.x_ref, trans_mask=e.trans_mask)
    with pytest.raises(ValueError, match="no FEM kernel is instantiated"):
        fk.FemOperator(cut, tsys.material)
    with pytest.raises(ValueError, match="no FEM kernel is instantiated"):
        System(elems=cut, material=tsys.material)
    for mask in (None, (True,) * e.n_shape, (False,) + e.trans_mask[1:]):
        bad = ElementBatch(conn=e.conn, grad_N=e.grad_N, dV=e.dV, mass_elem=e.mass_elem,
                           xe_ref=e.xe_ref, n_coef=e.n_coef, x_ref=e.x_ref, trans_mask=mask)
        with pytest.raises(ValueError, match="no FEM kernel is instantiated"):
            fk.FemOperator(bad, tsys.material)
    assert tsys.fem.family in ("ancf3243", "ancf3443")
