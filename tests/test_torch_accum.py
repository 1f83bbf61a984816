"""The accuracy mode of the torch port (`System.accum_dtype`) against the
JAX package's, on the CPU.

The problem is the stiff cantilever of `tests/test_f32_stiff.py` (E 7e8,
ALM penalty scaled to the stiffness) at 2 x 1 x 1 cells: float32 tables
and velocities, float64 displacement, `accum_dtype` float64. The JAX side
runs its XLA path, where the element pipeline, the pin force and the
scatter run in float64 and only the net gradient is cast down
(`tlfea/solvers/common.py:183-201`); the port runs the plain twins of its
float64 kernels on the tables cast up (`System.fem_wide`). Both start from
the same arrays, handed over through `interop.from_numpy_system`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import adamw as j_adamw
from tlfea.solvers import newton as j_newton
from tlfea.solvers.common import grad_L as j_grad_L
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.ops import resident
from tlfea_torch.solvers import adamw, newton
from tlfea_torch.solvers.common import _pin_terms, grad_L

torch.set_num_threads(2)

F32 = np.float32
SEED = 0
DT, RHO = 1e-3, 1e11  # tests/test_f32_stiff.py: dt^2 rho ~ dt E h


def _stiff(x=None, accum="float64"):
    """(nodes, JAX system, rest state with u in float64, f_ext): the stiff
    beam in float32, pinned at its x = 0 face, at positions x (rest if
    None; the pins hold the face where x puts it)."""
    nodes, conn = box_t10_mesh(1.0, 0.2, 0.15, 2, 1, 1)
    lam, mu = lame_from_E_nu(7e8, 0.3)
    mat = JSVK(lam=jnp.asarray(lam, F32), mu=jnp.asarray(mu, F32),
               eta_damp=jnp.asarray(1e5, F32), lam_damp=jnp.asarray(1e5, F32))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    x = nodes if x is None else x
    elems = j_feat10.build(nodes, conn, rho=1000.0, dtype=F32)
    system = JSystem(elems=elems, material=mat,
                     constraints=JFixedCoefs.from_indices(fixed, x.astype(F32)),
                     accum_dtype=accum)
    state = JStepState.rest(system, nodes.astype(F32))
    state = state.replace(u=state.u.astype(jnp.float64))
    f_ext = jnp.zeros((len(nodes), 3), F32).at[:, 2].add(j_lumped_mass(elems) * F32(-9.81))
    return nodes, system, state, f_ext


def _rotated(nodes, theta, strain, rng):
    """Positions of the beam turned by theta about z, with a random strain
    of the given size on top (float64)."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return nodes @ R.T + strain * rng.standard_normal(nodes.shape)


def _port(jsys, jstate, params=None, dtype=torch.float32, accum="float64"):
    return from_numpy_system(jsys.elems, jsys.material, jsys.constraints, jstate, params,
                             device="cpu", dtype=dtype, accum_dtype=accum)


def _within_ulps(got, want, floor):
    """Every entry within 2 float32 ulps of its magnitude, or `floor`."""
    want = np.asarray(want)
    bar = np.maximum(2.0 * np.spacing(np.abs(want).astype(np.float32)), floor)
    worst = float((np.abs(got - want) / bar).max())
    assert worst <= 1.0, worst


@pytest.fixture(scope="module")
def strained():
    """A strained, rotated, moving state of the stiff beam and a direction,
    from the seed, in both packages."""
    rng = np.random.default_rng(SEED)
    nodes, jsys, jstate, f_ext = _stiff()
    x = _rotated(nodes, 0.3, 1e-5, rng)
    v = (1e-3 * rng.standard_normal(x.shape)).astype(F32)
    jstate = jstate.replace(
        x=jnp.asarray(x, F32), u=jnp.asarray(x - np.asarray(jsys.elems.x_ref, np.float64)),
        v=jnp.asarray((1e-3 * rng.standard_normal(x.shape)).astype(F32)),
        lam=jnp.asarray((1e2 * rng.standard_normal(jstate.lam.shape)).astype(F32)))
    p = rng.standard_normal(x.shape).astype(F32)
    return jsys, jstate, f_ext, v, p


def test_gradient_and_products_match_jax(strained):
    """grad_L, g_and_hvp's g and H p, and torch.func.jvp of grad_L against
    JAX's grad_L and jax.linearize of it, accum_dtype float64 on both
    sides: each entry within 2 float32 ulps of its magnitude, or 1e-6 of
    ||f_ext|| (the gradient) or of ||H p|| (the products)."""
    jsys, jstate, f_ext, v, p = strained
    dt, rho = F32(DT), F32(RHO)

    def jg(vv):
        return j_grad_L(vv, jstate.x, jstate.v, jstate.lam, f_ext, dt, rho, jsys, u_prev=jstate.u)

    gj, lin = jax.linearize(jg, jnp.asarray(v))
    hj = np.asarray(lin(jnp.asarray(p)))
    gj = np.asarray(gj)
    assert gj.dtype == np.float32

    tsys, ts, _ = _port(jsys, jstate)
    assert ts.u.dtype == torch.float64 and ts.v.dtype == torch.float32
    assert tsys.fem_wide.gN_t.dtype == torch.float64
    assert torch.equal(tsys.fem_wide.gN_t, tsys.fem.gN_t.double())  # cast up, not rebuilt
    tf, tv, tp = (torch.as_tensor(np.array(a)) for a in (f_ext, v, p))

    def tg(vv):
        return grad_L(vv, ts.x, ts.v, ts.lam, tf, float(dt), float(rho), tsys, u_prev=ts.u)

    g_floor = 1e-6 * float(np.linalg.norm(np.asarray(f_ext)))
    h_floor = 1e-6 * float(np.linalg.norm(hj))
    g1 = tg(tv)
    assert g1.dtype == torch.float32
    _within_ulps(g1.numpy(), gj, g_floor)
    _, jv = torch.func.jvp(tg, (tv,), (tp,))
    _within_ulps(jv.numpy(), hj, h_floor)

    pins = _pin_terms(tsys, ts.lam, float(dt), float(rho), torch.float64)
    g2, hvp = fk.g_and_hvp(tv, ts.u, ts.v, tf, float(dt), tsys.grad_op, pins)
    assert g2.dtype == torch.float32
    _within_ulps(g2.numpy(), gj, g_floor)
    h2 = hvp(tp)
    assert h2.dtype == torch.float32
    _within_ulps(h2.numpy(), hj, h_floor)


def test_newton_steps_match_jax():
    """Five accuracy-mode Newton steps under a ramped load: identical Newton
    and CG counts, positions within 1e-6 of the displacement scale. At dt
    1e-4 each CG solve takes about 70 iterations; at the stiff test's dt
    1e-3 it takes 100-250, over which the float32 dot products (summed in
    another order by XLA and by torch) move a count by 1-2."""
    nodes, jsys, jstate, f_ext = _stiff()
    fs = float(jnp.linalg.norm(f_ext))
    jparams = j_newton.NewtonParams(
        dt=F32(1e-4), rho=F32(1e12), inner_atol=F32(1e-4 * fs), inner_rtol=F32(0.0),
        outer_tol=F32(1e-5 * fs), max_outer=2, max_inner=8, cg_rtol=F32(1e-3),
        cg_max_iter=300, ew_eta_max=F32(0.5))
    tsys, ts, tparams = _port(jsys, jstate, jparams)
    assert not resident.eligible(tsys, None)
    jstep = j_newton.make_step(jsys, jparams)
    js = jstate
    tf = torch.as_tensor(np.array(f_ext))
    for k in range(5):
        scale = F32(min(1.0, (k + 1) / 3))
        js, jd = jstep(js, f_ext * scale)
        ts, td = newton.step(tsys, ts, tparams, tf * float(scale))
        assert (td["newton_iters"], td["cg_iters"]) == (int(jd["newton_iters"]),
                                                         int(jd["cg_iters"])), k
        assert ts.u.dtype == torch.float64 and ts.x.dtype == torch.float32
    ju = np.asarray(js.u)
    assert ju.dtype == np.float64
    err = float(np.abs(ts.u.numpy() - ju).max() / np.abs(ju).max())
    assert err < 1e-6, err
    assert float(np.abs(ts.x.numpy() - np.asarray(js.x)).max() / np.abs(ju).max()) < 1e-6


def test_accum_gradient_removes_the_float32_floor():
    """The mode's point: at the beam turned by 0.3 rad (the pins turned with
    it) with a strain of 1e-6, the accuracy-mode gradient lies within 1e-4
    of the load from the float64 one, and the pure float32 gradient at
    least 10 times further (eps * E * theta)."""
    rng = np.random.default_rng(SEED)
    nodes, _, _, _ = _stiff()
    x = _rotated(nodes, 0.3, 1e-6, rng)
    _, jsys, jstate, f_ext = _stiff(x)
    fs = float(np.linalg.norm(np.asarray(f_ext)))
    x_ref = np.asarray(jsys.elems.x_ref, np.float64)
    grads = {}
    for mode, dtype, accum, u_dtype in (("accum", torch.float32, "float64", np.float64),
                                        ("f32", torch.float32, None, np.float32),
                                        ("f64", torch.float64, None, np.float64)):
        st = jstate.replace(x=jnp.asarray(x, F32), u=jnp.asarray((x - x_ref).astype(u_dtype)))
        tsys, ts, _ = _port(jsys, st, dtype=dtype, accum=accum)
        tf = torch.as_tensor(np.array(f_ext)).to(dtype)
        grads[mode] = grad_L(ts.v, ts.x, ts.v, ts.lam, tf, float(F32(DT)), float(F32(RHO)), tsys,
                             u_prev=ts.u).double()
    err_accum = float((grads["accum"] - grads["f64"]).norm()) / fs
    err_f32 = float((grads["f32"] - grads["f64"]).norm()) / fs
    assert err_accum < 1e-4, err_accum
    assert err_f32 >= 10.0 * err_accum, (err_f32, err_accum)


def test_resident_gate_refuses_accum():
    """The persistent kernel never runs the accuracy mode (`newton.py:166-175`
    keeps it off the banded path): the same beam passes the gate without
    accum_dtype."""
    _, jsys, jstate, _ = _stiff()
    tsys, _, _ = _port(jsys, jstate)
    assert tsys.accum_dtype == torch.float64 and not resident.eligible(tsys, None)
    plain, _, _ = _port(jsys, jstate, accum=None)
    assert plain.fem_wide is None and resident.eligible(plain, None)
    with pytest.raises(ValueError):
        _port(jsys, jstate, accum="float16")


def test_adamw_step_matches_jax():
    """One AdamW step through grad_fn in the accuracy mode (K5 + K4 in
    float64 on the card; the twins here) against the JAX package's, capped
    at 40 iterations: equal counts, positions within 1e-5 of the
    displacement scale."""
    _, jsys, jstate, f_ext = _stiff()
    jparams = j_adamw.AdamWParams(dt=F32(DT), rho=F32(RHO), lr=F32(1e-3), inner_tol=F32(1e-9),
                                  max_outer=1, max_inner=40, convergence_check_interval=10)
    tsys, ts, tparams = _port(jsys, jstate, jparams)
    assert isinstance(tparams, adamw.AdamWParams)
    js, jd = j_adamw.make_step(jsys, jparams)(jstate, f_ext)
    ts, td = adamw.make_step(tsys, tparams)(ts, torch.as_tensor(np.array(f_ext)))
    assert td["inner_iters"] == int(jd["inner_iters"]) and td["outer_iters"] == int(
        jd["outer_iters"])
    assert ts.u.dtype == torch.float64
    ju = np.asarray(js.u)
    err = float(np.abs(ts.u.numpy() - ju).max() / np.abs(ju).max())
    assert err < 1e-5, err
