"""The first-order solvers of the torch port (`tlfea_torch.solvers.adamw`,
`nesterov`, `vbd`) and the ALM gradient they call (`common.grad_L`, K5 + K4
through `ElementContrib`), against the JAX package in float64 on the CPU.

The JAX side runs its XLA path (`system.pallas=None`); the port's wrappers
run their plain twins on the CPU. Both start from the same arrays (built
by JAX, handed over by `tlfea_torch.interop.from_numpy_system`):

- `grad_L` and `torch.func.jvp(grad_L)` against `grad_L` and
  `jax.jvp(grad_L)` within 1e-12 relative, the jvp also against the
  Newton path's K2 product (`g_and_hvp`);
- three steps of each solver on the beam of `tests/test_solvers.py` (4 x 1
  x 1 FEAT10 box, E 1e6): identical outer, inner and sweep counts, and
  positions within 1e-9 of the displacement scale. The tolerances are set
  so that inner solves end on the convergence test, not only on the cap;
- the penalty subproblem of `test_first_order_solvers_match_newton`
  (`tests/test_solvers.py:86-130`) through the port: AdamW and Nesterov
  within 10 % of the deformation from Newton's. That test runs 30,000
  iterations a step; here 1,000, the depth at which the JAX package's
  solvers already sit at their plateau on this beam (AdamW 5.5 %, Nesterov
  4.6 % at 1,000 iterations; 5.5 % and 5.5 % at 30,000). The 30,000-iteration
  form runs on the card at the flagship size (`chip_smoke.py`,
  `[first_order_vs_newton]`);
- make_solver's VBD colour groups of 4 diverging alike in both packages
  on a box of the flagship's cells;
- the colouring equal to the JAX package's NumPy colouring.
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
from tlfea.solvers import nesterov as j_nesterov
from tlfea.solvers import vbd as j_vbd
from tlfea.solvers.common import grad_L as j_grad_L
from tlfea.utils import coloring as j_coloring
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers import adamw, nesterov, newton, vbd
from tlfea_torch.solvers.common import _pin_terms, grad_L
from tlfea_torch.utils import coloring

torch.set_num_threads(2)

DT, RHO = 1e-3, 1e6

# Parameters of the parity steps: (JAX module, port module, parameters).
SOLVERS = {
    "adamw": (j_adamw, adamw, dict(dt=DT, rho=RHO, lr=1e-3, inner_tol=1e-4, inner_rtol=1e-2,
                                   max_outer=2, max_inner=300, convergence_check_interval=25)),
    "nesterov": (j_nesterov, nesterov, dict(dt=DT, rho=RHO, alpha=1e-5, inner_tol=1e-6,
                                            max_outer=3, max_inner=400)),
    "vbd": (j_vbd, vbd, dict(dt=DT, rho=RHO, omega=1.0, inner_tol=3e-3, max_outer=3,
                             max_sweeps=40, convergence_check_interval=4)),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def beam():
    """The beam of tests/test_solvers.py: 1 x 0.1 x 0.1, 4 x 1 x 1 cells,
    E 1e6, nu 0.3, eta = lam_d = 1e2, the x=0 face pinned, gravity."""
    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 4, 1, 1)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = JSVK(lam=lam, mu=mu, eta_damp=1e2, lam_damp=1e2)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    return nodes, jsys, JStepState.rest(jsys, nodes), f_ext


def test_grad_L_and_its_jvp_match_jax(beam):
    nodes, jsys, _, _ = beam
    tsys, _, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, device="cpu")
    n = len(nodes)
    rng = np.random.default_rng(3)
    u_prev, v_prev, v, p = (rng.normal(size=(n, 3)) * s for s in (1e-3, 0.1, 0.1, 1.0))
    lam = rng.normal(size=(int(jsys.constraints.idx.shape[0]), 3))
    f_ext = rng.normal(size=(n, 3))

    def jg(v):
        return j_grad_L(v, jnp.asarray(nodes + u_prev), jnp.asarray(v_prev), jnp.asarray(lam),
                        jnp.asarray(f_ext), DT, RHO, jsys, u_prev=jnp.asarray(u_prev))

    def tg(v):
        return grad_L(v, _t(nodes + u_prev), _t(v_prev), _t(lam), _t(f_ext), DT, RHO, tsys,
                      u_prev=_t(u_prev))

    want, dwant = jax.jvp(jg, (jnp.asarray(v),), (jnp.asarray(p),))
    got, dgot = torch.func.jvp(tg, (_t(v),), (_t(p),))
    assert _rel(got.numpy(), want) < 1e-12
    assert _rel(dgot.numpy(), dwant) < 1e-12
    pins = _pin_terms(tsys, _t(lam), DT, RHO, torch.float64)
    _, hvp = fk.g_and_hvp(_t(v), _t(u_prev), _t(v_prev), _t(f_ext), DT, tsys.fem, pins)
    assert _rel(dgot.numpy(), hvp(_t(p)).numpy()) < 1e-12
    # torch.func.linearize traces the plain path into a graph: the same product.
    _, lin = torch.func.linearize(tg, _t(v))
    assert _rel(lin(_t(p)).numpy(), dwant) < 1e-12
    # A jvp of a jvp cannot differentiate a kernel launch: it raises unless
    # the system runs the twins.
    with pytest.raises(RuntimeError, match="nested torch.func transforms"):
        torch.func.jvp(lambda x: torch.func.jvp(tg, (x,), (_t(p),))[1], (_t(v),), (_t(p),))
    tsys.plain = True
    torch.func.jvp(lambda x: torch.func.jvp(tg, (x,), (_t(p),))[1], (_t(v),), (_t(p),))


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_first_order_steps_match_jax(beam, solver):
    nodes, jsys, jstate, f_ext = beam
    jmod, tmod, kw = SOLVERS[solver]
    jparams = {"adamw": j_adamw.AdamWParams, "nesterov": j_nesterov.NesterovParams,
               "vbd": j_vbd.VBDParams}[solver](**kw)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    assert type(tparams) is {"adamw": adamw.AdamWParams, "nesterov": nesterov.NesterovParams,
                             "vbd": vbd.VBDParams}[solver]
    assert all(getattr(tparams, k) == v for k, v in kw.items())
    jstep, tstep = jmod.make_step(jsys, jparams), tmod.make_step(tsys, tparams)
    tf = _t(f_ext)
    fk.reset_launch_counts()
    converged = 0
    for _ in range(3):
        jstate, jd = jstep(jstate, f_ext)
        tstate, td = tstep(tstate, tf)
        for key, val in jd.items():
            if key == "norm_c":
                assert td[key] == pytest.approx(float(val), rel=1e-8)
            else:
                assert td[key] == int(val), key
        inner = td["sweeps" if solver == "vbd" else "inner_iters"]
        cap = tparams.max_sweeps if solver == "vbd" else tparams.max_inner
        converged += inner < cap * td["outer_iters"]
        jx = np.asarray(jstate.x)
        scale = np.abs(jx - nodes).max()
        assert np.abs(tstate.x.numpy() - jx).max() < 1e-9 * scale
        np.testing.assert_allclose(tstate.lam.numpy(), np.asarray(jstate.lam), rtol=1e-7,
                                   atol=1e-9 * np.abs(np.asarray(jstate.lam)).max())
        assert torch.equal(tstate.dv, torch.zeros_like(tstate.v))
    assert converged > 0  # the counts come from the convergence test, not only caps
    assert all(v == 0 for v in fk.LAUNCHES.values())


def test_first_order_solvers_match_newton(beam):
    """The penalty subproblem (one outer iteration, lam = 0, dt 2e-3, rho
    1e6, two steps) has one minimiser: AdamW and Nesterov land within 10 %
    of the deformation from Newton's (`tests/test_solvers.py:86-130`)."""
    nodes, jsys, jstate, f_ext = beam
    tsys, state0, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, jstate,
                                        device="cpu")
    tf = _t(f_ext)
    dt, rho = 2e-3, 1e6
    runs = {
        "newton": newton.make_step(tsys, newton.NewtonParams(
            dt=dt, rho=rho, inner_atol=1e-11, max_outer=1, max_inner=25)),
        "adamw": adamw.make_step(tsys, adamw.AdamWParams(
            dt=dt, rho=rho, lr=1e-3, inner_tol=1e-12, inner_rtol=0.0, max_outer=1,
            max_inner=1000, convergence_check_interval=100)),
        "nesterov": nesterov.make_step(tsys, nesterov.NesterovParams(
            dt=dt, rho=rho, alpha=1e-5, inner_tol=1e-12, max_outer=1, max_inner=1000)),
    }
    x = {}
    for name, step in runs.items():
        s = state0
        for _ in range(2):
            s, _ = step(s, tf)
        x[name] = s.x.numpy()
    scale = np.abs(x["newton"] - nodes).max()
    for name in ("adamw", "nesterov"):
        dev = np.abs(x[name] - x["newton"]).max() / scale
        assert dev < 0.10, f"{name} deviates {dev:.3e} (rel to deformation)"


def test_vbd_colour_groups_of_4_diverge_alike():
    """make_solver's VBD (colour groups of 4, omega 1) on a box of the
    bench.py flagship's cells, material, pins, dt and ALM rho (24 x 4 x 4
    cells of 0.0476 x 0.05 x 0.05 m instead of 42 x 7 x 6): the gradient is
    refreshed once per group, the group's colours update against the stale
    gradient, and the sweeps diverge. In one step from rest (one outer pass,
    200 sweeps) the velocity passes g*dt, which a step from rest under
    gravity cannot reach, in the JAX package as in the port, along the same
    iterates. At the full flagship the JAX package's step goes to NaN
    between sweeps 128 and 200 in float32 and float64 alike."""
    from tlfea.utils.reorder import apply_node_order, best_order

    nodes, conn = box_t10_mesh(24 * 2.0 / 42, 0.2, 0.2, 24, 4, 4)
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=lam, mu=mu, eta_damp=1e3, lam_damp=1e3)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    jstate = JStepState.rest(jsys, nodes)
    jparams = j_vbd.VBDParams(dt=1e-3, rho=1e7, omega=1.0, inner_tol=1e-7, outer_tol=1e-8,
                              max_outer=1, max_sweeps=200, convergence_check_interval=8,
                              color_group_size=4)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    js, jd = j_vbd.make_step(jsys, jparams)(jstate, f_ext)
    ts, td = vbd.make_step(tsys, tparams)(tstate, _t(f_ext))
    assert td["sweeps"] == int(jd["sweeps"]) == 200
    jv = np.asarray(js.v)
    assert np.abs(jv).max() > 2 * 9.81 * 1e-3 and np.isfinite(jv).all()
    assert np.abs(ts.v.numpy() - jv).max() < 1e-9 * np.abs(jv).max()


def test_coloring_matches_jax(beam):
    nodes, jsys, _, _ = beam
    conn, n = np.asarray(jsys.elems.conn), len(nodes)
    adj = coloring.build_adjacency(conn, n)
    assert adj == j_coloring.build_adjacency(conn, n)
    colors = coloring.greedy_coloring(adj)
    np.testing.assert_array_equal(colors, j_coloring.greedy_coloring(adj))
    assert coloring.validate_coloring(adj, colors)
    for a, b in zip(coloring.build_incidence(conn, n), j_coloring.build_incidence(conn, n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(coloring.pad_colors(colors, 4), j_coloring.pad_colors(colors, 4)):
        np.testing.assert_array_equal(a, b)
    tsys, _, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, device="cpu")
    st, jst = vbd.prepare(tsys, 3), j_vbd.prepare(jsys, 3)
    jnodes, jmask = np.asarray(jst.color_nodes), np.asarray(jst.color_mask)
    assert len(st.groups) == jst.n_groups and st.n_colors == int(colors.max()) + 1
    for g, idx in enumerate(st.groups):
        np.testing.assert_array_equal(idx.numpy(), jnodes[g][jmask[g]])
    assert torch.equal(torch.sort(torch.cat(st.groups)).values, torch.arange(n))

