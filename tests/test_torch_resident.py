"""The resident inner solve of the torch port (`tlfea_torch.ops.resident`)
on the CPU, where it takes its plain version.

The gate follows `pallas_resident.eligible`; a step through the resident
entry is held against the JAX package's XLA path in float64 on the problem
and parameters of the JAX resident test (`tests/test_pallas_banded.py`,
`test_resident_inner_matches_newton_inner`): positions within 1e-10 of the
displacement scale, identical Newton and CG counts, the full ||g|| history
within 1e-9. The kernel itself runs only on the card
(`tests/test_torch_cuda.py`).
"""

from dataclasses import replace

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
from tlfea.solvers import newton as j_newton
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.elements import ancf3443, feat10
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import SVK
from tlfea_torch.ops import resident
from tlfea_torch.solvers import StepState, System, newton
from tlfea_torch.solvers.coarse import build_coarse_precond

torch.set_num_threads(2)


def _jax_problem(nx=8, ny=2, nz=2):
    """`test_pallas_banded._problem(8, 2, 2)` and the resident test's
    parameters, float64, on the JAX XLA path."""
    nodes, conn = box_t10_mesh(1.0, 0.3, 0.3, nx, ny, nz)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu), eta_damp=jnp.asarray(1e3),
               lam_damp=jnp.asarray(1e3))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                     constraints=JFixedCoefs.from_indices(fixed, nodes))
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(system.elems) * -9.81)
    params = j_newton.NewtonParams(dt=1e-3, rho=1e6, inner_atol=1e-6, inner_rtol=0.0,
                                   outer_tol=0.0, max_outer=1, max_inner=4, cg_rtol=1e-3,
                                   cg_max_iter=40, ew_eta_max=0.5)
    return nodes, system, f_ext, params


@pytest.fixture(scope="module")
def prob():
    nodes, jsys, f_ext, jparams = _jax_problem()
    tsys, _, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                         params=jparams, device="cpu")
    return nodes, jsys, tsys, f_ext, jparams, tparams


def _feat10_system(dims):
    nodes, conn = box_t10_mesh(*dims)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    return System(elems=feat10.build(nodes, conn, rho=1000.0, device="cpu"),
                  material=SVK(lam, mu, 1e3, 1e3))


def test_eligible_for_small_pinned_box(prob):
    _, _, tsys, _, _, _ = prob
    assert tsys.fem.E == 192 and tsys.constraints is not None
    assert resident.eligible(tsys, None)


@pytest.mark.parametrize("case", ["coarse", "too_many_elements", "ancf3443"])
def test_not_eligible(prob, case):
    if case == "coarse":
        _, _, tsys, _, _, tparams = prob
        nodes = tsys.elems.x_ref
        coarse = build_coarse_precond(tsys, nodes, tparams.dt, tparams.rho)
        assert not resident.eligible(tsys, coarse)
        return
    if case == "too_many_elements":
        system = _feat10_system((1.0, 0.3, 0.3, 13, 4, 4))
        assert system.fem.E == 1248
    else:
        coefs, conn = ancf3443.shell_grid(2, 2, L=0.05, W=0.05)
        system = System(elems=ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0,
                                             device="cpu"),
                        material=SVK(*lame_from_E_nu(1e7, 0.3), 1e3, 1e3))
        assert system.fem.E <= resident.MAX_ELEMS
    assert not resident.eligible(system, None)


# The box compressed along x to this fraction of its length: SVK's tangent is
# indefinite there (uniaxial stiffness changes sign below a stretch of
# 1/sqrt(3)), so CG meets non-positive curvature and the Newton loop
# backtracks. At 0.5 the partial CG steps amplify summation-order
# differences to 1e-6 of the displacement; at 0.6 the port and JAX agree to
# 1e-13.
COMPRESSED = 0.6


def _start(nodes, dtype_np, compressed):
    """Rest, or the box compressed along x (COMPRESSED)."""
    x = nodes.copy()
    if compressed:
        x[:, 0] *= COMPRESSED
    z = np.zeros_like(nodes)
    return x.astype(dtype_np), z, x - nodes


def _state(tsys, x, v, u):
    return StepState(x=torch.as_tensor(x), v=torch.as_tensor(v),
                     lam=torch.zeros((int(tsys.constraints.idx.numel()), 3),
                                     dtype=torch.float64),
                     u=torch.as_tensor(u), dv=torch.as_tensor(v))


def test_cpu_and_plain_system_take_the_plain_version(prob, monkeypatch):
    nodes, _, tsys, f_ext, _, tparams = prob
    x, v, u = _start(nodes, np.float64, compressed=False)
    args = newton.inner_solve_args(tsys, _state(tsys, x, v, u),
                                   torch.as_tensor(np.array(f_ext)), tparams)

    def no_launch(*a, **k):
        raise AssertionError("the kernel was launched for a CPU tensor")

    monkeypatch.setattr(resident, "launch", no_launch)
    want = resident.newton_inner_resident_plain(*args)
    for system in (tsys, replace(tsys, plain=True)):
        got = resident.newton_inner_resident(*args[:5], system, *args[6:])
        assert torch.equal(got[0], want[0]) and got[1:4] == want[1:4]
        np.testing.assert_array_equal(got[4], want[4])
    assert want[1] > 0 and want[3] > 0


@pytest.mark.parametrize("compressed", [False, True])
def test_step_matches_jax(prob, monkeypatch, compressed):
    """One implicit step through the resident entry against the JAX XLA
    `_step`; from rest and from the compressed box, where the plain path
    backtracks."""
    nodes, jsys, tsys, f_ext, jparams, tparams = prob
    x, v, u = _start(nodes, np.float64, compressed)
    jstate = JStepState(x=jnp.asarray(x), v=jnp.asarray(v), lam=jnp.zeros((len(
        np.asarray(jsys.constraints.idx)), 3)), u=jnp.asarray(u), dv=jnp.asarray(v))
    js, jd = j_newton.make_step(jsys, jparams)(jstate, f_ext)

    calls = {"resident": 0, "backtrack": 0}
    plain, backtrack = resident.newton_inner_resident_plain, newton._backtrack

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(resident, "newton_inner_resident_plain", count("resident", plain))
    monkeypatch.setattr(newton, "_backtrack", count("backtrack", backtrack))
    ts, td = newton.make_step(tsys, tparams)(_state(tsys, x, v, u),
                                             torch.as_tensor(np.array(f_ext)))
    assert calls["resident"] == 1
    assert (calls["backtrack"] > 0) == compressed

    j_x = np.asarray(js.x)
    scale = np.abs(j_x - x).max()
    assert scale > 0
    assert np.abs(ts.x.numpy() - j_x).max() < 1e-10 * scale
    for key in ("newton_iters", "cg_iters"):
        assert td[key] == int(jd[key]), key
    assert td["cg_iters"] > 0
    np.testing.assert_allclose(td["norm_g_history"].numpy(), np.asarray(jd["norm_g_history"]),
                               rtol=1e-9)
