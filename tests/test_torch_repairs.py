"""Three signatures and flags of the port held to the JAX package, in
float64 on the CPU.

- `feat10.build(nodes, conn, rho, dtype, mass_rule, device=...)`: JAX's
  positional order, with the 5-point ("keast5") consistent mass equal to
  JAX's to 1e-14 of its scale, and a Newton step on it equal to JAX's
  (counts, positions within 1e-10 of the displacement scale).
- `vbd.prepare(system, group_size, dtype=None)`: a JAX-style call with
  `dtype=` builds the same colour groups.
- `newton._step`'s diag["converged"]: a step stopped at max_inner whose last
  (untested) iterate meets the inner test counts as converged, one whose
  last iterate does not counts as unconverged; the iterates and counts are
  those of the uncapped run. `make_rollout` returns the flags beside the
  (newton_iters, cg_iters) pair it always returned.
"""

import inspect
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
from tlfea.solvers import vbd as j_vbd
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import feat10
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import SVK
from tlfea_torch.solvers import StepState, System, newton, vbd
from tlfea_torch.solvers.coarse import build_coarse_precond

torch.set_num_threads(2)

BOX = (1.0, 0.2, 0.2, 4, 1, 1)
E, NU, DAMP = 1e7, 0.3, 1e3


def test_feat10_build_signature_follows_jax():
    """mass_rule is the fifth parameter in both packages; device follows it."""
    jax_names = list(inspect.signature(j_feat10.build).parameters)
    port_names = list(inspect.signature(feat10.build).parameters)
    assert port_names == jax_names + ["device"]
    assert inspect.signature(feat10.build).parameters["mass_rule"].default == "exact"


@pytest.mark.parametrize("rule", ["keast5", "exact"])
def test_feat10_mass_rule_matches_jax(rule):
    nodes, conn = box_t10_mesh(*BOX)
    je = j_feat10.build(nodes, conn, 1000.0, np.float64, rule)
    te = feat10.build(nodes, conn, 1000.0, torch.float64, rule, device="cpu")
    want = np.asarray(je.mass_elem)
    assert te.mass_elem.dtype == torch.float64 and te.mass_elem.device.type == "cpu"
    np.testing.assert_allclose(te.mass_elem.numpy(), want, rtol=0,
                               atol=1e-14 * np.abs(want).max())
    other = "exact" if rule == "keast5" else "keast5"
    assert np.abs(want - np.asarray(j_feat10.element_mass(nodes, conn, 1000.0, other))).max() \
        > 1e-6 * np.abs(want).max()  # the two rules differ: the rule was honoured


def test_newton_step_on_keast5_mass_matches_jax():
    """One Newton step of the port's keast5 build beside JAX's, from rest
    under gravity: equal Newton and CG counts, x within 1e-10."""
    nodes, conn = box_t10_mesh(*BOX)
    lam, mu = lame_from_E_nu(E, NU)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, 1000.0, np.float64, "keast5"),
                   material=JSVK(lam=lam, mu=mu, eta_damp=DAMP, lam_damp=DAMP),
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    prm = dict(dt=1e-3, rho=1e7, inner_atol=1e-6 * float(jnp.linalg.norm(f_ext)),
               outer_tol=1e-9, max_outer=2, max_inner=8, cg_rtol=1e-4, cg_max_iter=100)
    js, jd = j_newton.make_step(jsys, j_newton.NewtonParams(**prm))(
        JStepState.rest(jsys, nodes), f_ext)
    x0 = torch.as_tensor(nodes)
    tsys = System(elems=feat10.build(nodes, conn, 1000.0, torch.float64, "keast5", device="cpu"),
                  material=SVK(lam=lam, mu=mu, eta_damp=DAMP, lam_damp=DAMP),
                  constraints=FixedCoefs.from_indices(fixed, x0))
    ts, td = newton.make_step(tsys, newton.NewtonParams(**prm))(
        StepState.rest(tsys, x0), torch.as_tensor(np.array(f_ext)))
    for key in ("outer_iters", "newton_iters", "cg_iters"):
        assert td[key] == int(jd[key]), key
    jx = np.asarray(js.x)
    scale = np.abs(jx - nodes).max()
    assert scale > 0 and np.abs(ts.x.numpy() - jx).max() < 1e-10 * scale


def test_vbd_prepare_accepts_dtype():
    """JAX's `prepare(system, group_size=4, dtype=None)` call builds the same
    groups in the port, with or without dtype, as JAX's own."""
    nodes, conn = box_t10_mesh(*BOX)
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0),
                   material=JSVK(*lame_from_E_nu(E, NU)))
    tsys, _, _ = from_numpy_system(jsys.elems, jsys.material, None, JStepState.rest(jsys, nodes),
                                   device="cpu")
    plain = vbd.prepare(tsys, group_size=4)
    typed = vbd.prepare(tsys, group_size=4, dtype=np.float64)
    js = j_vbd.prepare(jsys, group_size=4, dtype=np.float64)
    nodes_j, mask_j = np.asarray(js.color_nodes), np.asarray(js.color_mask)
    want = [nodes_j[g][mask_j[g]] for g in range(nodes_j.shape[0])]
    assert typed.n_colors == plain.n_colors
    for got in (plain.groups, typed.groups):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def capped_problem():
    """The bench.py problem on a small box at a tight inner tolerance, so a
    step takes a few Newton iterations."""
    nodes, conn = box_t10_mesh(*BOX)
    lam, mu = lame_from_E_nu(E, NU)
    x0 = torch.as_tensor(nodes)
    system = System(elems=feat10.build(nodes, conn, 1000.0, device="cpu"),
                    material=SVK(lam=lam, mu=mu, eta_damp=DAMP, lam_damp=DAMP),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    f_ext = torch.zeros((len(nodes), 3), dtype=torch.float64)
    f_ext[:, 2] = -9.81 * torch.as_tensor(np.asarray(j_lumped_mass(
        j_feat10.build(nodes, conn, rho=1000.0))))
    params = newton.NewtonParams(dt=1e-3, rho=1e7, inner_atol=1e-9 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=1, max_inner=20, cg_rtol=1e-6,
                                 cg_max_iter=200, ew_eta_max=0.0)
    return system, StepState.rest(system, x0), f_ext, params


@pytest.mark.parametrize("coarse", [False, True])
def test_converged_flag_at_the_cap(capped_problem, coarse):
    """Uncapped, the step converges in n >= 2 Newton iterations. Capped at
    n, it stops there with its last iterate untested: the flag evaluates it
    and counts the step converged (bitwise the uncapped step). Capped at
    n - 1, the last iterate fails the test: unconverged. Counts and
    iterates are those of the loop as it was."""
    system, state, f_ext, params = capped_problem
    co = build_coarse_precond(system, state.x, params.dt, params.rho) if coarse else None
    free, dfree = newton.step(system, state, params, f_ext, co)
    n = dfree["newton_iters"]
    assert 2 <= n < params.max_inner and dfree["converged"] is True
    at_n, d_n = newton.step(system, state, replace(params, max_inner=n), f_ext,
                              co)
    assert d_n["newton_iters"] == n and d_n["converged"] is True
    assert d_n["cg_iters"] == dfree["cg_iters"] and torch.equal(at_n.x, free.x)
    hist = d_n["norm_g_history"]
    assert torch.isnan(hist[n])  # the loop itself never tested the last iterate
    short, d_s = newton.step(system, state, replace(params, max_inner=n - 1),
                               f_ext, co)
    assert d_s["newton_iters"] == n - 1 and d_s["converged"] is False
    # The rollout's counts: the pair it always returned, the flags beside.
    roll = newton.make_rollout(system, replace(params, max_inner=n - 1), 2, coarse=co)
    _, counts = roll(state, f_ext)
    nits, cgits = counts
    assert nits == [n - 1, counts[0][1]] and len(cgits) == 2
    assert counts.converged[0] is False and len(counts.converged) == 2
