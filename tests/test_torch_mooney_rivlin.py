"""Mooney-Rivlin in the torch port (`tlfea_torch.materials.MooneyRivlin`, the
MR element twins of `tlfea_torch.ops.fem_kernels`, `precond_blocks` and the
solvers on an MR system) against the JAX package, in float64 on the CPU.

The JAX side runs its XLA path only (`system.pallas=None`: the material's
`first_piola_du` through `_element_contrib_values`, Hv from
`jax.linearize(grad_L)`, the preconditioner's exact blocks from three JVPs
of `first_piola`); interpret-mode Pallas takes minutes here. The port's
wrappers run their plain twins on the CPU, the same `_MRTile` algebra that
its CUDA kernels run on the card (`tests/test_torch_cuda.py` holds those to
the twins). Inputs come from numpy seeds; both packages get the same
arrays through `tlfea_torch.interop.from_numpy_system`.

One fault of the JAX package is stepped around here, not copied: its
`precond_blocks` hands `MooneyRivlin.tangent_diag_block` an F of shape (E,
Q, 1, 3, 3) and shape gradients (E, Q, S, 3), and `jax.jvp` refuses a
tangent of another shape than its primal, so a JAX Newton step on a
Mooney-Rivlin system raises. `_JMooneyRivlin` is the JAX material with F
broadcast first: the same three JVPs, so both packages precondition with
the same exact blocks and the Newton and CG counts must be equal.

Tolerances: 1e-12 relative for the material and the element twins (the
same float64 arithmetic in another order; `J.pow(1/3)` against `jnp.cbrt`
differs by an ulp), 1e-10 of the displacement for Newton rollouts with
identical counts, 1e-9 for the first-order steps (as
`tests/test_torch_first_order.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import _element_contrib_values
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.materials import MooneyRivlin as JMR
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import adamw as j_adamw
from tlfea.solvers import nesterov as j_nesterov
from tlfea.solvers import newton as j_newton
from tlfea.solvers.coarse import build_coarse_precond as j_build_coarse
from tlfea.solvers.common import grad_L as j_grad_L
from tlfea.solvers.common import precond_blocks as j_precond_blocks
from tlfea.solvers.common import suggest_rho as j_suggest_rho
from tlfea.utils.reorder import apply_node_order, best_order
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import MooneyRivlin
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers import adamw, nesterov, newton
from tlfea_torch.solvers.coarse import build_coarse_precond
from tlfea_torch.solvers.common import _pin_terms, precond_blocks, suggest_rho

torch.set_num_threads(2)

DT, RTOL = 1e-3, 1e-12


@struct.dataclass
class _JMooneyRivlin(JMR):
    """The JAX MooneyRivlin with F broadcast to h's batch shape before its
    own `tangent_diag_block` (see the module docstring)."""

    def tangent_diag_block(self, F, h):
        return super().tangent_diag_block(jnp.broadcast_to(F, h.shape[:-1] + (3, 3)), h)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _mr_from_E_nu(E, nu, damping):
    """`examples/bunny_deform.py:58-64`: mu10 = 0.4 mu, mu01 = 0.1 mu,
    kappa = E / (3 (1 - 2 nu)), so that the small-strain mu and lam are the
    SVK ones at (E, nu)."""
    mu = E / (2.0 * (1.0 + nu))
    return dict(mu10=0.4 * mu, mu01=0.1 * mu, kappa=E / (3.0 * (1.0 - 2.0 * nu)),
                eta_damp=damping, lam_damp=damping)


# --- the material ----------------------------------------------------------


@pytest.mark.parametrize("strain", [1e-3, 0.3])
def test_material_matches_jax(strain):
    """first_piola, first_piola_du, energy_density and tangent_diag_block at
    a near-identity and at a large strain; mu, lam and a clamped lam."""
    kw = dict(mu10=3e5, mu01=1e5, kappa=1e7)
    jm, tm = JMR(**kw), MooneyRivlin(**kw)
    rng = np.random.default_rng(5)
    Du = strain * rng.normal(size=(4, 6, 3, 3))
    F = Du + np.eye(3)
    assert np.linalg.det(F).min() > 0.1
    h = rng.normal(size=(4, 6, 10, 3))
    assert _rel(tm.first_piola(_t(F)).numpy(), jm.first_piola(jnp.asarray(F))) < RTOL
    assert _rel(tm.first_piola_du(_t(Du)).numpy(), jm.first_piola_du(jnp.asarray(Du))) < RTOL
    # W is a difference of terms of size 3 (mu10 + mu01) that cancel to
    # O(strain^2): its error is held against the terms' size.
    dW = tm.energy_density(_t(F)).numpy() - np.asarray(jm.energy_density(jnp.asarray(F)))
    assert np.abs(dW).max() < RTOL * 3.0 * (kw["mu10"] + kw["mu01"])
    want = jm.tangent_diag_block(jnp.asarray(F)[:, :, None].repeat(10, axis=2), jnp.asarray(h))
    got = tm.tangent_diag_block(_t(F)[:, :, None], _t(h))  # F broadcast over the slots
    assert _rel(got.numpy(), want) < RTOL
    assert tm.mu == pytest.approx(float(jm.mu), rel=1e-15)
    assert tm.lam == pytest.approx(float(jm.lam), rel=1e-15)
    soft = dict(mu10=3e5, mu01=1e5, kappa=4e5)  # kappa < 4/3 (mu10 + mu01): lam clamps
    assert MooneyRivlin(**soft).lam == float(JMR(**soft).lam) == 0.0
    assert not tm.damped and MooneyRivlin(**kw, eta_damp=1.0).damped


# --- the element twins -----------------------------------------------------


def _box_mr(damped, box=(1.0, 0.3, 0.3, 4, 2, 2)):
    """`tests/test_pallas_fem.py`'s Mooney-Rivlin box (4 x 2 x 2 cells), the
    x=0 face pinned, E 1e6, nu 0.3, damped or not."""
    nodes, conn = box_t10_mesh(*box)
    jmat = _JMooneyRivlin(**_mr_from_E_nu(1e6, 0.3, 1e2 if damped else 0.0))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=jmat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    tsys, _, _ = from_numpy_system(jsys.elems, jmat, jsys.constraints, device="cpu")
    n = len(nodes)
    rng = np.random.default_rng(7)
    # The JAX test's strained state: 1e-2 random displacement.
    d = dict(u_prev=rng.normal(size=(n, 3)) * 1e-2, v=rng.normal(size=(n, 3)) * 0.1,
             v_prev=rng.normal(size=(n, 3)) * 0.1, p=rng.normal(size=(n, 3)),
             lam=rng.normal(size=(len(fixed), 3)), f_ext=rng.normal(size=(n, 3)),
             dpacked=rng.normal(size=(n, 9)))
    return nodes, jsys, tsys, d


@pytest.fixture(scope="module", params=[False, True], ids=["undamped", "damped"])
def box(request):
    return _box_mr(request.param)


def _slots(a, op):
    """(E, S, 3) per-(element, slot) values -> the kernels' (S*3, E)."""
    return np.transpose(np.asarray(a), (1, 2, 0)).reshape(op.S * 3, op.E)


def test_element_twins_match_jax(box):
    """K1's fe (and K5's) against `_element_contrib_values`, K5t against its
    `jax.jvp` along independent tangents of u, v and dv/dt."""
    _, jsys, tsys, d = box
    op = tsys.fem
    assert (op.kind, op.tag, op.prep_rows) == ("mr", "feat10_mr", 30)
    u = d["u_prev"] + DT * d["v"]
    dvdt = (d["v"] - d["v_prev"]) / DT
    packed = np.concatenate([u, d["v"], dvdt], axis=1)

    def contrib(u, v, dvdt):
        return _element_contrib_values(u, v, dvdt, jsys.elems, jsys.material)

    dp = d["dpacked"]
    ref, dref = jax.jvp(contrib, tuple(jnp.asarray(a) for a in (u, d["v"], dvdt)),
                        tuple(jnp.asarray(dp[:, 3 * k:3 * k + 3]) for k in range(3)))
    fe, prep = fk.primal_prep_plain(op, _t(packed))
    assert prep.shape == (op.Q * 30, op.E)
    assert _rel(fe.numpy(), _slots(ref, op)) < RTOL
    assert torch.equal(fk.contrib_plain(op, _t(packed)), fe)
    got = fk.contrib_tangent_plain(op, _t(packed), _t(dp))
    assert _rel(got.numpy(), _slots(dref, op)) < RTOL

    # The prep rows: Du, F^{-T}, [J - 1, I1, I2], Fd per quadrature point.
    pr = prep.numpy().reshape(op.Q, 30, op.E).transpose(2, 0, 1)  # (E, Q, 30)
    Du = pr[..., 0:9].reshape(op.E, op.Q, 3, 3)
    F = Du + np.eye(3)
    np.testing.assert_allclose(pr[..., 9:18].reshape(op.E, op.Q, 3, 3),
                               np.linalg.inv(F).transpose(0, 1, 3, 2), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pr[..., 18], np.linalg.det(F) - 1.0, rtol=1e-10, atol=1e-15)
    C = F.transpose(0, 1, 3, 2) @ F
    I1 = np.trace(C, axis1=-2, axis2=-1)
    np.testing.assert_allclose(pr[..., 19], I1, rtol=1e-14)
    np.testing.assert_allclose(pr[..., 20], 0.5 * (I1**2 - np.trace(C @ C, axis1=-2, axis2=-1)),
                               rtol=1e-13)


def test_hv_twin_matches_jax_linearize(box):
    """K2's twin from K1's MR prep cache: per element against the jvp of the
    element contribution along the Newton chain, and assembled with the
    pins (`g_and_hvp`) against `jax.linearize` of the JAX `grad_L`."""
    nodes, jsys, tsys, d = box
    op = tsys.fem

    def g(v):
        return j_grad_L(v, jnp.asarray(nodes + d["u_prev"]), jnp.asarray(d["v_prev"]),
                        jnp.asarray(d["lam"]), jnp.asarray(d["f_ext"]), DT, 1e7, jsys,
                        u_prev=jnp.asarray(d["u_prev"]))

    g0, f_jvp = jax.linearize(g, jnp.asarray(d["v"]))
    pins = _pin_terms(tsys, _t(d["lam"]), DT, 1e7, torch.float64)
    gt, hvp = fk.g_and_hvp(_t(d["v"]), _t(d["u_prev"]), _t(d["v_prev"]), _t(d["f_ext"]), DT,
                           op, pins)
    assert _rel(gt.numpy(), g0) < RTOL
    assert _rel(hvp(_t(d["p"])).numpy(), f_jvp(jnp.asarray(d["p"]))) < RTOL

    def contrib(v):
        return _element_contrib_values(jnp.asarray(d["u_prev"]) + DT * v, v,
                                       (v - jnp.asarray(d["v_prev"])) / DT, jsys.elems,
                                       jsys.material)

    _, ref = jax.jvp(contrib, (jnp.asarray(d["v"]),), (jnp.asarray(d["p"]),))
    packed = np.concatenate([d["u_prev"] + DT * d["v"], d["v"],
                             (d["v"] - d["v_prev"]) / DT], axis=1)
    _, prep = fk.primal_prep_plain(op, _t(packed))
    assert _rel(fk.hv_plain(op, _t(d["p"]), prep, DT).numpy(), _slots(ref, op)) < RTOL


def test_precond_blocks_match_jax(box):
    """The exact MR blocks (`tangent_diag_block`, three JVPs), the viscous
    fold from the small-strain lam and mu, mass, pins and the Gershgorin
    shift, against the JAX package's XLA branch."""
    nodes, jsys, tsys, d = box
    x_prev = nodes + d["u_prev"]
    want = j_precond_blocks(jnp.asarray(d["v"]), jnp.asarray(x_prev), DT, 1e7, jsys,
                            u_prev=jnp.asarray(d["u_prev"]))
    got = precond_blocks(_t(d["v"]), _t(x_prev), DT, 1e7, tsys, u_prev=_t(d["u_prev"]))
    assert _rel(got.numpy(), want) < RTOL
    assert suggest_rho(tsys.elems, tsys.material, DT) == pytest.approx(
        j_suggest_rho(jsys.elems, jsys.material, DT), rel=1e-14)


# --- the solvers on an MR system ------------------------------------------


def _newton_problem(case):
    """"box": the bench.py problem at a small size with the flagship's
    material mapped to Mooney-Rivlin (E 1e7, nu 0.3, damping 1e3; gravity,
    the x=0 face pinned, rho 1e7). "bunny": `examples/bunny_deform.py`'s
    fallback mesh and defaults with --material mooney_rivlin (box 1 x 1 x
    2 of 2 x 2 x 4 cells, E 5e5, nu 0.4, damping 50, the base clamped, 20 N
    sideways on each ear node, rho_alm 1e8) and `make_solver("newton")`'s
    parameters."""
    if case == "box":
        nodes, conn = box_t10_mesh(1.0, 0.2, 0.2, 4, 1, 1)
        nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
        mat = _JMooneyRivlin(**_mr_from_E_nu(1e7, 0.3, 1e3))
        fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
        elems = j_feat10.build(nodes, conn, rho=1000.0)
        f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(elems) * -9.81)
        fs = float(jnp.linalg.norm(f_ext))
        prm = dict(dt=DT, rho=1e7, inner_atol=1e-3 * fs, inner_rtol=0.0, outer_tol=1e-9,
                   max_outer=2, max_inner=6, cg_rtol=1e-3, cg_max_iter=50, ew_eta_max=0.5)
    else:
        nodes, conn = box_t10_mesh(1.0, 1.0, 2.0, 2, 2, 4)
        mat = _JMooneyRivlin(**_mr_from_E_nu(5e5, 0.4, 50.0))
        z = nodes[:, 2]
        zr = z.max() - z.min()
        fixed = np.nonzero(z < z.min() + 0.05 * zr)[0]
        ears = np.nonzero(z > z.max() - 0.1 * zr)[0]
        elems = j_feat10.build(nodes, conn, rho=1000.0)
        f_ext = jnp.zeros((len(nodes), 3)).at[ears, 0].add(20.0)
        prm = dict(dt=DT, rho=1e8, inner_atol=1e-7, inner_rtol=1e-4, outer_tol=0.0,
                   max_outer=1, max_inner=6, cg_rtol=1e-3, cg_max_iter=50)
    jsys = JSystem(elems=elems, material=mat, constraints=JFixedCoefs.from_indices(fixed, nodes))
    jstate = JStepState.rest(jsys, nodes)
    jparams = j_newton.NewtonParams(**prm)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, mat, jsys.constraints, jstate,
                                              jparams, device="cpu")
    return nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext


@pytest.mark.parametrize("coarse", [False, True], ids=["jacobi", "coarse"])
@pytest.mark.parametrize("case", ["box", "bunny"])
def test_newton_rollout_matches_jax(case, coarse):
    """Three steps, block-Jacobi refreshed every 2 (with and without the
    frozen coarse correction, whose build reads the material's small-strain
    lam and mu): identical Newton and CG lists, positions within 1e-10 of
    the displacement."""
    nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext = _newton_problem(case)
    assert isinstance(tsys.material, MooneyRivlin) and tsys.fem.kind == "mr"
    jco = tco = None
    if coarse:
        jco = j_build_coarse(jsys, jstate.x, float(jparams.dt), float(jparams.rho))
        tco = build_coarse_precond(tsys, tstate.x, tparams.dt, tparams.rho)
    js, (jn, jc) = j_newton.make_rollout(jsys, jparams, 3, coarse=jco,
                                         precond_refresh=2)(jstate, f_ext)
    fk.reset_launch_counts()
    ts, (tn, tc) = newton.make_rollout(tsys, tparams, 3, coarse=tco,
                                       precond_refresh=2)(tstate, _t(f_ext))
    assert all(v == 0 for v in fk.LAUNCHES.values())  # CPU tensors: the twins
    assert tn == np.asarray(jn).tolist()
    assert tc == np.asarray(jc).tolist() and sum(tc) > 0
    jx = np.asarray(js.x)
    scale = np.abs(jx - nodes).max()
    assert scale > 0
    assert np.abs(ts.x.numpy() - jx).max() < 1e-10 * scale


def _beam_mr():
    """The beam of `tests/test_solvers.py` (1 x 0.1 x 0.1, 4 x 1 x 1 cells,
    the x=0 face pinned, gravity) with Mooney-Rivlin mapped from its E 1e6,
    nu 0.3, damping 1e2."""
    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 4, 1, 1)
    mat = JMR(**_mr_from_E_nu(1e6, 0.3, 1e2))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    return nodes, jsys, JStepState.rest(jsys, nodes), f_ext


# `tests/test_torch_first_order.py`'s parity settings.
FIRST_ORDER = {
    "adamw": (j_adamw, adamw, dict(dt=DT, rho=1e6, lr=1e-3, inner_tol=1e-4, inner_rtol=1e-2,
                                   max_outer=2, max_inner=300, convergence_check_interval=25)),
    "nesterov": (j_nesterov, nesterov, dict(dt=DT, rho=1e6, alpha=1e-5, inner_tol=1e-6,
                                            max_outer=3, max_inner=400)),
}


@pytest.mark.parametrize("solver", list(FIRST_ORDER))
def test_first_order_steps_match_jax(solver):
    """Two steps of AdamW or Nesterov on the MR beam: the same outer and
    inner counts, positions within 1e-9 of the displacement."""
    nodes, jsys, jstate, f_ext = _beam_mr()
    jmod, tmod, kw = FIRST_ORDER[solver]
    jparams = {"adamw": j_adamw.AdamWParams, "nesterov": j_nesterov.NesterovParams}[solver](**kw)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    assert isinstance(tsys.material, MooneyRivlin)
    jstep, tstep = jmod.make_step(jsys, jparams), tmod.make_step(tsys, tparams)
    for _ in range(2):
        jstate, jd = jstep(jstate, f_ext)
        tstate, td = tstep(tstate, _t(f_ext))
        assert td["outer_iters"] == int(jd["outer_iters"])
        assert td["inner_iters"] == int(jd["inner_iters"])
        jx = np.asarray(jstate.x)
        assert np.abs(tstate.x.numpy() - jx).max() < 1e-9 * np.abs(jx - nodes).max()


# --- the faults of the port this material showed ---------------------------


def test_fem_operator_takes_svk_and_mr_only(monkeypatch):
    """FemOperator reads the material's type, not its attributes: an object
    with SVK's attribute names is refused. Mooney-Rivlin builds with every
    family (the JAX `tile_material` is family-agnostic), a (family,
    material) pair without a CUDA source raises, and MR has no K3."""
    from dataclasses import dataclass

    from tlfea_torch.elements import ancf3243

    _, jsys, tsys, _ = _box_mr(True, box=(1.0, 0.3, 0.3, 2, 1, 1))

    @dataclass(frozen=True)
    class LooksLikeSVK:
        lam: float = 1.0
        mu: float = 1.0
        eta_damp: float = 0.0
        lam_damp: float = 0.0

    with pytest.raises(TypeError, match="no FEM kernel for material LooksLikeSVK"):
        fk.FemOperator(tsys.elems, LooksLikeSVK())
    coefs, conn = ancf3243.straight_beam(2, L=0.1)
    beam = ancf3243.build(coefs, conn, 0.1, 0.02, 0.02, rho=1000.0, device="cpu")
    op = fk.FemOperator(beam, tsys.material)
    assert (op.tag, op.source, op.prep_rows) == ("ancf3243_mr", "fem_ancf3243_mr.cu", 30)
    monkeypatch.delitem(fk.SOURCES, ("ancf3243", "mr"))
    with pytest.raises(ValueError, match="MooneyRivlin with ancf3243"):
        fk.FemOperator(beam, tsys.material)
    u = torch.zeros((tsys.n_coef, 3), dtype=torch.float64)
    for fn in (fk.svk_blocks, fk.svk_blocks_plain):
        with pytest.raises(ValueError, match="takes no MooneyRivlin"):
            fn(tsys.fem, u)


def test_resident_gate_is_shut_for_mr():
    """The persistent kernel takes Mooney-Rivlin where it has an
    instantiation (FEAT10, ANCF3243): a small pinned MR box passes the gate.
    The gate stays shut for MR on the ANCF3443 shell, which has none (nor a
    JAX resident path), and `resident.launch` refuses it."""
    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import ancf3443
    from tlfea_torch.ops import resident
    from tlfea_torch.solvers.common import StepState, System

    _, _, tsys, _ = _box_mr(True, box=(1.0, 0.3, 0.3, 2, 1, 1))
    assert tsys.fem.E <= resident.MAX_ELEMS
    assert resident.eligible(tsys, None)
    coefs, conn = ancf3443.shell_grid(2, 2, L=0.05, W=0.05)
    x0 = torch.as_tensor(coefs)
    shell = System(elems=ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0,
                                        device="cpu"),
                   material=tsys.material, constraints=FixedCoefs.from_indices([0, 1, 2, 3], x0))
    assert shell.fem.tag == "ancf3443_mr" and shell.fem.E <= resident.MAX_ELEMS
    assert not resident.eligible(shell, None)
    params = newton.NewtonParams(dt=DT, rho=1e6)
    state = StepState.rest(shell, x0)
    args = newton.inner_solve_args(shell, state, torch.zeros_like(state.x), params)
    with pytest.raises(ValueError, match="no newton_resident kernel for MooneyRivlin with "
                                         "ancf3443"):
        resident.launch(*args)
