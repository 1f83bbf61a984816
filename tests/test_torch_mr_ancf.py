"""Mooney-Rivlin with the ANCF element families in the torch port (the MR
twins of K1, K2, K5 and K5t at ANCF3243 and ANCF3443, the exact MR
preconditioner blocks, a Newton rollout) and the real cube root at an
inverted element, in float64 on the CPU against the JAX package.

The JAX side runs its XLA path (`_element_contrib_values` and its
`jax.jvp`, `jax.linearize` of `grad_L`): the JAX Pallas kernels take
`_MRTile` at these shapes too (`pallas_fem.tile_material` is family-
agnostic), but interpret-mode ANCF3443 takes minutes here. The port's
wrappers run their plain twins on the CPU, the algebra its CUDA kernels run
on the card (`tests/test_torch_cuda.py` holds those to the twins).

`_JMooneyRivlin` (from `tests/test_torch_mooney_rivlin.py`) is the JAX
material with F broadcast before its `tangent_diag_block` (the JAX
`precond_blocks` hands it an F that `jax.jvp` refuses), so that both
packages precondition with the same exact blocks.

Tolerances: 1e-12 relative for the twins, the blocks and the stress (the
same float64 arithmetic in another order), 1e-10 of the displacement for
the rollout, with identical Newton and CG lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mooney_rivlin import _JMooneyRivlin, _mr_from_E_nu
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements import ancf3443 as j_ancf3443
from tlfea.elements.assembly import _element_contrib_values
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.solvers.coarse import build_coarse_precond as j_build_coarse
from tlfea.solvers.common import grad_L as j_grad_L
from tlfea.solvers.common import precond_blocks as j_precond_blocks
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import MooneyRivlin
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers import newton
from tlfea_torch.solvers.coarse import build_coarse_precond
from tlfea_torch.solvers.common import _pin_terms, precond_blocks

torch.set_num_threads(2)

DT, RHO, RTOL = 1e-3, 1e7, 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _mr():
    """The flagship's material mapped to Mooney-Rivlin (E 1e7, nu 0.3,
    damping 1e3)."""
    return _JMooneyRivlin(**_mr_from_E_nu(1e7, 0.3, 1e3))


# family -> (mesh, extents, JAX module, u scale of the strained state): a
# 4-element beam and a 2-element shell strip; at these scales J - 1 spans
# about +-0.2 (checked in the test).
MESHES = {"ancf3243": (lambda: j_ancf3243.straight_beam(4, L=0.5), (0.5, 0.05, 0.05),
                       j_ancf3243, 2e-2),
          "ancf3443": (lambda: j_ancf3443.shell_grid(2, 1, L=0.05, W=0.05), (0.05, 0.05, 0.01),
                       j_ancf3443, 2e-3)}


def _system(family, material):
    """(coefs, JAX system, port system): the first node column clamped."""
    mesh, (L, W, H), jmod, _ = MESHES[family]
    coefs, conn = mesh()
    pos = coefs[0::4, 0]
    edge = np.nonzero(pos < pos.min() + 1e-12)[0]
    fixed = (4 * edge[:, None] + np.arange(4)[None, :]).reshape(-1)
    jsys = JSystem(elems=jmod.build(coefs, conn, L, W, H, rho=1000.0), material=material,
                   constraints=JFixedCoefs.from_indices(fixed, coefs))
    tsys, _, _ = from_numpy_system(jsys.elems, material, jsys.constraints, device="cpu")
    return coefs, jsys, tsys


def _state(family, n, n_fixed):
    rng = np.random.default_rng(17)
    return dict(u_prev=rng.normal(size=(n, 3)) * MESHES[family][3],
                v=rng.normal(size=(n, 3)) * 0.1, v_prev=rng.normal(size=(n, 3)) * 0.1,
                p=rng.normal(size=(n, 3)), lam=rng.normal(size=(n_fixed, 3)),
                f_ext=rng.normal(size=(n, 3)), dpacked=rng.normal(size=(n, 9)))


def _slots(a, op):
    """(E, S, 3) per-(element, slot) values -> the kernels' (S*3, E)."""
    return np.transpose(np.asarray(a), (1, 2, 0)).reshape(op.S * 3, op.E)


def _contrib_fn(jsys):
    def contrib(u, v, dvdt):
        return _element_contrib_values(u, v, dvdt, jsys.elems, jsys.material)
    return contrib


@pytest.mark.parametrize("family", ["ancf3243", "ancf3443"])
def test_mr_twins_match_jax(family):
    """K1's fe (and K5's), K5t, K2 and the assembled gradient and Hessian
    product against the JAX XLA path, damped, at a strained state."""
    coefs, jsys, tsys = _system(family, _mr())
    op = tsys.fem
    assert (op.tag, op.prep_rows) == (f"{family}_mr", 30)
    d = _state(family, len(coefs), int(jsys.constraints.idx.shape[0]))
    u = d["u_prev"] + DT * d["v"]
    dvdt = (d["v"] - d["v_prev"]) / DT
    packed = _t(np.concatenate([u, d["v"], dvdt], axis=1))
    dp = d["dpacked"]
    ref, dref = jax.jit(lambda x, dx: jax.jvp(_contrib_fn(jsys), x, dx))(
        tuple(jnp.asarray(a) for a in (u, d["v"], dvdt)),
        tuple(jnp.asarray(dp[:, 3 * k:3 * k + 3]) for k in range(3)))
    fe, prep = fk.primal_prep_plain(op, packed)
    jm1 = prep.view(op.Q, 30, op.E)[:, 18]
    assert 0.1 < float(jm1.abs().max()) < 0.5  # strained, not inverted
    assert _rel(fe.numpy(), _slots(ref, op)) < RTOL
    assert torch.equal(fk.contrib_plain(op, packed), fe)
    assert _rel(fk.contrib_tangent_plain(op, packed, _t(dp)).numpy(), _slots(dref, op)) < RTOL

    # K2 along the Newton chain (dt p, p, p / dt), per element and assembled
    # with the pins against jax.linearize of grad_L.
    def contrib_v(v):
        return _contrib_fn(jsys)(jnp.asarray(d["u_prev"]) + DT * v, v,
                                 (v - jnp.asarray(d["v_prev"])) / DT)

    def g(v):
        return j_grad_L(v, jnp.asarray(coefs + d["u_prev"]), jnp.asarray(d["v_prev"]),
                        jnp.asarray(d["lam"]), jnp.asarray(d["f_ext"]), DT, RHO, jsys,
                        u_prev=jnp.asarray(d["u_prev"]))

    hv_ref, g0, hg = jax.jit(lambda v, p: (jax.jvp(contrib_v, (v,), (p,))[1],
                                           *jax.jvp(g, (v,), (p,))))(jnp.asarray(d["v"]),
                                                                     jnp.asarray(d["p"]))
    assert _rel(fk.hv_plain(op, _t(d["p"]), prep, DT).numpy(), _slots(hv_ref, op)) < RTOL
    pins = _pin_terms(tsys, _t(d["lam"]), DT, RHO, torch.float64)
    gt, hvp = fk.g_and_hvp(_t(d["v"]), _t(d["u_prev"]), _t(d["v_prev"]), _t(d["f_ext"]), DT,
                           op, pins)
    assert _rel(gt.numpy(), g0) < RTOL
    assert _rel(hvp(_t(d["p"])).numpy(), hg) < RTOL


@pytest.mark.parametrize("family", ["ancf3243", "ancf3443"])
def test_mr_precond_blocks_match_jax(family):
    """The exact MR blocks (three JVPs of first_piola per element and slot)
    with the fold, mass, pins and shift, against the JAX XLA branch."""
    coefs, jsys, tsys = _system(family, _mr())
    d = _state(family, len(coefs), int(jsys.constraints.idx.shape[0]))
    x_prev = coefs + d["u_prev"]
    want = jax.jit(lambda v, x, up: j_precond_blocks(v, x, DT, RHO, jsys, u_prev=up))(
        jnp.asarray(d["v"]), jnp.asarray(x_prev), jnp.asarray(d["u_prev"]))
    got = precond_blocks(_t(d["v"]), _t(x_prev), DT, RHO, tsys, u_prev=_t(d["u_prev"]))
    assert _rel(got.numpy(), want) < RTOL


def test_mr_ancf3243_rollout_matches_jax():
    """Three Newton steps of a clamped MR cantilever under gravity with the
    frozen coarse correction (the composed path; without it the resident
    gate takes the beam, `tests/test_torch_resident_pairs.py`): identical
    Newton and CG lists, positions within 1e-10 of the displacement."""
    coefs, jsys, _ = _system("ancf3243", _mr())
    jstate = JStepState.rest(jsys, coefs)
    f_ext = jnp.zeros((len(coefs), 3)).at[:, 2].add(j_lumped_mass(jsys.elems) * -9.81)
    fs = float(jnp.linalg.norm(f_ext))
    jparams = j_newton.NewtonParams(dt=DT, rho=RHO, inner_atol=1e-3 * fs, inner_rtol=0.0,
                                    outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                    cg_max_iter=50, ew_eta_max=0.5)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    assert isinstance(tsys.material, MooneyRivlin) and tsys.fem.tag == "ancf3243_mr"
    jco = j_build_coarse(jsys, jstate.x, DT, RHO, target_cluster=2)
    tco = build_coarse_precond(tsys, tstate.x, DT, RHO, target_cluster=2)
    js, (jn, jc) = j_newton.make_rollout(jsys, jparams, 3, coarse=jco,
                                         precond_refresh=2)(jstate, f_ext)
    ts, (tn, tc) = newton.make_rollout(tsys, tparams, 3, coarse=tco,
                                       precond_refresh=2)(tstate, _t(f_ext))
    assert tn == np.asarray(jn).tolist()
    assert tc == np.asarray(jc).tolist() and sum(tc) > 0
    jx = np.asarray(js.x)
    scale = np.abs(jx - coefs).max()
    assert scale > 0 and np.abs(ts.x.numpy() - jx).max() < 1e-10 * scale


def test_mr_stress_is_finite_at_an_inverted_point():
    """det F < 0: the real cube root (negative, as `jnp.cbrt`) keeps the
    port's stress finite and equal to the JAX package's, where J.pow(1/3)
    gives NaN. The material (first_piola, first_piola_du, the exact blocks
    through torch.func.jvp), `_mr_coefs`, and the element twins of K1 and
    K2 on the beam mirrored in x (F ~ diag(-1, 1, 1) plus a strain)."""
    jm = _mr()
    tm = MooneyRivlin(jm.mu10, jm.mu01, jm.kappa, jm.eta_damp, jm.lam_damp)
    rng = np.random.default_rng(23)
    Du = 0.1 * rng.normal(size=(5, 3, 3))
    Du[:, 0, 0] -= 2.0  # mirrored in x
    F = Du + np.eye(3)
    assert np.linalg.det(F).max() < 0
    for name, arg in (("first_piola", F), ("first_piola_du", Du)):
        got = getattr(tm, name)(_t(arg)).numpy()
        assert np.isfinite(got).all() and _rel(got, getattr(jm, name)(jnp.asarray(arg))) < RTOL
    h = rng.normal(size=(5, 3))
    got = tm.tangent_diag_block(_t(F), _t(h)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, jm.tangent_diag_block(jnp.asarray(F), jnp.asarray(h))) < RTOL
    Jm1 = _t(np.linalg.det(F) - 1.0)
    assert all(bool(torch.isfinite(c).all()) for c in fk._mr_coefs(Jm1, tm))

    coefs, jsys, tsys = _system("ancf3243", jm)
    op = tsys.fem
    d = _state("ancf3243", len(coefs), int(jsys.constraints.idx.shape[0]))
    u = d["u_prev"] - 2.0 * coefs * np.array([1.0, 0.0, 0.0])  # every row's x mirrored
    dvdt = (d["v"] - d["v_prev"]) / DT
    fe, prep = fk.primal_prep_plain(op, _t(np.concatenate([u, d["v"], dvdt], axis=1)))
    assert float(prep.view(op.Q, 30, op.E)[:, 18].max()) < -1.0  # J < 0 everywhere
    # K1's f_e, and K2's product: the derivative along the Newton chain
    # (dt p, p, p / dt).
    ref, full = jax.jit(lambda x, v, a, p: jax.jvp(
        lambda w: _contrib_fn(jsys)(x + DT * w, v + w, a + w / DT), (jnp.zeros_like(p),),
        (p,)))(*(jnp.asarray(a) for a in (u, d["v"], dvdt, d["p"])))
    assert bool(torch.isfinite(fe).all()) and _rel(fe.numpy(), _slots(ref, op)) < RTOL
    hv = fk.hv_plain(op, _t(d["p"]), prep, DT)
    assert bool(torch.isfinite(hv).all()) and _rel(hv.numpy(), _slots(full, op)) < RTOL
