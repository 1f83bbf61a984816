"""The whole coarse correction of the torch port (`tlfea_torch.solvers.coarse`)
against the JAX package, in float64 on the CPU.

On the slender stiff SVK beam of `tests/test_coarse_precond.py:19-31` (the
case where block-Jacobi CG stalls): the frozen correction in each mode
(k = 3, 6, 12), the range mode, the bfloat16 factored apply and the
spectral truncation; one Newton step with each; the legacy per-solve
two-level path (`CoarseSetup`); and `alm_residual_contributions`. Both
packages start from the same arrays (`interop.from_numpy_system`).
bfloat16 is held at the JAX package's own bar (3e-2 of the apply's scale,
x within 1e-3 and CG at most 1.3 x + 2): torch's CPU bfloat16 products and
XLA's accumulate in other orders, so they never agree bit for bit.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import alm_residual_contributions as j_alm_contrib
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.simulation import gravity_force as j_gravity
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.solvers.coarse import build_aggregates as j_build_aggregates
from tlfea.solvers.coarse import build_coarse_precond as j_build_coarse
from tlfea.solvers.coarse import coarse_operator as j_coarse_operator
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.elements.assembly import alm_residual_contributions
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.solvers import newton
from tlfea_torch.solvers.coarse import (
    CoarseSetup, build_aggregates, build_coarse_precond, coarse_operator,
)

torch.set_num_threads(2)

DT, RHO = 1e-3, 1e9
# tests/test_coarse_precond.py's Newton tolerances with the default
# Eisenstat-Walker forcing, at dt 1e-3: its dt 5e-3 with cg_rtol 1e-6 takes
# ~2,100 CG iterations in the 3-mode correction, whose count then moves by
# 2 with the order of float64 sums; here 579 (trans) to 111 (rigid).
PARAMS = dict(dt=DT, rho=RHO, inner_atol=1e-7, inner_rtol=1e-8, max_outer=1, max_inner=8,
              cg_rtol=1e-4, cg_max_iter=400, ew_eta_max=0.5)
_BUILDS = {}


@pytest.fixture(scope="module")
def beam():
    """The stiff slender cantilever (1 x 0.05 x 0.05 m, 12 x 1 x 1 cells, E
    2e9, nu 0), in both packages, float64."""
    nodes, conn = box_t10_mesh(1.0, 0.05, 0.05, 12, 1, 1)
    lam, mu = lame_from_E_nu(2e9, 0.0)
    mat = JSVK(lam=lam, mu=mu, eta_damp=2e4, lam_damp=2e4)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    jstate = JStepState.rest(jsys, nodes)
    jparams = j_newton.NewtonParams(**PARAMS)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              jstate, jparams, device="cpu")
    f_ext = np.asarray(j_gravity(jsys))
    return nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext


def _build(beam, **kw):
    """(JAX's, the port's) correction built with kw, each built once."""
    key = tuple(sorted(kw.items()))
    if key not in _BUILDS:
        nodes, (jsys, *_), (tsys, *_), _ = beam
        _BUILDS[key] = (j_build_coarse(jsys, nodes, DT, RHO, **kw),
                        build_coarse_precond(tsys, torch.as_tensor(nodes), DT, RHO, **kw))
    return _BUILDS[key]


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _cond_tol(Ainv) -> float:
    """1e-12, or the forward-error bound of the coarse solve, 8 eps
    kappa(A_c), where that is larger: each package's inverse is exact only
    to eps kappa, and on this beam kappa reaches 1.5e5 (rigid, affine), so
    two correct factorisations differ by ~1e-12 and their applies by up to
    ~5e-12 (measured) of the scale."""
    A = np.asarray(Ainv, dtype=np.float64)
    return max(1e-12, 8 * np.finfo(np.float64).eps * np.linalg.cond(A))


def _residuals(nodes, n=2):
    rng = np.random.default_rng(3)
    return [rng.standard_normal(nodes.shape) for _ in range(n)]


@pytest.mark.parametrize("modes,k", [("trans", 3), ("rigid", 6), ("affine", 12)])
def test_modes_match_jax(beam, modes, k):
    """Aggregates (exactly), lever arms (1e-12 relative), the inverse and
    the apply of each mode (`_cond_tol`), and the apply on JAX's inverse,
    which holds the mode's restrict and prolong, within 1e-12 of its scale;
    rotations=False is "trans"."""
    nodes = beam[0]
    jc, tc = _build(beam, modes=modes)
    assert tc.k_modes == jc.k_modes == k and tc.n_agg == jc.n_agg
    np.testing.assert_array_equal(tc.Agg.numpy(), np.asarray(jc.Agg))
    np.testing.assert_array_equal(tc.agg.numpy(), np.asarray(jc.Agg).argmax(axis=0))
    assert _rel(tc.u0.numpy(), jc.u0) < 1e-12
    assert tc.Ainv.shape == (k * jc.n_agg,) * 2
    tol = _cond_tol(jc.Ainv)
    assert _rel(tc.Ainv.numpy(), jc.Ainv) < tol
    shared = replace(tc, Ainv=torch.as_tensor(np.array(jc.Ainv)))
    for r in _residuals(nodes):
        want = np.asarray(jc.apply(jnp.asarray(r)))
        assert _rel(tc.apply(torch.as_tensor(r)).numpy(), want) < tol
        assert _rel(shared.apply(torch.as_tensor(r)).numpy(), want) < 1e-12
    if modes == "trans":
        t3 = build_coarse_precond(beam[2][0], torch.as_tensor(nodes), DT, RHO, rotations=False)
        assert t3.k_modes == 3
        torch.testing.assert_close(t3.Ainv, tc.Ainv, rtol=0, atol=0)


def test_ranges_matches_jax(beam):
    """The range mode builds the dense mode's aggregates; the JAX package's
    factored restrict equals the port's dense one to rounding."""
    nodes = beam[0]
    jc, tc = _build(beam, ranges=True)
    assert jc.seg > 0 and tc.ranges
    _, dense = _build(beam)
    torch.testing.assert_close(tc.Ainv, dense.Ainv, rtol=0, atol=0)
    for r in _residuals(nodes):
        want = np.asarray(jc.apply(jnp.asarray(r)))
        assert _rel(tc.apply(torch.as_tensor(r)).numpy(), want) < _cond_tol(dense.Ainv)


def test_bf16_apply(beam):
    """The JAX package's dtypes (no Ainv; Li and Agg in bfloat16), the
    result in r's dtype, within 3e-2 of JAX's bfloat16 apply and of the
    full-precision apply; the range mode's the same."""
    nodes = beam[0]
    jc, tc = _build(beam, mm_dtype="bfloat16")
    assert jc.Ainv is None and jc.Li.dtype == jnp.bfloat16 and jc.Agg.dtype == jnp.bfloat16
    assert tc.Ainv is None and tc.Li.dtype == torch.bfloat16 and tc.Agg.dtype == torch.bfloat16
    _, full = _build(beam)
    tr = build_coarse_precond(beam[2][0], torch.as_tensor(nodes), DT, RHO, ranges=True,
                              mm_dtype="bfloat16")
    for r in _residuals(nodes):
        rt = torch.as_tensor(r)
        z = tc.apply(rt)
        assert z.dtype == rt.dtype
        zf = full.apply(rt).numpy()
        assert _rel(z.numpy(), zf) < 3e-2
        assert _rel(z.numpy(), np.asarray(jc.apply(jnp.asarray(r)))) < 3e-2
        torch.testing.assert_close(tr.apply(rt), z, rtol=0, atol=0)
    # The factor is L^-1 rounded: Li^T Li is the inverse to bfloat16's precision.
    M = (tc.Li.double().T @ tc.Li.double()).numpy()
    assert _rel(M, full.Ainv.numpy()) < 3e-2


def test_rank_truncation(beam):
    """rank=r: the whitened basis W (K, r) of the r smallest eigenvalues, W
    W^T within 1e-8 of JAX's (the eigenvectors' signs are free), and an
    apply that is symmetric and positive semi-definite."""
    nodes = beam[0]
    _, full = _build(beam)
    K = full.Ainv.shape[0]
    r = max(6, K // 2)
    jc, tc = _build(beam, rank=r)
    assert tc.Ainv is None and tc.W.shape == (K, r) and jc.W.shape == (K, r)
    WW = (tc.W @ tc.W.T).numpy()
    assert _rel(WW, np.asarray(jc.W) @ np.asarray(jc.W).T) < 1e-8
    a, b = (torch.as_tensor(x) for x in _residuals(nodes))
    ab, ba = float((b * tc.apply(a)).sum()), float((a * tc.apply(b)).sum())
    assert abs(ab - ba) <= 1e-9 * max(abs(ab), abs(ba))
    assert float((a * tc.apply(a)).sum()) >= 0.0
    assert _rel(tc.apply(a).numpy(), np.asarray(jc.apply(jnp.asarray(a.numpy())))) < 1e-8


def _steps(beam, jco, tco):
    nodes, (jsys, jstate, jparams), (tsys, tstate, tparams), f_ext = beam
    js, jd = j_newton.step(jsys, jstate, jparams, jnp.asarray(f_ext), jco)
    ts, td = newton.make_step(tsys, tparams, coarse=tco)(tstate, torch.as_tensor(f_ext))
    jx = np.asarray(js.x)
    err = np.abs(ts.x.numpy() - jx).max() / np.abs(jx - nodes).max()
    return err, (td["newton_iters"], td["cg_iters"]), (int(jd["newton_iters"]),
                                                       int(jd["cg_iters"]))


@pytest.mark.parametrize("kw", [dict(modes="trans"), dict(modes="rigid"),
                                dict(modes="affine"), dict(ranges=True),
                                dict(mm_dtype="bfloat16")],
                         ids=["trans", "rigid", "affine", "ranges", "bf16"])
def test_newton_step_matches_jax(beam, kw):
    """One Newton step preconditioned by each mode: equal Newton and CG
    counts and x within 1e-10 of the displacement scale; bfloat16 within
    1e-3, its CG at most 1.3 x JAX's + 2."""
    jco, tco = _build(beam, **kw)
    err, (tn, tcg), (jn, jcg) = _steps(beam, jco, tco)
    assert tcg > 0
    if "mm_dtype" in kw:
        assert err < 1e-3, err
        assert tcg <= 1.3 * jcg + 2, (tcg, jcg)
    else:
        assert err < 1e-10, err
        assert (tn, tcg) == (jn, jcg)


def test_legacy_two_level(beam):
    """The per-solve path: build_aggregates as JAX's, coarse_operator within
    1e-12 and SPD, and a step with make_step(coarse=CoarseSetup) with equal
    counts, x within 1e-10."""
    nodes, (jsys, jstate, jparams), (tsys, tstate, _), _ = beam
    jset = j_build_aggregates(nodes)
    tset = build_aggregates(nodes, device="cpu")
    assert isinstance(tset, CoarseSetup) and tset.n_agg == jset.n_agg
    np.testing.assert_array_equal(tset.agg.numpy(), np.asarray(jset.agg))
    x = nodes + 1e-3 * np.random.default_rng(5).standard_normal(nodes.shape)
    jA = np.asarray(j_coarse_operator(jnp.asarray(x), jsys.elems, jsys.material,
                                      jsys.constraints, jset, DT, RHO))
    tA = coarse_operator(torch.as_tensor(x), tsys.elems, tsys.material, tsys.constraints,
                         tset, DT, RHO)
    assert tA.shape == (3 * tset.n_agg,) * 2
    assert _rel(tA.numpy(), jA) < 1e-12
    torch.testing.assert_close(tA, tA.T, rtol=0, atol=0)
    assert float(torch.linalg.eigvalsh(tA).min()) > 0.0
    err, tcounts, jcounts = _steps(beam, jset, tset)
    assert err < 1e-10, err
    assert tcounts == jcounts and tcounts[1] > 0


def test_alm_residual_contributions(beam):
    """M dv/dt + f_int(u, v) summed onto the nodes (K5 + K4 twins) against
    JAX's fused element contributions, 1e-12."""
    nodes, (jsys, *_), (tsys, *_), _ = beam
    rng = np.random.default_rng(11)
    u, v, a = (1e-3 * rng.standard_normal(nodes.shape) for _ in range(3))
    want = np.asarray(j_alm_contrib(jnp.asarray(u), jnp.asarray(v), jnp.asarray(a),
                                    jsys.elems, jsys.material))
    got = alm_residual_contributions(*(torch.as_tensor(t) for t in (u, v, a)), tsys.elems,
                                     tsys.material)
    assert _rel(got.numpy(), want) < 1e-12
