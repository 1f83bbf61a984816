"""FEM element kernels of the torch port (`tlfea_torch.ops.fem_kernels`).

On the CPU each wrapper runs its plain PyTorch twin, and the twins are held
in float64 against the JAX package's XLA path on a 3x1x1 box (18 FEAT10
elements, damped SVK, pinned face), the same reference the JAX Pallas
kernels are held to:

- K1 primal_prep: per-element contributions against
  `assembly._element_contrib_values`, the prep cache against the JAX tile
  algebra, and the assembled gradient against `grad_L`;
- K2 hv: against the tangent of `jax.linearize(grad_L)`;
- K3 svk_blocks: against `precond_blocks`' einsum branch;
- K4 node_reduce: against `.at[].add`;
- K5 contrib and K5t contrib_tangent (the port of `pallas_fem._body`,
  primal and tangent): against `_element_contrib_values` and its `jax.jvp`
  along independent tangents of u, v and dv/dt, for all three element
  families, the reference `tests/test_pallas_fem.py` holds `_body` to. The
  Pallas kernel itself in interpret mode takes about two minutes on a
  one-cell box here, so the XLA path is the reference.

Tolerance 1e-12 relative: the same float64 arithmetic in another summation
order. The CUDA kernels themselves are held against these twins on the
card by `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements import ancf3443 as j_ancf3443
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import _element_contrib_values, center_translation
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.ops.pallas_fem import _svk_stress_rows
from tlfea.solvers import System as JSystem
from tlfea.solvers.common import grad_L, precond_blocks as j_precond_blocks
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers.common import precond_blocks
from tlfea_torch.solvers.newton import _pin_terms

torch.set_num_threads(2)

DT, RHO = 1e-3, 1e7
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def prob():
    nodes, conn = box_t10_mesh(1.0, 0.2, 0.2, 3, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
               eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(1e3))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    tsys, _, _ = from_numpy_system(jsys.elems, mat, jsys.constraints, device="cpu")
    n = len(nodes)
    rng = np.random.default_rng(0)
    d = dict(
        u_prev=rng.normal(size=(n, 3)) * 1e-2, v=rng.normal(size=(n, 3)) * 0.1,
        v_prev=rng.normal(size=(n, 3)) * 0.1, p=rng.normal(size=(n, 3)),
        lam=rng.normal(size=(len(fixed), 3)), f_ext=rng.normal(size=(n, 3)),
    )
    return jsys, tsys, nodes, d


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _packed(d):
    u = d["u_prev"] + DT * d["v"]
    return u, np.concatenate([u, d["v"], (d["v"] - d["v_prev"]) / DT], axis=1)


def _port_g_and_hvp(tsys, d):
    pins = _pin_terms(tsys, _t(d["lam"]), DT, RHO, torch.float64)
    return fk.g_and_hvp(_t(d["v"]), _t(d["u_prev"]), _t(d["v_prev"]), _t(d["f_ext"]), DT,
                        tsys.fem, pins)


def _jax_grad_L(jsys, nodes, d):
    def g(v):
        return grad_L(v, jnp.asarray(nodes + d["u_prev"]), jnp.asarray(d["v_prev"]),
                      jnp.asarray(d["lam"]), jnp.asarray(d["f_ext"]), DT, RHO, jsys,
                      u_prev=jnp.asarray(d["u_prev"]))
    return g


def test_primal_prep_twin_matches_jax(prob):
    jsys, tsys, nodes, d = prob
    op = tsys.fem
    u, packed = _packed(d)
    fe, prep = fk.primal_prep_plain(op, _t(packed))
    ref = _element_contrib_values(jnp.asarray(u), jnp.asarray(d["v"]),
                                  jnp.asarray((d["v"] - d["v_prev"]) / DT), jsys.elems,
                                  jsys.material)  # (E, S, 3)
    assert _rel(fe.numpy(), np.transpose(np.asarray(ref), (1, 2, 0)).reshape(op.S * 3, op.E)) < RTOL

    # Prep cache: Du, total S0 and Fd per QP, from the JAX tile algebra.
    pe = jnp.asarray(packed)[jsys.elems.conn]
    Du = jnp.einsum("eai,eqaj->eqij", center_translation(pe[..., 0:3], jsys.elems),
                    jsys.elems.grad_N)
    Fd = jnp.einsum("eai,eqaj->eqij", center_translation(pe[..., 3:6], jsys.elems),
                    jsys.elems.grad_N)
    mat = jsys.material
    _, S0 = _svk_stress_rows([[Du[..., i, j] for j in range(3)] for i in range(3)],
                             [[Fd[..., i, j] for j in range(3)] for i in range(3)],
                             float(mat.lam), float(mat.mu), float(mat.eta_damp),
                             float(mat.lam_damp))
    S0 = jnp.stack([jnp.stack(row, -1) for row in S0], -2)
    want = jnp.concatenate([a.reshape(op.E, op.Q, 9) for a in (Du, S0, Fd)], axis=-1)
    got = prep.numpy().reshape(op.Q, op.prep_rows, op.E).transpose(2, 0, 1)
    assert _rel(got, want) < RTOL

    g, _ = _port_g_and_hvp(tsys, d)
    assert _rel(g.numpy(), _jax_grad_L(jsys, nodes, d)(jnp.asarray(d["v"]))) < RTOL


def test_hv_twin_matches_jax_linearize(prob):
    jsys, tsys, nodes, d = prob
    op = tsys.fem
    _, hvp = _port_g_and_hvp(tsys, d)
    _, f_jvp = jax.linearize(_jax_grad_L(jsys, nodes, d), jnp.asarray(d["v"]))
    assert _rel(hvp(_t(d["p"])).numpy(), f_jvp(jnp.asarray(d["p"]))) < RTOL

    # Per element: K2 against the JVP of the element contribution.
    def contrib(v):
        return _element_contrib_values(jnp.asarray(d["u_prev"]) + DT * v, v,
                                       (v - jnp.asarray(d["v_prev"])) / DT, jsys.elems,
                                       jsys.material)

    _, ref = jax.jvp(contrib, (jnp.asarray(d["v"]),), (jnp.asarray(d["p"]),))
    _, packed = _packed(d)
    _, prep = fk.primal_prep_plain(op, _t(packed))
    got = fk.hv_plain(op, _t(d["p"]), prep, DT)
    assert _rel(got.numpy(), np.transpose(np.asarray(ref), (1, 2, 0)).reshape(op.S * 3, op.E)) < RTOL


def test_svk_blocks_twin_matches_precond_blocks(prob):
    jsys, tsys, nodes, d = prob
    x_prev = nodes + d["u_prev"]
    want = j_precond_blocks(jnp.asarray(d["v"]), jnp.asarray(x_prev), DT, RHO, jsys,
                            u_prev=jnp.asarray(d["u_prev"]))
    got = precond_blocks(_t(d["v"]), _t(x_prev), DT, RHO, tsys, u_prev=_t(d["u_prev"]))
    assert _rel(got.numpy(), want) < RTOL

    # Per element and slot: K3 against the einsum branch before its scatter.
    op = tsys.fem
    u = jnp.asarray(d["u_prev"] + DT * d["v"])
    F = jnp.einsum("eai,eqaj->eqij", u[jsys.elems.conn], jsys.elems.grad_N) + jnp.eye(3)
    Kb = jsys.material.tangent_diag_block(F[:, :, None], jsys.elems.grad_N)
    Kb = (Kb * jsys.elems.dV[:, :, None, None, None]).sum(axis=1)  # (E, S, 3, 3)
    ref = np.stack([Kb[..., a, b] for a, b in fk.SYM6], axis=-1)  # (E, S, 6)
    got = fk.svk_blocks_plain(op, _t(d["u_prev"] + DT * d["v"]))
    assert _rel(got.numpy(), np.transpose(ref, (1, 2, 0)).reshape(op.S * 6, op.E)) < RTOL


@pytest.mark.parametrize("C", [3, 6])
def test_node_reduce_twin_matches_scatter_add(prob, C):
    jsys, tsys, _, _ = prob
    op = tsys.fem
    vals = np.random.default_rng(C).normal(size=(op.E, op.S, C))
    want = jnp.zeros((op.n, C)).at[jsys.elems.conn.reshape(-1)].add(vals.reshape(-1, C))
    got = fk.node_reduce_plain(op, _t(np.transpose(vals, (1, 2, 0)).reshape(op.S * C, op.E)))
    assert _rel(got.numpy(), want) < RTOL


def test_wrappers_run_the_twins_on_cpu_without_launching(prob):
    _, tsys, _, d = prob
    op = tsys.fem
    _, packed = _packed(d)
    fk.reset_launch_counts()
    fe, prep = fk.primal_prep(op, _t(packed))
    fe2, prep2 = fk.primal_prep_plain(op, _t(packed))
    assert torch.equal(fe, fe2) and torch.equal(prep, prep2)
    assert torch.equal(fk.hv(op, _t(d["p"]), prep, DT), fk.hv_plain(op, _t(d["p"]), prep, DT))
    u = _t(d["u_prev"])
    assert torch.equal(fk.svk_blocks(op, u), fk.svk_blocks_plain(op, u))
    assert torch.equal(fk.node_reduce(op, fe), fk.node_reduce_plain(op, fe))
    assert torch.equal(fk.contrib(op, _t(packed)), fk.contrib_plain(op, _t(packed)))
    dp = _t(packed[::-1].copy())
    assert torch.equal(fk.contrib_tangent(op, _t(packed), dp),
                       fk.contrib_tangent_plain(op, _t(packed), dp))
    assert all(v == 0 for v in fk.LAUNCHES.values())


def test_wrappers_reject_what_the_kernels_do_not_take(prob):
    _, tsys, _, d = prob
    op = tsys.fem
    _, packed = _packed(d)
    with pytest.raises(ValueError, match="expected a contiguous"):
        fk.primal_prep(op, _t(packed)[:, :6])
    with pytest.raises(ValueError, match="expected a contiguous"):
        fk.hv(op, _t(d["p"]).t().contiguous().t(), torch.zeros(op.Q * op.prep_rows, op.E,
                                                                  dtype=torch.float64), DT)
    with pytest.raises(ValueError, match="tables are"):
        fk.svk_blocks(op, _t(d["p"]).float())
    with pytest.raises(ValueError, match="tables are"):
        fk.node_reduce(op, torch.zeros(op.S * 3, op.E, dtype=torch.float64, device="meta"))


def test_element_algebra_and_helpers_match_jax(prob):
    """The plain modules under the kernels: assembly, SVK, 3x3 algebra,
    gather/scatter, constraints and the solver helpers."""
    from tlfea.elements import assembly as j_asm
    from tlfea.ops import linalg as j_linalg
    from tlfea.ops import segment as j_segment
    from tlfea.solvers.common import constraint_values as j_constraint_values
    from tlfea.solvers.common import suggest_rho as j_suggest_rho
    from tlfea_torch.elements import assembly as t_asm
    from tlfea_torch.ops import linalg as t_linalg
    from tlfea_torch.ops import segment as t_segment
    from tlfea_torch.solvers.common import constraint_values, flat_norm, grad_L as t_grad_L
    from tlfea_torch.solvers.common import suggest_rho

    jsys, tsys, nodes, d = prob
    je, te = jsys.elems, tsys.elems
    rng = np.random.default_rng(11)
    A = rng.normal(size=(7, 3, 3))
    A[0] = 0.0  # singular: the eps clamp
    assert _rel(t_linalg.det3x3(_t(A)).numpy(), j_linalg.det3x3(jnp.asarray(A))) < RTOL
    assert _rel(t_linalg.inv3x3(_t(A), eps=1e-30).numpy(),
                j_linalg.inv3x3(jnp.asarray(A), eps=1e-30)) < RTOL

    x = rng.normal(size=(te.n_coef, 4))
    ae = t_segment.gather_coefs(_t(x), te.conn)
    assert np.array_equal(ae.numpy(), np.asarray(j_segment.gather_coefs(jnp.asarray(x), je.conn)))
    assert _rel(t_segment.coef_scatter_add(ae, te.conn, te.n_coef).numpy(),
                j_segment.coef_scatter_add(jnp.asarray(ae.numpy()), je.conn, je.n_coef)) < RTOL
    assert np.array_equal(t_asm.center_translation(ae, te).numpy(),
                          np.asarray(j_asm.center_translation(jnp.asarray(ae.numpy()), je)))
    assert _rel(t_asm.mass_diag(te).numpy(), j_asm.mass_diag(je)) < RTOL
    assert _rel(t_asm.lumped_mass(te).numpy(), j_asm.lumped_mass(je)) < RTOL
    assert np.array_equal(t_asm.node_ref(te).numpy(), np.asarray(j_asm.node_ref(je)))

    Du, Fd = rng.normal(size=(2, 6, 3, 3)) * 0.1
    h = rng.normal(size=(6, 3))
    jm, tm = jsys.material, tsys.material
    assert _rel(tm.first_piola_du(_t(Du)).numpy(), jm.first_piola_du(jnp.asarray(Du))) < RTOL
    assert _rel(tm.tangent_diag_block(_t(Du) + torch.eye(3), _t(h)).numpy(),
                jm.tangent_diag_block(jnp.asarray(Du) + jnp.eye(3), jnp.asarray(h))) < RTOL
    assert _rel(t_asm.viscous_piola(_t(Du) + torch.eye(3), _t(Fd), 1e3, 2e3).numpy(),
                j_asm.viscous_piola(jnp.asarray(Du) + jnp.eye(3), jnp.asarray(Fd), 1e3, 2e3)) < RTOL

    x_prev = nodes + d["u_prev"]
    jargs = (jnp.asarray(x_prev), jnp.asarray(d["v"]), DT, je)
    targs = (_t(x_prev), _t(d["v"]), DT, te)
    assert _rel(constraint_values(tsys.constraints, *targs, u_prev=_t(d["u_prev"])).numpy(),
                j_constraint_values(jsys.constraints, *jargs, u_prev=jnp.asarray(d["u_prev"]))) < RTOL
    assert _rel(t_grad_L(_t(d["v"]), _t(x_prev), _t(d["v_prev"]), _t(d["lam"]), _t(d["f_ext"]),
                         DT, RHO, tsys, u_prev=_t(d["u_prev"])).numpy(),
                _jax_grad_L(jsys, nodes, d)(jnp.asarray(d["v"]))) < RTOL
    assert suggest_rho(te, tm, DT) == pytest.approx(j_suggest_rho(je, jm, DT), rel=1e-14)
    assert float(flat_norm(_t(x))) == pytest.approx(float(np.linalg.norm(x)), rel=1e-14)


def _family_case(family):
    """(JAX element batch, JAX material, port system) of a small mesh of the
    family, damped SVK, float64 on the CPU."""
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
               eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(2e3))
    if family == "feat10":
        nodes, conn = box_t10_mesh(1.0, 0.2, 0.2, 3, 1, 1)
        elems = j_feat10.build(nodes, conn, rho=1000.0)
    elif family == "ancf3243":
        coefs, conn = j_ancf3243.straight_beam(4, L=0.5)
        elems = j_ancf3243.build(coefs, conn, 0.5, 0.05, 0.05, rho=1000.0)
    else:
        coefs, conn = j_ancf3443.shell_grid(3, 2, L=0.05, W=0.05)
        elems = j_ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0)
    tsys, _, _ = from_numpy_system(elems, mat, device="cpu")
    assert tsys.fem.family == family
    return elems, mat, tsys


@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
def test_contrib_twins_match_jax(family):
    """K5's twin against `_element_contrib_values`, and K5t's twin against
    its `jax.jvp` along independent tangents (du, dv, d(dv/dt))."""
    elems, mat, tsys = _family_case(family)
    op = tsys.fem
    rng = np.random.default_rng(21)
    n = op.n
    prim = [rng.normal(size=(n, 3)) * s for s in (1e-2, 0.1, 10.0)]  # u, v, dv/dt
    tang = [rng.normal(size=(n, 3)) for _ in range(3)]
    ref, dref = jax.jvp(lambda u, v, a: _element_contrib_values(u, v, a, elems, mat),
                        tuple(map(jnp.asarray, prim)), tuple(map(jnp.asarray, tang)))

    def slots(x):
        return np.transpose(np.asarray(x), (1, 2, 0)).reshape(op.S * 3, op.E)

    packed, dpacked = _t(np.concatenate(prim, axis=1)), _t(np.concatenate(tang, axis=1))
    assert _rel(fk.contrib_plain(op, packed).numpy(), slots(ref)) < RTOL
    assert _rel(fk.contrib_tangent_plain(op, packed, dpacked).numpy(), slots(dref)) < RTOL


def test_contrib_twins_agree_with_k1_and_k2(prob):
    """K5's twin is K1's fe to the bit; K5t's twin along the Newton chain
    (dt p, p, p/dt) is K2's product."""
    _, tsys, _, d = prob
    op = tsys.fem
    _, packed = _packed(d)
    fe, prep = fk.primal_prep_plain(op, _t(packed))
    assert torch.equal(fk.contrib_plain(op, _t(packed)), fe)
    p = d["p"]
    chain = _t(np.concatenate([DT * p, p, p / DT], axis=1))
    assert _rel(fk.contrib_tangent_plain(op, _t(packed), chain).numpy(),
                fk.hv_plain(op, _t(p), prep, DT).numpy()) < RTOL


def test_element_contrib_gives_the_wrappers_plain_tensors(prob, monkeypatch):
    """Under torch.func.jvp the Function hands its wrappers ordinary tensors
    (whose data_ptr a kernel launch reads), the primal to K5 and the tangent
    to K5t, and returns K4 of each."""
    _, tsys, _, d = prob
    op = tsys.fem
    seen = []

    def spy(name):
        plain = getattr(fk, name + "_plain")

        def fn(op_, *tensors):
            seen.append(name)
            for t in tensors:
                t.data_ptr()  # raises on a functorch wrapper
                assert t.is_contiguous()
            return plain(op_, *tensors)
        return fn

    for name in ("contrib", "contrib_tangent", "node_reduce"):
        monkeypatch.setitem(fk._KERNELS, name, spy(name))
    _, packed = _packed(d)
    dpacked = _t(np.random.default_rng(4).normal(size=packed.shape))
    out, tan = torch.func.jvp(lambda x: fk.ElementContrib.apply(op, x, False),
                              (_t(packed),), (dpacked.t().contiguous().t(),))
    assert seen == ["contrib", "node_reduce", "contrib_tangent", "node_reduce"]
    assert torch.equal(out, fk.node_reduce_plain(op, fk.contrib_plain(op, _t(packed))))
    assert torch.equal(tan, fk.node_reduce_plain(
        op, fk.contrib_tangent_plain(op, _t(packed), dpacked)))
