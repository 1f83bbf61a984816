"""The port's CUDA kernels on the card (`cuda` marker; skipped without one).

Each kernel, in each element family's instantiation (FEAT10, ANCF3243,
ANCF3443), is held against its plain PyTorch twin on the same card inputs
(float64 within 1e-12 relative, float32 within 1e-5: the same arithmetic in
another summation order); float32 results are bitwise repeatable; and short
rollouts through the kernels match the same rollouts through the twins. The
persistent Newton-PCG kernel is held against its plain version with the
JAX package's bars for the resident solve (`tests/test_pallas_banded.py`,
`test_resident_inner_matches_newton_inner`): the same Newton count, CG
within 2, positions within 1e-10 relative. The Mooney-Rivlin instantiations
(`[feat10_mr]`) are held to their twins at a strained state (the JAX
test's 1e-2 random displacement of a 1.0 x 0.3 x 0.3 box of 4 x 2 x 2
cells, `tests/test_pallas_fem.py:23,113-125`): the isochoric terms cancel to
O(strain), so their float32 error relative to |P| is about eps / strain.
This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed; tests/conftest.py imports jax, so on such a machine
run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import ancf3243, ancf3443, feat10
from tlfea_torch.elements.assembly import lumped_mass
from tlfea_torch.materials import SVK, MooneyRivlin, lame_from_E_nu
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.ops import resident
from tlfea_torch.solvers import StepState, System, newton
from tlfea_torch.utils.tetmesh import box_t10_mesh

DT = 1e-3
KERNELS = ["primal_prep", "hv", "svk_blocks", "node_reduce"]
MR_KERNELS = ["primal_prep", "hv", "contrib", "contrib_tangent"]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    fk.build_kernels()
    return torch.device("cuda")


def _mooney_rivlin(E=1e7, nu=0.3, damping=1e3):
    """Mooney-Rivlin mapped from (E, nu) as `examples/bunny_deform.py` maps it."""
    mu = E / (2.0 * (1.0 + nu))
    return MooneyRivlin(0.4 * mu, 0.1 * mu, E / (3.0 * (1.0 - 2.0 * nu)), damping, damping)


def _box_system(device, dtype, dims=(1.0, 0.2, 0.2, 3, 1, 1), material=None):
    nodes, conn = box_t10_mesh(*dims)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    elems = feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu")
    f_ext = torch.zeros((len(nodes), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems) * -9.81
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(elems=elems.to(device), material=material or SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    return system, x0, f_ext.to(device)


def _ancf_system(device, dtype, family, n=(4, 3), material=None):
    """A clamped ANCF plate (ANCF3443) or cantilever (ANCF3243) under gravity;
    damped SVK unless another material is given."""
    if family == "ancf3443":
        coefs, conn = ancf3443.shell_grid(*n, L=0.05, W=0.05)
        elems = ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0, dtype=dtype,
                               device="cpu")
    else:
        coefs, conn = ancf3243.straight_beam(n[0] * n[1], L=0.1)
        elems = ancf3243.build(coefs, conn, 0.1, 0.02, 0.02, rho=1000.0, dtype=dtype,
                               device="cpu")
    lam, mu = lame_from_E_nu(1e7, 0.3)
    f_ext = torch.zeros((len(coefs), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems) * -9.81
    x0 = torch.as_tensor(coefs, dtype=dtype, device=device)
    pos = coefs[0::4, 0]
    edge = np.nonzero(pos < pos.min() + 1e-12)[0]
    fixed = (4 * edge[:, None] + np.arange(4)[None, :]).reshape(-1)
    system = System(elems=elems.to(device), material=material or SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(fixed, x0))
    return system, x0, f_ext.to(device)


def _family_system(device, dtype, family):
    if family == "feat10":
        return _box_system(device, dtype)
    return _ancf_system(device, dtype, family)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_twin_on_card(cuda_dev, kernel, dtype, tol, family):
    system, _, _ = _family_system(cuda_dev, dtype, family)
    op = system.fem
    assert op.family == family
    n = system.n_coef
    rng = np.random.default_rng(7)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda_dev).contiguous()

    packed = dev(np.concatenate([rng.normal(size=(n, 3)) * 1e-3, rng.normal(size=(n, 6))], 1))
    _, prep = fk.primal_prep_plain(op, packed)
    args = {
        "primal_prep": (packed,),
        "hv": (dev(rng.normal(size=(n, 3))), prep, DT),
        "svk_blocks": (dev(rng.normal(size=(n, 3)) * 1e-3),),
        "node_reduce": (dev(rng.normal(size=(op.S * 6, op.E))),),
    }[kernel]
    fk.reset_launch_counts()
    got = getattr(fk, kernel)(op, *args)
    want = getattr(fk, kernel + "_plain")(op, *args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"{kernel}[{family}]"] == 1
    assert sum(fk.LAUNCHES.values()) == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert _rel(g, w) < tol


@pytest.mark.cuda
def test_node_reduce_is_bitwise_repeatable(cuda_dev):
    system, _, _ = _box_system(cuda_dev, torch.float32)
    vals = torch.randn(system.fem.S * 3, system.fem.E, device=cuda_dev)
    first = fk.node_reduce(system.fem, vals)
    for _ in range(5):
        assert torch.equal(fk.node_reduce(system.fem, vals), first)


@pytest.mark.cuda
def test_shell_kernels_are_bitwise_repeatable(cuda_dev):
    """K1-K3 at S=16 sum each element's 48 quadrature points in a fixed order
    (4 groups of 12, then the groups in turn): no atomics, same bits."""
    system, _, _ = _ancf_system(cuda_dev, torch.float32, "ancf3443")
    op = system.fem
    gen = torch.Generator(device=cuda_dev).manual_seed(3)
    packed = torch.randn(op.n, 9, device=cuda_dev, generator=gen) * 1e-2
    p = torch.randn(op.n, 3, device=cuda_dev, generator=gen)
    first = fk.primal_prep(op, packed)
    runs = [(fk.primal_prep(op, packed), fk.hv(op, p, first[1], DT), fk.svk_blocks(op, p * 1e-3))
            for _ in range(4)]
    for (fe, prep), hv, blocks in runs:
        assert torch.equal(fe, first[0]) and torch.equal(prep, first[1])
        assert torch.equal(hv, runs[0][1]) and torch.equal(blocks, runs[0][2])
    assert torch.equal(fk.node_reduce(op, hv), fk.node_reduce(op, runs[0][1]))


@pytest.mark.cuda
def test_shell_rollout_is_bitwise_repeatable(cuda_dev):
    """The coarse build sums in sorted-index order and the kernels in fixed
    orders, so a float32 shell rollout from rest, coarse build included,
    gives the same bits and the same counts twice."""
    from tlfea_torch.solvers.coarse import build_coarse_precond

    system, x0, f_ext = _ancf_system(cuda_dev, torch.float32, "ancf3443")
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=2.5e-2 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                 cg_max_iter=50)
    runs = []
    for _ in range(2):
        coarse = build_coarse_precond(system, x0, DT, 1e7, target_cluster=8)
        state, counts = newton.make_rollout(system, params, 3, coarse=coarse, precond_refresh=2)(
            StepState.rest(system, x0), f_ext)
        runs.append((coarse.Ainv, state.x, counts))
    (ainv_a, x_a, counts_a), (ainv_b, x_b, counts_b) = runs
    assert torch.equal(ainv_a, ainv_b)
    assert torch.equal(x_a, x_b) and counts_a == counts_b


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["resident", "composed"])
def test_rollout_through_kernels_matches_twins(cuda_dev, monkeypatch, path):
    """Four float64 steps of a small cantilever, kernels against twins:
    same Newton and CG counts, positions within 1e-10 of the displacement.
    The mesh is small enough for the resident kernel; "composed" turns its
    gate off, so that K1-K4 carry the Newton-PCG loop."""
    system, x0, f_ext = _box_system(cuda_dev, torch.float64, dims=(1.0, 0.2, 0.2, 6, 1, 1))
    fs = float(f_ext.norm())
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * fs, outer_tol=1e-9,
                                 max_outer=2, max_inner=6, cg_rtol=1e-3, cg_max_iter=50)
    if path == "composed":
        monkeypatch.setattr(resident, "eligible", lambda *a, **k: False)
    kernels = KERNELS if path == "composed" else ["newton_resident", "svk_blocks", "node_reduce"]
    out = {}
    for plain in (False, True):
        sysx = replace(system, plain=plain)
        fk.reset_launch_counts()
        out[plain] = newton.make_rollout(sysx, params, 4, precond_refresh=2)(
            StepState.rest(sysx, x0), f_ext)
        assert (min(fk.LAUNCHES[f"{k}[feat10]"] for k in kernels) > 0) != plain
        assert sum(fk.LAUNCHES.values()) == 0 or not plain
    (sk, ck), (sp, cp) = out[False], out[True]
    assert ck == cp
    assert float((sk.x - sp.x).abs().max()) < 1e-10 * float((sp.x - x0).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ancf3243", "ancf3443"])
def test_ancf_rollout_through_kernels_matches_twins(cuda_dev, family):
    """Three float64 steps of a clamped ANCF structure with the coarse
    correction, kernels against twins: same counts, positions within 1e-10
    of the displacement."""
    from tlfea_torch.solvers.coarse import build_coarse_precond

    system, x0, f_ext = _ancf_system(cuda_dev, torch.float64, family)
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                 cg_max_iter=50)
    coarse = build_coarse_precond(system, x0, DT, 1e7, target_cluster=8)
    out = {}
    for plain in (False, True):
        sysx = replace(system, plain=plain)
        fk.reset_launch_counts()
        out[plain] = newton.make_rollout(sysx, params, 3, coarse=coarse, precond_refresh=2)(
            StepState.rest(sysx, x0), f_ext)
        assert (min(fk.LAUNCHES[f"{k}[{family}]"] for k in KERNELS) > 0) != plain
    (sk, ck), (sp, cp) = out[False], out[True]
    assert ck == cp
    assert float((sk.x - sp.x).abs().max()) < 1e-10 * float((sp.x - x0).abs().max())


def _resident_case(device, dtype, start):
    """A 192-element pinned box (the JAX resident test's mesh) and one
    inner solve's inputs: after three steps from rest ("stepped"), or at
    rest with the box compressed to 0.6 of its length along x, where SVK's
    tangent is indefinite and the Newton loop backtracks ("compressed")."""
    system, x0, f_ext = _box_system(device, dtype, dims=(1.0, 0.3, 0.3, 8, 2, 2))
    params = newton.NewtonParams(dt=DT, rho=1e6, inner_atol=1e-6, outer_tol=0.0, max_outer=1,
                                 max_inner=4, cg_rtol=1e-3, cg_max_iter=40)
    state = StepState.rest(system, x0)
    if start == "stepped":
        state, _ = newton.make_rollout(system, params, 3, precond_refresh=2)(state, f_ext)
    else:
        x = x0.clone()
        x[:, 0] *= 0.6
        state = replace(state, x=x, u=x - x0)
    return system, params, newton.inner_solve_args(system, state, f_ext, params)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["stepped", "compressed"])
def test_resident_kernel_matches_plain(cuda_dev, start):
    system, params, args = _resident_case(cuda_dev, torch.float64, start)
    fk.reset_launch_counts()
    v, stats = resident.launch(*args)
    st = resident.read_stats(stats)
    assert fk.LAUNCHES["newton_resident[feat10]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = resident.newton_inner_resident_plain(*args)
    assert sum(fk.LAUNCHES.values()) == 1  # the plain version launches nothing
    assert st["iters"] == want[1] and abs(st["cg_total"] - want[3]) <= 2
    x_ref = system.elems.x_ref
    u_prev = args[1]
    x_k, x_p = x_ref + u_prev + DT * v, x_ref + u_prev + DT * want[0]
    assert _rel(x_k, x_p) < 1e-10
    np.testing.assert_allclose(st["hist"][:st["iters"] + 1], want[4][:want[1] + 1], rtol=1e-8)
    # Trial gradients beyond one per Newton iteration (plus the converged
    # one, when the loop converged) show the backtracking branch.
    backtracked = st["grad_evals"] > st["iters"] + (st["iters"] < params.max_inner)
    assert backtracked == (start == "compressed")
    # grid: the launch's one cluster, the plan's for 6 tiles (8 blocks)
    assert st["hv_evals"] == st["cg_total"] and st["grid"] == _cluster(system, torch.float64) == 8


@pytest.mark.cuda
def test_resident_kernel_matches_plain_float32(cuda_dev):
    """The float32 instantiation, the rollouts' dtype: the same Newton count,
    CG within 2, v within 1e-3 of the solve's update max |v - v0| (perturbing
    v0 or the block inverses by 1e-7..1e-5 relative moves the plain
    version's v by about 1e-6 of it here)."""
    _, _, args = _resident_case(cuda_dev, torch.float32, "stepped")
    v, stats = resident.launch(*args)
    st = resident.read_stats(stats)
    want = resident.newton_inner_resident_plain(*args)
    assert st["iters"] == want[1] and abs(st["cg_total"] - want[3]) <= 2
    assert float((v - want[0]).abs().max()) < 1e-3 * float((want[0] - args[0]).abs().max())


@pytest.mark.cuda
def test_resident_kernel_is_bitwise_repeatable(cuda_dev):
    _, _, args = _resident_case(cuda_dev, torch.float32, "stepped")
    first, s1 = resident.launch(*args)
    for _ in range(3):
        v, s = resident.launch(*args)
        assert torch.equal(v, first)
        assert torch.equal(s.nan_to_num(-1.0), s1.nan_to_num(-1.0))


@pytest.mark.cuda
def test_resident_rollout_launches_once_per_inner_solve(cuda_dev):
    """Five steps with two dual updates each: one launch per inner solve, no
    K1 or K2 launch, and K3 + K4 only at the preconditioner refreshes."""
    system, x0, f_ext = _box_system(cuda_dev, torch.float32, dims=(1.0, 0.3, 0.3, 8, 2, 2))
    params = newton.NewtonParams(dt=DT, rho=1e6, inner_atol=1e-3 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=2, max_inner=6, cg_rtol=1e-3,
                                 cg_max_iter=50)
    fk.reset_launch_counts()
    state, (nit, _) = newton.make_rollout(system, params, 5, precond_refresh=2)(
        StepState.rest(system, x0), f_ext)
    assert bool(torch.isfinite(state.x).all()) and sum(nit) > 0
    got = {k: fk.LAUNCHES[f"{k}[feat10]"] for k in KERNELS + ["newton_resident"]}
    assert got == {"primal_prep": 0, "hv": 0, "svk_blocks": 3, "node_reduce": 3,
                   "newton_resident": 10}


@pytest.mark.cuda
def test_resident_converged_flag_at_the_cap(cuda_dev):
    """A float64 resident step converging in n Newton iterations, capped at
    n: the same bits, converged, the last iterate tested by one K1 + K4
    launch beside the persistent one; capped at n - 1: unconverged. Uncapped,
    no K1."""
    system, x0, f_ext = _box_system(cuda_dev, torch.float64, dims=(1.0, 0.3, 0.3, 8, 2, 2))
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-9 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=1, max_inner=20, cg_rtol=1e-6,
                                 cg_max_iter=200, ew_eta_max=0.0)
    state = StepState.rest(system, x0)
    assert resident.eligible(system, None)
    runs = {}
    for cap in (None, "n", "n-1"):
        prm = params if cap is None else replace(
            params, max_inner=runs[None][1]["newton_iters"] - (cap == "n-1"))
        fk.reset_launch_counts()
        runs[cap] = newton.step(system, state, prm, f_ext)
        runs[cap] += ({k: fk.LAUNCHES[f"{k}[feat10]"] for k in
                       ("primal_prep", "node_reduce", "newton_resident")},)
    (free, dfree, lfree), (at_n, d_n, l_n), (_, d_s, l_s) = (runs[k] for k in (None, "n", "n-1"))
    assert dfree["newton_iters"] >= 2 and dfree["converged"] is True
    assert lfree["primal_prep"] == 0 and lfree["newton_resident"] == 1
    assert d_n["converged"] is True and torch.equal(at_n.x, free.x)
    assert l_n["primal_prep"] == 1 and l_n["newton_resident"] == 1
    assert l_n["node_reduce"] == lfree["node_reduce"] + 1
    assert d_s["converged"] is False and l_s["primal_prep"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("kernel", ["contrib", "contrib_tangent"])
def test_contrib_kernels_match_twins_on_card(cuda_dev, kernel, dtype, tol, family):
    """K5 and K5t (the port of pallas_fem._body, primal and tangent) against
    their plain twins, one launch each."""
    system, _, _ = _family_system(cuda_dev, dtype, family)
    op = system.fem
    gen = torch.Generator(device=cuda_dev).manual_seed(11)
    packed = torch.randn(op.n, 9, device=cuda_dev, dtype=dtype, generator=gen)
    packed[:, :3] *= 1e-3
    args = (packed,) if kernel == "contrib" else (
        packed, torch.randn(op.n, 9, device=cuda_dev, dtype=dtype, generator=gen))
    fk.reset_launch_counts()
    got = getattr(fk, kernel)(op, *args)
    want = getattr(fk, kernel + "_plain")(op, *args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"{kernel}[{family}]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert _rel(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_contrib_is_k1_and_its_tangent_is_k2(cuda_dev, dtype, tol, family):
    """K5 is K1's tile code with the prep writes compiled out: the same fe,
    bit for bit. K5t + K4 along the Newton chain (dt p, p, p/dt) is the
    Hessian product K2 + K4 along p."""
    system, _, _ = _family_system(cuda_dev, dtype, family)
    op = system.fem
    gen = torch.Generator(device=cuda_dev).manual_seed(12)
    packed = torch.randn(op.n, 9, device=cuda_dev, dtype=dtype, generator=gen)
    packed[:, :3] *= 1e-3
    p = torch.randn(op.n, 3, device=cuda_dev, dtype=dtype, generator=gen)
    fe, prep = fk.primal_prep(op, packed)
    assert torch.equal(fk.contrib(op, packed), fe)
    chain = torch.cat([DT * p, p, p / DT], dim=1).contiguous()
    h5 = fk.node_reduce(op, fk.contrib_tangent(op, packed, chain))
    h2 = fk.node_reduce(op, fk.hv(op, p, prep, DT))
    assert _rel(h5, h2) < tol


def _flagship_box(device, dtype):
    """The 10k flagship problem: FEAT10 box 42 x 7 x 6 in best_order."""
    from tlfea_torch.utils.reorder import apply_node_order, best_order

    nodes, conn = box_t10_mesh(2.0, 0.35, 0.3, 42, 7, 6)
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
    lam, mu = lame_from_E_nu(1e7, 0.3)
    elems = feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu")
    f_ext = torch.zeros((len(nodes), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems) * -9.81
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(elems=elems.to(device), material=SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    return system, x0, f_ext.to(device)


@pytest.mark.cuda
def test_adamw_flagship_step_is_bitwise_repeatable(cuda_dev):
    """K5 and K4 sum in fixed orders and the pins are dense fields, so a
    float32 AdamW step at the flagship size (two outer passes of 300
    iterations) gives the same bits twice, through K5 + K4 only."""
    from tlfea_torch.solvers import adamw

    system, x0, f_ext = _flagship_box(cuda_dev, torch.float32)
    params = adamw.AdamWParams(dt=DT, rho=1e7, lr=1e-3, inner_tol=1e-8, inner_rtol=1e-8,
                               max_outer=2, max_inner=300, convergence_check_interval=50)
    runs = []
    for _ in range(2):
        fk.reset_launch_counts()
        state, diag = adamw.make_step(system, params)(StepState.rest(system, x0), f_ext)
        runs.append((state.x, state.lam, diag["inner_iters"]))
    assert fk.LAUNCHES["contrib[feat10]"] == runs[1][2] > 0
    assert fk.LAUNCHES["primal_prep[feat10]"] == fk.LAUNCHES["hv[feat10]"] == 0
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2]


@pytest.mark.cuda
def test_grad_L_jvp_runs_through_k5t(cuda_dev):
    """torch.func.jvp(grad_L) on the card launches K5 and K5t (each with K4)
    and equals the Newton path's product; torch.func.linearize records the
    kernels as operators and launches K5t + K4 again at each call of the
    linearized function, equal to the jvp at two directions."""
    from tlfea_torch.solvers.common import _pin_terms, grad_L

    system, x0, f_ext = _box_system(cuda_dev, torch.float64)
    state = StepState.rest(system, x0)
    gen = torch.Generator(device=cuda_dev).manual_seed(13)
    v, p = (torch.randn(x0.shape, device=cuda_dev, dtype=torch.float64, generator=gen)
            for _ in range(2))

    def g_of(v):
        return grad_L(v, state.x, state.v, state.lam, f_ext, DT, 1e7, system, u_prev=state.u)

    fk.reset_launch_counts()
    g, dg = torch.func.jvp(g_of, (v,), (p,))
    assert {k: fk.LAUNCHES[f"{k}[feat10]"] for k in ("contrib", "contrib_tangent",
                                                     "node_reduce")} == {
        "contrib": 1, "contrib_tangent": 1, "node_reduce": 2}
    pins = _pin_terms(system, state.lam, DT, 1e7, torch.float64)
    g2, hvp = fk.g_and_hvp(v, state.u, state.v, f_ext, DT, system.fem, pins)
    assert _rel(g, g2) < 1e-12 and _rel(dg, hvp(p)) < 1e-12
    _, lin = torch.func.linearize(g_of, v)
    lin(p)  # the first call also evaluates the graph's folded constants (K5 + K4)
    for q in (p, torch.flip(p, (0,)) * 2.0 + 1.0):
        before = {k: fk.LAUNCHES[f"{k}[feat10]"] for k in ("contrib_tangent", "node_reduce")}
        got = lin(q)
        assert {k: fk.LAUNCHES[f"{k}[feat10]"] - n for k, n in before.items()} == {
            "contrib_tangent": 1, "node_reduce": 1}
        assert _rel(got, torch.func.jvp(g_of, (v,), (q,))[1]) < 1e-12


@pytest.mark.cuda
def test_grad_L_raises_without_the_library(cuda_dev, monkeypatch):
    """On a CUDA tensor grad_L launches K5 or raises: no plain fallback."""
    from tlfea_torch.solvers.common import grad_L

    system, x0, f_ext = _box_system(cuda_dev, torch.float32)
    state = StepState.rest(system, x0)

    def missing():
        raise RuntimeError("nvcc not found (set CUDA_HOME); the FEM kernels need the CUDA toolkit")

    monkeypatch.setattr(fk, "build_kernels", missing)
    fk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        grad_L(state.v, state.x, state.v, state.lam, f_ext, DT, 1e7, system, u_prev=state.u)
    assert sum(fk.LAUNCHES.values()) == 0


def _mr_case(device, dtype, damping):
    """The strained Mooney-Rivlin state: the 4 x 2 x 2 box, 1e-2 random
    displacement, random velocities, increments, directions and tangents."""
    system, _, _ = _box_system(device, dtype, dims=(1.0, 0.3, 0.3, 4, 2, 2),
                               material=_mooney_rivlin(1e6, 0.3, damping))
    op = system.fem
    rng = np.random.default_rng(21)
    n = op.n

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    packed = dev(np.concatenate([rng.normal(size=(n, 3)) * 1e-2, rng.normal(size=(n, 6))], 1))
    return system, packed, dev(rng.normal(size=(n, 3))), dev(rng.normal(size=(n, 9)))


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e2])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("kernel", MR_KERNELS)
def test_mr_kernel_matches_twin_on_card(cuda_dev, kernel, dtype, tol, damping):
    """K1, K2, K5 and K5t `[feat10_mr]` (the port of `_MRTile` in
    `_primal_prep_body`, `_hv_body` and `_body`) against their twins, one
    launch each, damped and undamped."""
    system, packed, p, dpacked = _mr_case(cuda_dev, dtype, damping)
    op = system.fem
    assert (op.tag, op.source, op.prep_rows) == ("feat10_mr", "fem_feat10_mr.cu", 30)
    _, prep = fk.primal_prep_plain(op, packed)
    args = {"primal_prep": (packed,), "hv": (p, prep, DT), "contrib": (packed,),
            "contrib_tangent": (packed, dpacked)}[kernel]
    fk.reset_launch_counts()
    got = getattr(fk, kernel)(op, *args)
    want = getattr(fk, kernel + "_plain")(op, *args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"{kernel}[feat10_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert bool(torch.isfinite(g).all()) and _rel(g, w) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_mr_contrib_is_k1_and_its_tangent_is_k2(cuda_dev, dtype, tol):
    """As for SVK: K5 `[feat10_mr]` is K1's fe bit for bit, and K5t + K4
    along the Newton chain (dt p, p, p/dt) is K2 + K4 along p."""
    system, packed, p, _ = _mr_case(cuda_dev, dtype, 1e2)
    op = system.fem
    fe, prep = fk.primal_prep(op, packed)
    assert torch.equal(fk.contrib(op, packed), fe)
    chain = torch.cat([DT * p, p, p / DT], dim=1).contiguous()
    h5 = fk.node_reduce(op, fk.contrib_tangent(op, packed, chain))
    h2 = fk.node_reduce(op, fk.hv(op, p, prep, DT))
    assert _rel(h5, h2) < tol


@pytest.mark.cuda
def test_mr_rollout_is_bitwise_repeatable_and_matches_twins(cuda_dev):
    """Three float32 steps of the pinned MR box with the coarse correction
    through K1/K2 `[feat10_mr]` give the same bits and counts twice (no
    atomics; the MR blocks sum in a fixed order); in float64 the kernel path
    takes the twins' counts, positions within 1e-10 of the displacement."""
    from tlfea_torch.solvers.coarse import build_coarse_precond

    out = {}
    for dtype in (torch.float32, torch.float64):
        system, x0, f_ext = _box_system(cuda_dev, dtype, dims=(1.0, 0.3, 0.3, 4, 2, 2),
                                        material=_mooney_rivlin())
        params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * float(f_ext.norm()),
                                     outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                     cg_max_iter=50)
        coarse = build_coarse_precond(system, x0, DT, 1e7, target_cluster=8)
        runs = []
        for plain in (False, False, True):
            sysx = replace(system, plain=plain)
            fk.reset_launch_counts()
            state, counts = newton.make_rollout(sysx, params, 3, coarse=coarse,
                                                precond_refresh=2)(StepState.rest(sysx, x0),
                                                                   f_ext)
            launched = {k: fk.LAUNCHES[f"{k}[feat10_mr]"] for k in ("primal_prep", "hv")}
            assert (min(launched.values()) > 0) != plain
            assert fk.LAUNCHES["svk_blocks[feat10]"] == 0
            runs.append((state.x, counts))
        out[dtype] = (runs, x0)
    (a, b, _), _ = out[torch.float32]
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    (k, _, p), x0 = out[torch.float64]
    assert k[1] == p[1]
    assert float((k[0] - p[0]).abs().max()) < 1e-10 * float((p[0] - x0).abs().max())


@pytest.mark.cuda
def test_mr_raises_on_ancf_and_has_no_k3(cuda_dev):
    """Mooney-Rivlin has element kernels in every family, but no persistent
    kernel for the ANCF3443 shell (nor a JAX resident path), and K3 is SVK
    only: both raise on the card, launching nothing."""
    system, _, _ = _ancf_system(cuda_dev, torch.float32, "ancf3443", material=_mooney_rivlin())
    assert system.fem.tag == "ancf3443_mr" and not resident.eligible(system, None)
    params = newton.NewtonParams(dt=DT, rho=1e7)
    args = newton.inner_solve_args(system, StepState.rest(system, system.elems.x_ref),
                                   torch.zeros_like(system.elems.x_ref), params)
    mr, _, _ = _box_system(cuda_dev, torch.float32, material=_mooney_rivlin())
    fk.reset_launch_counts()
    with pytest.raises(ValueError, match="no newton_resident kernel for MooneyRivlin with "
                                         "ancf3443"):
        resident.launch(*args)
    with pytest.raises(ValueError, match="takes no MooneyRivlin"):
        fk.svk_blocks(mr.fem, torch.zeros((mr.n_coef, 3), device=cuda_dev))
    assert sum(fk.LAUNCHES.values()) == 0


# The displacement scale of the strained Mooney-Rivlin state on the small
# ANCF structures of `_ancf_system`: J - 1 spans [-0.32, 0.35] on the beam
# and [-0.30, 0.45] on the plate (float64 twins, seed 21).
ANCF_MR_STRAIN = {"ancf3243": 1e-2, "ancf3443": 5e-3}


def _mr_ancf_case(device, dtype, family):
    """The strained Mooney-Rivlin state on a small ANCF structure, with
    random velocities, increments, directions and tangents."""
    system, _, _ = _ancf_system(device, dtype, family, material=_mooney_rivlin())
    op = system.fem
    rng = np.random.default_rng(21)
    n = op.n

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    packed = dev(np.concatenate([rng.normal(size=(n, 3)) * ANCF_MR_STRAIN[family],
                                 rng.normal(size=(n, 6))], 1))
    return system, packed, dev(rng.normal(size=(n, 3))), dev(rng.normal(size=(n, 9)))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ancf3243", "ancf3443"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("kernel", MR_KERNELS)
def test_mr_ancf_kernel_matches_twin_on_card(cuda_dev, kernel, dtype, tol, family):
    """K1, K2, K5 and K5t `[<family>_mr]` (`_MRTile` in the ANCF bodies:
    the unchunked ones at ANCF3243, the QP-chunked ones at ANCF3443) against
    their twins at a strained state, one launch each."""
    system, packed, p, dpacked = _mr_ancf_case(cuda_dev, dtype, family)
    op = system.fem
    assert (op.tag, op.source) == (f"{family}_mr", f"fem_{family}_mr.cu")
    _, prep = fk.primal_prep_plain(op, packed)
    jm1 = prep.view(op.Q, op.prep_rows, op.E)[:, 18]
    assert 0.25 < float(jm1.abs().max()) < 0.5
    args = {"primal_prep": (packed,), "hv": (p, prep, DT), "contrib": (packed,),
            "contrib_tangent": (packed, dpacked)}[kernel]
    fk.reset_launch_counts()
    got = getattr(fk, kernel)(op, *args)
    want = getattr(fk, kernel + "_plain")(op, *args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"{kernel}[{family}_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert bool(torch.isfinite(g).all()) and _rel(g, w) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ancf3243", "ancf3443"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_mr_ancf_contrib_is_k1_and_its_tangent_is_k2(cuda_dev, dtype, tol, family):
    """K5 `[<family>_mr]` is K1's fe bit for bit, and K5t + K4 along the
    Newton chain (dt p, p, p/dt) is K2 + K4 along p."""
    system, packed, p, _ = _mr_ancf_case(cuda_dev, dtype, family)
    op = system.fem
    fe, prep = fk.primal_prep(op, packed)
    assert torch.equal(fk.contrib(op, packed), fe)
    chain = torch.cat([DT * p, p, p / DT], dim=1).contiguous()
    h5 = fk.node_reduce(op, fk.contrib_tangent(op, packed, chain))
    h2 = fk.node_reduce(op, fk.hv(op, p, prep, DT))
    assert _rel(h5, h2) < tol


@pytest.mark.cuda
def test_mr_coefs_match_k1_at_an_inverted_point(cuda_dev):
    """At det F < 0 (the box mirrored in x, F ~ diag(-1, 1, 1) plus a random
    strain) K1 `[feat10_mr]` takes CUDA's real `cbrt`; its twin, through
    `_mr_coefs`' sign-preserving cube root, is finite and equal (float64,
    1e-12), prep cache included."""
    system, packed, _, _ = _mr_case(cuda_dev, torch.float64, 1e2)
    op = system.fem
    packed = packed.clone()
    packed[:, 0] -= 2.0 * system.elems.x_ref[:, 0]  # x -> -x
    fe, prep = fk.primal_prep(op, packed)
    fe_p, prep_p = fk.primal_prep_plain(op, packed)
    torch.cuda.synchronize()
    J = 1.0 + prep_p.view(op.Q, op.prep_rows, op.E)[:, 18]
    assert float(J.max()) < 0.0
    t1, t2, t3 = fk._mr_coefs(J - 1.0, op.material)
    assert all(bool(torch.isfinite(t).all()) for t in (t1, t2, t3))
    assert bool(torch.isfinite(fe_p).all()) and bool(torch.isfinite(prep_p).all())
    assert _rel(fe, fe_p) < 1e-12 and _rel(prep, prep_p) < 1e-12


def _cluster(system, dtype):
    """The cluster size of the persistent kernel's launch on `system`."""
    op = system.fem
    return resident.plan(op.family, op.kind, op.E, dtype,
                         resident.max_cluster(op.tag, dtype)).cluster


def _resident_pair(device, dtype, pair):
    """One inner solve's inputs, three steps from rest, for a (family,
    material) pair of the persistent kernel: the 192-element box of
    `_resident_case` in Mooney-Rivlin, or a clamped ANCF3243 cantilever
    under gravity of 12 or 1,024 elements (one element block, 32 tiles) in
    SVK or Mooney-Rivlin."""
    tag, n_elem = pair
    material = _mooney_rivlin() if tag.endswith("_mr") else None
    if tag.startswith("feat10"):
        system, x0, f_ext = _box_system(device, dtype, dims=(1.0, 0.3, 0.3, 8, 2, 2),
                                        material=material)
    else:
        system, x0, f_ext = _ancf_system(device, dtype, "ancf3243", n=(n_elem, 1),
                                         material=material)
    assert system.fem.tag == tag and system.fem.E == n_elem
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                 cg_max_iter=50)
    state, _ = newton.make_rollout(system, params, 3, precond_refresh=2)(
        StepState.rest(system, x0), f_ext)
    return system, newton.inner_solve_args(system, state, f_ext, params)


RESIDENT_PAIRS = [("feat10_mr", 192), ("ancf3243", 12), ("ancf3243_mr", 12), ("ancf3243", 1024),
                  ("ancf3243_mr", 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", RESIDENT_PAIRS, ids=[f"{t}-{e}" for t, e in RESIDENT_PAIRS])
def test_resident_pair_matches_plain(cuda_dev, pair):
    """The persistent kernel at FEAT10 x MR and ANCF3243 x SVK/MR against its
    plain version in float64: the same Newton count, CG within 2, positions
    within 1e-10 relative, one launch."""
    system, args = _resident_pair(cuda_dev, torch.float64, pair)
    fk.reset_launch_counts()
    v, stats = resident.launch(*args)
    st = resident.read_stats(stats)
    assert fk.LAUNCHES[f"newton_resident[{pair[0]}]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = resident.newton_inner_resident_plain(*args)
    assert st["iters"] == want[1] and abs(st["cg_total"] - want[3]) <= 2 and st["cg_total"] > 0
    x_ref, u_prev = system.elems.x_ref, args[1]
    assert _rel(x_ref + u_prev + DT * v, x_ref + u_prev + DT * want[0]) < 1e-10
    assert st["grid"] == _cluster(system, torch.float64) <= 16
    assert st["hv_evals"] == st["cg_total"]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", RESIDENT_PAIRS[:3], ids=[t for t, _ in RESIDENT_PAIRS[:3]])
def test_resident_pair_float32_matches_plain_and_repeats(cuda_dev, pair):
    """The float32 instantiations: the same Newton count, CG within 2, v
    within 1e-3 of the solve's update, bitwise repeatable."""
    _, args = _resident_pair(cuda_dev, torch.float32, pair)
    v, stats = resident.launch(*args)
    v2, _ = resident.launch(*args)
    st = resident.read_stats(stats)
    want = resident.newton_inner_resident_plain(*args)
    assert torch.equal(v, v2)
    assert st["iters"] == want[1] and abs(st["cg_total"] - want[3]) <= 2
    assert float((v - want[0]).abs().max()) < 1e-3 * float((want[0] - args[0]).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["feat10_mr", "ancf3243", "ancf3243_mr"])
def test_resident_pair_rollout_launches_once_per_inner_solve(cuda_dev, tag):
    """Four float32 steps through the gate: one persistent launch per inner
    solve, K2 never, K1 + K4 once for each step that stopped at the Newton
    cap (its converged flag tests the last iterate); K3 + K4 at the SVK
    refreshes only (the Mooney-Rivlin blocks are plain tensor code)."""
    system, x0, f_ext = (_box_system(cuda_dev, torch.float32, dims=(1.0, 0.3, 0.3, 8, 2, 2),
                                     material=_mooney_rivlin()) if tag == "feat10_mr" else
                         _ancf_system(cuda_dev, torch.float32, "ancf3243", n=(12, 1),
                                      material=_mooney_rivlin() if tag.endswith("_mr") else None))
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * float(f_ext.norm()),
                                 outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                                 cg_max_iter=50)
    fk.reset_launch_counts()
    state, (nit, _) = newton.make_rollout(system, params, 4, precond_refresh=2)(
        StepState.rest(system, x0), f_ext)
    assert bool(torch.isfinite(state.x).all()) and sum(nit) > 0
    svk = not tag.endswith("_mr")
    capped = sum(n >= params.max_inner for n in nit)  # one inner solve a step
    got = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in KERNELS + ["newton_resident"]}
    assert got == {"primal_prep": capped, "hv": 0, "svk_blocks": 2 * svk,
                   "node_reduce": 2 * svk + capped, "newton_resident": 4}
    assert fk.launch_key("newton_resident", system.fem) == f"newton_resident[{tag}]"


ALL_RESIDENT_PAIRS = [("feat10", 192), ("feat10_mr", 192), ("ancf3243", 1024),
                      ("ancf3243_mr", 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ALL_RESIDENT_PAIRS, ids=[t for t, _ in ALL_RESIDENT_PAIRS])
def test_resident_cluster_kernel_matches_plain_in_every_pair(cuda_dev, pair):
    """The persistent kernel as one thread-block cluster, every (family,
    material) pair: in float64 the plain version's Newton and CG counts and
    its ||g|| history; a cluster of at most 16 blocks, the plan's; as many
    cluster barriers as the cooperative grid crossed (three a gradient, four
    a CG iteration: each PCG here runs at least one); in float32 bitwise
    repeatable, the stats included."""
    system, args = _resident_pair(cuda_dev, torch.float64, pair)
    v, stats = resident.launch(*args)
    st = resident.read_stats(stats)
    want = resident.newton_inner_resident_plain(*args)
    assert st["iters"] == want[1] and st["cg_total"] == want[3] > 0
    hist = want[4][:want[1] + 1]
    np.testing.assert_allclose(st["hist"][:st["iters"] + 1], hist, rtol=1e-10, atol=1e-10 * hist[0])
    assert st["grid"] == _cluster(system, torch.float64) <= 16
    assert st["barriers"] == 3 * st["grad_evals"] + 4 * st["hv_evals"]
    _, args32 = _resident_pair(cuda_dev, torch.float32, pair)
    v1, s1 = resident.launch(*args32)
    for _ in range(2):
        v2, s2 = resident.launch(*args32)
        assert torch.equal(v1, v2) and torch.equal(s1.nan_to_num(-1.0), s2.nan_to_num(-1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_resident_plan_matches_the_kernel(cuda_dev, dtype):
    """`resident.plan` (the host's launch shape) against the kernel's own
    count of shared memory, every pair and gate size, at the card's largest
    cluster and at 8; the card schedules clusters of 8 or 16."""
    sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    for family, kind in fk.RESIDENT_SOURCES:
        tag = family if kind == "svk" else f"{family}_{kind}"
        lib = fk.build_kernels()[fk.RESIDENT_SOURCES[(family, kind)]]
        smem = getattr(lib, f"tlfea_newton_resident_{tag}_{sfx}_smem")
        top = resident.max_cluster(tag, dtype)
        assert top in (8, 16)
        for E in (1, 31, 32, 33, 64, 192, 864, 1024):
            for cap in {top, 8}:
                pl = resident.plan(family, kind, E, dtype, cap)
                assert smem(E, pl.cluster) == pl.smem_bytes, (tag, E, cap)
        assert smem(1025, 16) == 0 and smem(64, 3) == 0  # refused shapes


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["feat10", "ancf3443", "ancf3243"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_node_reduce_matches_twin_and_repeats(cuda_dev, family, dtype, tol):
    """K4 (three channels a thread, batched walk) at C = 3, 6 and 9: its
    twin within the kernels' tolerance, and bitwise repeatable; a width that
    is not a multiple of 3 is refused."""
    system, _, _ = _family_system(cuda_dev, dtype, family)
    op = system.fem
    rng = np.random.default_rng(11)
    for C in (3, 6, 9):
        vals = torch.as_tensor(rng.normal(size=(op.S * C, op.E)), dtype=dtype, device=cuda_dev)
        got = fk.node_reduce(op, vals)
        assert got.shape == (op.n, C)
        assert _rel(got, fk.node_reduce_plain(op, vals)) < tol
        for _ in range(3):
            assert torch.equal(fk.node_reduce(op, vals), got)
    with pytest.raises(ValueError, match="multiple of 3"):
        fk.node_reduce(op, torch.zeros(op.S * 4, op.E, dtype=dtype, device=cuda_dev))


def _op_samples(device, dtype):
    """(name, arguments) of each element operator on the 3 x 1 x 1 box."""
    system, _, _ = _box_system(device, dtype)
    op = system.fem
    rng = np.random.default_rng(5)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    packed, p = dev(rng.normal(size=(op.n, 9)) * 1e-2), dev(rng.normal(size=(op.n, 3)))
    _, prep = fk.primal_prep_plain(op, packed)
    mat = list(op.mat_args)
    return {"primal_prep": (packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, op.tag, mat),
            "hv": (p, op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, DT, op.tag, mat),
            "svk_blocks": (p, op.conn_t, op.gN_t, op.dV_t, op.tag, [op.lam, op.mu]),
            "node_reduce": (dev(rng.normal(size=(op.S * 3, op.E))), op.conn, op.inc_ptr,
                            op.inc, op.family),
            "contrib": (packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, op.tag, mat),
            "contrib_tangent": (packed, dev(rng.normal(size=(op.n, 9))), op.conn_t, op.gN_t,
                                op.dV_t, op.Me_t, op.tag, mat)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", fk.KERNEL_NAMES)
def test_operator_passes_opcheck_on_card(cuda_dev, name):
    """torch.library.opcheck of each element operator's CUDA kernel (schema,
    fake tensor, AOT dispatch) on float64 card tensors."""
    args = _op_samples(cuda_dev, torch.float64)[name]
    torch.library.opcheck(getattr(torch.ops.tlfea, name).default, args)


def _phase_case(device):
    """The 6 x 2 x 2 box (144 elements) in float32 on `device`: (op, p, K1's
    prep cache at [0 | v | 0], dt)."""
    system, _, _ = _box_system(device, torch.float32, dims=(1.0, 0.25, 0.25, 6, 2, 2))
    op = system.fem
    rng = np.random.default_rng(9)
    v = 0.1 * rng.normal(size=(op.n, 3))
    zero = np.zeros_like(v)
    packed = torch.as_tensor(np.concatenate([zero, v, zero], 1), dtype=torch.float32,
                             device=device)
    p = torch.as_tensor(rng.normal(size=(op.n, 3)), dtype=torch.float32, device=device)
    return op, p, fk.primal_prep(op, packed)[1], DT


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["dma_win", "dma_wininv", "dma", "gather", "gfe", "scat",
                                     "full"])
def test_hv_phase_matches_twin_on_card(cuda_dev, variant):
    """Each phase variant of the Hv kernel (`ops.hv_phases`) launches once
    and matches its twin: gfe equals K2's output and full the production
    K2 + K4 bit for bit, scat K4's on the same buffer; the touch variants'
    word sums equal their twins' bit for bit."""
    from tlfea_torch.ops import hv_phases as hp

    op, p, prep, dt = _phase_case(cuda_dev)
    fes = hp.scat_buffer(op, p)
    args = {"dma_win": (p,), "dma_wininv": (p,), "dma": (prep,), "gather": (p,),
            "gfe": (p, prep, dt), "scat": (fes,), "full": (p, prep, dt)}[variant]
    fk.reset_launch_counts()
    got = getattr(hp, variant)(op, *args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"hv_phase[{variant}]"] == 1
    if variant in ("gfe", "scat", "full"):
        want = {"gfe": lambda: fk.hv(op, p, prep, dt), "scat": lambda: fk.node_reduce(op, fes),
                "full": lambda: fk.node_reduce(op, fk.hv(op, p, prep, dt))}[variant]()
        assert torch.equal(got, want)
        assert _rel(got, getattr(hp, variant + "_plain")(op, *args)) < 1e-5
    else:
        assert torch.equal(got, getattr(hp, variant + "_plain")(op, *args))


@pytest.mark.cuda
def test_hv_phase_touch_check_refuses_planted_skips_on_card(cuda_dev):
    """Each touch variant's kernel, run on its tables with one of them
    zeroed wholly or every other row (what a kernel that skipped those
    loads would sum), is refused by the check, which names that table."""
    from tlfea_torch.tools import ablate_hv

    op, p, prep, dt = _phase_case(cuda_dev)
    fk.reset_launch_counts()
    n = ablate_hv.check_refuses_skips(op, p, prep, dt, log=lambda m: None)
    assert n == 20 and sum(fk.LAUNCHES[f"hv_phase[{v}]"] for v in ("dma_win", "dma_wininv",
                                                                    "dma", "gather")) == n


@pytest.mark.cuda
def test_hv_phases_take_float32_feat10_svk_only(cuda_dev):
    """The phase kernels exist for FEAT10 with SVK in float32: other dtypes
    and materials raise on the card."""
    from tlfea_torch.ops import hv_phases as hp

    system, _, _ = _box_system(cuda_dev, torch.float64)
    with pytest.raises(TypeError, match="float32"):
        hp.gfe(system.fem, torch.zeros((system.n_coef, 3), dtype=torch.float64, device=cuda_dev),
               torch.zeros((system.fem.Q * 27, system.fem.E), dtype=torch.float64,
                           device=cuda_dev), DT)
    mr, _, _ = _box_system(cuda_dev, torch.float32, material=_mooney_rivlin())
    with pytest.raises(ValueError, match="FEAT10 with SVK"):
        hp.dma_win(mr.fem, torch.zeros((mr.n_coef, 3), device=cuda_dev))


# The tile of the Mooney-Rivlin K1 and K5 (`fem_kernels.cuh`
# `primal_prep_tile`, loading the shape gradients as fem_<family>_mr.cu's
# `Hold` says): sizes that are a multiple of neither 4 nor 32 (a ragged last
# tile, a row stride E * itemsize off 16 bytes), and the full sizes of
# chip_smoke's [kernels] (the 10k flagship, the 72 x 72 shell).
MR_TILE_CASES = [("feat10", 18), ("ancf3243", 13), ("ancf3443", 25), ("feat10", 10584),
                 ("ancf3443", 5184)]


def _mr_tile_case(device, dtype, family, E, damping=1e3):
    """(system, packed) at a strained random state: the small structures of
    `_mr_case` / `_mr_ancf_case` (a 3 x 1 x 1 box, a 13-element beam, a 5 x
    5 plate), or chip_smoke's full-size builders at its [kernels] state (u
    1e-3, scaled by STRAIN_SCALE): the 10k flagship, the 72 x 72 shell, the
    64-element beam."""
    mr = _mooney_rivlin(damping=damping)
    rng = np.random.default_rng(21)
    if E in (10584, 5184, 64):
        import os
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if root not in sys.path:
            sys.path.insert(0, root)
        import chip_smoke as cs

        builder = {"feat10": cs.flagship_problem, "ancf3443": cs.shell_problem,
                   "ancf3243": cs.ancf_beam_problem}[family]
        system = builder("cpu", torch.float64, material=mr)[0]
        system = replace(system, elems=system.elems.to(device, dtype))
        scale = 1e-3 * cs.STRAIN_SCALE.get(f"{family}_mr", 1.0)
    elif family == "feat10":
        system = _box_system(device, dtype, material=mr)[0]
        scale = 1e-2
    else:
        system = _ancf_system(device, dtype, family, n=(13, 1) if family == "ancf3243" else (5, 5),
                              material=mr)[0]
        scale = ANCF_MR_STRAIN[family]
    n = system.n_coef
    packed = np.concatenate([rng.normal(size=(n, 3)) * scale, rng.normal(size=(n, 6))], 1)
    return system, torch.as_tensor(packed, dtype=dtype, device=device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", MR_TILE_CASES, ids=[f"{f}-{e}" for f, e in MR_TILE_CASES])
def test_mr_tile_matches_twins_repeats_and_k5_is_k1(cuda_dev, case, dtype, tol):
    """K1 `[<family>_mr]` (fe and the prep cache) and K5 against their twins,
    one launch each; both bitwise repeatable; K5 equal to K1's fe bit for
    bit."""
    family, E = case
    system, packed = _mr_tile_case(cuda_dev, dtype, family, E)
    op = system.fem
    assert (op.tag, op.E) == (f"{family}_mr", E)
    fk.reset_launch_counts()
    fe, prep = fk.primal_prep(op, packed)
    fe5 = fk.contrib(op, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"primal_prep[{family}_mr]"] == 1
    assert fk.LAUNCHES[f"contrib[{family}_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 2
    fe_p, prep_p = fk.primal_prep_plain(op, packed)
    jm1 = prep_p.view(op.Q, op.prep_rows, op.E)[:, 18]
    assert float(jm1.abs().max()) < 0.9  # strained, nothing inverted
    assert bool(torch.isfinite(fe).all()) and bool(torch.isfinite(prep).all())
    assert _rel(fe, fe_p) < tol and _rel(prep, prep_p) < tol
    assert torch.equal(fe5, fe)
    fe2, prep2 = fk.primal_prep(op, packed)
    assert torch.equal(fe2, fe) and torch.equal(prep2, prep)
    assert torch.equal(fk.contrib(op, packed), fe5)



# K2 with Mooney-Rivlin (`fem_kernels.cuh` `hv_tile`, its operands streamed
# through shared memory or not as fem_<family>_mr.cu picks) at the ragged
# sizes and the full sizes of chip_smoke's [kernels] (the 10k flagship, the
# 72 x 72 shell, the 64-element beam); and the blocks of the float32 FEAT10
# launch that one SM holds, as PERF.md records them: 3, so that the 10k
# flagship's 331 tiles run in one wave on an H100's 132 SMs.
MR_HV_CASES = MR_TILE_CASES + [("ancf3243", 64)]
MR_HV_FEAT10_BLOCKS_PER_SM = 3


def _mr_hv_args(system, packed, dtype, device):
    """(p, prep): a random direction and the twin's prep cache at packed."""
    rng = np.random.default_rng(7)
    p = torch.as_tensor(rng.normal(size=(system.n_coef, 3)), dtype=dtype, device=device)
    return p.contiguous(), fk.primal_prep_plain(system.fem, packed)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", MR_HV_CASES, ids=[f"{f}-{e}" for f, e in MR_HV_CASES])
def test_mr_hv_matches_twin_and_repeats(cuda_dev, case, dtype, tol, damping):
    """K2 `[<family>_mr]` against `hv_plain`, one launch, damped and
    undamped; bitwise repeatable."""
    family, E = case
    system, packed = _mr_tile_case(cuda_dev, dtype, family, E, damping)
    op = system.fem
    assert (op.tag, op.E) == (f"{family}_mr", E)
    p, prep = _mr_hv_args(system, packed, dtype, cuda_dev)
    fk.reset_launch_counts()
    got = fk.hv(op, p, prep, DT)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"hv[{family}_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = fk.hv_plain(op, p, prep, DT)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert torch.equal(fk.hv(op, p, prep, DT), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
def test_mr_hv_matches_twin_at_an_inverted_point(cuda_dev, family, dtype, tol):
    """At det F < 0 (the small structure mirrored in x) K2 takes CUDA's real
    `cbrt` in `mr_coefs`; its twin's sign-preserving cube root gives the
    same finite product."""
    small = {"feat10": 18, "ancf3243": 13, "ancf3443": 25}[family]
    system, packed = _mr_tile_case(cuda_dev, dtype, family, small)
    packed = packed.clone()
    packed[:, 0] -= 2.0 * system.elems.x_ref[:, 0]  # x -> -x
    op = system.fem
    p, prep = _mr_hv_args(system, packed, dtype, cuda_dev)
    assert float(prep.view(op.Q, op.prep_rows, op.E)[:, 18].max()) < -1.0  # J < 0
    got = fk.hv(op, p, prep, DT)
    want = fk.hv_plain(op, p, prep, DT)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all()) and bool(torch.isfinite(got).all())
    assert _rel(got, want) < tol


@pytest.mark.cuda
def test_mr_hv_feat10_runs_the_flagship_in_one_wave(cuda_dev):
    """The float32 K2 `[feat10_mr]` launch: as many blocks an SM as PERF.md
    records, so that the 10k flagship's 331 tiles take one wave of the
    card's SMs."""
    occ = fk.occupancy("hv", "feat10_mr", torch.float32)
    assert occ["blocks_per_sm"] == MR_HV_FEAT10_BLOCKS_PER_SM
    n_sm = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
    assert -(-10584 // fk.TILE) <= occ["blocks_per_sm"] * n_sm


# K1 `primal_prep[ancf3243]`, K2 `hv[ancf3243]` and K5 `contrib[ancf3243]`
# (SVK) and K2 `hv[ancf3243_mr]`, which an instantiation may launch with one
# thread a quadrature point (`fem_kernels.cuh` `Points`): beams of E
# elements of `_ancf_system`, E a multiple of neither 8 nor 32 where ragged
# (1, 7, 33, 65, 1,027: a last block of one element, a row stride E *
# itemsize off 16 bytes), the lengths of chip_smoke's [kernels] and
# [ancf_beam_1024] beams (64, 1,024), and one element past each gate of
# `BEAM_SPLIT` (2,049, 4,097, 32,769: the parent tile of a split
# instantiation), at the strained state of `_mr_ancf_case` (u 1e-2, J - 1
# within +-0.5).
BEAM_TILE_SIZES = [1, 7, 33, 64, 65, 1024, 1027, 2049, 4097, 32769]
# K2 `[ancf3243_mr]` on the strained state: all but 32,769, which is past no
# gate of its own (2,048, 4,096) and where the random state's |J - 1|
# reaches 0.905, past the 0.9 that test holds the state to.
MR_BEAM_TILE_SIZES = BEAM_TILE_SIZES[:-1]
# Each kernel's launch as PERF.md records the choice, by (kernel, tag,
# dtype): (TE, MAX_E), the split (TE elements x 12 points a block, `Points`
# or `Direct`) on beams of up to MAX_E elements, the parent tile (32
# elements x 4 groups of points) above; None, the parent at every E.
BEAM_SPLIT = {("contrib", "ancf3243", torch.float32): (8, 4096),
              ("contrib", "ancf3243", torch.float64): (8, 4096),
              ("hv", "ancf3243_mr", torch.float32): (8, 2048),
              ("hv", "ancf3243_mr", torch.float64): (8, 4096),
              ("primal_prep", "ancf3243", torch.float32): (8, 2048),
              ("primal_prep", "ancf3243", torch.float64): (8, 32768),
              ("hv", "ancf3243", torch.float32): (8, 4096),
              ("hv", "ancf3243", torch.float64): (8, 4096)}


def _beam_tile_case(device, dtype, E, material=None):
    """(system, packed, p): an E-element cantilever of `_ancf_system` at the
    strained random state, and a random direction."""
    system, _, _ = _ancf_system(device, dtype, "ancf3243", n=(E, 1), material=material)
    rng = np.random.default_rng(21)
    n = system.n_coef

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    packed = np.concatenate([rng.normal(size=(n, 3)) * ANCF_MR_STRAIN["ancf3243"],
                             rng.normal(size=(n, 6))], 1)
    return system, dev(packed), dev(rng.normal(size=(n, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", BEAM_TILE_SIZES)
def test_beam_contrib_matches_twin_repeats_and_is_k1(cuda_dev, E, dtype, tol):
    """K5 `[ancf3243]` against its twin in one launch, bitwise repeatable,
    and equal to K1's fe bit for bit."""
    system, packed, _ = _beam_tile_case(cuda_dev, dtype, E)
    op = system.fem
    assert (op.tag, op.E) == ("ancf3243", E)
    fk.reset_launch_counts()
    fe5 = fk.contrib(op, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["contrib[ancf3243]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(fe5).all()) and _rel(fe5, fk.contrib_plain(op, packed)) < tol
    assert torch.equal(fk.contrib(op, packed), fe5)
    assert torch.equal(fk.primal_prep(op, packed)[0], fe5)


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", MR_BEAM_TILE_SIZES)
def test_beam_mr_hv_matches_twin_and_repeats(cuda_dev, E, dtype, tol, damping):
    """K2 `[ancf3243_mr]` against `hv_plain` in one launch, damped and
    undamped; bitwise repeatable."""
    system, packed, p = _beam_tile_case(cuda_dev, dtype, E, _mooney_rivlin(damping=damping))
    op = system.fem
    assert (op.tag, op.E) == ("ancf3243_mr", E)
    _, prep = fk.primal_prep_plain(op, packed)
    assert float(prep.view(op.Q, op.prep_rows, op.E)[:, 18].abs().max()) < 0.9
    fk.reset_launch_counts()
    got = fk.hv(op, p, prep, DT)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["hv[ancf3243_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(got).all()) and _rel(got, fk.hv_plain(op, p, prep, DT)) < tol
    assert torch.equal(fk.hv(op, p, prep, DT), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", BEAM_TILE_SIZES)
def test_beam_mr_hv_matches_twin_at_an_inverted_point(cuda_dev, E, dtype, tol):
    """K2 `[ancf3243_mr]` on the beam mirrored in x (det F < 0 at every
    point: CUDA's real `cbrt` against the twin's sign-preserving root)."""
    system, packed, p = _beam_tile_case(cuda_dev, dtype, E, _mooney_rivlin())
    packed = packed.clone()
    packed[:, 0] -= 2.0 * system.elems.x_ref[:, 0]  # x -> -x
    op = system.fem
    _, prep = fk.primal_prep_plain(op, packed)
    assert float(prep.view(op.Q, op.prep_rows, op.E)[:, 18].max()) < -1.0  # J < 0
    got = fk.hv(op, p, prep, DT)
    want = fk.hv_plain(op, p, prep, DT)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all()) and bool(torch.isfinite(got).all())
    assert _rel(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", BEAM_TILE_SIZES)
def test_beam_primal_prep_and_hv_match_twins_and_repeat(cuda_dev, E, dtype, tol, damping):
    """K1 `[ancf3243]` (fe and the prep cache) and K2 `[ancf3243]` (SVK),
    damped and undamped: each against its twin in one launch, bitwise
    repeatable; K2 reads the kernel's prep cache."""
    lam, mu = lame_from_E_nu(1e7, 0.3)
    system, packed, p = _beam_tile_case(cuda_dev, dtype, E, SVK(lam, mu, damping, damping))
    op = system.fem
    assert (op.tag, op.E) == ("ancf3243", E)
    fk.reset_launch_counts()
    fe, prep = fk.primal_prep(op, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["primal_prep[ancf3243]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    fe_want, prep_want = fk.primal_prep_plain(op, packed)
    assert bool(torch.isfinite(fe).all()) and bool(torch.isfinite(prep).all())
    assert _rel(fe, fe_want) < tol and _rel(prep, prep_want) < tol
    fe2, prep2 = fk.primal_prep(op, packed)
    assert torch.equal(fe2, fe) and torch.equal(prep2, prep)
    fk.reset_launch_counts()
    got = fk.hv(op, p, prep, DT)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["hv[ancf3243]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(got).all()) and _rel(got, fk.hv_plain(op, p, prep, DT)) < tol
    assert torch.equal(fk.hv(op, p, prep, DT), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kernel,tag", [("contrib", "ancf3243"), ("hv", "ancf3243_mr"),
                                        ("primal_prep", "ancf3243"), ("hv", "ancf3243")])
def test_beam_tiles_report_the_block_they_launch(cuda_dev, kernel, tag, dtype):
    """`occupancy` reports the block of the launch that runs: the split's TE
    elements x 12 points up to MAX_E elements, the parent's 32 x 4 above,
    each with at least one block an SM; and `launch_blocks` counts the
    split's blocks on a ragged beam."""
    split = BEAM_SPLIT[(kernel, tag, dtype)]
    te, max_e = split or (32, 0)
    cases = ((1, (te, te * 12)), (65, (te, te * 12)), (max_e, (te, te * 12)),
             (max_e + 1, (32, 128)), (None, (32, 128)))
    for E, shape in cases if split else ((1, (32, 128)), (65, (32, 128)), (None, (32, 128))):
        occ = fk.occupancy(kernel, tag, dtype, E)
        assert (occ["elements"], occ["threads"]) == shape, E
        assert occ["blocks_per_sm"] >= 1
    system = _beam_tile_case(cuda_dev, dtype, 65, None if tag == "ancf3243" else
                             _mooney_rivlin())[0]
    assert fk.launch_blocks(kernel, system.fem) == -(-65 // te)


# K3 `svk_blocks[ancf3243]` (SVK), K5t `contrib_tangent[ancf3243_mr]` and
# K5t `contrib_tangent[ancf3243]` (SVK), which the instantiations may launch
# with one thread an (element, slot) (`fem_kernels.cuh` `Slots`): the beams
# of BEAM_TILE_SIZES (the MR K5t at the strained state on
# MR_BEAM_TILE_SIZES, damped and undamped, and at the mirrored beam on all
# of them; the SVK K5t on all of them, damped and undamped), at
# `_beam_tile_case`'s state (K3 at its u) and a standard normal tangent
# direction.
# The launch as PERF.md records the choice, by (kernel, tag, dtype): (TE,
# rows, MAX_E, blocks an SM), TE elements x rows (the 8 slots, or 12 where
# one chunk holds all 12 points) a block on beams of up to MAX_E elements and
# the parent tile (32 elements x 4 groups of points) above.
BEAM_SLOTS = {("svk_blocks", "ancf3243", torch.float32): (8, 12, 4096, 10),
              ("svk_blocks", "ancf3243", torch.float64): (8, 12, 4096, 5),
              ("contrib_tangent", "ancf3243_mr", torch.float32): (8, 12, 4096, 5),
              ("contrib_tangent", "ancf3243_mr", torch.float64): (8, 12, 2**31 - 1, 2),
              ("contrib_tangent", "ancf3243", torch.float32): (8, 12, 4096, 10),
              ("contrib_tangent", "ancf3243", torch.float64): (8, 12, 2**31 - 1, 5)}


def _beam_tangent_case(device, dtype, E, damping, mirrored=False, svk=False):
    """(op, packed, dpacked): K5t `[ancf3243_mr]`'s case (`[ancf3243]`'s
    with svk) on an E-element beam, at the strained state or its mirror in x
    (det F < 0)."""
    material = _svk(damping) if svk else _mooney_rivlin(damping=damping)
    system, packed, _ = _beam_tile_case(device, dtype, E, material)
    if mirrored:
        packed = packed.clone()
        packed[:, 0] -= 2.0 * system.elems.x_ref[:, 0]  # x -> -x
    dpacked = np.random.default_rng(23).normal(size=(system.n_coef, 9))
    return system.fem, packed, torch.as_tensor(dpacked, dtype=dtype, device=device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", BEAM_TILE_SIZES)
def test_beam_svk_blocks_matches_twin_and_repeats(cuda_dev, E, dtype, tol):
    """K3 `[ancf3243]` against its twin in one launch; bitwise repeatable."""
    system, packed, _ = _beam_tile_case(cuda_dev, dtype, E)
    op = system.fem
    assert (op.tag, op.E) == ("ancf3243", E)
    u = packed[:, :3].contiguous()
    fk.reset_launch_counts()
    got = fk.svk_blocks(op, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["svk_blocks[ancf3243]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(got).all()) and _rel(got, fk.svk_blocks_plain(op, u)) < tol
    assert torch.equal(fk.svk_blocks(op, u), got)


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", MR_BEAM_TILE_SIZES)
def test_beam_mr_contrib_tangent_matches_twin_and_repeats(cuda_dev, E, dtype, tol, damping):
    """K5t `[ancf3243_mr]` against its twin in one launch, damped and
    undamped, at the strained state; bitwise repeatable."""
    op, packed, dpacked = _beam_tangent_case(cuda_dev, dtype, E, damping)
    assert (op.tag, op.E) == ("ancf3243_mr", E)
    _, prep = fk.primal_prep_plain(op, packed)
    assert float(prep.view(op.Q, op.prep_rows, op.E)[:, 18].abs().max()) < 0.9
    fk.reset_launch_counts()
    got = fk.contrib_tangent(op, packed, dpacked)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["contrib_tangent[ancf3243_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = fk.contrib_tangent_plain(op, packed, dpacked)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert torch.equal(fk.contrib_tangent(op, packed, dpacked), got)


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", BEAM_TILE_SIZES)
def test_beam_svk_contrib_tangent_matches_twin_and_repeats(cuda_dev, E, dtype, tol, damping):
    """K5t `[ancf3243]` (SVK) against its twin in one launch, damped and
    undamped; bitwise repeatable."""
    op, packed, dpacked = _beam_tangent_case(cuda_dev, dtype, E, damping, svk=True)
    assert (op.tag, op.E) == ("ancf3243", E)
    fk.reset_launch_counts()
    got = fk.contrib_tangent(op, packed, dpacked)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["contrib_tangent[ancf3243]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = fk.contrib_tangent_plain(op, packed, dpacked)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert torch.equal(fk.contrib_tangent(op, packed, dpacked), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", BEAM_TILE_SIZES)
def test_beam_mr_contrib_tangent_matches_twin_at_an_inverted_point(cuda_dev, E, dtype, tol):
    """K5t `[ancf3243_mr]` on the beam mirrored in x (det F < 0 at every
    point: CUDA's real `cbrt` against the twin's sign-preserving root)."""
    op, packed, dpacked = _beam_tangent_case(cuda_dev, dtype, E, 1e3, mirrored=True)
    _, prep = fk.primal_prep_plain(op, packed)
    assert float(prep.view(op.Q, op.prep_rows, op.E)[:, 18].max()) < -1.0  # J < 0
    got = fk.contrib_tangent(op, packed, dpacked)
    want = fk.contrib_tangent_plain(op, packed, dpacked)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all()) and bool(torch.isfinite(got).all())
    assert _rel(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kernel,tag", [("svk_blocks", "ancf3243"),
                                        ("contrib_tangent", "ancf3243_mr"),
                                        ("contrib_tangent", "ancf3243")])
def test_beam_slot_tiles_report_the_block_they_launch(cuda_dev, kernel, tag, dtype):
    """`occupancy` reports the block of the K3 `[ancf3243]` / K5t
    `[ancf3243_mr]` / K5t `[ancf3243]` launch that runs, as BEAM_SLOTS records it, on each side
    of any gate; and `launch_blocks` counts its blocks on the ragged 65
    elements."""
    te, rows, max_e, per_sm = BEAM_SLOTS[(kernel, tag, dtype)]
    gate = [max_e, max_e + 1] if max_e < 2**31 - 1 else []
    for E in [1, 65, 1024, *gate, 32769, None]:
        occ = fk.occupancy(kernel, tag, dtype, E)
        if (E or 2**31 - 1) <= max_e:
            assert (occ["elements"], occ["threads"], occ["blocks_per_sm"]) == (te, te * rows,
                                                                             per_sm), E
        else:
            assert (occ["elements"], occ["threads"]) == (32, 128), E
        assert occ["blocks_per_sm"] >= 1
    system = _beam_tile_case(cuda_dev, dtype, 65, None if tag == "ancf3243" else
                             _mooney_rivlin())[0]
    assert fk.launch_blocks(kernel, system.fem) == -(-65 // te)


# K3 `svk_blocks[ancf3443]` (SVK), which the instantiation may launch with one
# thread an (element, slot) (`fem_kernels.cuh` `Slots`): shells of 1, 35 (5 x
# 7: a ragged last block, a row stride E * itemsize off 16 bytes), 576 (24 x
# 24) and 5,184 (72 x 72, chip_smoke's [shell]) elements, at a random u of
# 1e-2.
SHELL_BLOCK_SIZES = [(1, 1), (5, 7), (24, 24), (72, 72)]
# The launch as PERF.md records the choice, by dtype: TE elements x 16 slots a
# block at every E.
SHELL_SLOTS = {torch.float32: 8, torch.float64: 8}


def _shell_blocks_case(device, dtype, shell):
    system, _, _ = _ancf_system(device, dtype, "ancf3443", n=shell)
    rng = np.random.default_rng(17)
    u = rng.normal(size=(system.n_coef, 3)) * 1e-2
    return system, torch.as_tensor(u, dtype=dtype, device=device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shell", SHELL_BLOCK_SIZES, ids=[f"{x}x{y}" for x, y in SHELL_BLOCK_SIZES])
def test_shell_svk_blocks_matches_twin_and_repeats(cuda_dev, shell, dtype, tol):
    """K3 `[ancf3443]` against its twin in one launch; bitwise repeatable."""
    system, u = _shell_blocks_case(cuda_dev, dtype, shell)
    op = system.fem
    assert (op.tag, op.E) == ("ancf3443", shell[0] * shell[1])
    fk.reset_launch_counts()
    got = fk.svk_blocks(op, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["svk_blocks[ancf3443]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(got).all()) and _rel(got, fk.svk_blocks_plain(op, u)) < tol
    assert torch.equal(fk.svk_blocks(op, u), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_shell_svk_blocks_reports_the_block_it_launches(cuda_dev, dtype):
    """`occupancy` reports the block of the K3 `[ancf3443]` launch that runs:
    TE elements x 16 slots at every E, with at least one block an SM; and
    `launch_blocks` counts its blocks on the ragged 5 x 7 shell."""
    te = SHELL_SLOTS[dtype]
    cases = [(1, (te, te * 16)), (35, (te, te * 16)), (20736, (te, te * 16)),
             (None, (te, te * 16))]
    for E, shape in cases:
        occ = fk.occupancy("svk_blocks", "ancf3443", dtype, E)
        assert (occ["elements"], occ["threads"]) == shape, E
        assert occ["blocks_per_sm"] >= 1
    system, _ = _shell_blocks_case(cuda_dev, dtype, (5, 7))
    assert fk.launch_blocks("svk_blocks", system.fem) == -(-35 // te)


# K5t `contrib_tangent[ancf3443]` (SVK) and `[ancf3443_mr]`, which the
# instantiations may launch with one thread an (element, slot)
# (`fem_kernels.cuh` `Slots`, `contrib_tangent_slots_kernel`) up to a gate:
# shells of 1, 35 (5 x 7: a ragged last block, a row stride E * itemsize off
# 16 bytes), 576 (24 x 24) and 5,184 (72 x 72, chip_smoke's [shell])
# elements, and for SVK 7,056 (84 x 84, past its float64 gate), at a
# strained random state (u ANCF_MR_STRAIN["ancf3443"], v and dv/dt standard
# normal) and a standard normal direction.
SHELL_TANGENT_SIZES = [(1, 1), (5, 7), (24, 24), (72, 72)]
SHELL_TANGENT_CASES = ([(shell, tag) for tag in ("ancf3443", "ancf3443_mr")
                        for shell in SHELL_TANGENT_SIZES] + [((84, 84), "ancf3443")])
# The launch as PERF.md records the choice, by (tag, dtype): (TE, MAX_E), TE
# elements x 16 slots a block on shells of up to MAX_E elements and the
# parent tile (32 elements x 4 groups) above; None, the parent at every E.
SHELL_TANGENT_SLOTS = {("ancf3443", torch.float32): (8, 2**31 - 1),
                       ("ancf3443", torch.float64): (8, 5184),
                       ("ancf3443_mr", torch.float32): (8, 2**31 - 1),
                       ("ancf3443_mr", torch.float64): None}


@lru_cache(maxsize=None)
def _shell_elems(shell):
    """The float64 tables of an nx x ny ANCF3443 shell on the CPU, built once
    (the build takes seconds at thousands of elements)."""
    coefs, conn = ancf3443.shell_grid(*shell, L=0.05, W=0.05)
    return len(coefs), ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0,
                                      dtype=torch.float64, device="cpu")


def _shell_tangent_case(device, dtype, shell, tag, damping):
    """(op, packed, dpacked) on an nx x ny shell of material `tag` (SVK or
    Mooney-Rivlin) with the given damping."""
    lam, mu = lame_from_E_nu(1e7, 0.3)
    material = (_mooney_rivlin(damping=damping) if tag == "ancf3443_mr"
                else SVK(lam, mu, damping, damping))
    n, elems = _shell_elems(shell)
    op = fk.FemOperator(elems.to(device, dtype), material)
    rng = np.random.default_rng(31)
    packed = np.concatenate([rng.normal(size=(n, 3)) * ANCF_MR_STRAIN["ancf3443"],
                             rng.normal(size=(n, 6))], 1)
    dpacked = rng.normal(size=(n, 9))
    return (op, *(torch.as_tensor(a, dtype=dtype, device=device).contiguous()
                  for a in (packed, dpacked)))


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shell,tag", SHELL_TANGENT_CASES,
                         ids=[f"{x}x{y}-{t}" for (x, y), t in SHELL_TANGENT_CASES])
def test_shell_contrib_tangent_matches_twin_and_repeats(cuda_dev, shell, tag, dtype, tol,
                                                         damping):
    """K5t `[ancf3443]` and `[ancf3443_mr]` against their twins in one
    launch, damped and undamped, at a strained state; bitwise repeatable."""
    op, packed, dpacked = _shell_tangent_case(cuda_dev, dtype, shell, tag, damping)
    assert (op.tag, op.E) == (tag, shell[0] * shell[1])
    fk.reset_launch_counts()
    got = fk.contrib_tangent(op, packed, dpacked)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[f"contrib_tangent[{tag}]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = fk.contrib_tangent_plain(op, packed, dpacked)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert torch.equal(fk.contrib_tangent(op, packed, dpacked), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tag", ["ancf3443", "ancf3443_mr"])
def test_shell_contrib_tangent_reports_the_block_it_launches(cuda_dev, tag, dtype):
    """`occupancy` reports the block of the K5t `[ancf3443]` / `[ancf3443_mr]`
    launch that runs, as SHELL_TANGENT_SLOTS records it, on each side of any
    gate, with at least one block an SM; and `launch_blocks` counts its
    blocks on the ragged 5 x 7 shell."""
    slots = SHELL_TANGENT_SLOTS[(tag, dtype)]
    te, max_e = slots or (32, 0)
    gate = [max_e, max_e + 1] if slots and max_e < 2**31 - 1 else []
    for E in [1, 35, 5184, *gate, 20736, None]:
        occ = fk.occupancy("contrib_tangent", tag, dtype, E)
        on_slots = slots is not None and (E or 2**31 - 1) <= max_e
        assert (occ["elements"], occ["threads"]) == ((te, te * 16) if on_slots else (32, 128)), E
        assert occ["blocks_per_sm"] >= 1
    op = _shell_tangent_case(cuda_dev, dtype, (5, 7), tag, 1e3)[0]
    assert fk.launch_blocks("contrib_tangent", op) == -(-35 // (te if slots else 32))


# K5t `contrib_tangent[feat10_mr]` (its operands streamed through shared
# memory or not as fem_feat10_mr.cu picks): the first E elements of a FEAT10
# box, E = 1 and 33 (of a 3 x 2 x 1 box: ragged), 96 (the bunny's fallback
# mesh), 864 (the bench.py 1k box) and 10,584 (the flagship), at a random
# strained state (u a fiftieth of the smallest cell).
MR_TANGENT_BOXES = {1: (1.0, 0.4, 0.2, 3, 2, 1), 33: (1.0, 0.4, 0.2, 3, 2, 1),
                    96: (1.0, 1.0, 2.0, 2, 2, 4), 864: (1.0, 0.25, 0.25, 12, 4, 3),
                    10584: (2.0, 0.35, 0.3, 42, 7, 6)}


def _mr_tangent_case(device, dtype, E, damping):
    """(op, packed, dpacked) on the first E elements of MR_TANGENT_BOXES[E]."""
    return _box_case(device, dtype, E, _mooney_rivlin(damping=damping))


def _box_case(device, dtype, E, material):
    """(op, packed, dpacked) of `material` on the first E elements of
    MR_TANGENT_BOXES[E], at a random strained state (u a fiftieth of the
    smallest cell, v and dv/dt standard normal) and a standard normal
    direction."""
    dims = MR_TANGENT_BOXES[E]
    nodes, conn = box_t10_mesh(*dims)
    elems = feat10.build(nodes, conn[:E], rho=1000.0, dtype=dtype, device="cpu")
    op = fk.FemOperator(elems.to(device), material)
    rng = np.random.default_rng(23)
    n = len(nodes)
    scale = 0.02 * min(d / c for d, c in zip(dims[:3], dims[3:]))
    packed = np.concatenate([rng.normal(size=(n, 3)) * scale, rng.normal(size=(n, 6))], 1)
    dpacked = rng.normal(size=(n, 9))
    return (op, *(torch.as_tensor(a, dtype=dtype, device=device).contiguous()
                  for a in (packed, dpacked)))


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", list(MR_TANGENT_BOXES))
def test_mr_contrib_tangent_feat10_matches_twin_and_repeats(cuda_dev, E, dtype, tol, damping):
    """K5t `[feat10_mr]` against its twin in one launch, damped and
    undamped, at a strained state; bitwise repeatable."""
    op, packed, dpacked = _mr_tangent_case(cuda_dev, dtype, E, damping)
    assert (op.tag, op.E) == ("feat10_mr", E)
    _, prep = fk.primal_prep_plain(op, packed)
    assert float(prep.view(op.Q, op.prep_rows, op.E)[:, 18].abs().max()) < 0.9
    fk.reset_launch_counts()
    got = fk.contrib_tangent(op, packed, dpacked)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["contrib_tangent[feat10_mr]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = fk.contrib_tangent_plain(op, packed, dpacked)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert torch.equal(fk.contrib_tangent(op, packed, dpacked), got)


# The blocks of the float32 K5t `[feat10_mr]` launch (its operands streamed
# through shared memory) that one SM holds, as PERF.md records them: 3, so
# that the 10k flagship's 331 tiles run in one wave on an H100's 132 SMs.
MR_TANGENT_FEAT10_BLOCKS_PER_SM = 3


@pytest.mark.cuda
def test_mr_contrib_tangent_feat10_runs_the_flagship_in_one_wave(cuda_dev):
    """The float32 K5t `[feat10_mr]` launch: as many blocks an SM as PERF.md
    records, so that the 10k flagship's 331 tiles take one wave of the
    card's SMs."""
    occ = fk.occupancy("contrib_tangent", "feat10_mr", torch.float32)
    assert occ["blocks_per_sm"] == MR_TANGENT_FEAT10_BLOCKS_PER_SM
    n_sm = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
    assert -(-10584 // fk.TILE) <= occ["blocks_per_sm"] * n_sm


# K3 `svk_blocks[feat10]` and K5t `contrib_tangent[feat10]` (SVK), which the
# instantiation launches with one thread an (element, slot) (`fem_kernels.cuh`
# `Slots<16, 5>`, all 5 points one chunk copied into one buffer): the first E
# elements of a FEAT10 box, E = 1, 33 (of a 3 x 2 x 1 box: a multiple of
# neither 16 nor 32, and a row stride E * itemsize off 16 bytes, so the copy
# goes word by word), 864 (the bench.py 1k box) and 10,584 (the flagship), at
# `_box_case`'s strained state (K3 at its u).
FEAT10_TILE_SIZES = [1, 33, 864, 10584]
# The launch as PERF.md records the choice, by (kernel, dtype): (TE, blocks an
# SM), TE elements x 10 slots a block at every E.
FEAT10_SLOTS = {("svk_blocks", torch.float32): (16, 7), ("svk_blocks", torch.float64): (16, 4),
                ("contrib_tangent", torch.float32): (16, 7),
                ("contrib_tangent", torch.float64): (16, 3)}


def _svk(damping=1e3):
    lam, mu = lame_from_E_nu(1e7, 0.3)
    return SVK(lam, mu, damping, damping)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", FEAT10_TILE_SIZES)
def test_feat10_svk_blocks_matches_twin_and_repeats(cuda_dev, E, dtype, tol):
    """K3 `[feat10]` against its twin in one launch; bitwise repeatable."""
    op, packed, _ = _box_case(cuda_dev, dtype, E, _svk())
    assert (op.tag, op.E) == ("feat10", E)
    u = packed[:, :3].contiguous()
    fk.reset_launch_counts()
    got = fk.svk_blocks(op, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["svk_blocks[feat10]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(got).all()) and _rel(got, fk.svk_blocks_plain(op, u)) < tol
    assert torch.equal(fk.svk_blocks(op, u), got)


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("E", FEAT10_TILE_SIZES)
def test_feat10_contrib_tangent_matches_twin_and_repeats(cuda_dev, E, dtype, tol, damping):
    """K5t `[feat10]` (SVK) against its twin in one launch, damped and
    undamped, at a strained state; bitwise repeatable."""
    op, packed, dpacked = _box_case(cuda_dev, dtype, E, _svk(damping))
    assert (op.tag, op.E) == ("feat10", E)
    fk.reset_launch_counts()
    got = fk.contrib_tangent(op, packed, dpacked)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["contrib_tangent[feat10]"] == 1 and sum(fk.LAUNCHES.values()) == 1
    want = fk.contrib_tangent_plain(op, packed, dpacked)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert torch.equal(fk.contrib_tangent(op, packed, dpacked), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["svk_blocks", "contrib_tangent"])
def test_feat10_tangent_tiles_report_the_block_they_launch(cuda_dev, kernel, dtype):
    """`occupancy` reports the block of the K3 / K5t `[feat10]` launch, as
    FEAT10_SLOTS records it, at every E; and `launch_blocks` counts its
    blocks on the ragged 33 elements."""
    te, per_sm = FEAT10_SLOTS[(kernel, dtype)]
    for E in [1, 33, 864, 10584, 101376, None]:
        occ = fk.occupancy(kernel, "feat10", dtype, E)
        assert (occ["elements"], occ["threads"], occ["blocks_per_sm"]) == (te, te * 10, per_sm), E
    op = _box_case(cuda_dev, dtype, 33, _svk())[0]
    assert fk.launch_blocks(kernel, op) == -(-33 // te)


def _accum_case(device):
    """The float32 box in the accuracy mode (`System.accum_dtype` float64)
    at a strained, moving state with u in float64, and a direction."""
    system, x0, f_ext = _box_system(device, torch.float32)
    system = system.replace(accum_dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(18)
    state = StepState.rest(system, x0)
    u = state.u.double() + 1e-3 * torch.randn(x0.shape, device=device, dtype=torch.float64,
                                              generator=gen)
    v, v_prev, p = (torch.randn(x0.shape, device=device, generator=gen) for _ in range(3))
    return system, state, u, v, v_prev, p, f_ext


@pytest.mark.cuda
def test_accum_g_and_hvp_runs_the_float64_kernels(cuda_dev):
    """The accuracy mode's g and H p on the card: K1, K2 and K4 in float64
    (and no other launch), against the plain twins on the same inputs:
    within 1e-12 before the downcast (float64 v), and float32 results
    within one float32 rounding of the twins' after it."""
    from tlfea_torch.solvers.common import _pin_terms

    system, state, u, v, v_prev, p, f_ext = _accum_case(cuda_dev)
    op = system.grad_op
    assert op is system.fem_wide and op.gN_t.dtype == torch.float64
    pins = _pin_terms(system, state.lam, DT, 1e7, torch.float64)
    fk.reset_launch_counts()
    g, hvp = fk.g_and_hvp(v, u, v_prev, f_ext, DT, op, pins)
    h = hvp(p)
    torch.cuda.synchronize()
    assert g.dtype == h.dtype == torch.float32
    assert fk.LAUNCHES_F64 == fk.LAUNCHES
    assert {k: fk.LAUNCHES_F64[f"{k}[feat10]"] for k in ("primal_prep", "hv", "node_reduce")} \
        == {"primal_prep": 1, "hv": 1, "node_reduce": 2} and sum(fk.LAUNCHES.values()) == 4
    g_p, hvp_p = fk.g_and_hvp(v, u, v_prev, f_ext, DT, op, pins, plain=True)
    assert _rel(g, g_p) < 1e-6 and _rel(h, hvp_p(p)) < 1e-6
    wide = [t.double() for t in (v, v_prev, p)]
    g64, hvp64 = fk.g_and_hvp(wide[0], u, wide[1], f_ext, DT, op, pins)
    g64_p, hvp64_p = fk.g_and_hvp(wide[0], u, wide[1], f_ext, DT, op, pins, plain=True)
    assert g64.dtype == torch.float64
    assert _rel(g64, g64_p) < 1e-12 and _rel(hvp64(wide[2]), hvp64_p(wide[2])) < 1e-12


@pytest.mark.cuda
def test_accum_grad_L_runs_float64_k5_and_raises_without_the_library(cuda_dev, monkeypatch):
    """grad_L and its jvp in the accuracy mode launch K5, K5t and K4 in
    float64, equal to the twins within one float32 rounding; with the
    library missing they raise, with no launch and no plain fallback."""
    from tlfea_torch.solvers.common import grad_L

    system, state, u, v, v_prev, p, f_ext = _accum_case(cuda_dev)

    def g_of(sysx):
        return lambda vv: grad_L(vv, state.x, v_prev, state.lam, f_ext, DT, 1e7, sysx, u_prev=u)

    fk.reset_launch_counts()
    g, dg = torch.func.jvp(g_of(system), (v,), (p,))
    assert {k: fk.LAUNCHES_F64[f"{k}[feat10]"] for k in ("contrib", "contrib_tangent",
                                                         "node_reduce")} == {
        "contrib": 1, "contrib_tangent": 1, "node_reduce": 2}
    assert g.dtype == dg.dtype == torch.float32
    g_p, dg_p = torch.func.jvp(g_of(replace(system, plain=True)), (v,), (p,))
    assert _rel(g, g_p) < 1e-6 and _rel(dg, dg_p) < 1e-6

    def missing():
        raise RuntimeError("nvcc not found (set CUDA_HOME); the FEM kernels need the CUDA toolkit")

    monkeypatch.setattr(fk, "build_kernels", missing)
    fk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        g_of(system)(v)
    assert sum(fk.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_accum_step_refuses_the_resident_kernel(cuda_dev):
    """The box passes the resident gate in float32 and not in the accuracy
    mode, whose step runs the composed path: no persistent launch, float64
    K1, K2 and K4, u kept in float64 and x in float32."""
    system, x0, f_ext = _box_system(cuda_dev, torch.float32)
    assert resident.eligible(system, None)
    system = system.replace(accum_dtype=torch.float64)
    assert not resident.eligible(system, None)
    state = StepState.rest(system, x0)
    state = state.replace(u=state.u.double())
    fs = float(f_ext.norm())
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * fs, max_outer=1, max_inner=4,
                                 cg_rtol=1e-3, cg_max_iter=50)
    fk.reset_launch_counts()
    st, diag = newton.step(system, state, params, f_ext)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["newton_resident[feat10]"] == 0 and diag["newton_iters"] >= 1
    assert min(fk.LAUNCHES_F64[f"{k}[feat10]"] for k in ("primal_prep", "hv", "node_reduce")) > 0
    assert st.u.dtype == torch.float64 and st.x.dtype == st.v.dtype == torch.float32
    assert bool(torch.isfinite(st.x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["resident", "composed"])
def test_simulation_resume_is_bitwise(cuda_dev, monkeypatch, tmp_path, path):
    """Simulation + newton.stepper on the card: six steps, or three, a
    checkpoint, a new Simulation loaded from it and three more, bitwise
    equal; both equal to make_rollout's six, bitwise (the same `_step`)."""
    from tlfea_torch.simulation import Simulation, gravity_force

    system, x0, _ = _box_system(cuda_dev, torch.float32, dims=(1.0, 0.2, 0.2, 6, 1, 1))
    if path == "composed":
        monkeypatch.setattr(resident, "eligible", lambda *a, **k: False)
    f_ext = gravity_force(system)
    fs = float(f_ext.norm())
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=2.5e-2 * fs, max_outer=1,
                                 max_inner=6, cg_rtol=1e-3, cg_max_iter=50)
    state0 = StepState.rest(system, x0)
    fk.reset_launch_counts()
    whole = Simulation(system, state0, newton.stepper(params), base_f_ext=f_ext)
    whole.run(6)
    key = "newton_resident[feat10]" if path == "resident" else "primal_prep[feat10]"
    assert fk.LAUNCHES[key] > 0
    first = Simulation(system, state0, newton.stepper(params), base_f_ext=f_ext)
    first.run(3)
    ckpt = str(tmp_path / "state.npz")
    first.save_state(ckpt)
    second = Simulation(system, state0, newton.stepper(params), base_f_ext=f_ext)
    second.load_state(ckpt)
    assert second.step_count == 3 and second.state.x.device == x0.device
    second.run(3)
    ref, _ = newton.make_rollout(system, params, 6)(state0, f_ext)
    for k in ("x", "v", "lam", "u", "dv"):
        assert torch.equal(getattr(second.state, k), getattr(whole.state, k)), k
    for k in ("x", "v", "u"):
        assert torch.equal(getattr(ref, k), getattr(whole.state, k)), k


def _coarse_box(device, dtype):
    """A pinned 1 x 0.2 x 0.2 box of 6 x 2 x 2 cells and its rest state."""
    system, x0, _ = _box_system(device, dtype, dims=(1.0, 0.2, 0.2, 6, 2, 2))
    return system, x0


@pytest.mark.cuda
@pytest.mark.parametrize("modes", ["trans", "rigid", "affine"])
def test_coarse_modes_f64_apply_matches_cpu(cuda_dev, modes):
    """Each mode's float64 apply on the card against the CPU's on the same
    residual, within max(1e-12, 8 eps kappa(A_c)) of its scale."""
    from tlfea_torch.solvers.coarse import build_coarse_precond

    built = []
    for dev in ("cpu", cuda_dev):
        system, x0 = _coarse_box(dev, torch.float64)
        built.append(build_coarse_precond(system, x0, DT, 1e7, modes=modes, target_cluster=8))
    r = torch.as_tensor(np.random.default_rng(1).standard_normal((built[0].u0.shape[0], 3)))
    z_cpu, z_dev = built[0].apply(r), built[1].apply(r.to(cuda_dev)).cpu()
    kappa = float(torch.linalg.cond(built[0].Ainv))
    tol = max(1e-12, 8 * float(np.finfo(np.float64).eps) * kappa)
    assert float((z_dev - z_cpu).abs().max() / z_cpu.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_coarse_bf16_apply_matches_cpu(cuda_dev, dtype):
    """The bfloat16 factored apply on the card against the CPU's (3e-2 of
    its scale), with bfloat16 tables and the result in r's dtype."""
    from tlfea_torch.solvers.coarse import build_coarse_precond

    built = []
    for dev in ("cpu", cuda_dev):
        system, x0 = _coarse_box(dev, dtype)
        built.append(build_coarse_precond(system, x0, DT, 1e7, target_cluster=8,
                                          mm_dtype="bfloat16", ranges=True))
    assert built[1].Li.dtype == built[1].Agg.dtype == torch.bfloat16 and built[1].Ainv is None
    r = torch.as_tensor(np.random.default_rng(2).standard_normal((built[0].u0.shape[0], 3)),
                        dtype=dtype)
    z_cpu, z_dev = built[0].apply(r), built[1].apply(r.to(cuda_dev))
    assert z_dev.dtype == dtype
    assert float((z_dev.cpu() - z_cpu).abs().max() / z_cpu.abs().max()) < 3e-2


@pytest.mark.cuda
def test_bf16_reduced_precision_reduction_is_off(cuda_dev):
    """The package pins bfloat16 products to float32 accumulation."""
    import tlfea_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


@pytest.mark.cuda
def test_native_library_is_built(cuda_dev):
    """The native host helper builds from the port's source where the card is."""
    from tlfea_torch import native

    assert native.available(), native.BUILD_ERROR
    assert native.library_path().startswith(os.path.join(os.path.dirname(
        os.path.abspath(native.__file__)), "_build"))
