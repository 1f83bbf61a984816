"""Matrix-free Newton-PCG implicit solver (port of `tlfea/solvers/newton.py`).

One backward-Euler step solves the ALM stationarity system

    H dv = -g,   H = M/h + h K_t(u) + C_visc + h^2 rho J^T J,

by preconditioned conjugate gradients with exact Hessian-vector products
from the FEM kernels (`tlfea_torch.ops.fem_kernels.g_and_hvp`: one K1 + K4
pass per gradient, one K2 + K4 pass per product). The preconditioner is the
3x3 block-Jacobi inverse (K3 + K4), optionally plus the frozen two-level
coarse correction (`tlfea_torch.solvers.coarse`), or the legacy two-level
form whose coarse operator is assembled at every inner solve (a
`CoarseSetup`). A mesh of at most 1,024
elements without the coarse correction runs each inner solve in one
persistent kernel instead (`tlfea_torch.ops.resident`).

The JAX version runs the outer dual loop, the Newton loop and the CG loop
as nested `lax.while_loop`s on the device. Here they are Python loops; each
CG iteration reads two scalars (r.r and r.z) to the host for its stopping
test, and each Newton iteration reads ||g||. The arithmetic and every
branch follow the JAX code, so in float64 the two take the same number of
Newton and CG iterations (`tests/test_torch_newton.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tlfea_torch.elements.assembly import node_ref
from tlfea_torch.ops import resident
from tlfea_torch.ops.fem_kernels import g_and_hvp
from tlfea_torch.ops.linalg import inv3x3
from tlfea_torch.solvers.coarse import CoarseSetup, coarse_operator, make_two_level_precond
from tlfea_torch.solvers.common import (
    StepState, System, _pin_terms, constraint_values, flat_norm, precond_blocks,
)

__all__ = ["NewtonParams", "RolloutCounts", "step", "make_step", "stepper", "make_rollout",
           "make_coupled_rollout", "inner_solve_args"]


@dataclass(frozen=True)
class NewtonParams:
    """Tolerances and iteration caps (`tlfea/solvers/newton.py:38-79`).

    predict: warm start v0 = v + predict * dv from the last step's velocity
    increment. ls_max: residual-norm backtracking trials, taken only after
    CG met non-positive curvature or a non-finite step (0 disables).
    ew_eta_max: upper end of the Eisenstat-Walker CG forcing (0 disables).
    """

    dt: float = 1e-3
    rho: float = 1e6
    inner_atol: float = 1e-7
    inner_rtol: float = 0.0
    outer_tol: float = 1e-8
    max_outer: int = 4
    max_inner: int = 20
    cg_rtol: float = 1e-4
    cg_max_iter: int = 200
    predict: float = 1.0
    ls_max: int = 8
    ew_eta_max: float = 0.5


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _pcg(hvp, precond, b: torch.Tensor, rtol: float, max_iter: int):
    """Preconditioned CG for H x = b (`newton.py:82-133`).

    Returns (x, n_iters, ||r||, neg_curv). A direction of non-positive
    curvature takes no step and ends the solve (neg_curv=True); the loop
    also stops once r.r reaches the dtype's noise floor, since running CG
    past convergence corrupts the iterate.
    """
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    bnorm = float(flat_norm(b))
    tol = rtol * bnorm
    eps_floor = 1e-30 if b.dtype == torch.float64 else 1e-18
    tol2 = max(tol * tol, eps_floor * max(bnorm, 1.0) ** 2)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    neg = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter:
        rr_h, rz_h = torch.stack([_dot(r, r), rz]).tolist()
        if not (rr_h > tol2 and rz_h > 0):
            break
        hp = hvp(p)
        denom = _dot(p, hp)
        good = denom > 0
        alpha = torch.where(good, rz / torch.where(good, denom, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.where(good, _dot(r, z), zero)
        p = z + (rz_new / rz) * p  # rz > 0 here: the test above holds it
        rz = rz_new
        neg = neg | ~good
        k += 1
    return x, k, flat_norm(r), bool(neg)


def _newton_inner(v0, x_prev, v_prev, lam, f_ext, params: NewtonParams, system: System,
                  coarse=None, inv_blocks=None, u_prev=None):
    """Inner Newton loop at fixed duals (`newton.py:135-434`).

    Returns (v, iters, ||g||, cg_total, hist). inv_blocks: inverted
    block-Jacobi blocks to reuse (see `make_rollout`); staleness changes CG
    counts only, never the converged solution. A mesh that passes
    `resident.eligible` runs the whole loop in one kernel launch
    (`tlfea_torch.ops.resident`, the port of `pallas_resident`).

    coarse (`newton.py:303-321`): an object with `apply` (`CoarsePrecond`)
    adds its frozen correction to the block-Jacobi apply; a `CoarseSetup`
    takes the legacy two-level preconditioner instead, its Galerkin operator
    assembled and factored at x_prev + dt v0 and its block-Jacobi solve on
    fresh blocks at v0.
    """
    args = _inner_args(v0, x_prev, v_prev, lam, f_ext, params, system, inv_blocks, u_prev)
    if resident.eligible(system, coarse):
        return resident.newton_inner_resident(*args)
    if isinstance(coarse, CoarseSetup):
        dt, rho = params.dt, params.rho
        Ac = coarse_operator(x_prev + dt * v0, system.elems, system.material,
                             system.constraints, coarse, dt, rho)
        blocks = precond_blocks(v0, x_prev, dt, rho, system, u_prev=args[1])
        precond = make_two_level_precond(blocks, torch.linalg.cholesky(Ac), coarse)
        return _composed_inner(*args, plain=system.plain, precond=precond)
    return _composed_inner(*args, coarse, plain=system.plain)


def _inner_args(v0, x_prev, v_prev, lam, f_ext, params: NewtonParams, system: System,
                inv_blocks=None, u_prev=None):
    """The arguments of one inner solve, (v0, u_prev, v_prev, f_ext, params,
    system, inv_blocks, pin_terms), in the order `_composed_inner` and
    `resident.newton_inner_resident` take them: the dense pin fields (in
    float64 in the accuracy mode, which never runs resident), and the
    block-Jacobi inverse at v0 unless one is passed."""
    dt, rho = params.dt, params.rho
    if u_prev is None:
        u_prev = x_prev - node_ref(system.elems)
    pin_terms = _pin_terms(system, lam, dt, rho, system.grad_op.gN_t.dtype)
    if inv_blocks is None:
        blocks0 = precond_blocks(v0, x_prev, dt, rho, system, u_prev=u_prev)
        inv_blocks = inv3x3(blocks0, eps=1e-30)
    return v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms


def inner_solve_args(system: System, state: StepState, f_ext, params: NewtonParams):
    """The arguments of a step's first inner solve from `state` (warm start
    v + predict * dv, the state's duals, a fresh block-Jacobi inverse), as
    `_step` hands them to `_newton_inner`: for calling
    `resident.newton_inner_resident`, its kernel or its plain version on
    one inner solve."""
    v0 = state.v + params.predict * state.dv
    return _inner_args(v0, state.x, state.v, state.lam, f_ext, params, system,
                       u_prev=state.u)


def _composed_inner(v0, u_prev, v_prev, f_ext, params: NewtonParams, system: System,
                    inv_blocks, pin_terms, coarse=None, plain=False, precond=None):
    """The Newton iterations of `_newton_inner` (`newton.py:325-434`) as one
    kernel launch per gradient and per Hv product (the element twins when
    `plain`), with block-Jacobi (plus `coarse`) preconditioning, or with
    `precond` r -> z in its place. Returns (v, iters, ||g||, cg_total, hist)."""

    def linearize_g(v):
        return g_and_hvp(v, u_prev, v_prev, f_ext, params.dt, system.grad_op, pin_terms,
                         plain=plain)

    def jacobi(r):
        z = torch.einsum("nij,nj->ni", inv_blocks, r)
        return z if coarse is None else z + coarse.apply(r)

    precond = precond or jacobi

    tiny = torch.finfo(v0.dtype).tiny
    emax = max(params.ew_eta_max, params.cg_rtol)
    v = v0
    k = 0
    norm_g = norm_g0 = norm_g_prev = float("inf")
    cg_total = 0
    hist = [float("nan")] * (params.max_inner + 1)
    while k < params.max_inner:
        g, hvp = linearize_g(v)
        norm_g = float(flat_norm(g))
        if k == 0:
            norm_g0 = norm_g
        hist[k] = norm_g
        if _inner_test(norm_g, norm_g0, params):
            break
        # Eisenstat-Walker forcing, choice 2; the loose end on the first
        # iteration, which has no history.
        if k == 0:
            eta = emax
        else:
            ratio = norm_g / max(norm_g_prev, tiny)
            eta = min(max(0.9 * ratio * ratio, params.cg_rtol), emax)
        dv, cg_iters, _, neg_curv = _pcg(hvp, precond, -g, eta, params.cg_max_iter)
        cg_total += cg_iters
        # Backtrack only when CG met non-positive curvature or produced a
        # non-finite step: an SPD solve always gives a descent direction.
        if params.ls_max > 0 and (neg_curv or not torch.isfinite(flat_norm(dv))):
            v = _backtrack(linearize_g, v, dv, norm_g, params.ls_max)
        else:
            v = v + dv
        norm_g_prev = norm_g
        k += 1
    return v, k, norm_g, cg_total, hist


def _inner_test(norm_g: float, norm_g0: float, params: NewtonParams) -> bool:
    """The inner loop's convergence test on one ||g||."""
    return norm_g < params.inner_atol or (
        params.inner_rtol > 0.0 and norm_g <= params.inner_rtol * norm_g0)


def _inner_converged(v, n_it, norm_g, hist, u_prev, v_prev, lam, f_ext, params: NewtonParams,
                     system: System) -> bool:
    """Whether an inner solve ended on a converged iterate. The loop tests
    ||g|| at the top of an iteration, so a solve that stopped at
    max_inner never tested its last iterate: only there, one more gradient
    (K1 + K4, or the twins) is evaluated at v. Otherwise the last tested
    ||g|| decides. Nothing of the solve or its counts changes."""
    if n_it < params.max_inner:
        return _inner_test(norm_g, hist[0], params)
    pin_terms = _pin_terms(system, lam, params.dt, params.rho, system.grad_op.gN_t.dtype)
    g, _ = g_and_hvp(v, u_prev, v_prev, f_ext, params.dt, system.grad_op, pin_terms,
                     plain=system.plain)
    norm_final = float(flat_norm(g))
    return _inner_test(norm_final, hist[0] if n_it > 0 else norm_final, params)


def _backtrack(linearize_g, v, dv, gn0: float, ls_max: int):
    """Residual-norm backtracking (`newton.py:388-419`): t = 1, 1/2, ...;
    accept the first t with ||g(v + t dv)|| <= (1 - 1e-4 t) ||g(v)||, else
    the best t seen, which starts at 0 (never a residual-increasing or NaN
    update)."""
    t, best_t, best_gn = 1.0, 0.0, gn0
    for _ in range(ls_max):
        gn = float(flat_norm(linearize_g(v + t * dv)[0]))
        if gn < best_gn:  # False for NaN: best stays as is
            best_t, best_gn = t, gn
        if gn <= (1.0 - 1e-4 * t) * gn0:
            break
        t *= 0.5
    return v + best_t * dv


def _step(system: System, state: StepState, params: NewtonParams, f_ext, coarse=None,
          inv_blocks=None):
    """One backward-Euler step (`newton.py:437-512`): the outer ALM dual
    loop around `_newton_inner`. Returns (new_state, diagnostics). u keeps
    its dtype from step to step (float64 in the accuracy mode) and x is
    derived from it in the state's dtype."""
    x_prev = state.x
    x_ref = node_ref(system.elems)
    u_prev = state.u
    cons = system.constraints
    v_prev = state.v
    v = state.v + params.predict * state.dv
    lam = state.lam
    norm_c = float("inf")
    outers = newton_tot = cg_tot = 0
    hist_all = []
    ok = converged = False
    while outers < params.max_outer and (outers == 0 or norm_c >= params.outer_tol):
        v, n_it, norm_g, cg_it, hist = _newton_inner(
            v, x_prev, v_prev, lam, f_ext, params, system, coarse, inv_blocks,
            u_prev=u_prev)
        hist_all.append(hist)
        # A budget exit means v is not this step's backward-Euler solution.
        ok = n_it < params.max_inner
        converged = _inner_converged(v, n_it, norm_g, hist, u_prev, v_prev, lam, f_ext, params,
                                     system)
        v_prev = v
        if cons is not None:
            c = constraint_values(cons, x_prev, v, params.dt, system.elems, u_prev=u_prev)
            lam = lam + params.rho * c  # dual update (newton.py:464-469)
            norm_c = float(flat_norm(c))
        else:
            norm_c = 0.0
        outers += 1
        newton_tot += n_it
        cg_tot += cg_it
    u = u_prev + params.dt * v  # displacement-scale update: never x_prev + dt v
    x = (x_ref + u).to(x_prev.dtype)
    # Feed the next step's warm start only from a converged step: a budget
    # exit's error would compound through the extrapolation.
    dv_next = v - state.v if ok else torch.zeros_like(v)
    nan_row = [float("nan")] * (params.max_inner + 1)
    hist_all += [nan_row] * (params.max_outer - len(hist_all))
    diag = {
        "outer_iters": outers,
        "newton_iters": newton_tot,
        "cg_iters": cg_tot,
        "norm_c": norm_c,
        "norm_g_history": torch.tensor(hist_all, dtype=torch.float64).reshape(-1),
        # The last inner solve's final iterate passed the inner test (the
        # warm start reads `ok`, a step that stopped short of max_inner).
        "converged": converged,
    }
    return StepState(x=x, v=v, lam=lam, u=u, dv=dv_next), diag


def step(system: System, state: StepState, params: NewtonParams, f_ext, coarse=None):
    """One step (`newton.py:523-544`). The JAX version jits it and re-traces
    per constraints object on its banded path; here there is nothing to
    trace, and the step is `make_step`'s."""
    return _step(system, state, params, f_ext, coarse)


def make_step(system: System, params: NewtonParams, coarse=None):
    """step(state, f_ext) -> (state, diag) over a fixed system."""
    return lambda state, f_ext: _step(system, state, params, f_ext, coarse)


def stepper(params: NewtonParams, coarse=None):
    """call(system, state, f_ext) -> (state, diag): the `Simulation`
    contract (`newton.py:760-796`). The system is an argument, so its
    constraint targets, pins or material may change between calls; each
    call takes the resident path when `resident.eligible` holds, as
    `make_step` does."""
    return lambda system, state, f_ext: _step(system, state, params, f_ext, coarse)


class RolloutCounts(tuple):
    """A rollout's per-step counts, the pair (newton_iters, cg_iters) of int
    lists, with `converged`, each step's diag["converged"] (bool list)."""

    converged: list

    def __new__(cls, newton_iters, cg_iters, converged):
        self = super().__new__(cls, (newton_iters, cg_iters))
        self.converged = converged
        return self


def make_rollout(system: System, params: NewtonParams, n_steps: int, coarse=None,
                 precond_refresh: int = 1):
    """roll(state, f_ext) -> (state, (newton_iters, cg_iters)) chaining
    n_steps steps (`newton.py:620-693`); the counts are int lists, one entry
    per step, in a `RolloutCounts` whose `converged` lists each step's flag.

    precond_refresh=K > 1 freezes the inverted block-Jacobi preconditioner
    for K consecutive steps, rebuilt from the state at every K-th step;
    K = 1 builds it inside every inner solve at the warm-start iterate.
    """
    refresh = max(int(precond_refresh), 1)

    def roll(state: StepState, f_ext):
        nits, cgits, conv = [], [], []
        inv_b = None
        for k in range(n_steps):
            if refresh > 1 and k % refresh == 0:
                inv_b = _fresh_inv(system, state, params)
            state, d = _step(system, state, params, f_ext, coarse, inv_blocks=inv_b)
            nits.append(d["newton_iters"])
            cgits.append(d["cg_iters"])
            conv.append(d["converged"])
        return state, RolloutCounts(nits, cgits, conv)

    return roll


def _fresh_inv(system: System, st: StepState, params: NewtonParams) -> torch.Tensor:
    """The inverted block-Jacobi blocks at a state, for a frozen window."""
    return inv3x3(precond_blocks(st.v, st.x, params.dt, params.rho, system, u_prev=st.u),
                  eps=1e-30)


def make_coupled_rollout(system: System, params: NewtonParams, n_steps: int, force_fn,
                         coarse=None, precond_refresh: int = 1):
    """roll(state, f_base) -> (state, (newton_iters, cg_iters), any_overflow):
    n_steps of [f_ext = f_base + force_fn(x, v); a backward-Euler step]
    (`newton.py:696-752`). force_fn(x, v) -> (f_col (n, 3), overflow), e.g.
    a closure over `HydroelasticCollision.step`, evaluated at the
    start-of-step state; the overflow flags are OR-ed on the device, with
    no host read per step, for the caller's capacity check. The counts are
    int lists, one entry per step, in a `RolloutCounts` as `make_rollout`'s.

    precond_refresh=K > 1 freezes the inverted block-Jacobi blocks for K
    steps, rebuilt at every K-th step, as `make_rollout` does. With K = 1
    no blocks are built outside the steps: the JAX version builds an
    initial inverse there that no step reads.
    """
    refresh = max(int(precond_refresh), 1)

    def roll(state: StepState, f_base):
        nits, cgits, conv = [], [], []
        inv_b = None
        ovf = torch.zeros((), dtype=torch.bool, device=state.x.device)
        for k in range(n_steps):
            if refresh > 1 and k % refresh == 0:
                inv_b = _fresh_inv(system, state, params)
            f_col, o = force_fn(state.x, state.v)
            state, d = _step(system, state, params, f_base + f_col, coarse, inv_blocks=inv_b)
            ovf = ovf | torch.as_tensor(o, device=ovf.device)
            nits.append(d["newton_iters"])
            cgits.append(d["cg_iters"])
            conv.append(d["converged"])
        return state, RolloutCounts(nits, cgits, conv), ovf

    return roll
