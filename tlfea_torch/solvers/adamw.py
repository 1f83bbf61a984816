"""AdamW first-order implicit solver (port of `tlfea/solvers/adamw.py`).

AdamW on the velocity unknowns against the ALM gradient `common.grad_L`
(one K5 + K4 pass per iteration on the card). The update order is the
reference's, update-then-evaluate (`SyncedAdamW.cu:156-212`): the first
iteration applies a zero gradient, and the step counter t starts at 1 and
is raised before its first use. The JAX version decides `done` inside a
`lax.while_loop` on the device; here the loop runs on the host and reads
||g|| and ||v|| only at the convergence checks, every
`convergence_check_interval` iterations (one host sync each). g0, the
reference norm of the relative test, is the first check's ||g||.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tlfea_torch.solvers.common import StepState, System, alm_outer, flat_norm, grad_fn

__all__ = ["AdamWParams", "make_step", "stepper"]


@dataclass(frozen=True)
class AdamWParams:
    """Reference: `SyncedAdamW.cuh:27-34` (`tlfea/solvers/adamw.py:28`)."""

    dt: float = 1e-3
    rho: float = 1e6
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    lr_decay: float = 1.0
    inner_tol: float = 1e-6
    inner_rtol: float = 0.0
    outer_tol: float = 1e-8
    max_outer: int = 4
    max_inner: int = 2000
    convergence_check_interval: int = 50


def scalar_type(dtype: torch.dtype):
    """The NumPy scalar type of a float dtype: host-side scalars of a loop are
    rounded as the device loop of the reference rounds them."""
    return np.float32 if dtype == torch.float32 else np.float64


def _inner(g_of, v0: torch.Tensor, params: AdamWParams):
    """AdamW iterations from v0 (`adamw.py:47-88`). Returns (v, iterations,
    ||g|| of the last gradient, a device scalar)."""
    ft = scalar_type(v0.dtype)
    one = ft(1.0)
    v = v0
    g = m = s = torch.zeros_like(v0)
    lr, t, g0 = ft(params.lr), one, -1.0
    k = 0
    while k < params.max_inner:
        lr = lr * ft(params.lr_decay)
        t = t + one
        m = params.beta1 * m + (1.0 - params.beta1) * g
        s = params.beta2 * s + (1.0 - params.beta2) * g * g
        m_hat = m / float(one - ft(params.beta1) ** t)
        s_hat = s / float(one - ft(params.beta2) ** t)
        step = m_hat / (torch.sqrt(s_hat) + params.eps)
        if params.weight_decay != 0.0:
            step = step + params.weight_decay * v
        v = v - float(lr) * step
        g = g_of(v)
        check = k % params.convergence_check_interval == 0
        k += 1
        if check:
            norm_g, norm_v = torch.stack([flat_norm(g), flat_norm(v)]).tolist()
            if g0 < 0:
                g0 = norm_g
            tol_rel = params.inner_rtol * g0 if params.inner_rtol > 0 and g0 > 0 else 0.0
            if norm_g <= params.inner_tol * (1.0 + norm_v) or (tol_rel > 0 and norm_g <= tol_rel):
                break
    return v, k, flat_norm(g)


def _step(system: System, state: StepState, params: AdamWParams, f_ext):
    """One backward-Euler step (`adamw.py:91-124`): the outer ALM loop with
    the first-order dual update lam += rho * dt * c."""

    def inner(v, v_prev, lam):
        g_of = grad_fn(system, state.x, v_prev, lam, f_ext, params.dt, params.rho, state.u)
        v, n_it, _ = _inner(g_of, v, params)
        return v, n_it

    new, outers, inner_tot, norm_c = alm_outer(system, state, params, f_ext, inner,
                                               params.rho * params.dt)
    return new, {"outer_iters": outers, "inner_iters": inner_tot, "norm_c": norm_c}


def make_step(system: System, params: AdamWParams):
    """step(state, f_ext) -> (state, diag) over a fixed system."""
    return lambda state, f_ext: _step(system, state, params, f_ext)


def stepper(params: AdamWParams):
    """step(system, state, f_ext) -> (state, diag): the `Simulation` contract."""
    return lambda system, state, f_ext: _step(system, state, params, f_ext)
