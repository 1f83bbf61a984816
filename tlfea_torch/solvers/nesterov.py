"""Nesterov accelerated-gradient implicit solver (port of
`tlfea/solvers/nesterov.py`).

NAG with the t-sequence momentum: y = v_k + beta (v_k - v_{k-1}), beta =
(t - 1)/t_next, t_next = (1 + sqrt(1 + 4 t^2))/2, v_{k+1} = y - alpha g(y)
(`SyncedNesterov.cu:151-258`), with the reference's twin convergence test
|‖g‖ - ‖g_prev‖| < tol or |‖v_{k+1}‖ - ‖v_k‖| < tol, from the second
iteration on (`SyncedNesterov.cu:230-283`).

The JAX version tests `done` in a `lax.while_loop` on the device after every
iteration. Here the host queues blocks of BLOCK iterations: `done` stays on
the device, and once it is set every later iteration of the block leaves
the carry (iterate, previous iterate, norms, iteration count) as it was,
so the iterates and counts are the ones the JAX loop gives, at one host
sync per block. t depends only on the iteration number and is kept on the
host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tlfea_torch.solvers.adamw import scalar_type
from tlfea_torch.solvers.common import StepState, System, alm_outer, flat_norm, grad_fn

__all__ = ["NesterovParams", "make_step", "stepper"]

BLOCK = 64  # iterations queued between two reads of the device-side `done`


@dataclass(frozen=True)
class NesterovParams:
    """Reference: `SyncedNesterov.cuh:26-30` (`tlfea/solvers/nesterov.py:27`)."""

    dt: float = 1e-3
    rho: float = 1e6
    alpha: float = 1e-6  # gradient step size
    inner_tol: float = 1e-6
    outer_tol: float = 1e-8
    max_outer: int = 4
    max_inner: int = 2000


def _inner(g_of, v0: torch.Tensor, params: NesterovParams):
    """Nesterov iterations from v0 (`nesterov.py:39-68`). Returns (v,
    iterations, ||g|| of the last iteration, a device scalar)."""
    ft = scalar_type(v0.dtype)
    one, half, four = ft(1.0), ft(0.5), ft(4.0)
    v_k = v_km1 = v0
    norm_vk = flat_norm(v0)
    norm_g_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    done = torch.zeros((), dtype=torch.bool, device=v0.device)
    k_dev = torch.zeros((), dtype=torch.int64, device=v0.device)
    t = one
    i = 0
    while i < params.max_inner:
        for _ in range(min(BLOCK, params.max_inner - i)):
            t_next = half * (one + np.sqrt(one + four * t * t))
            beta = float((t - one) / t_next)
            y = v_k + beta * (v_k - v_km1)
            g = g_of(y)
            norm_g = flat_norm(g)
            v_next = y - params.alpha * g
            norm_vn = flat_norm(v_next)
            live = ~done
            if i > 0:  # the twin test; while live, the device count equals i
                conv = ((norm_g - norm_g_prev).abs() < params.inner_tol) | (
                    (norm_vn - norm_vk).abs() < params.inner_tol)
                done = done | (live & conv)
            v_k, v_km1 = torch.where(live, v_next, v_k), torch.where(live, v_k, v_km1)
            norm_vk = torch.where(live, norm_vn, norm_vk)
            norm_g_prev = torch.where(live, norm_g, norm_g_prev)
            k_dev = k_dev + live
            t = t_next
            i += 1
        if bool(done):
            break
    return v_k, int(k_dev), norm_g_prev


def _step(system: System, state: StepState, params: NesterovParams, f_ext):
    """One backward-Euler step (`nesterov.py:71-103`): the outer ALM loop
    with the first-order dual update lam += rho * dt * c."""

    def inner(v, v_prev, lam):
        g_of = grad_fn(system, state.x, v_prev, lam, f_ext, params.dt, params.rho, state.u)
        v, n_it, _ = _inner(g_of, v, params)
        return v, n_it

    new, outers, inner_tot, norm_c = alm_outer(system, state, params, f_ext, inner,
                                               params.rho * params.dt)
    return new, {"outer_iters": outers, "inner_iters": inner_tot, "norm_c": norm_c}


def make_step(system: System, params: NesterovParams):
    """step(state, f_ext) -> (state, diag) over a fixed system."""
    return lambda state, f_ext: _step(system, state, params, f_ext)


def stepper(params: NesterovParams):
    """step(system, state, f_ext) -> (state, diag): the `Simulation` contract."""
    return lambda system, state, f_ext: _step(system, state, params, f_ext)
