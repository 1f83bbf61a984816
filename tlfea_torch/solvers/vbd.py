"""Coloured Vertex Block Descent implicit solver (port of
`tlfea/solvers/vbd.py`).

Nonlinear block Gauss-Seidel over graph-coloured coefficients: each
coefficient a takes the damped local Newton step H_a dv_a = -g_a, with g
the ALM gradient and H_a its 3x3 diagonal tangent block
(`SyncedVBD.cu:162-377`), in the reference package's form: the gradient is
refreshed once per colour group (`color_group_size` colours,
`SyncedVBD.cu:950-996`), and the blocks are `precond_blocks` (K3 + K4 on
the card, SPD-shifted), frozen for the inner solve.

Within a group every colour reads the group-start gradient and the frozen
blocks, and colours are disjoint, so the group's colour updates are one
update of the group's nodes: one gradient (K5 + K4), one gather, one
batched 3x3 product with the blocks' inverses and one write per group.
The inverses are taken once per inner solve (`inv3x3`), where the
reference solves each colour's blocks with `solve3x3`: equal up to
rounding. ||g|| is read to the host at the convergence checks only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tlfea_torch.ops.linalg import inv3x3
from tlfea_torch.solvers.common import (
    StepState, System, alm_outer, flat_norm, grad_fn, precond_blocks,
)
from tlfea_torch.utils.coloring import colors_and_incidence, pad_colors

__all__ = ["VBDParams", "VBDStructures", "prepare", "make_step", "stepper"]


@dataclass(frozen=True)
class VBDParams:
    """Reference: `SyncedVBD.cuh:28-36` (`tlfea/solvers/vbd.py:58`)."""

    dt: float = 1e-3
    rho: float = 1e6
    omega: float = 1.0  # relaxation
    hess_eps: float = 1e-9  # trace-scaled regularisation
    inner_tol: float = 1e-6  # residual-norm tolerance
    outer_tol: float = 1e-8
    max_outer: int = 4
    max_sweeps: int = 50
    color_group_size: int = 4
    convergence_check_interval: int = 4


@dataclass
class VBDStructures:
    """The host-built colouring (`vbd.py:74`): groups, the real nodes of
    each conflict-free group of colours in colour order (int64 on the
    system's device), and the number of colours."""

    groups: list
    n_colors: int


def prepare(system: System, group_size: int = 4, dtype=None) -> VBDStructures:
    """Greedy first-fit colouring packed into conflict-free groups (`vbd.py:84`).
    `dtype` is accepted and unused, as in the JAX signature."""
    conn = system.elems.conn.cpu().numpy()
    colors, _, _ = colors_and_incidence(conn, system.elems.n_coef)
    nodes, mask = pad_colors(colors, group_size)
    dev = system.elems.conn.device
    groups = [torch.as_tensor(nodes[g][mask[g]].astype(np.int64), device=dev)
              for g in range(nodes.shape[0])]
    return VBDStructures(groups=groups, n_colors=int(colors.max()) + 1)


def _inner(g_of, v0, blocks, structures: VBDStructures, params: VBDParams):
    """Sweeps from v0 at fixed duals with frozen blocks (`vbd.py:129-150`).
    Returns (v, sweeps)."""
    eye = torch.eye(3, dtype=v0.dtype, device=v0.device)
    tr = blocks[..., 0, 0] + blocks[..., 1, 1] + blocks[..., 2, 2]
    H = blocks + (params.hess_eps * torch.clamp(tr, min=1.0))[:, None, None] * eye
    step = -params.omega * inv3x3(H, eps=1e-30)  # dv_a = step_a g_a
    steps = [step[idx] for idx in structures.groups]
    v = v0.clone()
    k = 0
    while k < params.max_sweeps:
        for idx, st in zip(structures.groups, steps):
            grad = g_of(v)  # refreshed once per group
            v[idx] = v[idx] + torch.einsum("nij,nj->ni", st, grad[idx])
        check = k % params.convergence_check_interval == 0
        k += 1
        if check and float(flat_norm(g_of(v))) < params.inner_tol:
            break
    return v, k


def _step(system: System, structures: VBDStructures, params: VBDParams, state: StepState,
          f_ext):
    """One backward-Euler step (`vbd.py:152-183`): the outer ALM loop with
    the dual update lam += rho * c (the reference's VBD convention,
    `SyncedVBD.cu:456-464`)."""

    def inner(v, v_prev, lam):
        blocks = precond_blocks(v, state.x, params.dt, params.rho, system, u_prev=state.u)
        g_of = grad_fn(system, state.x, v_prev, lam, f_ext, params.dt, params.rho, state.u)
        return _inner(g_of, v, blocks, structures, params)

    new, outers, sweeps, norm_c = alm_outer(system, state, params, f_ext, inner, params.rho)
    return new, {"outer_iters": outers, "sweeps": sweeps, "norm_c": norm_c}


def make_step(system: System, params: VBDParams, structures: VBDStructures | None = None):
    """step(state, f_ext) -> (state, diag) over a fixed system."""
    if structures is None:
        structures = prepare(system, group_size=params.color_group_size)
    return lambda state, f_ext: _step(system, structures, params, state, f_ext)


def stepper(params: VBDParams, structures: VBDStructures):
    """step(system, state, f_ext) -> (state, diag): the `Simulation` contract."""
    return lambda system, state, f_ext: _step(system, structures, params, state, f_ext)
