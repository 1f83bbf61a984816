"""Gather/scatter between element-local and node arrays (port of
`tlfea/ops/segment.py`).

`coef_scatter_add` is the plain PyTorch form of the node reduce; the CUDA
kernel `node_reduce` (`tlfea_torch.ops.fem_kernels`) computes the same sum
in a fixed order over a host-built incidence list.
"""

from __future__ import annotations

import torch

__all__ = ["gather_coefs", "coef_scatter_add"]


def gather_coefs(x: torch.Tensor, conn: torch.Tensor) -> torch.Tensor:
    """(n, C) node values, (E, S) connectivity -> (E, S, C)."""
    return x[conn]


def coef_scatter_add(values: torch.Tensor, conn: torch.Tensor, n_coef: int) -> torch.Tensor:
    """Sum per-(element, slot) values (E, S, C) onto the nodes -> (n_coef, C).

    `index_put_(accumulate=True)` sums each node's values in a fixed order
    (on the card it sorts the indices first), so results are repeatable;
    `index_add_` would sum with atomics on the card."""
    C = values.shape[-1]
    out = torch.zeros((n_coef, C), dtype=values.dtype, device=values.device)
    return out.index_put_((conn.reshape(-1),), values.reshape(-1, C), accumulate=True)
