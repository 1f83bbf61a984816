"""Closed-form batched 3x3 linear algebra (port of `tlfea/ops/linalg.py`), and
the real cube root that PyTorch lacks."""

from __future__ import annotations

import torch

__all__ = ["cbrt", "det3x3", "solve3x3", "inv3x3", "inv_transpose3x3"]


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root, negative for x < 0, as `jnp.cbrt` and CUDA `cbrt`
    (`x.pow(1/3)` is NaN there): sign(x) |x|^(1/3). Equal to `x.pow(1/3)`
    bit for bit where x > 0; its derivative under `torch.func.jvp` is finite
    wherever x != 0 (sign's is zero)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def det3x3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def _adjugate3x3(a: torch.Tensor) -> torch.Tensor:
    """Adjugate (transpose of the cofactor matrix) of (..., 3, 3)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    # adj[i, j] = cofactor(j, i)
    row0 = torch.stack([c00, c10, c20], dim=-1)
    row1 = torch.stack([c01, c11, c21], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def solve3x3(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Solve a @ x = b for (..., 3, 3) a and (..., 3) b via the adjugate
    (`tlfea/ops/linalg.py:42-52`), with the same sign-preserving clamp of
    |det| to at least eps."""
    det = det3x3(a)
    if eps:
        e = det.new_full((), eps)
        det = torch.where(det.abs() < eps, torch.where(det >= 0, e, -e), det)
    return (_adjugate3x3(a) * b[..., None, :]).sum(-1) / det[..., None]


def inv3x3(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Inverse of (..., 3, 3) via the adjugate, with a sign-preserving clamp
    of |det| to at least eps."""
    det = det3x3(a)
    if eps:
        e = det.new_full((), eps)
        det = torch.where(det.abs() < eps, torch.where(det >= 0, e, -e), det)
    return _adjugate3x3(a) / det[..., None, None]


def inv_transpose3x3(a: torch.Tensor, det: torch.Tensor | None = None,
                     eps: float = 1e-12) -> torch.Tensor:
    """Inverse-transpose of (..., 3, 3) with a sign-preserving clamp of |det|
    to at least eps (`tlfea/ops/linalg.py:68`, after the reference's
    `mr_invT3x3`). det, when given, is used in place of det3x3(a)."""
    if det is None:
        det = det3x3(a)
    e = det.new_full((), eps)
    safe = torch.where(det.abs() < eps, torch.where(det >= 0, e, -e), det)
    return _adjugate3x3(a).transpose(-1, -2) / safe[..., None, None]
