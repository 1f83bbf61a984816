"""Quadrature rules for the element families (host-side NumPy).

A copy of the rules of `tlfea/utils/quadrature.py` that FEAT10 and the ANCF
elements need: `gauss_legendre_1d` (:28), `tensor_product_rule` (:34),
`tet_duffy_rule` (:55) and `keast5_tet` (:87). Copied rather than imported,
because importing `tlfea` pulls in jax; `tests/test_torch_setup.py` holds
every table equal to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_legendre_1d", "tensor_product_rule", "tet_duffy_rule", "keast5_tet"]


def gauss_legendre_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [-1, 1] -> (points, weights), float64."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


def tensor_product_rule(n_xi: int, n_eta: int, n_zeta: int):
    """Tensor-product Gauss rule on [-1,1]^3 -> (points (N, 3), weights
    (N,)), xi-major iteration order (outer loop over xi, inner over zeta)."""
    xs, wx = gauss_legendre_1d(n_xi)
    ys, wy = gauss_legendre_1d(n_eta)
    zs, wz = gauss_legendre_1d(n_zeta)
    pts = []
    wts = []
    for i in range(n_xi):
        for j in range(n_eta):
            for k in range(n_zeta):
                pts.append((xs[i], ys[j], zs[k]))
                wts.append(wx[i] * wy[j] * wz[k])
    return np.asarray(pts, dtype=np.float64), np.asarray(wts, dtype=np.float64)


def tet_duffy_rule(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Positive-weight tet rule via the Duffy (collapsed-cube) transform.

    Maps an n^3 Gauss-Legendre product rule on [0,1]^3 to the unit right tet
    x+y+z <= 1. It integrates polynomials of total degree <= 2n-4 exactly
    with all-positive weights, so for n >= 4 the T10 consistent mass is
    exact and SPD (the 5-point Keast rule's negative weight makes it
    indefinite).

    Returns (points (n^3, 3) in tet natural coords, weights (n^3,)) with
    sum(w) = 1/6.
    """
    x, w = gauss_legendre_1d(n)
    x = 0.5 * (x + 1.0)  # [0, 1]
    w = 0.5 * w
    pts = []
    wts = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                u, vq, t = x[i], x[j], x[k]
                xi = u
                eta = vq * (1.0 - u)
                zeta = t * (1.0 - u) * (1.0 - vq)
                jac = (1.0 - u) ** 2 * (1.0 - vq)
                pts.append((xi, eta, zeta))
                wts.append(w[i] * w[j] * w[k] * jac)
    return np.asarray(pts, dtype=np.float64), np.asarray(wts, dtype=np.float64)


def keast5_tet() -> tuple[np.ndarray, np.ndarray]:
    """5-point Keast rule for tetrahedra.

    Returns (bary (5,4), weights (5,)); the weights include the 1/6
    reference-tet volume, so sum(w) = 1/6.
    """
    bary = np.array(
        [
            [0.25, 0.25, 0.25, 0.25],
            [0.5, 1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0],
            [1.0 / 6.0, 0.5, 1.0 / 6.0, 1.0 / 6.0],
            [1.0 / 6.0, 1.0 / 6.0, 0.5, 1.0 / 6.0],
            [1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0, 0.5],
        ],
        dtype=np.float64,
    )
    w = np.array([-4.0 / 5.0, 9.0 / 20.0, 9.0 / 20.0, 9.0 / 20.0, 9.0 / 20.0]) / 6.0
    return bary, w
