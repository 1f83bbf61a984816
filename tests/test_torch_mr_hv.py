"""K2 `hv` with Mooney-Rivlin on the CPU, at the small sizes at which
`tests/test_torch_cuda.py` holds its CUDA kernel to the twin
(`test_mr_hv_matches_twin_and_repeats`): a FEAT10 box of 18 elements, an
ANCF3243 beam of 13 and an ANCF3443 plate of 5 x 5, each a multiple of
neither 4 nor 32, so the last tile is ragged; and the same structures
mirrored in x, where det F < 0 at every quadrature point.

On the CPU the wrapper runs the plain twin, which the card tests take as the
reference: here the twin's product from K1's prep cache goes against the
JAX package's XLA path, `jax.jvp` of the element contribution
(`_element_contrib_values`, as in `tests/test_torch_mooney_rivlin.py`)
along the Newton chain (dt p, p, p / dt), in float64 within 1e-12 of its
largest entry, damped and undamped. At the inverted point the port's real
cube root (`ops/linalg.cbrt`, negative as `jnp.cbrt` and CUDA's `cbrt`)
keeps the product finite and equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mr_tile import CASES, _case, _slots
from tlfea.elements.assembly import _element_contrib_values
from tlfea_torch.ops import fem_kernels as fk

torch.set_num_threads(2)

DT, RTOL = 1e-3, 1e-12


def _hv_against_jax(family, damping, mirrored):
    """(port, JAX) per-(element, slot) products at the card tests' strained
    state, or at it mirrored in x; and the prep cache's J - 1 rows."""
    coefs, jsys, op, host = _case(family, torch.float64, damping)
    if mirrored:
        host = host.copy()
        host[:, 0] -= 2.0 * coefs[:, 0]  # every x mirrored (ANCF: the gradient rows' x too)
    rng = np.random.default_rng(5)
    p = rng.normal(size=(len(coefs), 3))
    _, prep = fk.primal_prep(op, torch.as_tensor(host))
    got = fk.hv(op, torch.as_tensor(p), prep, DT)
    assert torch.equal(got, fk.hv_plain(op, torch.as_tensor(p), prep, DT))

    def contrib(u, v, a):
        return _element_contrib_values(u, v, a, jsys.elems, jsys.material)

    u, v, a = (jnp.asarray(host[:, 3 * k:3 * k + 3]) for k in range(3))
    pj = jnp.asarray(p)
    _, ref = jax.jit(lambda u, v, a, p: jax.jvp(contrib, (u, v, a), (DT * p, p, p / DT)))(
        u, v, a, pj)
    return got.numpy(), _slots(ref, op), prep.view(op.Q, op.prep_rows, op.E)[:, 18]


@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("family", list(CASES))
def test_mr_hv_twin_at_ragged_tiles_matches_jax(family, damping):
    got, want, jm1 = _hv_against_jax(family, damping, mirrored=False)
    assert 0.1 < float(jm1.abs().max()) < 0.9  # strained, nothing inverted
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < RTOL


@pytest.mark.parametrize("family", list(CASES))
def test_mr_hv_twin_at_an_inverted_point_matches_jax(family):
    got, want, jm1 = _hv_against_jax(family, 1e3, mirrored=True)
    assert float(jm1.max()) < -1.0  # J < 0 at every point
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() / np.abs(want).max() < RTOL
