"""K1 `primal_prep` and K5 `contrib` with Mooney-Rivlin on the CPU, at the
small sizes at which `tests/test_torch_cuda.py` holds their CUDA kernels to
the twins (`test_mr_tile_matches_twins_repeats_and_k5_is_k1`): a FEAT10 box
of 18 elements, an ANCF3243 beam of 13 and an ANCF3443 plate of 5 x 5, each
a multiple of neither 4 nor 32, so the last tile is ragged.

On the CPU the wrappers run the plain twins, which the card tests take as
the reference: here the same structures and the same strained state go
through the JAX package's XLA path (`_element_contrib_values`, as in
`tests/test_torch_mooney_rivlin.py`), damped and undamped. K1's fe within
1e-12 (float64) or 1e-5 (float32, against float64 JAX) of JAX's, relative
to its largest entry; its J - 1 row det(F) - 1 at every point within 1e-10
(float64); K5 equal to K1's fe bit for bit, and both repeatable. K1's
prep rows (Du, F^{-T}, [J - 1, I1, I2], Fd) against numpy from its own Du
within 1e-12 (float64) or 1e-5 (float32), and Fd equal bit for bit to the
Du of the state with u and v swapped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mooney_rivlin import _JMooneyRivlin, _mr_from_E_nu
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements import ancf3443 as j_ancf3443
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import _element_contrib_values
from tlfea.solvers import System as JSystem
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk

torch.set_num_threads(2)

# family -> (elements, u scale of the strained state): the card tests'
# structures and scales (`_mr_tile_case`).
CASES = {"feat10": (18, 1e-2), "ancf3243": (13, 1e-2), "ancf3443": (25, 5e-3)}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _jax_system(family, damping):
    """The JAX system of the card tests' structure, E 1e7, nu 0.3."""
    if family == "feat10":
        coefs, conn = box_t10_mesh(1.0, 0.2, 0.2, 3, 1, 1)
        elems = j_feat10.build(coefs, conn, rho=1000.0)
        fixed = np.nonzero(coefs[:, 0] < 1e-12)[0]
    else:
        if family == "ancf3443":
            coefs, conn = j_ancf3443.shell_grid(5, 5, L=0.05, W=0.05)
            elems = j_ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0)
        else:
            coefs, conn = j_ancf3243.straight_beam(13, L=0.1)
            elems = j_ancf3243.build(coefs, conn, 0.1, 0.02, 0.02, rho=1000.0)
        pos = coefs[0::4, 0]
        edge = np.nonzero(pos < pos.min() + 1e-12)[0]
        fixed = (4 * edge[:, None] + np.arange(4)[None, :]).reshape(-1)
    material = _JMooneyRivlin(**_mr_from_E_nu(1e7, 0.3, damping))
    return coefs, JSystem(elems=elems, material=material,
                          constraints=JFixedCoefs.from_indices(fixed, coefs))


def _case(family, dtype, damping=1e3):
    """(coefs, JAX system, port operator, host packed state): the card
    tests' strained state (u scaled, v and dv/dt standard normal)."""
    E, scale = CASES[family]
    coefs, jsys = _jax_system(family, damping)
    system, _, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, device="cpu",
                                     dtype=dtype)
    op = system.fem
    assert (op.tag, op.E) == (f"{family}_mr", E) and E % 4 and E % 32
    n = len(coefs)
    rng = np.random.default_rng(21)
    host = np.concatenate([rng.normal(size=(n, 3)) * scale, rng.normal(size=(n, 6))], 1)
    return coefs, jsys, op, host


def _slots(a, op):
    """(E, S, 3) per-(element, slot) values -> the kernels' (S*3, E)."""
    return np.transpose(np.asarray(a), (1, 2, 0)).reshape(op.S * 3, op.E)


@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("family", list(CASES))
def test_mr_k1_k5_at_ragged_tiles_match_jax(family, dtype, damping):
    _, jsys, op, host = _case(family, dtype, damping)
    E = op.E
    packed = torch.as_tensor(host, dtype=dtype).contiguous()

    fe, prep = fk.primal_prep(op, packed)
    ref = _element_contrib_values(*(jnp.asarray(host[:, 3 * k:3 * k + 3]) for k in range(3)),
                                  jsys.elems, jsys.material)
    want = _slots(ref, op)
    got = fe.double().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < TOL[dtype]

    jm1 = prep.view(op.Q, op.prep_rows, op.E)[:, 18]
    assert bool(torch.isfinite(prep).all()) and 0.1 < float(jm1.abs().max()) < 0.9
    if dtype == torch.float64:
        Du = prep.view(op.Q, op.prep_rows, op.E)[:, :9].permute(2, 0, 1).reshape(E, op.Q, 3, 3)
        det = np.linalg.det(Du.numpy() + np.eye(3)) - 1.0
        np.testing.assert_allclose(jm1.T.numpy(), det, rtol=1e-10, atol=1e-15)

    fe5 = fk.contrib(op, packed)
    assert torch.equal(fe5, fe)
    fe2, prep2 = fk.primal_prep(op, packed)
    assert torch.equal(fe2, fe) and torch.equal(prep2, prep)
    assert torch.equal(fk.contrib(op, packed), fe5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("family", list(CASES))
def test_mr_k1_prep_rows_at_ragged_tiles(family, dtype):
    _, _, op, host = _case(family, dtype)
    tol = TOL[dtype]
    _, prep = fk.primal_prep(op, torch.as_tensor(host, dtype=dtype).contiguous())
    pr = prep.view(op.Q, 30, op.E).permute(2, 0, 1)  # (E, Q, 30)
    F = pr[..., 0:9].double().numpy().reshape(op.E, op.Q, 3, 3) + np.eye(3)
    C = F.transpose(0, 1, 3, 2) @ F
    I1 = np.trace(C, axis1=-2, axis2=-1)
    want = {"F^-T": np.linalg.inv(F).transpose(0, 1, 3, 2).reshape(op.E, op.Q, 9),
            "J-1": np.linalg.det(F) - 1.0, "I1": I1,
            "I2": 0.5 * (I1**2 - np.trace(C @ C, axis1=-2, axis2=-1))}
    got = {"F^-T": pr[..., 9:18], "J-1": pr[..., 18], "I1": pr[..., 19], "I2": pr[..., 20]}
    for k, w in want.items():
        err = np.abs(got[k].double().numpy() - w).max()
        assert err <= tol * max(np.abs(w).max(), 1.0), k

    swapped = host[:, [3, 4, 5, 0, 1, 2, 6, 7, 8]]
    _, prep_s = fk.primal_prep(op, torch.as_tensor(swapped, dtype=dtype).contiguous())
    assert torch.equal(prep_s.view(op.Q, 30, op.E)[:, 0:9], prep.view(op.Q, 30, op.E)[:, 21:30])
