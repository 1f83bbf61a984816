"""The port's materials and FEAT10 assembly (`tlfea_torch.materials`,
`tlfea_torch.elements.feat10` and `.assembly`) against the independent
NumPy oracles of `tests/oracles.py`, in float64 on the CPU, as
`tests/test_elements_feat10.py` holds the JAX package to them: the SVK,
Mooney-Rivlin and Kelvin-Voigt first Piola stresses, the T10 internal force
(undamped and damped) at a randomly deformed state, and the consistent mass
(the 5-point rule's product and diagonal; the exact rule's total)."""

import numpy as np
import pytest
import torch

from tests import oracles
from tlfea_torch.elements import feat10
from tlfea_torch.elements.assembly import (
    deformation_gradient, internal_force, mass_diag, mass_matvec, viscous_piola,
)
from tlfea_torch.materials import SVK, MooneyRivlin, lame_from_E_nu
from tlfea_torch.utils.tetmesh import box_t10_mesh

torch.set_num_threads(2)

LAM, MU = lame_from_E_nu(1e6, 0.3)


@pytest.fixture(scope="module")
def small_mesh():
    return box_t10_mesh(1.0, 0.5, 0.5, 2, 1, 1)


def _deformed(nodes, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return nodes + scale * rng.standard_normal(nodes.shape), rng.standard_normal(nodes.shape)


def _strains(seed):
    rng = np.random.default_rng(seed)
    return np.eye(3) + 0.1 * rng.standard_normal((4, 3, 3)), rng.standard_normal((4, 3, 3))


@pytest.mark.parametrize("material", ["svk", "mooney_rivlin"])
def test_piola_matches_oracle(material):
    """`first_piola_du` at F - I for four random strains near I."""
    F, _ = _strains(2)
    if material == "svk":
        lam, mu = lame_from_E_nu(7e8, 0.33)
        mat, oracle, rtol = SVK(lam=lam, mu=mu), lambda f: oracles.svk_P(f, lam, mu), 1e-12
    else:
        mat = MooneyRivlin(mu10=3e5, mu01=1e5, kappa=1e7)
        oracle, rtol = (lambda f: oracles.mr_P(f, 3e5, 1e5, 1e7)), 1e-9
    # The port's stresses take the displacement gradient F - I.
    P = mat.first_piola_du(torch.as_tensor(F - np.eye(3))).numpy()
    for k in range(len(F)):
        np.testing.assert_allclose(P[k], oracle(F[k]), rtol=rtol)


def test_kelvin_voigt_matches_oracle():
    F, Fdot = _strains(4)
    P = viscous_piola(torch.as_tensor(F), torch.as_tensor(Fdot), 50.0, 10.0).numpy()
    for k in range(len(F)):
        want = oracles.kelvin_voigt_P(F[k], Fdot[k], 50.0, 10.0)
        np.testing.assert_allclose(P[k], want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_identity_F_and_zero_force_at_rest(small_mesh):
    nodes, conn = small_mesh
    elems = feat10.build(nodes, conn, rho=1000.0, device="cpu")
    x = torch.as_tensor(nodes)
    F = deformation_gradient(x, elems).numpy()
    np.testing.assert_allclose(F, np.broadcast_to(np.eye(3), F.shape), atol=1e-12)
    f = internal_force(x, None, elems, SVK(lam=LAM, mu=MU)).numpy()
    np.testing.assert_allclose(f, 0.0, atol=1e-6)


@pytest.mark.parametrize("damped", [False, True])
def test_internal_force_matches_oracle(small_mesh, damped):
    nodes, conn = small_mesh
    elems = feat10.build(nodes, conn, rho=1000.0, device="cpu")
    eta, lam_d = (50.0, 10.0) if damped else (0.0, 0.0)
    x, v = _deformed(nodes)
    v = v if damped else None
    mat = SVK(lam=LAM, mu=MU, eta_damp=eta, lam_damp=lam_d)
    f = internal_force(torch.as_tensor(x), None if v is None else torch.as_tensor(v), elems,
                       mat).numpy()
    want = oracles.t10_internal_force(nodes, conn, x, v, LAM, MU, eta, lam_d)
    np.testing.assert_allclose(f, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_mass_matches_oracle(small_mesh):
    """The 5-point ("keast5") mass reproduces the oracle's assembly, its
    product and diagonal; the default exact rule is SPD with the same total
    mass, rho times the volume."""
    nodes, conn = small_mesh
    rho = 2700.0
    M = oracles.t10_mass_matrix(nodes, conn, rho)
    elems = feat10.build(nodes, conn, rho, torch.float64, "keast5", device="cpu")
    vv = np.random.default_rng(1).standard_normal(nodes.shape)
    np.testing.assert_allclose(mass_matvec(torch.as_tensor(vv), elems).numpy(), M @ vv,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mass_diag(elems).numpy(), np.diag(M), rtol=1e-10)
    np.testing.assert_allclose(M.sum(), rho * 1.0 * 0.5 * 0.5, rtol=1e-9)
    exact = feat10.build(nodes, conn, rho, device="cpu")
    dense = np.zeros_like(M)
    me, cc = exact.mass_elem.numpy(), exact.conn.numpy()
    for e in range(cc.shape[0]):
        dense[np.ix_(cc[e], cc[e])] += me[e]
    assert np.linalg.eigvalsh(dense).min() > 0
    np.testing.assert_allclose(dense.sum(), M.sum(), rtol=1e-10)
