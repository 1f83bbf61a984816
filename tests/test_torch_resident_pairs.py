"""The resident gate of the torch port at the (family, material) pairs its
persistent kernel is instantiated for beyond FEAT10 x SVK: FEAT10 x
Mooney-Rivlin and ANCF3243 x SVK and x Mooney-Rivlin, on the CPU, where
`resident.newton_inner_resident` takes its plain version.

The gate's cases follow `pallas_resident.eligible`; ANCF3443 stays out, as
the JAX package's banded build refuses every shell mesh. One implicit step
through the gate is held against the JAX package's XLA `_step` in float64:
identical Newton and CG counts, positions within 1e-10 of the displacement
and the ||g|| history within 1e-9 relative, or 1e-10 of its first entry for
the converged residuals, which are differences of terms of that size (as
`tests/test_torch_resident.py` holds FEAT10 x SVK). The kernels run only on the card (`tests/test_torch_cuda.py`).

`_JMooneyRivlin` (from `tests/test_torch_mooney_rivlin.py`) is the JAX
material with F broadcast before its `tangent_diag_block`, which the JAX
`precond_blocks` would otherwise hand an F that `jax.jvp` refuses.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mooney_rivlin import _JMooneyRivlin, _mr_from_E_nu
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.solvers import newton as j_newton
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.elements import ancf3243, ancf3443
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import SVK, MooneyRivlin
from tlfea_torch.ops import resident
from tlfea_torch.solvers import System, newton
from tlfea_torch.solvers.coarse import build_coarse_precond

torch.set_num_threads(2)


def _jax_material(kind):
    """Damped SVK at (E 1e7, nu 0.3), or Mooney-Rivlin mapped from the same
    (E, nu) as `examples/bunny_deform.py:58-64` maps it."""
    if kind == "svk":
        lam, mu = lame_from_E_nu(1e7, 0.3)
        return JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu), eta_damp=jnp.asarray(1e3),
                    lam_damp=jnp.asarray(1e3))
    return _JMooneyRivlin(**_mr_from_E_nu(1e7, 0.3, 1e3))


def _jax_problem(tag):
    """(coordinates, JAX system, f_ext, params) in float64: the JAX resident
    test's box (`tests/test_pallas_banded.py`, 4 x 2 x 2 cells here, the x=0
    face pinned) or an 8-element ANCF3243 cantilever (node 0 clamped), under
    gravity, with that test's solver parameters."""
    family, kind = (tag[:-3], "mr") if tag.endswith("_mr") else (tag, "svk")
    if family == "feat10":
        x0, conn = box_t10_mesh(1.0, 0.3, 0.3, 4, 2, 2)
        elems = j_feat10.build(x0, conn, rho=1000.0)
        fixed = np.nonzero(x0[:, 0] < 1e-12)[0]
    else:
        x0, conn = j_ancf3243.straight_beam(8, L=0.1)
        elems = j_ancf3243.build(x0, conn, 0.1, 0.02, 0.02, rho=1000.0)
        fixed = np.arange(4)
    system = JSystem(elems=elems, material=_jax_material(kind),
                     constraints=JFixedCoefs.from_indices(fixed, x0))
    f_ext = jnp.zeros((len(x0), 3)).at[:, 2].add(j_lumped_mass(elems) * -9.81)
    params = j_newton.NewtonParams(dt=1e-3, rho=1e6, inner_atol=1e-6, inner_rtol=0.0,
                                   outer_tol=0.0, max_outer=1, max_inner=4, cg_rtol=1e-3,
                                   cg_max_iter=40, ew_eta_max=0.5)
    return x0, system, f_ext, params


def _beam(n_elem, material):
    coefs, conn = ancf3243.straight_beam(n_elem, L=0.1)
    return System(elems=ancf3243.build(coefs, conn, 0.1, 0.02, 0.02, rho=1000.0, device="cpu"),
                  material=material)


def _mr():
    return MooneyRivlin(**_mr_from_E_nu(1e7, 0.3, 1e3))


def _svk():
    return SVK(*lame_from_E_nu(1e7, 0.3), 1e3, 1e3)


PAIRS = ["feat10_mr", "ancf3243", "ancf3243_mr"]


@pytest.mark.parametrize("tag", PAIRS)
def test_eligible_pairs(tag):
    x0, jsys, _, _ = _jax_problem(tag)
    tsys, _, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, device="cpu")
    assert tsys.fem.tag == tag and tsys.constraints is not None
    assert resident.eligible(tsys, None)
    assert resident.eligible(System(elems=tsys.elems, material=tsys.material), None)


@pytest.mark.parametrize("case", ["ancf3443_svk", "ancf3443_mr", "too_many_elements", "coarse",
                                  "other_constraints"])
def test_not_eligible(case):
    if case.startswith("ancf3443"):
        coefs, conn = ancf3443.shell_grid(2, 2, L=0.05, W=0.05)
        system = System(elems=ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0,
                                             device="cpu"),
                        material=_mr() if case.endswith("mr") else _svk())
        assert system.fem.E <= resident.MAX_ELEMS
        assert not resident.eligible(system, None)
        return
    if case == "too_many_elements":
        system = _beam(resident.MAX_ELEMS + 1, _mr())
        assert not resident.eligible(system, None)
        assert resident.eligible(_beam(resident.MAX_ELEMS, _mr()), None)
        return
    x0, jsys, _, jparams = _jax_problem("ancf3243_mr")
    tsys, _, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                         params=jparams, device="cpu")
    if case == "coarse":
        coarse = build_coarse_precond(tsys, tsys.elems.x_ref, tparams.dt, tparams.rho,
                                      target_cluster=2)
        assert not resident.eligible(tsys, coarse)
        return

    @dataclass(frozen=True)
    class OtherConstraints:  # any constraints but FixedCoefs, as the JAX gate's
        idx: torch.Tensor

    system = System(elems=tsys.elems, material=tsys.material,
                    constraints=OtherConstraints(tsys.constraints.idx))
    assert not resident.eligible(system, None)


@pytest.mark.parametrize("tag", PAIRS)
def test_step_matches_jax(tag, monkeypatch):
    """One implicit step from rest through the resident entry against the
    JAX XLA `_step`."""
    x0, jsys, f_ext, jparams = _jax_problem(tag)
    js, jd = j_newton.make_step(jsys, jparams)(JStepState.rest(jsys, x0), f_ext)
    tsys, tstate, tparams = from_numpy_system(jsys.elems, jsys.material, jsys.constraints,
                                              JStepState.rest(jsys, x0), jparams, device="cpu")
    calls = []
    plain = resident.newton_inner_resident_plain
    monkeypatch.setattr(resident, "newton_inner_resident_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    ts, td = newton.make_step(tsys, tparams)(tstate, torch.as_tensor(np.array(f_ext)))
    assert len(calls) == 1
    j_x = np.asarray(js.x)
    scale = np.abs(j_x - x0).max()
    assert scale > 0
    assert np.abs(ts.x.numpy() - j_x).max() < 1e-10 * scale
    for key in ("newton_iters", "cg_iters"):
        assert td[key] == int(jd[key]), key
    assert td["cg_iters"] > 0
    # The last entries are converged residuals, differences of terms of the
    # first entry's size: their rounding is held against that size.
    hist = np.asarray(jd["norm_g_history"])
    np.testing.assert_allclose(td["norm_g_history"].numpy(), hist, rtol=1e-9,
                               atol=1e-10 * hist[0])
