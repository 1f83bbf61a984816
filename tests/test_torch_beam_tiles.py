"""K1 `primal_prep[ancf3243]`, K2 `hv[ancf3243]`, K3 `svk_blocks[ancf3243]`
and K5 `contrib[ancf3243]` (SVK) and K2 `hv[ancf3243_mr]` and K5t
`contrib_tangent[ancf3243_mr]` on the CPU, at the beam lengths at which
`tests/test_torch_cuda.py` holds their CUDA kernels (which may launch one
thread a quadrature point, `fem_kernels.cuh` `Points`, or one thread an
(element, slot), `Slots`) to the twins (`test_beam_*`): E = 1, 7, 33, 64,
65, 1,024 and 1,027 elements, the ragged ones a multiple of neither 4, 8,
16 nor 32, and with a row stride E * itemsize off 16 bytes.

On the CPU the wrappers run the plain twins, which the card tests take as
the reference. Here they go against the JAX package's XLA path at the card
tests' strained state (u 1e-2, v and dv/dt standard normal), in float64
within 1e-12 of the largest entry: K1's and K5's fe against the element
contribution `_element_contrib_values`, K2's product (SVK and
Mooney-Rivlin) from K1's prep cache against its `jax.jvp` along the Newton
chain (dt p, p, p / dt), damped and undamped, and at the beam mirrored in
x (det F < 0 at every point). K3's blocks per element and slot go against
the einsum branch of `precond_blocks` before its scatter, and K5t's
Mooney-Rivlin tangent against `jax.jvp` of the element contribution along
a random direction (du, dv, d(dv/dt)), damped, undamped and mirrored; these
two in float64 within 1e-12 and float32 within 1e-5. `straight_beam`
spaces the nodes by the element length, so a beam of E elements is the
first E elements of the longest one: JAX runs once on the longest beam
(jitted), and each shorter beam's twin goes against its first E columns.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mooney_rivlin import _JMooneyRivlin, _mr_from_E_nu
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements.assembly import _element_contrib_values
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu as j_lame
from tlfea_torch.elements import ancf3243
from tlfea_torch.materials import SVK, MooneyRivlin
from tlfea_torch.ops import fem_kernels as fk

torch.set_num_threads(2)

SIZES = [1, 7, 33, 64, 65, 1024, 1027]
ELEM = (0.1, 0.02, 0.02)  # element length, width, height (`_ancf_system`)
STRAIN, DT, RTOL = 1e-2, 1e-3, 1e-12
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


def _materials(kind, damping=1e3):
    """(port, JAX) material: damped SVK at E 1e7, nu 0.3, or Mooney-Rivlin
    mapped from the same as `examples/bunny_deform.py` maps it."""
    if kind == "svk":
        lam, mu = (float(x) for x in j_lame(1e7, 0.3))
        return SVK(lam, mu, damping, damping), JSVK(lam=lam, mu=mu, eta_damp=damping,
                                                    lam_damp=damping)
    c = _mr_from_E_nu(1e7, 0.3, damping)
    return MooneyRivlin(c["mu10"], c["mu01"], c["kappa"], damping, damping), _JMooneyRivlin(**c)


@pytest.fixture(scope="module")
def beam():
    """The longest beam: coefficients, JAX elements, the strained state
    (n, 9), its mirror in x, a direction p (n, 3) and a tangent direction d
    (n, 9)."""
    coefs, conn = j_ancf3243.straight_beam(max(SIZES), L=ELEM[0])
    elems = j_ancf3243.build(coefs, conn, *ELEM, rho=1000.0)
    rng = np.random.default_rng(21)
    n = len(coefs)
    host = np.concatenate([rng.normal(size=(n, 3)) * STRAIN, rng.normal(size=(n, 6))], 1)
    mirrored = host.copy()
    mirrored[:, 0] -= 2.0 * coefs[:, 0]  # every x mirrored (the gradient rows' x too)
    p = rng.normal(size=(n, 3))
    return dict(coefs=coefs, elems=elems, host=host, mirrored=mirrored, p=p,
                d=rng.normal(size=(n, 9)))


@functools.lru_cache(maxsize=None)
def _elems(E):
    """The port's first E elements, float64 on the CPU, and their coefficients."""
    coefs, conn = ancf3243.straight_beam(E, L=ELEM[0])
    return coefs, ancf3243.build(coefs, conn, *ELEM, rho=1000.0, device="cpu")


def _op(beam, E, material, dtype=torch.float64):
    """The port's operator on the first E elements, in dtype."""
    coefs, elems = _elems(E)
    assert np.array_equal(coefs, beam["coefs"][:len(coefs)])
    return fk.FemOperator(elems.to(dtype=dtype), material)


def _cols(ref, E):
    """JAX's (E_max, S, 3) values -> the first E elements as (S*3, E)."""
    return np.transpose(np.asarray(ref)[:E], (1, 2, 0)).reshape(-1, E)


def _rel(got, want):
    got = got.numpy().astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def k5_ref(beam):
    """JAX's element contribution with damped SVK on the longest beam."""
    jmat = _materials("svk")[1]
    fn = jax.jit(lambda u, v, a: _element_contrib_values(u, v, a, beam["elems"], jmat))
    return fn(*(jnp.asarray(beam["host"][:, 3 * k:3 * k + 3]) for k in range(3)))


@pytest.fixture(scope="module")
def k2_refs(beam):
    """refs(kind, damping): JAX's Hv with material kind ("svk" or "mr") at
    (the strained state, its mirror): jax.jvp of the element contribution
    along (dt p, p, p / dt), one jitted function a material, run once."""
    p = jnp.asarray(beam["p"])

    @functools.lru_cache(maxsize=None)
    def refs(kind, damping):
        jmat = _materials(kind, damping)[1]

        def contrib(u, v, a):
            return _element_contrib_values(u, v, a, beam["elems"], jmat)

        fn = jax.jit(lambda u, v, a: jax.jvp(contrib, (u, v, a), (DT * p, p, p / DT))[1])
        return tuple(fn(*(jnp.asarray(beam[state][:, 3 * k:3 * k + 3]) for k in range(3)))
                     for state in ("host", "mirrored"))

    return refs


@pytest.mark.parametrize("E", SIZES)
def test_beam_contrib_twin_matches_jax(beam, k5_ref, E):
    op = _op(beam, E, _materials("svk")[0])
    assert (op.tag, op.E) == ("ancf3243", E)
    packed = torch.as_tensor(beam["host"][:op.n]).contiguous()
    fe5 = fk.contrib(op, packed)
    assert _rel(fe5, _cols(k5_ref, E)) < RTOL
    assert torch.equal(fk.primal_prep(op, packed)[0], fe5)


@pytest.mark.parametrize("E", SIZES)
def test_beam_primal_prep_twin_matches_jax(beam, k5_ref, E):
    op = _op(beam, E, _materials("svk")[0])
    fe, prep = fk.primal_prep(op, torch.as_tensor(beam["host"][:op.n]).contiguous())
    assert prep.shape == (op.Q * op.prep_rows, E) and bool(torch.isfinite(prep).all())
    assert _rel(fe, _cols(k5_ref, E)) < RTOL


def _twin_hv(beam, E, damping, state, kind="mr"):
    op = _op(beam, E, _materials(kind, damping)[0])
    assert (op.tag, op.E) == (fk._tag("ancf3243", kind), E)
    _, prep = fk.primal_prep(op, torch.as_tensor(beam[state][:op.n]).contiguous())
    got = fk.hv(op, torch.as_tensor(beam["p"][:op.n]).contiguous(), prep, DT)
    return got, prep.view(op.Q, op.prep_rows, op.E)[:, 18]


@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("E", SIZES)
def test_beam_mr_hv_twin_matches_jax(beam, k2_refs, E, damping):
    got, jm1 = _twin_hv(beam, E, damping, "host")
    assert float(jm1.abs().max()) < 0.9  # strained, nothing inverted
    assert bool(torch.isfinite(got).all())
    assert _rel(got, _cols(k2_refs("mr", damping)[0], E)) < RTOL


@pytest.mark.parametrize("E", SIZES)
def test_beam_mr_hv_twin_at_an_inverted_point_matches_jax(beam, k2_refs, E):
    got, jm1 = _twin_hv(beam, E, 1e3, "mirrored")
    want = _cols(k2_refs("mr", 1e3)[1], E)
    assert float(jm1.max()) < -1.0  # J < 0 at every point
    assert bool(torch.isfinite(got).all()) and np.isfinite(want).all()
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("state", ["host", "mirrored"])
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
@pytest.mark.parametrize("E", SIZES)
def test_beam_hv_twin_matches_jax(beam, k2_refs, E, damping, state):
    """K2 `[ancf3243]` (SVK) from K1's prep cache, at the strained beam and
    at its mirror in x."""
    got = _twin_hv(beam, E, damping, state, "svk")[0]
    assert bool(torch.isfinite(got).all())
    assert _rel(got, _cols(k2_refs("svk", damping)[state == "mirrored"], E)) < RTOL


@pytest.fixture(scope="module")
def k3_ref(beam):
    """The einsum branch of JAX's `precond_blocks` before its scatter and its
    dt weight on the longest beam at the strained u: sum_q K(F_q, gradN_qa)
    dV_q per element and slot, (E_max, S, 6) in the kernels' SYM6 order."""
    elems, jmat = beam["elems"], _materials("svk")[1]

    @jax.jit
    def blocks(u):
        F = jnp.einsum("eai,eqaj->eqij", u[elems.conn], elems.grad_N)
        Kb = jmat.tangent_diag_block(F[:, :, None] + jnp.eye(3), elems.grad_N)
        Kb = (Kb * elems.dV[:, :, None, None, None]).sum(axis=1)  # (E, S, 3, 3)
        return jnp.stack([Kb[..., a, b] for a, b in fk.SYM6], axis=-1)

    return blocks(jnp.asarray(beam["host"][:, :3]))


def _rounded(a, dtype):
    """a as the port holds it in dtype, back in float64."""
    return torch.as_tensor(np.array(a)).to(dtype).double().numpy()


@pytest.fixture(scope="module")
def k5t_refs(beam):
    """refs(state, damping, dtype): JAX's Mooney-Rivlin K5t at the strained
    state or its mirror ("host", "mirrored"): jax.jvp of the element
    contribution along the tangent direction d, in float64 on the inputs the
    twin in dtype sees (the state, d and the element tables rounded to
    dtype; at the mirror the centred x differences of float32 inputs carry
    up to 3e-4 of the result, which is the inputs' error, not the twin's).
    One jitted function, the tables and the material its arguments; each
    (state, damping, dtype) run once."""
    base = beam["elems"]

    @jax.jit
    def jvp(elems, material, x, d):
        def contrib(u, v, a):
            return _element_contrib_values(u, v, a, elems, material)

        return jax.jvp(contrib, (x[:, 0:3], x[:, 3:6], x[:, 6:9]),
                       (d[:, 0:3], d[:, 3:6], d[:, 6:9]))[1]

    @functools.lru_cache(maxsize=None)
    def refs(state, damping, dtype):
        def r(a):
            return jnp.asarray(_rounded(a, dtype))

        elems = base.replace(grad_N=r(base.grad_N), dV=r(base.dV), mass_elem=r(base.mass_elem))
        return jvp(elems, _materials("mr", damping)[1], r(beam[state]), r(beam["d"]))

    return refs


@DTYPES
@pytest.mark.parametrize("E", SIZES)
def test_beam_svk_blocks_twin_matches_jax(beam, k3_ref, E, dtype):
    """K3 `[ancf3243]`'s twin against JAX's einsum blocks."""
    op = _op(beam, E, _materials("svk")[0], dtype)
    assert (op.tag, op.E) == ("ancf3243", E)
    u = torch.as_tensor(beam["host"][:op.n, :3], dtype=dtype).contiguous()
    got = fk.svk_blocks(op, u)
    assert got.dtype == dtype and torch.equal(got, fk.svk_blocks_plain(op, u))
    assert bool(torch.isfinite(got).all())
    assert _rel(got, _cols(k3_ref, E)) < TOL[dtype]


# K5t `[ancf3243_mr]`'s (state, damping): the strained beam damped and
# undamped, and its mirror in x (det F < 0 at every point), damped.
MR_TANGENT_CASES = [("host", 1e3), ("host", 0.0), ("mirrored", 1e3)]


@DTYPES
@pytest.mark.parametrize("state,damping", MR_TANGENT_CASES,
                         ids=["damped", "undamped", "mirrored"])
@pytest.mark.parametrize("E", SIZES)
def test_beam_mr_contrib_tangent_twin_matches_jax(beam, k5t_refs, E, state, damping, dtype):
    """K5t `[ancf3243_mr]`'s twin against `jax.jvp` of the element
    contribution."""
    op = _op(beam, E, _materials("mr", damping)[0], dtype)
    assert (op.tag, op.E) == ("ancf3243_mr", E)
    packed, dpacked = (torch.as_tensor(beam[k][:op.n], dtype=dtype).contiguous()
                       for k in (state, "d"))
    got = fk.contrib_tangent(op, packed, dpacked)
    assert got.dtype == dtype and torch.equal(got, fk.contrib_tangent_plain(op, packed, dpacked))
    want = _cols(k5t_refs(state, damping, dtype), E)
    assert bool(torch.isfinite(got).all()) and np.isfinite(want).all()
    assert _rel(got, want) < TOL[dtype]
