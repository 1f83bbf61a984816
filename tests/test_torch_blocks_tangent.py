"""K3 `svk_blocks` (`[ancf3443]`, `[feat10]`) and K5t `contrib_tangent`
(`[feat10]`, `[feat10_mr]`, `[ancf3443]`, `[ancf3443_mr]`) on the CPU, at
the ragged sizes at which `tests/test_torch_cuda.py` holds their CUDA
kernels (which may launch one thread an (element, slot), `fem_kernels.cuh`
`Slots`, and stream a point's operands, `contrib_tangent_stream_tile`) to
the twins: a 5 x 7 shell (35 elements) and a 1 x 1 shell for the shell's
K3 and K5t; the first 33 elements of a FEAT10 box for FEAT10's K3 and K5t
(SVK and Mooney-Rivlin), each a multiple of neither 8, 16 nor 32, so the
last tile is ragged.

On the CPU the wrappers run the plain twins, which the card tests take as
the reference. Here they go against the JAX package's XLA path, in float64
within 1e-12 of the largest entry (float32 within 1e-5): K3's blocks per
element and slot against the einsum branch of `precond_blocks` before its
scatter (`SVK.tangent_diag_block` at each quadrature point times dV, as
`tests/test_torch_ancf.py` does on its 3 x 2 strip); K5t's tangent against
`jax.jvp` of the element contribution `_element_contrib_values` along
independent directions (du, dv, d(dv/dt)), damped and undamped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mooney_rivlin import _JMooneyRivlin, _mr_from_E_nu
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import ancf3443 as j_ancf3443
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import _element_contrib_values
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import System as JSystem
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.ops import fem_kernels as fk

torch.set_num_threads(2)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
SHELLS = [(5, 7), (1, 1)]  # (nx, ny): 35 elements, 1
TANGENT_E = 33  # the first elements of a 3 x 2 x 1 box of 36


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _slots(ref, op, C):
    """JAX per-element values (E, S, C) -> the kernels' (S*C, E) layout."""
    return np.transpose(np.asarray(ref), (1, 2, 0)).reshape(op.S * C, op.E)


def _port(jsys, dtype):
    system, _, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, device="cpu",
                                     dtype=dtype)
    return system.fem


def _svk(damping):
    lam, mu = lame_from_E_nu(1e7, 0.3)
    return JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu), eta_damp=jnp.asarray(damping),
                lam_damp=jnp.asarray(damping))


def _einsum_blocks(jsys, u, op):
    """The einsum branch of `precond_blocks` before its scatter and its dt
    weight: sum_q K(F_q, gradN_qa) dV_q per element and slot, in the
    kernels' SYM6 (S*6, E) layout."""
    elems = jsys.elems
    F = jnp.einsum("eai,eqaj->eqij", jnp.asarray(u)[elems.conn], elems.grad_N)
    Kb = jsys.material.tangent_diag_block(F[:, :, None] + jnp.eye(3), elems.grad_N)
    Kb = (Kb * elems.dV[:, :, None, None, None]).sum(axis=1)  # (E, S, 3, 3)
    return _slots(np.stack([Kb[..., a, b] for a, b in fk.SYM6], axis=-1), op, 6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shell", SHELLS, ids=[f"{nx}x{ny}" for nx, ny in SHELLS])
def test_svk_blocks_twin_on_ragged_shells_matches_jax(shell, dtype):
    coefs, conn = j_ancf3443.shell_grid(*shell, L=0.05, W=0.05)
    edge = np.nonzero(coefs[0::4, 0] < 1e-12)[0]
    fixed = (4 * edge[:, None] + np.arange(4)[None, :]).reshape(-1)
    jsys = JSystem(elems=j_ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0),
                   material=_svk(1e3), constraints=JFixedCoefs.from_indices(fixed, coefs))
    op = _port(jsys, dtype)
    assert (op.tag, op.E) == ("ancf3443", shell[0] * shell[1])
    u = np.random.default_rng(13).normal(size=coefs.shape) * 1e-2

    got = fk.svk_blocks(op, torch.as_tensor(u, dtype=dtype))
    assert torch.equal(got, fk.svk_blocks_plain(op, torch.as_tensor(u, dtype=dtype)))
    want = _einsum_blocks(jsys, u, op)
    assert np.isfinite(got.numpy()).all() and _rel(got.numpy(), want) < TOL[dtype]


@pytest.fixture(scope="module")
def tangent_box():
    """The first TANGENT_E elements of a 3 x 2 x 1 FEAT10 box, a strained
    state (u 1e-2, v and dv/dt standard normal), a tangent direction (n, 9)
    and the JAX jvp of the element contribution, jitted once."""
    nodes, conn = box_t10_mesh(1.0, 0.4, 0.2, 3, 2, 1)
    elems = j_feat10.build(nodes, conn[:TANGENT_E], rho=1000.0)
    rng = np.random.default_rng(21)
    n = len(nodes)
    host = np.concatenate([rng.normal(size=(n, 3)) * 1e-2, rng.normal(size=(n, 6))], 1)
    dhost = rng.normal(size=(n, 9))

    @jax.jit
    def jvp(material, x, dx):
        def contrib(u, v, a):
            return _element_contrib_values(u, v, a, elems, material)

        return jax.jvp(contrib, (x[:, 0:3], x[:, 3:6], x[:, 6:9]),
                       (dx[:, 0:3], dx[:, 3:6], dx[:, 6:9]))[1]

    return nodes, elems, host, dhost, jvp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_feat10_svk_blocks_twin_on_a_ragged_box_matches_jax(tangent_box, dtype):
    nodes, elems, _, _, _ = tangent_box
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=elems, material=_svk(1e3),
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    op = _port(jsys, dtype)
    assert (op.tag, op.E) == ("feat10", TANGENT_E) and op.E % 16 and op.E % 32
    u = np.random.default_rng(19).normal(size=nodes.shape) * 1e-2

    got = fk.svk_blocks(op, torch.as_tensor(u, dtype=dtype))
    assert torch.equal(got, fk.svk_blocks_plain(op, torch.as_tensor(u, dtype=dtype)))
    want = _einsum_blocks(jsys, u, op)
    assert np.isfinite(got.numpy()).all() and _rel(got.numpy(), want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
def test_svk_contrib_tangent_twin_on_a_ragged_box_matches_jax(tangent_box, damping, dtype):
    nodes, elems, host, dhost, jvp = tangent_box
    mat = _svk(damping)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=elems, material=mat, constraints=JFixedCoefs.from_indices(fixed, nodes))
    op = _port(jsys, dtype)
    assert (op.tag, op.E) == ("feat10", TANGENT_E) and op.E % 16 and op.E % 32

    packed, dpacked = (torch.as_tensor(a, dtype=dtype).contiguous() for a in (host, dhost))
    got = fk.contrib_tangent(op, packed, dpacked)
    assert torch.equal(got, fk.contrib_tangent_plain(op, packed, dpacked))
    want = _slots(jvp(mat, jnp.asarray(host), jnp.asarray(dhost)), op, 3)
    assert np.isfinite(got.numpy()).all() and _rel(got.numpy(), want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("damping", [0.0, 1e3], ids=["undamped", "damped"])
def test_mr_contrib_tangent_twin_on_a_ragged_box_matches_jax(tangent_box, damping, dtype):
    nodes, elems, host, dhost, jvp = tangent_box
    mat = _JMooneyRivlin(**_mr_from_E_nu(1e7, 0.3, damping))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=elems, material=mat, constraints=JFixedCoefs.from_indices(fixed, nodes))
    op = _port(jsys, dtype)
    assert (op.tag, op.E) == ("feat10_mr", TANGENT_E) and op.E % 8 and op.E % 32

    packed, dpacked = (torch.as_tensor(a, dtype=dtype).contiguous() for a in (host, dhost))
    got = fk.contrib_tangent(op, packed, dpacked)
    assert torch.equal(got, fk.contrib_tangent_plain(op, packed, dpacked))
    want = _slots(jvp(mat, jnp.asarray(host), jnp.asarray(dhost)), op, 3)
    assert np.isfinite(got.numpy()).all() and _rel(got.numpy(), want) < TOL[dtype]


# K5t on the shells of SHELLS: (tag, damping). SVK damped as chip_smoke's
# shell is; Mooney-Rivlin damped and undamped.
SHELL_TANGENTS = [("ancf3443", 1e3), ("ancf3443_mr", 1e3), ("ancf3443_mr", 0.0)]


@pytest.fixture(scope="module")
def tangent_shells():
    """shell -> (coefs, JAX elements, a strained state (u 2e-3, v and dv/dt
    standard normal), a tangent direction (n, 9), the JAX jvp of the element
    contribution jitted once a shell, the material an argument)."""
    cache = {}

    def get(shell):
        if shell not in cache:
            coefs, conn = j_ancf3443.shell_grid(*shell, L=0.05, W=0.05)
            elems = j_ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0)
            rng = np.random.default_rng(29)
            n = len(coefs)
            host = np.concatenate([rng.normal(size=(n, 3)) * 2e-3, rng.normal(size=(n, 6))], 1)
            dhost = rng.normal(size=(n, 9))

            @jax.jit
            def jvp(material, x, dx):
                def contrib(u, v, a):
                    return _element_contrib_values(u, v, a, elems, material)

                return jax.jvp(contrib, (x[:, 0:3], x[:, 3:6], x[:, 6:9]),
                               (dx[:, 0:3], dx[:, 3:6], dx[:, 6:9]))[1]

            cache[shell] = coefs, elems, host, dhost, jvp
        return cache[shell]

    return get


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("tag,damping", SHELL_TANGENTS,
                         ids=[f"{t}-{'damped' if d else 'undamped'}" for t, d in SHELL_TANGENTS])
@pytest.mark.parametrize("shell", SHELLS, ids=[f"{nx}x{ny}" for nx, ny in SHELLS])
def test_shell_contrib_tangent_twin_on_ragged_shells_matches_jax(tangent_shells, shell, tag,
                                                                damping, dtype):
    coefs, elems, host, dhost, jvp = tangent_shells(shell)
    mat = _svk(damping) if tag == "ancf3443" else _JMooneyRivlin(**_mr_from_E_nu(1e7, 0.3, damping))
    edge = np.nonzero(coefs[0::4, 0] < 1e-12)[0]
    fixed = (4 * edge[:, None] + np.arange(4)[None, :]).reshape(-1)
    jsys = JSystem(elems=elems, material=mat, constraints=JFixedCoefs.from_indices(fixed, coefs))
    op = _port(jsys, dtype)
    assert (op.tag, op.E) == (tag, shell[0] * shell[1])

    packed, dpacked = (torch.as_tensor(a, dtype=dtype).contiguous() for a in (host, dhost))
    got = fk.contrib_tangent(op, packed, dpacked)
    assert torch.equal(got, fk.contrib_tangent_plain(op, packed, dpacked))
    want = _slots(jvp(mat, jnp.asarray(host), jnp.asarray(dhost)), op, 3)
    assert np.isfinite(got.numpy()).all() and _rel(got.numpy(), want) < TOL[dtype]
