"""The element kernels as `torch.library` operators (`torch.ops.tlfea.*`).

K1 `primal_prep`, K2 `hv`, K3 `svk_blocks`, K4 `node_reduce`, K5 `contrib`
and K5t `contrib_tangent` are operators whose CPU kernel is the plain twin
on tables rebuilt from the operator's tensors and tag, and whose CUDA
kernel is the launch (held on the card by `tests/test_torch_cuda.py`).
Here, on the CPU, in float64:

- `torch.library.opcheck` of each operator's CPU kernel (schema, fake
  tensor, AOT dispatch), with SVK and, where the kernel reads it,
  Mooney-Rivlin;
- each CPU kernel equals the twin on the `FemOperator` bit for bit, in
  every family and material (conn, the translation mask and the material
  rebuilt from the tag);
- `torch.func.linearize` of the port's `grad_L` (not plain, so through the
  operators) against `jax.linearize(grad_L)`, 1e-12 at two directions, its
  graph calling `tlfea.contrib_tangent` and `tlfea.node_reduce` at each
  call;
- a `make_fx` graph of `g_and_hvp`'s Hv holds `tlfea.hv` and
  `tlfea.node_reduce` nodes and gives the Hv at a new direction;
- the persistent kernel, no operator, still refuses to be traced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import System as JSystem
from tlfea.solvers.common import grad_L as j_grad_L
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.elements import ancf3243, ancf3443, feat10
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import SVK, MooneyRivlin
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers.common import _pin_terms, grad_L

torch.set_num_threads(2)

DT, RHO = 1e-3, 1e7
MR = MooneyRivlin(1.538e6, 3.846e5, 8.333e6, 1e3, 1e3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _operator(family, material):
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(lam, mu, 1e3, 2e3) if material == "svk" else MR
    if family == "feat10":
        nodes, conn = box_t10_mesh(1.0, 0.2, 0.2, 2, 1, 1)
        elems = feat10.build(nodes, conn, rho=1000.0, device="cpu")
    elif family == "ancf3243":
        coefs, conn = ancf3243.straight_beam(3, L=0.5)
        elems = ancf3243.build(coefs, conn, 0.5, 0.05, 0.05, rho=1000.0, device="cpu")
    else:
        coefs, conn = ancf3443.shell_grid(2, 2, L=0.05, W=0.05)
        elems = ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0, device="cpu")
    return fk.FemOperator(elems, mat)


def _calls(op, seed=3):
    """{kernel: (wrapper arguments, operator arguments)} at a random state."""
    rng = np.random.default_rng(seed)
    packed = torch.as_tensor(rng.normal(size=(op.n, 9)) * 1e-2)
    p, dp = torch.as_tensor(rng.normal(size=(op.n, 3))), torch.as_tensor(rng.normal(size=(op.n, 9)))
    vals = torch.as_tensor(rng.normal(size=(op.S * 6, op.E)))
    _, prep = fk.primal_prep_plain(op, packed)
    mat = list(op.mat_args)
    out = {"primal_prep": ((packed,), (packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, op.tag, mat)),
           "hv": ((p, prep, DT), (p, op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, DT, op.tag, mat)),
           "node_reduce": ((vals,), (vals, op.conn, op.inc_ptr, op.inc, op.family)),
           "contrib": ((packed,), (packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, op.tag, mat)),
           "contrib_tangent": ((packed, dp), (packed, dp, op.conn_t, op.gN_t, op.dV_t, op.Me_t,
                                              op.tag, mat))}
    if op.kind == "svk":
        out["svk_blocks"] = ((p,), (p, op.conn_t, op.gN_t, op.dV_t, op.tag, [op.lam, op.mu]))
    return out


OPCHECK_CASES = [(k, "svk") for k in fk.KERNEL_NAMES] + [
    (k, "mr") for k in fk.MATERIAL_KERNELS["mr"]]


@pytest.mark.parametrize("name,material", OPCHECK_CASES)
def test_operator_passes_opcheck(name, material):
    op = _operator("feat10", material)
    args = _calls(op)[name][1]
    torch.library.opcheck(getattr(torch.ops.tlfea, name).default, args)


@pytest.mark.parametrize("material", ["svk", "mr"])
@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
def test_cpu_kernels_are_the_twins(family, material):
    """Each wrapper's operator call on CPU tensors gives the twin on the
    FemOperator bit for bit: the CPU kernel rebuilt conn, the translation
    mask, the prep rows and the material from the tensors and the tag (K4's
    takes conn itself)."""
    op = _operator(family, material)
    fk.reset_launch_counts()
    for name, (args, _) in _calls(op, seed=len(family)).items():
        got = getattr(fk, name)(op, *args)
        want = getattr(fk, name + "_plain")(op, *args)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    assert all(v == 0 for v in fk.LAUNCHES.values())
    t = fk._Tables(op.tag, op.mat_args, op.n, op.conn_t, op.gN_t, op.dV_t, op.Me_t)
    assert torch.equal(t.conn, op.conn) and torch.equal(t.tmask, op.tmask)
    assert (t.Q, t.S, t.E, t.prep_rows, t.material) == (op.Q, op.S, op.E, op.prep_rows,
                                                        op.material)


class _Ops(TorchDispatchMode):
    """Records the names of the operators called under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def flagship_cell():
    """A 3 x 1 x 1 pinned box in both packages (the fem-kernel tests' box)."""
    nodes, conn = box_t10_mesh(1.0, 0.2, 0.2, 3, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
               eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(1e3))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    tsys, _, _ = from_numpy_system(jsys.elems, mat, jsys.constraints, device="cpu")
    n = len(nodes)
    rng = np.random.default_rng(23)
    d = dict(u_prev=rng.normal(size=(n, 3)) * 1e-2, v=rng.normal(size=(n, 3)) * 0.1,
             v_prev=rng.normal(size=(n, 3)) * 0.1, lam=rng.normal(size=(len(fixed), 3)),
             f_ext=rng.normal(size=(n, 3)), p=[rng.normal(size=(n, 3)) for _ in range(2)])
    return jsys, tsys, nodes, d


def test_linearize_of_grad_L_runs_the_operators_and_matches_jax(flagship_cell):
    jsys, tsys, nodes, d = flagship_cell
    assert not tsys.plain
    t = torch.as_tensor

    def tg(v):
        return grad_L(v, t(nodes + d["u_prev"]), t(d["v_prev"]), t(d["lam"]), t(d["f_ext"]), DT,
                      RHO, tsys, u_prev=t(d["u_prev"]))

    def jg(v):
        return j_grad_L(v, jnp.asarray(nodes + d["u_prev"]), jnp.asarray(d["v_prev"]),
                        jnp.asarray(d["lam"]), jnp.asarray(d["f_ext"]), DT, RHO, jsys,
                        u_prev=jnp.asarray(d["u_prev"]))

    g0, lin = torch.func.linearize(tg, t(d["v"]))
    jg0, jlin = jax.linearize(jg, jnp.asarray(d["v"]))
    assert _rel(g0.numpy(), jg0) < 1e-12
    for p in d["p"]:
        rec = _Ops()
        with rec:
            got = lin(t(p))
        assert rec.seen.count("tlfea.contrib_tangent.default") == 1
        assert rec.seen.count("tlfea.node_reduce.default") >= 1
        assert _rel(got.numpy(), jlin(jnp.asarray(p))) < 1e-12


def test_make_fx_graph_of_hv_holds_the_operators(flagship_cell):
    _, tsys, _, d = flagship_cell
    t = torch.as_tensor
    pins = _pin_terms(tsys, t(d["lam"]), DT, RHO, torch.float64)
    _, hvp = fk.g_and_hvp(t(d["v"]), t(d["u_prev"]), t(d["v_prev"]), t(d["f_ext"]), DT,
                          tsys.fem, pins)
    gm = make_fx(hvp)(t(d["p"][0]))
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert "tlfea.hv.default" in targets and "tlfea.node_reduce.default" in targets
    assert torch.equal(gm(t(d["p"][1])), hvp(t(d["p"][1])))


def test_resident_launch_refuses_to_be_traced(flagship_cell):
    """newton_resident is no operator: under make_fx it raises before it
    builds or launches anything."""
    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import StepState, newton

    _, tsys, nodes, d = flagship_cell
    state = StepState.rest(tsys, torch.as_tensor(nodes))
    params = newton.NewtonParams(dt=DT, rho=RHO)
    args = newton.inner_solve_args(tsys, state, torch.as_tensor(d["f_ext"]), params)
    with pytest.raises(RuntimeError, match="cannot be traced"):
        make_fx(lambda v0: resident.launch(v0, *args[1:])[0])(args[0])
