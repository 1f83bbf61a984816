"""The phase ablation of the Hv kernel (`tlfea_torch.ops.hv_phases`) and its
entry point (`tlfea_torch.tools.ablate_hv`), the port of
`benchmarks/ablate_banded_hv.py`.

On the CPU each variant's wrapper runs its plain twin; the twins are held,
on a 6 x 2 x 2 FEAT10 box (144 elements, damped SVK, float64, inputs from
a numpy seed) at the script's point packed = [0 | v | 0]:

- gfe (K2) against the JAX element Hv, `jax.jvp` of
  `assembly._element_contrib_values` along the Newton chain, 1e-12;
- full (K2 + K4) against the tangent of `jax.linearize(grad_L)` of the same
  box without constraints (so no pin terms), 1e-12;
- dma_win, dma_wininv, dma, gather and scat against numpy versions of the
  ported phases' sums, built from the JAX element batch's arrays. The
  script's own bodies are TPU-only (`interpret=False`) and the script builds
  the 100k box when imported, so it is not run; its TPU bodies write
  node-window rows, so what the ported touch phases sum (the raw 32-bit
  words of each table they read, mod 2^32, one row a table) is the port's
  choice, held here;
- the touch check (`ablate_hv.differing_tables`) against a planted skip: a
  kernel that skips a table, or every other row of it, reads nothing there,
  which for a word sum is reading zeros, so the variant run on that table
  zeroed must be refused, naming that table and no other.

The tool builds bench.py's boxes from the script's CONFIGS (read from its
source), 864 / 10,584 / 101,376 elements, counted from the cells. The
kernels themselves are held against these twins on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py` `[hv_phases]`.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import _element_contrib_values
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.solvers import System as JSystem
from tlfea.solvers.common import grad_L
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.elements import feat10
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.materials import MooneyRivlin
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.ops import hv_phases as hp
from tlfea_torch.tools import ablate_hv

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 1e-3
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def box():
    """(JAX system without constraints, port operator, v, p, prep at
    [0 | v | 0]) on the 6 x 2 x 2 box."""
    nodes, conn = box_t10_mesh(1.0, 0.25, 0.25, 6, 2, 2)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = JSVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
               eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(1e3))
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=1000.0), material=mat)
    tsys, _, _ = from_numpy_system(jsys.elems, mat, device="cpu")
    op = tsys.fem
    rng = np.random.default_rng(17)
    v = 0.1 * rng.normal(size=(op.n, 3))
    p = rng.normal(size=(op.n, 3))
    zero = np.zeros_like(v)
    _, prep = fk.primal_prep_plain(op, torch.as_tensor(np.concatenate([zero, v, zero], 1)))
    return jsys, nodes, op, v, p, prep


def test_gfe_twin_matches_jax_element_hv(box):
    """gfe (K2's twin) against jax.jvp of the element contribution at
    [u | v | dv/dt] = [0 | v | 0] (u_prev = -dt v, v_prev = v) along the
    Newton chain (dt p, p, p/dt), per (element, slot)."""
    jsys, _, op, v, p, prep = box
    u_prev, v_prev = jnp.asarray(-DT * v), jnp.asarray(v)

    def contrib(w):
        return _element_contrib_values(u_prev + DT * w, w, (w - v_prev) / DT, jsys.elems,
                                       jsys.material)

    _, ref = jax.jvp(contrib, (jnp.asarray(v),), (jnp.asarray(p),))
    want = np.transpose(np.asarray(ref), (1, 2, 0)).reshape(op.S * 3, op.E)
    got = hp.gfe(op, torch.as_tensor(p), prep, DT)
    assert torch.equal(got, hp.gfe_plain(op, torch.as_tensor(p), prep, DT))
    assert _rel(got.numpy(), want) < RTOL


def test_full_twin_matches_jax_linearize(box):
    """full (K2 + K4) against jax.linearize(grad_L) of the box without
    constraints: the node Hv without pin terms."""
    jsys, nodes, op, v, p, prep = box
    u_prev = -DT * v

    def g(w):
        return grad_L(w, jnp.asarray(nodes + u_prev), jnp.asarray(v), None,
                      jnp.zeros((op.n, 3)), DT, 1e7, jsys, u_prev=jnp.asarray(u_prev))

    _, f_jvp = jax.linearize(g, jnp.asarray(v))
    got = hp.full(op, torch.as_tensor(p), prep, DT)
    assert _rel(got.numpy(), f_jvp(jnp.asarray(p))) < RTOL


def _numpy_sums(name, jsys, op, p, prep):
    """What each touch phase sums, from the JAX element batch's arrays
    (element-major) and numpy: per table, its raw 32-bit words added mod
    2^32, as int32."""
    el = jsys.elems
    conn = np.asarray(el.conn)
    E = conn.shape[0]
    G = -(-E // 32)

    def words(a):
        return np.ascontiguousarray(a).view(np.uint32).astype(np.uint64)

    def wrap(sums):
        return (np.asarray(sums, dtype=np.uint64) % (1 << 32)).astype(np.uint32).view(np.int32)

    def slabs(w):
        per = -(-w.size // G)
        return [w[b * per:(b + 1) * per].sum() for b in range(G)]

    if name == "dma_win":
        return wrap([slabs(words(p).reshape(-1))])
    if name == "dma_wininv":
        return wrap([slabs(words(t).reshape(-1)) for t in (p, op.inc_ptr.numpy(), op.inc.numpy())])
    if name == "dma":
        per_elem = [conn.astype(np.int32), np.asarray(prep).T, np.asarray(el.grad_N),
                    np.asarray(el.dV), np.asarray(el.mass_elem)]
        return wrap([words(a).reshape(E, -1).sum(1) for a in per_elem])
    return wrap([words(p)[conn].reshape(E, -1).sum(1)])  # gather


@pytest.mark.parametrize("name", ["dma_win", "dma_wininv", "dma", "gather"])
def test_touch_twins_match_numpy(box, name):
    """The touch phases' word sums, one row a table (`hv_phases.ROWS`),
    against numpy's, bit for bit."""
    jsys, _, op, _, p, prep = box
    x = prep if name == "dma" else torch.as_tensor(p)
    twin = getattr(hp, name + "_plain")
    got = getattr(hp, name)(op, x)
    assert torch.equal(got, twin(op, x)) and got.dtype == torch.int32
    want = _numpy_sums(name, jsys, op, p, prep.numpy())
    assert got.shape == want.shape == (len(hp.ROWS[name]), got.shape[1])
    assert np.array_equal(got.numpy(), want)


SKIPS = [(v, t, part) for v, tables in hp.ROWS.items() for t in tables
         for part in ("all", "every other row")]


@pytest.mark.parametrize("variant,table,part", SKIPS)
def test_touch_check_refuses_a_skipped_table(box, variant, table, part):
    """The word sums of a variant that skipped a table, wholly or every
    other row, differ from the twin's in that table's row and no other,
    however small its values beside the other tables' (gN_t's signed sum
    per QP is 0, dV_t's about the element's volume)."""
    _, _, op, _, p, prep = box
    p = torch.as_tensor(p)
    x_of = lambda p, prep: prep if variant == "dma" else p  # noqa: E731
    want = getattr(hp, variant + "_plain")(op, x_of(p, prep))
    sop, sp, sprep = ablate_hv.plant_skip(op, p, prep, table, part)
    got = getattr(hp, variant)(sop, x_of(sp, sprep))
    assert ablate_hv.differing_tables(variant, got, want) == [table]
    assert ablate_hv.differing_tables(variant, getattr(hp, variant)(op, x_of(p, prep)),
                                      want) == []


def test_check_refuses_every_planted_skip(box):
    """`ablate_hv.check_refuses_skips`, which chip_smoke runs on the card,
    plants both skips of every touch table and passes."""
    _, _, op, _, p, prep = box
    assert ablate_hv.check_refuses_skips(op, torch.as_tensor(p), prep, DT,
                                         log=lambda m: None) == 2 * len(
        [t for tables in hp.ROWS.values() for t in tables])


def test_scat_twin_matches_scatter_add(box):
    """scat (K4's twin) of the cheap (S*3, E) buffer of p's words against
    numpy's unbuffered node sums over the JAX connectivity."""
    jsys, _, op, _, p, _ = box
    fes = hp.scat_buffer(op, torch.as_tensor(p))
    assert fes.shape == (op.S * 3, op.E)
    assert np.array_equal(fes.numpy().reshape(-1), np.resize(p.reshape(-1), op.S * 3 * op.E))
    want = np.zeros((op.n, 3))
    np.add.at(want, np.asarray(jsys.elems.conn).reshape(-1),
              fes.numpy().reshape(op.S, 3, op.E).transpose(2, 0, 1).reshape(-1, 3))
    got = hp.scat(op, fes)
    assert torch.equal(got, hp.scat_plain(op, fes))
    assert _rel(got.numpy(), want) < RTOL


def test_wrappers_take_the_twins_on_cpu_and_check_holds(box):
    """On CPU tensors every wrapper runs its twin and launches nothing;
    `ablate_hv.check` holds each variant to its twin there too; the
    wrappers refuse another material and shapes the kernels do not take."""
    _, _, op, _, p, prep = box
    fk.reset_launch_counts()
    errs = ablate_hv.check(op, torch.as_tensor(p), prep, DT, log=lambda m: None)
    assert set(errs) == set(hp.VARIANTS) and max(e[1] for e in errs.values()) == 0.0
    assert all(v == 0 for v in fk.LAUNCHES.values())
    with pytest.raises(ValueError, match="expected a contiguous"):
        hp.gather(op, torch.as_tensor(p)[:-1])
    nodes, conn = box_t10_mesh(1.0, 0.25, 0.25, 6, 2, 2)
    mr = fk.FemOperator(feat10.build(nodes, conn, rho=1000.0, device="cpu"),
                        MooneyRivlin(1e6, 2e5, 5e6, 1e3, 1e3))
    with pytest.raises(ValueError, match="FEAT10 with SVK"):
        hp.dma_win(mr, torch.as_tensor(p))


def test_ablate_hv_builds_the_scripts_boxes():
    """The tool's CONFIGS are the script's (read from its source, which
    builds the 100k box when imported); their cells give 864, 10,584 and
    101,376 elements; the 1k problem has that many, with K1's prep cache
    and the seeded direction."""
    src = open(os.path.join(ROOT, "benchmarks", "ablate_banded_hv.py")).read()
    node = next(n for n in ast.parse(src).body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CONFIGS")
    assert ablate_hv.CONFIGS == ast.literal_eval(node.value)
    assert {s: ablate_hv.elements(s) for s in ablate_hv.CONFIGS} == {
        "1k": 864, "10k": 10584, "100k": 101376}
    op, p, prep, dt = ablate_hv.problem("1k", torch.device("cpu"))
    assert (op.E, op.family, op.kind, dt) == (864, "feat10", "svk", 1e-3)
    assert p.dtype == torch.float32 and p.shape == (op.n, 3)
    assert prep.shape == (op.Q * op.prep_rows, op.E) and bool(torch.isfinite(prep).all())


def test_ablate_hv_work_counts(box):
    """Bytes and operations behind each variant's bound: gfe and scat are
    K2's and K4's (`chip_smoke._pass_work`), full and prod both without
    the (S*3, E) values between them, dma every table word once."""
    cs = ablate_hv._cs()
    _, _, op, _, _, _ = box
    E, S, Q = op.E, op.S, op.Q
    assert ablate_hv.work("gfe", op) == cs._pass_work("hv", op)
    assert ablate_hv.work("scat", op) == cs._pass_work("node_reduce", op, C=3)
    tables = S * E + Q * op.prep_rows * E + Q * S * 3 * E + Q * E + S * S * E
    assert ablate_hv.work("dma", op) == (tables + 5 * E, tables)
    w2, w4 = cs._pass_work("hv", op)[0], cs._pass_work("node_reduce", op, C=3)[0]
    assert ablate_hv.work("full", op)[0] == ablate_hv.work("prod", op)[0] == w2 + w4 - 6 * S * E
