"""The ported example scripts (`tlfea_torch.examples`) against the JAX
scripts of `examples/`, in float64 on the CPU.

`make_solver` with each solver on `beam_sag_feat10.py`'s problem (res 0: 36
elements), two steps in both packages: equal Newton / CG, inner or sweep
counts per step, positions within 1e-9 of the displacement scale. AdamW and
Nesterov run make_solver's parameters with the inner cap cut to 300, VBD
with its sweep cap cut to 60, in both packages (make_solver's 20,000 cap is
what AdamW reaches on this beam: 40,000 iterations a step, minutes in the
port's host loop). `_auto_coarse`'s
choice on either side of 50,000 nodes. Each ported script's `main()` at
--steps=3 --vtk_every=0 in float64 on the CPU beside the JAX script at the
same options, in a temporary directory: the CSV histories within 1e-9 (the
bunny, which writes no CSV, through its VTU files at --vtk_every=2).
"""

import importlib
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.example_parity import jax_examples as _jax_examples
from tests.example_parity import vtu_arrays as _vtu_arrays
from tlfea.constraints import FixedCoefs as JFixedCoefs
from tlfea.elements import feat10 as j_feat10
from tlfea.materials import SVK as JSVK
from tlfea.materials import lame_from_E_nu
from tlfea.simulation import gravity_force as j_gravity
from tlfea.solvers import StepState as JStepState
from tlfea.solvers import System as JSystem
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch.examples import _common as tcommon
from tlfea_torch.interop import from_numpy_system
from tlfea_torch.solvers.coarse import CoarsePrecond

torch.set_num_threads(2)

SCRIPTS = ("beam_sag_feat10", "beam_sag_ancf3243", "beam_sag_ancf3443", "bunny_deform")
CAP = 300  # AdamW / Nesterov inner cap in the make_solver comparison
SWEEPS = 60  # VBD's sweep cap there


@pytest.fixture(scope="module")
def beam():
    """beam_sag_feat10.py's problem at res 0 in both packages (float64)."""
    nodes, conn = box_t10_mesh(3.0, 2.0, 1.0, 3, 2, 1)
    lam, mu = lame_from_E_nu(5e6, 0.3)
    mat = JSVK(lam=lam, mu=mu, eta_damp=1e3, lam_damp=1e3)
    fixed = np.nonzero(nodes[:, 0] < nodes[:, 0].min() + 1e-9)[0]
    jsys = JSystem(elems=j_feat10.build(nodes, conn, rho=2700.0), material=mat,
                   constraints=JFixedCoefs.from_indices(fixed, nodes))
    jstate = JStepState.rest(jsys, nodes)
    tsys, tstate, _ = from_numpy_system(jsys.elems, jsys.material, jsys.constraints, jstate,
                                        device="cpu")
    return nodes, (jsys, jstate), (tsys, tstate), np.asarray(j_gravity(jsys))


def _capped(module, name, key, cap):
    """`module` with its `name` parameter class's `key` capped at `cap`."""
    cls = getattr(module, name)
    return SimpleNamespace(**{name: lambda **kw: cls(**{**kw, key: cap}),
                              "stepper": module.stepper, "prepare": getattr(module, "prepare",
                                                                            None)})


CAPS = {"adamw": ("AdamWParams", "max_inner", CAP), "nesterov": ("NesterovParams", "max_inner", CAP),
        "vbd": ("VBDParams", "max_sweeps", SWEEPS)}


_COUNTS = {"newton": ("newton_iters", "cg_iters"), "nesterov": ("outer_iters", "inner_iters"),
           "adamw": ("outer_iters", "inner_iters"), "vbd": ("outer_iters", "sweeps")}


@pytest.mark.parametrize("solver", ["newton", "nesterov", "adamw", "vbd"])
def test_make_solver_matches_jax(beam, solver, monkeypatch):
    """Two steps of each solver from make_solver in both packages: equal
    counts per step, x within 1e-9 of the displacement scale."""
    nodes, (jsys, jstate), (tsys, tstate), f_ext = beam
    jcommon = _jax_examples()
    if solver in CAPS:
        for common in (jcommon, tcommon):
            monkeypatch.setattr(common, solver, _capped(getattr(common, solver), *CAPS[solver]))
    jstep = jcommon.make_solver(solver, jsys, 1e-3, 1e9)
    tstep = tcommon.make_solver(solver, tsys, 1e-3, 1e9)
    fj, ft = jnp.asarray(f_ext), torch.as_tensor(f_ext)
    for _ in range(2):
        jstate, jd = jstep(jsys, jstate, fj)
        tstate, td = tstep(tsys, tstate, ft)
        assert [int(td[k]) for k in _COUNTS[solver]] == [int(jd[k]) for k in _COUNTS[solver]]
    jx = np.asarray(jstate.x)
    err = np.abs(tstate.x.numpy() - jx).max() / np.abs(jx - nodes).max()
    assert err < 1e-9, err


def test_auto_coarse_choice(beam, monkeypatch):
    """The dense full-precision form with 512 aggregates up to 50,000 nodes,
    bfloat16 tables with the range flag and 1,024 above, as the JAX
    `_auto_coarse` passes them; Mooney-Rivlin builds too (its small-strain
    moduli), and the result on the beam is the JAX script's."""
    assert tcommon.coarse_options(50_000) == dict(ranges=False, max_agg=512, mm_dtype=None)
    assert tcommon.coarse_options(50_001) == dict(ranges=True, max_agg=1024,
                                                  mm_dtype="bfloat16")
    jcommon = _jax_examples()
    import tlfea.elements.assembly as j_assembly
    import tlfea.solvers.coarse as j_coarse

    seen = {}
    for n in (50_000, 50_001):
        x0 = np.zeros((n, 3))
        monkeypatch.setattr(j_assembly, "node_ref", lambda elems, x0=x0: x0)
        monkeypatch.setattr(j_coarse, "build_coarse_precond",
                            lambda *a, **kw: seen.setdefault(("jax", n), kw))
        monkeypatch.setattr(tcommon, "node_ref", lambda elems, x0=x0: torch.as_tensor(x0))
        monkeypatch.setattr(tcommon, "build_coarse_precond",
                            lambda *a, **kw: seen.setdefault(("port", n), kw))
        fake = SimpleNamespace(material=SimpleNamespace(lam=1.0, mu=1.0), elems=None)
        jcommon._auto_coarse(fake, 1e-3, 1e9)
        tcommon._auto_coarse(fake, 1e-3, 1e9)
        assert seen[("port", n)] == seen[("jax", n)] == tcommon.coarse_options(n)
    monkeypatch.undo()
    _, (jsys, _), (tsys, _), _ = beam
    jco, tco = jcommon._auto_coarse(jsys, 1e-3, 1e9), tcommon._auto_coarse(tsys, 1e-3, 1e9)
    assert isinstance(tco, CoarsePrecond) and tco.mm_dtype is None and tco.n_agg == jco.n_agg
    np.testing.assert_allclose(tco.Ainv.numpy(), np.asarray(jco.Ainv), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jco.Ainv)).max())
    assert tcommon._auto_coarse(SimpleNamespace(material=object(), elems=None), 1e-3, 1e9) is None


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_main_matches_jax(script, tmp_path, monkeypatch):
    """main() at --steps=3 in both packages: the CSV within 1e-9 of the
    displacement scale (the bunny's VTU point fields at steps 0 and 2)."""
    jcommon = _jax_examples()
    jmod = importlib.import_module(script)
    tmod = importlib.import_module(f"tlfea_torch.examples.{script}")
    if hasattr(tmod, "REF_DATA"):
        monkeypatch.setattr(tmod, "REF_DATA", jcommon.REF_DATA)  # the same meshes
    vtk = "2" if script == "bunny_deform" else "0"
    argv = ["--steps=3", f"--vtk_every={vtk}"]
    outs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [script] + argv)
            jmod.main()
        else:
            tmod.main(argv + ["--device=cpu", "--dtype=float64"])
        files = sorted((d / "out" / script).iterdir())
        assert files, side
        outs[side] = {f.name: (_vtu_arrays(f) if f.suffix == ".vtu"
                               else {"tip_z": np.loadtxt(f, delimiter=",", skiprows=1)})
                      for f in files}
    assert outs["port"].keys() == outs["jax"].keys()
    for name, arrays in outs["jax"].items():
        assert outs["port"][name].keys() == arrays.keys(), name
        for field, want in arrays.items():
            got = outs["port"][name][field]
            assert got.shape == want.shape, (name, field)
            if field == "tip_z":  # the tips start at z = 0: tip_z is the displacement
                np.testing.assert_array_equal(got[:, 0], want[:, 0])
                got, want = got[:, 1], want[:, 1]
            assert np.abs(got - want).max() < 1e-9 * np.abs(want).max(), (name, field)
