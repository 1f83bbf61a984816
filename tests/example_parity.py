"""Running an example script of `examples/` and its port in
`tlfea_torch.examples` side by side, in float64 on the CPU, for the
`test_torch_*examples.py` files.

`run_pair` runs the JAX script's `main()` (options through sys.argv) and the
port's `main(argv + --device=cpu --dtype=float64)`, each in a directory of
its own, with the script's `Simulation` replaced by a subclass that records
every solver step (its Newton / CG counts and the state it returns) and
every collision call (its patches or DEM info). `assert_same_run` then holds the port to the JAX script: equal
counts per step, positions within 1e-9 of the run's displacement scale, the
same output files with their positions within the same bound, and equal
force-carrying contacts per step.
"""

from __future__ import annotations

import importlib
import os
import re
import sys

import numpy as np

import tlfea.simulation as j_simulation
import tlfea_torch.simulation as t_simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
POSITION_TOL = 1e-9  # of the displacement scale
COUNT_KEYS = ("outer_iters", "newton_iters", "cg_iters")  # of a Newton step's diag


def jax_examples():
    """The JAX scripts' `_common` (they import it from their own folder)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module("_common")


def vtu_arrays(path):
    """{name: values} of a VTU file's Float64 DataArrays."""
    text = open(path).read()
    blocks = re.findall(r'type="Float64" Name="(\w+)"[^>]*>\s*(.*?)\s*</DataArray>', text, re.S)
    return {name: np.array(b.split(), dtype=np.float64) for name, b in blocks}


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _recording(sim_cls, log):
    """`sim_cls` whose instances record each solver step and collision call
    into `log`, however the script drives them (`Simulation.step`, or the
    collision and `solver_step` called apart, as the sphere drop does)."""

    class Recording(sim_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            solver_step = self.solver_step
            x_rest = _np(self.state.x).copy()

            def recorded_step(system, state, f_ext):
                state, diag = solver_step(system, state, f_ext)
                log["counts"].append(tuple(int(_np(diag[c])) for c in COUNT_KEYS))
                log["x"].append((_np(state.x).copy(), x_rest))
                return state, diag

            self.solver_step = recorded_step
            if self.collision is not None:
                _record_calls(self.collision, log)
            log["sims"].append(self)

        def _check_overflow(self):
            before = self.collision
            super()._check_overflow()
            if self.collision is not before:  # regrown after an overflow
                _record_calls(self.collision, log)

    return Recording


def _record_calls(collision, log):
    """Append each `collision.step` call's patches (or DEM info) to log."""
    step = collision.step

    def recorded(x, v=None, params=None):
        out = step(x, v, params)
        log["contacts"].append(out[1])
        return out

    collision.step = recorded


def run_pair(script, argv, tmp_path, monkeypatch, jax_argv=None, before_jax=None):
    """Run the JAX script and its port at the same options (jax_argv, when
    given, for the JAX side alone). before_jax(jax_module) may patch the JAX
    module first. Returns {"jax" | "port": {"counts", "x" ((state, rest)
    a step), "contacts", "sims", "files": {name: path}}}."""
    jax_examples()
    jmod = importlib.import_module(script)
    tmod = importlib.import_module(f"tlfea_torch.examples.{script}")
    if before_jax is not None:
        before_jax(jmod)
    runs = {}
    for side, mod, sim_cls in (("jax", jmod, j_simulation.Simulation),
                               ("port", tmod, t_simulation.Simulation)):
        log = {"counts": [], "x": [], "contacts": [], "sims": []}
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.setattr(mod, "Simulation", _recording(sim_cls, log))
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [script] + (argv if jax_argv is None else jax_argv))
            mod.main()
        else:
            log["result"] = mod.main(argv + ["--device=cpu", "--dtype=float64"])
        out = d / "out"
        log["files"] = {str(p.relative_to(out)): p for p in sorted(out.rglob("*")) if p.is_file()}
        runs[side] = log
    return runs


def _file_values(path):
    if path.suffix == ".vtu":
        return vtu_arrays(path)
    if path.suffix == ".csv":
        return {"csv": np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)}
    return {}


NOISE_AREA = 1e-12  # of the largest patch's area: below it an area is rounding noise


def force_carrying(patches, floor):
    """The mask of patches that carry force: valid, oriented, and of area
    above `floor`."""
    return _np(patches.valid) & _np(patches.valid_orientation) & (_np(patches.area) > floor)


def same_contacts(tp, jp, step):
    """A collision call's contacts in both packages. Patches whose validity
    or force differs must be slivers whose area is rounding noise, at most
    NOISE_AREA of the largest patch's in both (the JAX CPU backend fuses
    products and sums into FMAs, the port does not: a degenerate patch of
    area ~1e-20 m^2 may be valid, or above `patch_forces`' 1e-18 threshold,
    in one package only); the force-carrying patches, those above that
    floor, are the same pairs. DEM info: equal contact counts. Returns the
    force-carrying count."""
    if not hasattr(jp, "valid"):
        n = int(_np(jp.n_contacts))
        assert int(_np(tp.n_contacts)) == n, step
        return n
    ja, ta = _np(jp.area), _np(tp.area)
    floor = NOISE_AREA * max(float(np.abs(ja).max()), 1e-300)
    ju, tu = force_carrying(jp, 1e-18), force_carrying(tp, 1e-18)
    differ = ju != tu
    assert (ja[differ] <= floor).all() and (ta[differ] <= floor).all(), step
    fj, ft = force_carrying(jp, floor), force_carrying(tp, floor)
    assert (fj == ft).all(), step
    return int(fj.sum())


def assert_same_run(runs, contact=False):
    """The port's run against the JAX script's: equal counts per step, the
    states of every step within POSITION_TOL of the displacement scale,
    the same output files with every VTU array and CSV column within that
    bound (the CSVs' time column exactly), and with `contact`, equal
    force-carrying contacts at every collision call, at least one of them
    in contact. Returns the per-call force-carrying counts."""
    j, t = runs["jax"], runs["port"]
    assert t["counts"] == j["counts"] and len(j["counts"]) > 0
    scale = max(np.abs(x - rest).max() for x, rest in j["x"])
    assert scale > 0
    for k, ((xt, _), (xj, _)) in enumerate(zip(t["x"], j["x"])):
        assert np.abs(xt - xj).max() < POSITION_TOL * scale, (k, np.abs(xt - xj).max() / scale)
    assert t["files"].keys() == j["files"].keys() and j["files"]
    for name, path in j["files"].items():
        want, got = _file_values(path), _file_values(t["files"][name])
        assert got.keys() == want.keys(), name
        for field, w in want.items():
            g = got[field]
            assert g.shape == w.shape, (name, field)
            if field == "csv":
                np.testing.assert_array_equal(g[:, 0], w[:, 0])  # time or step
                g, w = g[:, 1:], w[:, 1:]
            assert np.abs(g - w).max() < POSITION_TOL * scale, (name, field)
    n = [same_contacts(tp, jp, k)
         for k, (tp, jp) in enumerate(zip(t["contacts"], j["contacts"]))]
    assert len(t["contacts"]) == len(j["contacts"])
    if contact:
        assert max(n) > 0, n
    return n
