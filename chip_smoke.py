"""Quick proof that the PyTorch/CUDA port (`tlfea_torch`) runs on an NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package `tlfea`. Phases, each
printed on its own line; any failure raises and exits non-zero:

1. setup: the card's name and power limit (nvidia-smi), the precision
   pins, and the nvcc build of the FEM kernels K1-K4 from
   `tlfea_torch/csrc/` (seconds, registers and spills per kernel).
2. kernels: each kernel against its plain PyTorch twin on the card, at the
   shapes of the 10,584-element flagship mesh, on inputs made from a seed:
   float64 within 1e-12 relative, float32 within 1e-5; and each timed
   beside its twin: device time per launch from CUDA events, and the
   host's time per wrapper call.
3. beam: the float32 beam sag (box 10x1x1, dt 1e-3, 150 steps) through the
   kernels, against `tests/fixtures/beam_sag_t10_tip.csv` (the float64 CPU
   trajectory of the JAX package) within 1e-6 of the displacement scale.
4. flagship: the `bench.py` "10k" problem (FEAT10 box 42x7x6, damped SVK,
   x=0 face pinned, float32, tolerance 2.5 % of ||f_ext||, frozen coarse
   correction, block-Jacobi refreshed every 8 steps): a warm-up 60-step
   rollout, then a timed one; ms/step, median Newton and CG counts,
   newton_capped_frac and the kernels' launch counts in the timed rollout,
   which must all be non-zero; a torch.profiler window of 16 more steps
   gives the device busy time per step and the largest device operations
   ([trace] lines). Then 5 steps from rest through the kernels and through
   the plain twins on the card, whose positions must agree within 5e-3 of
   the coordinate scale.

The last three lines are the kernels' JSON record, the nvidia-smi line and
`{"ok": true, "device": {...}}`.
"""

import json
import os
import subprocess
import sys
import time
import warnings
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "beam_sag_t10_tip.csv")
SEED = 0
BEAM_STEPS = 150  # the fixture's length
ROLLOUT = 60  # bench.py's ROLLOUT["10k"]
CHECK_STEPS = 5  # kernels against twins, from rest
TRACE_STEPS = 16  # profiled window

# (kernel, the TPU kernel it replaces)
KERNELS = [
    ("primal_prep", "tlfea/ops/pallas_fem.py:888"),
    ("hv", "tlfea/ops/pallas_fem.py:956"),
    ("svk_blocks", "tlfea/ops/pallas_fem.py:673"),
    ("node_reduce", "tlfea/ops/pallas_banded.py:689"),
]
KERNEL_SOURCE = "tlfea_torch/csrc/fem_kernels.cu"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def flagship_problem(device, dtype, dims=(2.0, 0.35, 0.3, 42, 7, 6)):
    """The bench.py "10k" problem: (system, state, f_ext, params)."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.solvers import StepState, System
    from tlfea_torch.solvers.newton import NewtonParams
    from tlfea_torch.utils.reorder import apply_node_order, best_order
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(*dims)
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
    lam, mu = lame_from_E_nu(1e7, 0.3)
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=dtype)
    # Host-side load: a fixed summation order, so every run gets the same f_ext.
    f_ext = torch.zeros((len(nodes), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems_cpu) * -9.81
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(
        elems=elems_cpu.to(device), material=SVK(lam, mu, 1e3, 1e3),
        constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0),
    )
    tol = 2.5e-2 * float(f_ext.norm())
    params = NewtonParams(dt=1e-3, rho=1e7, inner_atol=tol, inner_rtol=0.0, outer_tol=0.0,
                          max_outer=1, max_inner=6, cg_rtol=1e-3, cg_max_iter=50,
                          ew_eta_max=0.5)
    return system, StepState.rest(system, x0), f_ext.to(device), params


def _device_ms(fn, n):
    """Device ms per call over n back-to-back calls (CUDA events), and the
    host ms per call. A spin kernel holds the stream while the host queues
    the calls, so the events time the device work and not the host's
    launch overhead. The host gets ahead only while the launch queue has
    room (about a thousand launches), so n halves, and the spin doubles,
    until it does."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    cycles = 1 << 24
    while n >= 1:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        ahead = not start.query()  # the device had not reached the first call yet
        end.record()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / n, host * 1e3 / n
        n, cycles = n // 2, cycles * 2
    raise RuntimeError("the host never got ahead of the device; no device timing")


def phase_kernels(device):
    """Each kernel against its twin at the flagship shapes; returns
    {name: (f32 max abs err, kernel ms, twin ms)}."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk

    system, _, _, params = flagship_problem("cpu", torch.float64)
    n, dt = system.n_coef, params.dt
    rng = np.random.default_rng(SEED)
    host = dict(packed=np.concatenate([rng.normal(size=(n, 3)) * 1e-3,
                                       rng.normal(size=(n, 3)) * 1e-2,
                                       rng.normal(size=(n, 3))], axis=1),
                p=rng.normal(size=(n, 3)), u=rng.normal(size=(n, 3)) * 1e-3)
    E, S = system.elems.n_elem, system.elems.n_shape
    host["vals"] = rng.normal(size=(S * 6, E))
    out = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        op = fk.FemOperator(system.elems.to(device, dtype), system.material)
        x = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in host.items()}
        _, prep = fk.primal_prep_plain(op, x["packed"])
        args = {"primal_prep": (x["packed"],), "hv": (x["p"], prep, dt),
                "svk_blocks": (x["u"],), "node_reduce": (x["vals"],)}
        for name, _ in KERNELS:
            got = getattr(fk, name)(op, *args[name])
            want = getattr(fk, name + "_plain")(op, *args[name])
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
            ok = all(torch.isfinite(g).all() for g in got) and rel <= tol
            log("kernels", f"{name} {str(dtype)[6:]}: max rel err {rel:.3e} (tol {tol:g}), "
                f"max abs err {abs_err:.3e}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its twin in {dtype}: {rel:.3e}")
            if dtype == torch.float32:
                def k_call(name=name):
                    return getattr(fk, name)(op, *args[name])

                def p_call(name=name):
                    return getattr(fk, name + "_plain")(op, *args[name])

                # In turns on one card: twin, kernel, kernel, twin.
                p1, ph = _device_ms(p_call, 16)
                k1, kh = _device_ms(k_call, 256)
                k2, _ = _device_ms(k_call, 256)
                p2, _ = _device_ms(p_call, 16)
                ms, plain_ms = min(k1, k2), min(p1, p2)
                log("kernels", f"{name} float32 at E={E}: device {ms:.4f} ms per launch, twin "
                    f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x); host {kh:.4f} ms per wrapper "
                    f"call, twin {ph:.4f} ms")
                out[name] = (abs_err, ms, plain_ms)
    return out


def beam_sag(device, dtype):
    """Tip trajectory of the damped cantilever of tests/fixtures/generate.py
    through the kernels; returns (max deviation / displacement scale,
    seconds)."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.solvers import StepState, System, newton
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 10, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=dtype)
    f_ext = torch.zeros((len(nodes), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems_cpu) * -9.81
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(elems=elems_cpu.to(device), material=SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    step = newton.make_step(system, newton.NewtonParams(
        dt=1e-3, rho=1e8, inner_atol=1e-8, inner_rtol=1e-10, outer_tol=1e-10, max_outer=2,
        max_inner=10, cg_rtol=1e-6, cg_max_iter=500, ew_eta_max=0.0))
    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    state = StepState.rest(system, x0)
    f_ext = f_ext.to(device)
    rows = []
    t0 = time.perf_counter()
    for _ in range(BEAM_STEPS):
        state, _ = step(state, f_ext)
        rows.append(state.x[tip])
    rows = torch.stack(rows).double().cpu().numpy()
    secs = time.perf_counter() - t0
    ref = np.loadtxt(FIXTURE, delimiter=",", skiprows=1)[:, 1:4]
    scale = np.abs(ref - nodes[tip]).max()
    return float(np.abs(rows - ref).max() / scale), secs


def trace(roll, state, f_ext, ms_per_step):
    """Where the time goes: a torch.profiler window over TRACE_STEPS of the
    rollout; device busy time per step against the untraced ms/step, and
    the device operations that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the profiler's note on event cycles
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            roll(state, f_ext)
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy = sum(t for t, _ in by_name.values()) / TRACE_STEPS
    ops = sum(c for _, c in by_name.values()) / TRACE_STEPS
    log("trace", f"device busy {busy:.3f} ms/step = {busy / ms_per_step:.3f} of the untraced "
        f"{ms_per_step:.3f} ms/step; {ops:.0f} device operations per step")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log("trace", f"{t / TRACE_STEPS:.4f} ms/step, {c / TRACE_STEPS:.1f} calls/step: {name[:90]}")


def flagship(device, dims=(2.0, 0.35, 0.3, 42, 7, 6)):
    """The bench.py 10k rollout through the kernels. Returns the launch
    counts of the timed rollout."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    system, state0, f_ext, params = flagship_problem(device, torch.float32, dims)
    t0 = time.perf_counter()
    coarse = build_coarse_precond(system, state0.x, params.dt, params.rho, max_agg=512)
    sync()
    log("flagship", f"{system.elems.n_elem} elems, {system.n_coef} nodes, "
        f"{int(system.constraints.idx.numel())} pinned; coarse: {coarse.n_agg} aggregates "
        f"x 6 modes, built in {time.perf_counter() - t0:.2f} s")
    roll = newton.make_rollout(system, params, ROLLOUT, coarse=coarse, precond_refresh=8)
    t0 = time.perf_counter()
    s, _ = roll(state0, f_ext)
    sync()
    log("flagship", f"warm-up rollout ({ROLLOUT} steps): {time.perf_counter() - t0:.2f} s")

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    s, (nit, cgit) = roll(s, f_ext)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    if not bool(torch.isfinite(s.x).all()) or s.x.shape != state0.x.shape:
        raise AssertionError("flagship rollout state is not finite")
    nit, cgit = np.asarray(nit), np.asarray(cgit)
    ms = wall / ROLLOUT * 1e3
    log("flagship", f"timed rollout: {ROLLOUT} steps in {wall:.3f} s = {ms:.3f} ms/step; "
        f"newton/step median {np.median(nit):g}, cg/step median {np.median(cgit):g}, "
        f"newton_capped_frac {float((nit >= params.max_inner).mean()):.3f}, "
        f"max |u| {float(s.u.abs().max()):.4e}")
    log("flagship", f"launches in the timed rollout: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if device.type == "cuda":
        trace(newton.make_rollout(system, params, TRACE_STEPS, coarse=coarse, precond_refresh=8),
              s, f_ext, ms)

    # The same steps from rest, through the kernels and through the twins.
    finals = {}
    for plain in (False, True):
        sysx = replace(system, plain=plain)
        t0 = time.perf_counter()
        sx, (nx, cx) = newton.make_rollout(sysx, params, CHECK_STEPS, coarse=coarse,
                                           precond_refresh=8)(state0, f_ext)
        sync()
        log("flagship", f"{CHECK_STEPS} steps from rest via {'twins' if plain else 'kernels'}: "
            f"{(time.perf_counter() - t0) / CHECK_STEPS * 1e3:.3f} ms/step, newton {nx}, cg {cx}")
        finals[plain] = sx.x
    diff = float((finals[False] - finals[True]).abs().max())
    rel_coord = diff / float(finals[True].abs().max())
    rel_disp = diff / float((finals[True] - state0.x).abs().max())
    log("flagship", f"kernels vs twins after {CHECK_STEPS} steps: max |dx| {diff:.3e}, "
        f"{rel_coord:.3e} of the coordinate scale (bar 5e-3), {rel_disp:.3e} of the "
        f"displacement scale")
    if not rel_coord < 5e-3:
        raise AssertionError(f"kernel path disagrees with the twin path: {rel_coord:.3e}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tlfea_torch")):
        print(f"chip_smoke: no tlfea_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tlfea_torch
    from tlfea_torch.ops import fem_kernels as fk

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log("setup", f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log("setup", f"precision pins: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()!r} "
        f"(tlfea_torch {tlfea_torch.__version__})")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    fk.build_kernels()
    log("setup", f"built {os.path.relpath(fk.BUILD_INFO['path'], ROOT)} in "
        f"{fk.BUILD_INFO['seconds']:.1f} s (nvcc, sm_90a)")
    for line in fk.BUILD_INFO.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("setup", "ptxas: " + line.split("ptxas info    :")[-1].strip())

    timings = phase_kernels(device)

    dev, secs = beam_sag(device, torch.float32)
    log("beam", f"float32 beam sag, {BEAM_STEPS} steps in {secs:.2f} s: max tip deviation from the "
        f"float64 fixture {dev:.3e} of the displacement scale (bar 1e-6)")
    if not dev < 1e-6:
        raise AssertionError(f"beam sag deviates {dev:.3e} of the displacement scale")

    launches = flagship(device)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": timings[name][0],
         "ms": timings[name][1], "plain_ms": timings[name][2]}
        for name, replaces in KERNELS
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
