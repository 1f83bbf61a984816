"""Time other instantiations of the kernels beside the shipped ones, in
float32 on the card.

    python -m tlfea_torch.tools.kernel_variants [part ...]   # from the repository root

Parts (all when none is named):
  elements  K1-K3 at the 10k FEAT10 flagship and the 5,184-element shell
            shapes (SVK), and K1, K2 and K5t with Mooney-Rivlin at the
            shell's and at the 64-element ANCF3243 beam's shapes: variants
            of the quadrature-point split NG and of where the partial sums
            live;
  k4        K4's walk in its forms (one incidence at a time, batches of
            4-32 per (node, channel), a thread per node) at the 10k box, the
            100k box and the shell, each checked bit for bit against the
            shipped K4, beside `index_add_`;
  barriers  97 grid barriers of a cooperative launch at the persistent
            kernel's grids (27 and 32 blocks) and 97 cluster barriers in
            one cluster of 2, 8 and 16 blocks, each against the same launch
            with no barrier: the cost of one barrier;
  resident  the persistent kernel at the 1k box (FEAT10 x SVK and MR) and
            the 1,024-element ANCF3243 beam with two thread slabs a block
            (shipped) and with one (kernel_variants.cu), each in a cluster
            of 16 and of 8 blocks, each held bit for bit against the
            shipped launch.

Builds `tlfea_torch/csrc/kernel_variants.cu` next to the library, prints its
ptxas report (registers and spills) and each variant's device time per
launch (`chip_smoke._device_ms`), each variant twice, in the order A B C ...
C B A.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from tlfea_torch.ops import fem_kernels as fk

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANTS = {"feat10": ["f10regs", "f10regs1"],
            "ancf3443": ["s4smem", "s6regs", "s8smem", "s8regs"],
            "ancf3443_mr": ["s4smem_mr", "s8smem_mr"],
            "ancf3243_mr": ["b4smem_mr"]}
# the kernels timed for each material
TIMED = {"svk": ("primal_prep", "hv", "svk_blocks"),
         "mr": ("primal_prep", "hv", "contrib_tangent")}
# K4's forms in kernel_variants.cu (tlfea_node_reduce_form_f32)
K4_FORMS = {"walk1": 0, "chan4": 1, "chan8": 2, "chan16": 3, "chan32": 4, "node8": 5,
            "node16": 6, "node4": 7}
# (label, cluster size (0: cooperative grid), blocks) of the barrier probe
BARRIER_GRIDS = (("grid", 0, 27), ("grid", 0, 32), ("cluster", 2, 2), ("cluster", 8, 8),
                 ("cluster", 16, 16))
BARRIERS = 97  # a 1k inner solve's barriers (PERF.md)
PROBE_THREADS = 160  # the FEAT10 persistent kernel's block


def _cs():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _library():
    fk.build_kernels()
    so = os.path.join(fk._BUILD, "libkernel_variants.so")
    res = subprocess.run([fk._nvcc(), *fk._NVCC_FLAGS, "-o", so,
                          os.path.join(fk._CSRC, "kernel_variants.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    for line in res.stderr.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("ptxas: " + line.split("ptxas info    :")[-1].strip())
    return ctypes.CDLL(so)


def _checked(fn, what):
    def call():
        err = fn()
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    return call


def elements(lib):
    cs = _cs()
    dev = torch.device("cuda")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    problems = {"feat10": cs.flagship_problem("cpu", torch.float64)[0],
                "ancf3443": cs.shell_problem("cpu", torch.float64)[0],
                "ancf3443_mr": cs.shell_problem("cpu", torch.float64, material=cs.mooney_rivlin())[0],
                "ancf3243_mr": cs.ancf_beam_problem("cpu", torch.float64,
                                                    material=cs.mooney_rivlin())[0]}
    for tag, system in problems.items():
        op = fk.FemOperator(system.elems.to(dev, torch.float32), system.material)
        nm = len(op.mat_args)
        sigs = {"primal_prep": [P] * 7 + [I] + [D] * nm + [P],
                "hv": [P] * 7 + [I] + [D] * (1 + nm) + [P],
                "svk_blocks": [P] * 5 + [I] + [D] * 2 + [P],
                "contrib_tangent": [P] * 7 + [I] + [D] * nm + [P]}
        rng = np.random.default_rng(cs.SEED)
        n = op.n
        packed = torch.as_tensor(np.concatenate([rng.normal(size=(n, 3)) * 1e-3,
                                                 rng.normal(size=(n, 3)) * 1e-2,
                                                 rng.normal(size=(n, 3))], 1),
                                 dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
        dp = torch.as_tensor(rng.normal(size=(n, 9)), dtype=torch.float32, device=dev)
        u = p * 1e-3
        fe_ref, prep = fk.primal_prep_plain(op, packed)
        ref = {"primal_prep": fe_ref, "hv": fk.hv_plain(op, p, prep, 1e-3)}
        if op.kind == "svk":
            ref["svk_blocks"] = fk.svk_blocks_plain(op, u)
        else:
            ref["contrib_tangent"] = fk.contrib_tangent_plain(op, packed, dp)
        names = [tag] + VARIANTS[tag]
        for v in names + names[::-1]:
            src, sym = (fk.build_kernels()[op.source], op.tag) if v == tag else (lib, v)
            row = []
            for k in TIMED[op.kind]:
                f = getattr(src, f"tlfea_{k}_{sym}_f32")
                f.argtypes, f.restype = sigs[k], ctypes.c_int
                out, pr = torch.empty_like(ref[k]), torch.empty_like(prep)
                s = torch.cuda.current_stream().cuda_stream
                args = {"primal_prep": (packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, out, pr, op.E,
                                        *op.mat_args, s),
                        "hv": (p, op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, out, op.E, 1e-3,
                               *op.mat_args, s),
                        "svk_blocks": (u, op.conn_t, op.gN_t, op.dV_t, out, op.E, op.lam, op.mu, s),
                        "contrib_tangent": (packed, dp, op.conn_t, op.gN_t, op.dV_t, op.Me_t, out,
                                            op.E, *op.mat_args, s)}[k]
                conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
                call = _checked(lambda f=f, conv=conv: f(*conv), f"{k}[{v}]")
                call()
                torch.cuda.synchronize()
                rel = float((out - ref[k]).abs().max() / ref[k].abs().max())
                if not rel <= 1e-5:
                    raise AssertionError(f"{k}[{v}] disagrees with its twin: {rel:.3e}")
                row.append(f"{k} {cs._device_ms(call, 256)[0] * 1e3:.2f} us")
            print(f"{tag} {v}: " + ", ".join(row), flush=True)


def k4(lib):
    """K4's forms, float32, C = 3 (the gradient's and Hv's node sums) and C =
    6 (the block-Jacobi blocks', and `[kernels]`' random values)."""
    from tlfea_torch.tools import ablate_hv

    cs = _cs()
    dev = torch.device("cuda")
    f = lib.tlfea_node_reduce_form_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes, f.restype = [I] + [P] * 4 + [I] * 3 + [P], ctypes.c_int
    systems = {"feat10 10k": cs.flagship_problem("cpu", torch.float64)[0],
               "feat10 100k": cs.flagship_problem("cpu", torch.float64,
                                                  ablate_hv.CONFIGS["100k"])[0],
               "ancf3443": cs.shell_problem("cpu", torch.float64)[0],
               "ancf3243 64": cs.ancf_beam_problem("cpu", torch.float64)[0]}
    for (label, system), C in ((ls, C) for ls in systems.items() for C in (3, 6)):
        op = fk.FemOperator(system.elems.to(dev, torch.float32), system.material)
        counts = (op.inc_ptr[1:] - op.inc_ptr[:-1]).cpu().numpy()
        print(f"{label}: {op.n} nodes, incidences a node mean {counts.mean():.2f}, max "
              f"{counts.max()}, {np.mean(counts > 16):.3f} of nodes above 16", flush=True)
        rng = np.random.default_rng(cs.SEED)
        vals = torch.as_tensor(rng.normal(size=(op.S * C, op.E)), dtype=torch.float32, device=dev)
        want = fk.node_reduce(op, vals)
        s = torch.cuda.current_stream().cuda_stream
        calls = {"shipped": lambda: fk.node_reduce(op, vals)}
        for name, form in K4_FORMS.items():
            out = torch.empty_like(want)
            call = _checked(lambda form=form, out=out: f(
                form, vals.data_ptr(), op.inc_ptr.data_ptr(), op.inc.data_ptr(), out.data_ptr(),
                op.n, op.E, C, s), f"node_reduce form {name}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"node_reduce form {name} differs from the shipped K4 at "
                                     f"{label}")
            calls[name] = call
        vals_l = vals.view(op.S, C, op.E).permute(2, 0, 1).reshape(op.E * op.S, C).contiguous()
        idx = op.conn.reshape(-1)
        acc = torch.zeros((op.n, C), dtype=torch.float32, device=dev)
        calls["index_add_"] = lambda: acc.index_add_(0, idx, vals_l)
        names = list(calls)
        times = {k: [] for k in names}
        for name in names + names[::-1]:
            times[name].append(cs._device_ms(calls[name], 256)[0] * 1e3)
        print(f"{label} C={C} (bitwise equal forms): " + ", ".join(
            f"{k} {min(v):.2f} us ({v[0]:.2f}/{v[1]:.2f})" for k, v in times.items()), flush=True)


def barriers(lib):
    cs = _cs()
    f = lib.tlfea_barrier_probe
    f.argtypes, f.restype = [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    s = torch.cuda.current_stream().cuda_stream
    calls = {}
    for label, cluster, blocks in BARRIER_GRIDS:
        for n in (0, BARRIERS):
            calls[(label, blocks, n)] = _checked(
                lambda cluster=cluster, blocks=blocks, n=n: f(cluster, blocks, PROBE_THREADS, n, s),
                f"{label} barrier probe")
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    keys = list(calls)
    times = {k: [] for k in keys}
    for k in keys + keys[::-1]:
        times[k].append(cs._device_ms(calls[k], 64)[0] * 1e3)
    for label, _, blocks in BARRIER_GRIDS:
        t0, t1 = min(times[(label, blocks, 0)]), min(times[(label, blocks, BARRIERS)])
        print(f"{label} of {blocks} blocks x {PROBE_THREADS} threads: {BARRIERS} barriers "
              f"{t1:.2f} us, none {t0:.2f} us: {(t1 - t0) / BARRIERS * 1e3:.1f} ns a barrier "
              f"(runs {times[(label, blocks, BARRIERS)]})", flush=True)


def resident(lib):
    """The persistent kernel at each (slabs, cluster) beside the shipped
    launch, each held bit for bit against it (the stats but `grid`)."""
    from tlfea_torch.ops import resident as rs
    from tlfea_torch.solvers import newton

    cs = _cs()
    dev = torch.device("cuda")
    cases = {"feat10": lambda dt: cs.flagship_problem(dev, dt, cs.RESIDENT_DIMS),
             "feat10_mr": lambda dt: cs.flagship_problem(dev, dt, cs.RESIDENT_DIMS,
                                                         cs.mooney_rivlin()),
             "ancf3243": lambda dt: cs.ancf_beam_problem(dev, dt, cs.BIG_BEAM)}
    s = torch.cuda.current_stream().cuda_stream
    for tag, make in cases.items():
        system, state, f_ext, params = make(torch.float32)
        state, _ = newton.make_rollout(system, params, 10, precond_refresh=8)(state, f_ext)
        args = newton.inner_solve_args(system, state, f_ext, params)
        v_ref, s_ref = rs.launch(*args)
        shipped = getattr(fk.build_kernels()[fk.RESIDENT_SOURCES[fk._untag(tag)]],
                          f"tlfea_newton_resident_{tag}_f32")
        variant = getattr(lib, f"tlfea_newton_resident_{tag}_s1_f32")
        variant.argtypes, variant.restype = shipped.argtypes, ctypes.c_int
        calls = {"shipped": lambda args=args: rs.launch(*args)}
        for slabs, fn in ((rs.SLABS, shipped), (1, variant)):
            for cluster in (16, 8):
                kargs, v, st = rs.kernel_args(*args)
                conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in kargs]
                call = _checked(lambda fn=fn, conv=conv, cluster=cluster: fn(*conv, cluster, s),
                                f"newton_resident[{tag}] slabs {slabs} cluster {cluster}")
                call()
                torch.cuda.synchronize()
                same = (torch.equal(v, v_ref) and torch.equal(st[:6], s_ref[:6])
                        and torch.equal(st[7:].nan_to_num(-1), s_ref[7:].nan_to_num(-1)))
                if not same:
                    raise AssertionError(f"newton_resident[{tag}] at {slabs} slabs, cluster "
                                         f"{cluster} differs from the shipped launch")
                calls[f"slabs{slabs}_c{cluster}"] = call
        names = list(calls)
        times = {k: [] for k in names}
        for name in names + names[::-1]:
            times[name].append(cs._device_ms(calls[name], 32)[0] * 1e3)
        st = rs.read_stats(s_ref)
        print(f"resident {tag} (E={system.fem.E}, {st['barriers']} barriers, cluster "
              f"{st['grid']}, bitwise equal): " + ", ".join(
                  f"{k} {min(v):.1f} us ({v[0]:.1f}/{v[1]:.1f})" for k, v in times.items()),
              flush=True)


PARTS = {"elements": elements, "k4": k4, "barriers": barriers, "resident": resident}


def main():
    sys.path.insert(0, ROOT)
    parts = sys.argv[1:] or list(PARTS)
    unknown = [p for p in parts if p not in PARTS]
    if unknown:
        sys.exit(f"kernel_variants: unknown part(s) {unknown}; parts: {', '.join(PARTS)}")
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device")
    print(_cs().card_line(), flush=True)
    lib = _library()
    for p in parts:
        PARTS[p](lib)


if __name__ == "__main__":
    main()
