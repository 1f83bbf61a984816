"""Save the kernels' outputs and float32 device times, or compare two saved
files bit for bit: a check that a change to the kernels' sources leaves
their results as they were.

    python tlfea_torch/tools/kernel_outputs.py save OUT.pt [--no-fma]  # from a tree's root
    python tlfea_torch/tools/kernel_outputs.py compare A.pt B.pt
    python tlfea_torch/tools/kernel_outputs.py sass [--no-fma]         # from a tree's root

`save` imports `chip_smoke` and `tlfea_torch` from the current directory, so
run from the root of each tree to compare (for example this one and an
unpacked `git archive` of its parent), on the same card, in turns (parent,
this, this, parent). Inputs come from a numpy seed, in float32 and float64:
- the SVK element kernels K1-K5t and K4 at the 10k flagship's shapes;
- the Mooney-Rivlin element kernels K1 (fe and the prep cache), K2, K5 and
  K5t at the 10k flagship (`[feat10_mr]`), the 72 x 72 shell
  (`[ancf3443_mr]`) and the 64-element beam (`[ancf3243_mr]`), and K2
  again at the bench.py 1k box (864 elements, `[feat10_mr]`) and at the
  1,024-element beam (`[ancf3243_mr]`), and K5t again at the 1k box and the
  1,024-element beam, at chip_smoke's strained state (`ELEMENT_CASES`),
  whose K1 and K5 load the shape gradients and whose K2 and K5t run in the
  form and layout each instantiation chose (fem_kernels.cuh `Hold`,
  `hv_tile`'s and `contrib_tangent_kernel`'s STREAM, `Points`, `Slots`);
- K3 `svk_blocks` and K5t `contrib_tangent` with SVK at the 72 x 72 shell
  (`[ancf3443]`) and at the bench.py 1k box (`[feat10]`, 864 elements; the
  10k entries above hold the flagship), each of which may launch one thread
  an (element, slot), `Slots`;
- K1 (fe and the prep cache), K2, K3, K5 and K5t with SVK at the 64- and
  1,024-element beams (`[ancf3243]`, whose K1, K2 and K5 may launch one
  thread a quadrature point, and K3 and K5t one thread an (element, slot));
- K4 at the 100k box (`tools/ablate_hv`'s "100k");
- the persistent kernel of every (family, material) pair on one inner solve:
  FEAT10 x SVK and MR at the bench.py "1k" box, ANCF3243 x SVK and MR at
  64 and 1,024 elements. Its inputs are the state after 10 steps from rest
  through the plain twins (`system.plain`), so they do not depend on the
  kernels compared; its outputs are v and the stats tensor (iterations, CG
  total, ||g||, counts and the ||g|| history).
Device ms per launch come from `chip_smoke._device_ms` (float32). `save`
also times the bench.py "1k" rollout through the persistent kernel, as
chip_smoke's `[resident]` phase runs it (float32, 250 steps, after one
warm-up rollout), three times: host ms per step.

`--no-fma` builds every kernel with `nvcc -fmad=false` (in a build of its
own), so that no multiply and add are fused into one rounding: two trees
whose outputs differ only where the compiler fused differently agree bit
for bit when both are built so. `sass` prints, for each persistent-kernel
instantiation in the tree's build, its count of each floating-point
multiply, add and fused multiply-add instruction (`cuobjdump -sass`).

`compare` holds every output bit for bit, except the stats' `grid` entry,
which describes the launch (blocks, or the cluster size) and not the
result: it prints the two files' grids side by side, and their times,
without comparing them. Exit 0 when every output is bitwise equal.
"""

import os
import sys

import numpy as np
import torch

# (tag, chip_smoke builder, its arguments after (device, dtype)) of the
# persistent kernel's cases; "mr" in the material slot builds Mooney-Rivlin.
RESIDENT_CASES = (("feat10", "flagship_problem", ("RESIDENT_DIMS", None)),
                  ("feat10_mr", "flagship_problem", ("RESIDENT_DIMS", "mr")),
                  ("ancf3243_e64", "ancf_beam_problem", (64, None)),
                  ("ancf3243_mr_e64", "ancf_beam_problem", (64, "mr")),
                  ("ancf3243_e1024", "ancf_beam_problem", (1024, None)),
                  ("ancf3243_mr_e1024", "ancf_beam_problem", (1024, "mr")))
GRID = 6  # index of `grid` in the stats tensor (resident.STAT_FIELDS)
# (tag, chip_smoke builder, the name of its size argument there or None,
# kernels) of the element kernels' cases beside the flagship's SVK ones: K1,
# K2, K5 and K5t with Mooney-Rivlin at the builders' full sizes; K2 alone at
# the bench.py 1k box (864 elements, the size of chip_smoke's
# [composed_1k_mr]) and at the 1,024-element beam, saved as
# "hv[feat10_mr]_e864" and "hv[ancf3243_mr]_e1024", and K5t at the 1k box and
# the 1,024-element beam; K1, K2, K3, K5 and K5t with SVK at the 64- and
# 1,024-element beams ("contrib[ancf3243]", "svk_blocks[ancf3243]_e1024",
# ...); K3 and K5t with SVK at
# the 72 x 72 shell ("svk_blocks[ancf3443]", "contrib_tangent[ancf3443]")
# and at the 1k box ("svk_blocks[feat10]_e864", ...).
MR_KERNELS = ("primal_prep", "hv", "contrib", "contrib_tangent")
ELEMENT_CASES = (("feat10_mr", "flagship_problem", None, MR_KERNELS),
                 ("ancf3443_mr", "shell_problem", None, MR_KERNELS),
                 ("ancf3243_mr", "ancf_beam_problem", None, MR_KERNELS),
                 ("feat10_mr", "flagship_problem", "RESIDENT_DIMS", ("hv", "contrib_tangent")),
                 ("ancf3243_mr", "ancf_beam_problem", "BIG_BEAM", ("hv", "contrib_tangent")),
                 ("ancf3243", "ancf_beam_problem", None,
                  ("primal_prep", "hv", "svk_blocks", "contrib", "contrib_tangent")),
                 ("ancf3243", "ancf_beam_problem", "BIG_BEAM",
                  ("primal_prep", "hv", "svk_blocks", "contrib", "contrib_tangent")),
                 ("ancf3443", "shell_problem", None, ("svk_blocks", "contrib_tangent")),
                 ("feat10", "flagship_problem", "RESIDENT_DIMS", ("svk_blocks", "contrib_tangent")))


ROLLOUT_STEPS = 250  # chip_smoke's [resident] rollout
ROLLOUT_RUNS = 3
SASS_OPS = ("DFMA", "DMUL", "DADD", "FFMA", "FMUL", "FADD")


def _tree(no_fma: bool):
    """chip_smoke and fem_kernels of the tree at the current directory,
    the kernels built without fused multiply-adds if no_fma."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tlfea_torch.ops import fem_kernels as fk

    if no_fma:
        fk._NVCC_FLAGS.append("-fmad=false")
    return cs, fk


def save(path: str, no_fma: bool = False) -> None:
    cs, fk = _tree(no_fma)
    from tlfea_torch.tools import ablate_hv

    dev = torch.device("cuda")
    system = cs.flagship_problem("cpu", torch.float64)[0]
    box100k = cs.flagship_problem("cpu", torch.float64, ablate_hv.CONFIGS["100k"])[0]
    res = {"ms": {}, "no_fma": no_fma}
    for dtype in (torch.float32, torch.float64):
        op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
        rng = np.random.default_rng(0)
        n = op.n

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

        packed = t(np.concatenate([rng.normal(size=(n, 3)) * 1e-3, rng.normal(size=(n, 3)) * 1e-2,
                                   rng.normal(size=(n, 3))], 1))
        p, dp = t(rng.normal(size=(n, 3))), t(rng.normal(size=(n, 9)))
        u = (p * 1e-3).contiguous()
        fe, prep = fk.primal_prep(op, packed)
        op100k = fk.FemOperator(box100k.elems.to(dev, dtype), box100k.material)
        vals100k = t(rng.normal(size=(op100k.S * 3, op100k.E)))
        calls = {"primal_prep": lambda: fk.primal_prep(op, packed),
                 "hv": lambda: fk.hv(op, p, prep, 1e-3),
                 "svk_blocks": lambda: fk.svk_blocks(op, u),
                 "node_reduce": lambda: fk.node_reduce(op, fe),
                 "contrib": lambda: fk.contrib(op, packed),
                 "contrib_tangent": lambda: fk.contrib_tangent(op, packed, dp),
                 "node_reduce_100k": lambda: fk.node_reduce(op100k, vals100k)}
        out = {"prep": prep}
        for name, fn in calls.items():
            got = fn()
            out[name] = got[0] if isinstance(got, tuple) else got
        resident_calls = {}
        for case in RESIDENT_CASES:
            outs, call = _resident_outputs(cs, dev, dtype, *case)
            out.update(outs)
            resident_calls[f"newton_resident[{case[0]}]"] = call
        for case in ELEMENT_CASES:
            outs, case_calls = _element_outputs(cs, fk, dev, dtype, *case)
            out.update(outs)
            calls.update(case_calls)
        res[str(dtype)] = {k: v.cpu() for k, v in out.items()}
        if dtype == torch.float32:
            res["ms"] = {k: cs._device_ms(fn, 256)[0] for k, fn in calls.items()}
            res["ms"].update({k: cs._device_ms(fn, 16)[0] for k, fn in resident_calls.items()})
    res["rollout_ms"] = _rollout_ms(cs, dev)
    torch.save(res, path)
    print(os.getcwd(), {k: round(v * 1e3, 3) for k, v in res["ms"].items()}, "us per launch;",
          "1k rollout", [round(x, 4) for x in res["rollout_ms"]], "ms/step")


def _element_outputs(cs, fk, dev, dtype, tag, builder, size, kernels):
    """`kernels` of K1 (fe, prep), K2, K3, K5 and K5t `[tag]` (Mooney-Rivlin for
    a "_mr" tag, else the builder's SVK) on the random state of chip_smoke's
    `[kernels]` (u scaled by STRAIN_SCALE), keyed "<kernel>[<tag>]" (with
    "_e<E>" where a size is given); and calls that repeat each launch."""
    material = cs.mooney_rivlin() if tag.endswith("_mr") else None
    system = getattr(cs, builder)("cpu", torch.float64,
                                  *(() if size is None else (getattr(cs, size),)),
                                  material=material)[0]
    op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
    n = op.n
    rng = np.random.default_rng(1)
    packed = np.concatenate([rng.normal(size=(n, 3)) * 1e-3, rng.normal(size=(n, 3)) * 1e-2,
                             rng.normal(size=(n, 3))], 1)
    packed[:, :3] *= cs.STRAIN_SCALE.get(tag, 1.0)
    packed = torch.as_tensor(packed, dtype=dtype, device=dev).contiguous()
    p = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev).contiguous()
    dp = torch.as_tensor(rng.normal(size=(n, 9)), dtype=dtype, device=dev).contiguous()
    u = (p * 1e-3).contiguous()
    fe, prep = fk.primal_prep(op, packed)
    calls = {"primal_prep": lambda: fk.primal_prep(op, packed),
             "svk_blocks": lambda: fk.svk_blocks(op, u),
             "hv": lambda: fk.hv(op, p, prep, 1e-3),
             "contrib": lambda: fk.contrib(op, packed),
             "contrib_tangent": lambda: fk.contrib_tangent(op, packed, dp)}
    sfx = "" if size is None else f"_e{op.E}"
    out = {f"{k}[{tag}]{sfx}": calls[k]() for k in kernels if k != "primal_prep"}
    if "primal_prep" in kernels:
        out[f"primal_prep[{tag}]{sfx}"], out[f"prep[{tag}]{sfx}"] = fe, prep
    return out, {f"{k}[{tag}]{sfx}": calls[k] for k in kernels}


def _rollout_ms(cs, dev):
    """Host ms per step of the 1k rollout through the persistent kernel."""
    import time

    from tlfea_torch.solvers import newton

    system, state, f_ext, params = cs.flagship_problem(dev, torch.float32, cs.RESIDENT_DIMS)
    roll = newton.make_rollout(system, params, ROLLOUT_STEPS, precond_refresh=8)
    state, _ = roll(state, f_ext)
    torch.cuda.synchronize()
    out = []
    for _ in range(ROLLOUT_RUNS):
        t0 = time.perf_counter()
        state, _ = roll(state, f_ext)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / ROLLOUT_STEPS * 1e3)
    return out


def sass(no_fma: bool = False) -> None:
    """Per persistent-kernel instantiation of the tree at the current
    directory: its floating-point multiply, add and fma instruction counts."""
    import re
    import subprocess

    _, fk = _tree(no_fma)
    fk.build_kernels()
    bindir = os.path.dirname(fk._nvcc())
    for src in sorted(set(fk.RESIDENT_SOURCES.values())):
        so = fk.BUILD_INFO["sources"][src]["path"]
        dump = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass", so], check=True,
                              capture_output=True, text=True).stdout
        for block in dump.split("Function : ")[1:]:
            name = block.split(None, 1)[0]
            if "newton_resident_kernel" not in name:
                continue
            demangled = subprocess.run([os.path.join(bindir, "cu++filt"), name],
                                       capture_output=True, text=True).stdout.strip() or name
            counts = {op: len(re.findall(rf"\b{op}(?:\.[A-Z0-9]+)*\s", block)) for op in SASS_OPS}
            print(f"{'no fma ' if no_fma else ''}{src} {demangled}: "
                  + ", ".join(f"{op} {c}" for op, c in counts.items()), flush=True)


def _resident_outputs(cs, dev, dtype, tag, builder, extra):
    """v and the stats (NaN history slots as -1) of one launch of the
    persistent kernel on case `tag`, from the state after 10 steps through
    the twins; and a call that repeats the launch."""
    from dataclasses import replace

    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton

    size, material = extra
    size = getattr(cs, size) if isinstance(size, str) else size
    system, state, f_ext, params = getattr(cs, builder)(
        dev, dtype, size, cs.mooney_rivlin() if material == "mr" else None)
    plain = replace(system, plain=True)
    state, _ = newton.make_rollout(plain, params, 10, precond_refresh=8)(state, f_ext)
    args = newton.inner_solve_args(system, state, f_ext, params)
    v, stats = resident.launch(*args)
    return ({f"newton_resident[{tag}]_v": v,
             f"newton_resident[{tag}]_stats": stats.nan_to_num(-1.0)},
            lambda: resident.launch(*args))


def compare(a_path: str, b_path: str) -> bool:
    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for dtype in ("torch.float32", "torch.float64"):
        for k in a[dtype]:
            x, y = a[dtype][k], b[dtype][k]
            note = ""
            if k.endswith("_stats"):
                note = f" (grid {int(x[GRID])} vs {int(y[GRID])}, not compared)"
                x, y = torch.cat([x[:GRID], x[GRID + 1:]]), torch.cat([y[:GRID], y[GRID + 1:]])
            eq = torch.equal(x, y)
            same &= eq
            print(dtype, k, ("bitwise equal" if eq else
                             f"DIFFERS in {int((x != y).sum())} of {x.numel()} entries, max "
                             f"{float((x - y).abs().max()):.3e}") + note)
    for k in a["ms"]:
        print(f"float32 {k}: {a['ms'][k] * 1e3:.3f} vs {b['ms'].get(k, float('nan')) * 1e3:.3f} "
              f"us per launch")
    if "rollout_ms" in a and "rollout_ms" in b:
        print(f"float32 1k rollout through the persistent kernel: {a['rollout_ms']} vs "
              f"{b['rollout_ms']} ms/step")
    return same


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"]:
        save(sys.argv[2], "--no-fma" in sys.argv[3:])
    elif sys.argv[1:2] == ["compare"]:
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    elif sys.argv[1:2] == ["sass"]:
        sass("--no-fma" in sys.argv[2:])
    else:
        sys.exit(__doc__)
