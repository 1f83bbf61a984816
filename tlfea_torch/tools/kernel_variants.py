"""Time other instantiations of the kernels beside the shipped ones, in
float32 on the card.

    python -m tlfea_torch.tools.kernel_variants [part ...]   # from the repository root

Parts (all when none is named):
  elements  K1-K3 at the 10k FEAT10 flagship and the 5,184-element shell
            shapes (SVK): variants of the quadrature-point split NG and of
            where the partial sums live; then K1 and K5 with Mooney-Rivlin
            at the 10k flagship, the shell and the 64-element ANCF3243
            beam, with each way of loading a quadrature point's shape
            gradients (`MR_TILE_VARIANTS`; fem_kernels.cuh `Hold`: none,
            late, early, stream) beside the shipped kernel, float32 and
            float64, and SVK's K1 and K5 with them held (`SVK_TILES`), each
            held bit for bit against the shipped kernel, and the floor of
            an empty launch of the same grid;
  beams     K1 and K5 `[ancf3243_mr]` as in `elements` on beams of
            `BEAMS` elements (64 to 32,768);
  hv        K2 `hv` with Mooney-Rivlin in each form of `HV_FORMS`
            (kernel_variants.cu: the parent; the point's operands streamed
            through shared memory, `smem`, fem_kernels.cuh `hv_tile`'s
            STREAM; the chain reading the prep rows where it uses them,
            `rows`; each with no register cap and under __launch_bounds__
            for 2 and 3 blocks an SM, `_lb2`, `_lb3`) beside the shipped
            kernel at `HV_CASES` (the 10k
            flagship, the 1k box, the bunny's 96-element fallback mesh, the
            72 x 72 shell, the 64-element beam), float32 and float64: each
            form held bit for bit against the shipped kernel (the shipped
            within 1e-5, float64 1e-12, of its twin), timed twice in the
            order A B C ... C B A, with its registers, local (spill) bytes
            and blocks an SM from the CUDA runtime, ptxas's spill stores,
            and its waves over the card's SMs; and the floor of an empty
            launch of the grid with each form's shared memory;
  split     K1 `primal_prep[ancf3243]` and K2 `hv[ancf3243]` (SVK) in each
            form of `SPLIT_FORMS` (kernel_variants.cu: the parent layout,
            thread (x, g) walking points g, g + 4, g + 8 of 32 elements a
            block; one thread a quadrature point, fem_kernels.cuh
            `Points<TE, HOLD>`, TE = 8 or 16 (32 at the first beam only)
            elements x 12 points a block, a point's operands loaded where
            used, `none`, into registers before the gather, `early`, or
            copied into shared memory by cp.async, `stream`; and
            `split8_direct`, each point thread gathering its own element's
            slots with no staging and no first barrier), and the shipped
            split K5 `contrib[ancf3243]` and K2 `hv[ancf3243_mr]` in the
            parent and `split8_direct` (`SPLIT_KERNELS`), beside the
            shipped kernel on
            beams of `SPLIT_BEAMS` elements, float32 and float64 (a form
            splits at every E; the shipped kernel up to its gate, MAX_E):
            each form held bit for bit against the shipped kernel (K1's fe
            and prep; a difference is printed), the shipped within 1e-5
            (float64 1e-12) of its twin and K5 equal to K1's fe, timed twice
            in the order A B C ... C B A, with its registers, local bytes,
            ptxas's spill stores, blocks an SM, waves, block shape and
            shared memory, and the floor of an empty launch of its grid; the
            shipped row names the forms whose block and bits it has;
  blocks    K3 `svk_blocks[ancf3443]` (SVK) in each form of `BLOCKS_FORMS`
            (kernel_variants.cu: the parent tile, thread (x, g) walking
            points g, g + 4, ... of 32 elements with its 96 sums in shared
            memory; `stream`, the same walk with each round's gradient rows
            and dV row copied by cp.async into a two-stage ring;
            `slots<TE>_<NQ>`, fem_kernels.cuh `Slots`: one thread an
            (element, slot), TE = 8 or 16 elements a block, chunks of NQ = 4
            or 8 points copied into shared memory by the block, the sums in
            registers; `slots<TE>_<NQ>_nocopy`, kernel_variants.cu, the
            same reading global memory) beside the shipped kernel on the SVK shells of
            `BLOCKS_SHELLS` (24 x 24, 72 x 72, 144 x 144 elements), float32
            and float64: each form held bit for bit against the shipped
            kernel (the shipped within 1e-5, float64 1e-12, of its twin),
            timed twice in the order A B C ... C B A, with its registers,
            local bytes, ptxas's spill stores, blocks an SM, waves, block
            shape, shared memory and the empty launch of its grid; the
            shipped row names the forms whose block and bits it has; and
            K3 `svk_blocks[feat10]` in the parent, `stream` and
            `slots16_5` / `slots32_5` (one chunk of all 5 points) at
            `FEAT10_SIZES` (864, 10,584 and 101,376 elements);
  tangent   K5t `contrib_tangent` in its forms (kernel_variants.cu: the
            parent; `stream`, a point's operands copied into shared memory
            by cp.async, fem_kernels.cuh `contrib_tangent_stream_tile`;
            `stream_fused`, kernel_variants.cu, the four contractions in one
            pass; each of the
            two also under __launch_bounds__' minimum of 3 blocks an SM,
            `_lb3`, float32) beside the shipped kernel at `TANGENT_CASES`
            (`[feat10_mr]` at the bunny's 96 elements, the 1k box and the
            10k flagship); K5t `[feat10]` (SVK) in the parent, `stream`
            and `slots16_5` / `slots32_5` at `FEAT10_SIZES`; and K5t
            `[ancf3443]` (SVK) and `[ancf3443_mr]` in the parent, `stream`
            and `slots<TE>_<NQ>` (fem_kernels.cuh `Slots`,
            `contrib_tangent_slots_kernel`: one thread an (element, slot),
            TE = 8 or 16 elements a block, chunks of NQ = 4, 8 or 16 points
            copied into shared memory by the block; (8, 16) and (16, 8) in
            float32 only) on the damped shells of `BLOCKS_SHELLS`; float32
            and float64, as `blocks` reports them;
  tangent_gate  K5t `[ancf3443]` in the parent and `slots8_8` on the
            shells between (`TANGENT_GATE_CASES`: 7,056 to 17,424
            elements), as `tangent` reports them: where the float64 gate
            goes;
  blocks_feat10, tangent_feat10  the FEAT10 rows of `blocks` and
            `tangent` alone;
  blocks_beam, tangent_beam  K3 `svk_blocks[ancf3243]`, and K5t
            `contrib_tangent[ancf3243_mr]` (damped) and `[ancf3243]` (SVK),
            on the cantilevers of `SPLIT_BEAMS` (64 to 32,768 elements) in the
            parent and in `Slots<TE, 4>` (TE 4, 8, 16: three chunks of 4
            points, double-buffered) and `Slots<TE, 12>` (TE 4, 8: one chunk
            of all 12 points, a block of TE x 12 threads), float32 and
            float64, as `blocks` reports them;
  tangent_beam_gate  K5t `contrib_tangent[ancf3243]` (SVK) in the parent
            and `slots8_12` on the cantilevers of `GATE_BEAMS` (64 to
            32,768 elements, 2,048 and 16,384 among them), float32 and
            float64: where its float32 gate goes;
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
import re
import subprocess
import sys

import numpy as np
import torch

from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.tools import ablate_hv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANTS = {"feat10": ["f10regs", "f10regs1"],
            "ancf3443": ["s4smem", "s6regs", "s8smem", "s8regs"]}
TIMED = ("primal_prep", "hv", "svk_blocks")  # SVK's variants
# K1/K5 with each `Hold` of kernel_variants.cu beside the shipped kernel:
# tlfea_{primal_prep,contrib}_<family>_<hold>_mr_<sfx>, float32 and float64
# (no stream at ANCF3443 in float64: it does not fit a block's shared memory).
HOLDS = ["none", "late", "early", "stream"]
MR_TILE_VARIANTS = {tag: HOLDS for tag in ("feat10_mr", "ancf3443_mr", "ancf3243_mr")}
MR_TILE_VARIANTS_F64 = {**MR_TILE_VARIANTS, "ancf3443_mr": HOLDS[:3]}
# SVK's K1/K5 (shipped loading the gradients where used) with them held in
# registers: a finding only.
SVK_TILES = {"feat10": ["late", "early"], "ancf3443": ["late", "early"]}
TILE_TIMED = ("primal_prep", "contrib")
NG = {"feat10": 5, "ancf3243": 4, "ancf3443": 4}  # each family's quadrature-point groups
BEAMS = (64, 1024, 8192, 32768)  # ANCF3243 beam lengths of `beams`
SPLIT_BEAMS = (64, 1024, 2048, 4096, 8192, 32768)  # and of `split`
# K2's forms in kernel_variants.cu (tlfea_hv_<family>_<form>_mr_<sfx>)
HV_FORMS = ["parent", "lb2", "lb3", "smem", "smem_lb2", "smem_lb3", "rows", "rows_lb2",
            "rows_lb3", "smem_rows", "smem_rows_lb2", "smem_rows_lb3"]
# (tag, chip_smoke builder, the name of its size argument there or None) of
# `hv`'s shapes: the 10k flagship, the bench.py 1k box, the bunny's fallback
# mesh, the 72 x 72 shell, the 64-element beam
HV_CASES = (("feat10_mr", "flagship_problem", None),
            ("feat10_mr", "flagship_problem", "RESIDENT_DIMS"),
            ("feat10_mr", "flagship_problem", "BUNNY_DIMS"),
            ("ancf3443_mr", "shell_problem", None), ("ancf3243_mr", "ancf_beam_problem", None))
HV_DT = 1e-3
# `split`'s kernels on the ANCF3243 beam (kernel_variants.cu:
# tlfea_<kernel>_ancf3243_<form>[_mr]_<sfx>): (label, kernel, material, the
# beams of SPLIT_BEAMS it runs on). K1 and K2 with SVK in every form; K5
# (SVK) and K2 `[ancf3243_mr]` in the parent layout and the direct form
# beside their shipped split, at the lengths where it ships.
SPLIT_KERNELS = (("primal_prep", "primal_prep", "svk", SPLIT_BEAMS),
                 ("hv", "hv", "svk", SPLIT_BEAMS),
                 ("contrib", "contrib", "svk", SPLIT_BEAMS[:2]),
                 ("hv_mr", "hv", "mr", SPLIT_BEAMS[:2]))
# Their forms: the parent layout, split<TE>_<hold> (TE = 32 at the first
# beam only) and split8_direct.
SPLIT_HOLDS = ("none", "early", "stream")  # fem_kernels.cuh `Hold` 0, 2, 3
_ALL_FORMS = (["parent"] + [f"split{te}_{h}" for h in SPLIT_HOLDS for te in (8, 16, 32)]
              + ["split8_direct"])
SPLIT_FORMS = {"primal_prep": _ALL_FORMS, "hv": _ALL_FORMS,
               "contrib": ["parent", "split8_direct"], "hv_mr": ["parent", "split8_direct"]}
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


PTXAS = []  # the variants library's ptxas report, line by line


def _library():
    fk.build_kernels()
    so = os.path.join(fk._BUILD, "libkernel_variants.so")
    res = subprocess.run([fk._nvcc(), *fk._NVCC_FLAGS, "-o", so,
                          os.path.join(fk._CSRC, "kernel_variants.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    for line in res.stderr.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            PTXAS.append(line.split("ptxas info    :")[-1].strip())
            print("ptxas: " + PTXAS[-1])
    return ctypes.CDLL(so)


def _hv_spills():
    """{(T "f" or "d", S, STREAM, ROWS, MINB): ptxas's spill stores in bytes}
    of the Mooney-Rivlin K2 variants, from their mangled names:
    hv_kernel<T, F, M, STREAM> (MINB 1) or hv_capped_kernel<T, F, M, STREAM,
    MINB>, M MrMat or MrRows (ROWS)."""
    pat = re.compile(r"hv_(?:capped_)?kernelI([fd]).*?FamilyILi(\d+)E.*?(MrMat|MrRows)I[fd]E+"
                     r"Lb([01])E(?:Li(\d+)E)?")
    out, key = {}, None
    for line in PTXAS:
        m = pat.search(line) if "Compiling entry" in line else None
        if m:
            key = (m[1], int(m[2]), m[4] == "1", m[3] == "MrRows", int(m[5] or 1))
        elif key is not None and "spill stores" in line:
            out[key] = int(line.split(" bytes spill stores")[0].split(",")[-1])
            key = None
    return out


def _split_spills():
    """{(kernel, T "f" or "d", form): ptxas's spill stores in bytes} of
    `split`'s forms, kernel one of SPLIT_KERNELS' labels ("primal_prep",
    "hv", "contrib" with SVK, "hv_mr"), from their mangled names:
    primal_points_kernel<T, F, M, PREP, TE, HOLD, DIRECT> (K1 if PREP, else
    K5), hv_points_kernel<T, F, M, TE, HOLD, DIRECT>, and the parents
    primal_prep_kernel / contrib_kernel<T, F, SvkMat, Hold::none> and
    hv_kernel<T, F, M, false>, F = ANCF3243."""
    holds = {"0": "none", "2": "early", "3": "stream"}
    beam = r"I([fd])NS_6FamilyILi8ELi12E.*?(SvkMat|MrMat)I[fd]EE"
    split = re.compile(r"(primal|hv)_points_kernelI([fd]).*?(SvkMat|MrMat)I[fd]EE"
                       r"(?:Lb([01])E)?Li(\d+)EL\w*?HoldE(\d)ELb([01])E")
    parents = (re.compile(r"(primal_prep|contrib)_kernel" + beam + r"L\w*?HoldE0E"),
               re.compile(r"(hv)_kernel" + beam + r"Lb0E"))

    def label(kernel, mat, prep=None):
        if kernel == "primal":
            kernel = "primal_prep" if prep == "1" else "contrib"
        return kernel + ("_mr" if mat == "MrMat" else "")

    out, key = {}, None
    for line in PTXAS:
        if "Compiling entry" in line:
            m = split.search(line)
            mp = next((x for x in (pat.search(line) for pat in parents) if x), None)
            key = ((label(m[1], m[3], m[4]), m[2],
                    f"split{m[5]}_" + ("direct" if m[7] == "1" else holds[m[6]])) if m else
                   (label(mp[1], mp[3]), mp[2], "parent") if mp else None)
        elif key is not None and "spill stores" in line:
            out[key] = int(line.split(" bytes spill stores")[0].split(",")[-1])
            key = None
    return out


def _split_smem(kernel, form, op, itemsize):
    """The dynamic shared memory of a `split` form's launch on op: the
    parent tile's (K1, K5 smem_bytes<T, F, 9, 3>, K2 <3, 3>), PointSmem's,
    or the direct form's (the points' rows alone)."""
    cin = 3 if kernel == "hv" else 9
    if form == "parent":
        return (op.S * cin + NG["ancf3243"] * op.S * 3) * 32 * itemsize
    te, hold = form[5:].split("_")
    if hold == "direct":
        return op.Q * (op.S * 3 + 1) * int(te) * itemsize
    stream = hold == "stream"
    rows = op.S * 3 + 1 + (op.prep_rows if stream and kernel == "hv" else 0)
    return (op.S * cin + op.Q * rows + (op.S * op.S if stream else 0)) * int(te) * itemsize


def _form_key(dtype, S, form):
    """The _hv_spills key of a form of HV_FORMS."""
    minb = int(form[-1]) if "lb" in form else 1
    return ("f" if dtype == torch.float32 else "d", S, "smem" in form, "rows" in form, minb)


def _checked(fn, what):
    def call():
        err = fn()
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    return call


def _tile_args(op, x, out, prep, s):
    """A K1 (prep given) or K5 (prep None) entry's arguments."""
    head = (x["packed"], op.conn_t, op.gN_t, op.dV_t, op.Me_t, out)
    args = head + ((prep,) if prep is not None else ()) + (op.E, *op.mat_args, s)
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def _inputs(cs, op, tag, dtype, dev):
    rng = np.random.default_rng(cs.SEED)
    n = op.n
    packed = np.concatenate([rng.normal(size=(n, 3)) * 1e-3, rng.normal(size=(n, 3)) * 1e-2,
                             rng.normal(size=(n, 3))], 1)
    packed[:, :3] *= cs.STRAIN_SCALE.get(tag, 1.0)
    host = dict(packed=packed, p=rng.normal(size=(n, 3)), dp=rng.normal(size=(n, 9)))
    x = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in host.items()}
    x["u"] = x["p"] * 1e-3
    return x


def _svk_variants(lib, cs, tag, system):
    dev = torch.device("cuda")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    op = fk.FemOperator(system.elems.to(dev, torch.float32), system.material)
    nm = len(op.mat_args)
    sigs = {"primal_prep": [P] * 7 + [I] + [D] * nm + [P],
            "hv": [P] * 7 + [I] + [D] * (1 + nm) + [P],
            "svk_blocks": [P] * 5 + [I] + [D] * 2 + [P]}
    x = _inputs(cs, op, tag, torch.float32, dev)
    fe_ref, prep = fk.primal_prep_plain(op, x["packed"])
    ref = {"primal_prep": fe_ref, "hv": fk.hv_plain(op, x["p"], prep, 1e-3),
           "svk_blocks": fk.svk_blocks_plain(op, x["u"])}
    names = [tag] + VARIANTS[tag]
    for v in names + names[::-1]:
        src, sym = (fk.build_kernels()[op.source], op.tag) if v == tag else (lib, v)
        row = []
        for k in TIMED:
            f = getattr(src, f"tlfea_{k}_{sym}_f32")
            f.argtypes, f.restype = sigs[k], ctypes.c_int
            out, pr = torch.empty_like(ref[k]), torch.empty_like(prep)
            s = torch.cuda.current_stream().cuda_stream
            args = {"primal_prep": (x["packed"], op.conn_t, op.gN_t, op.dV_t, op.Me_t, out, pr,
                                    op.E, *op.mat_args, s),
                    "hv": (x["p"], op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, out, op.E, 1e-3,
                           *op.mat_args, s),
                    "svk_blocks": (x["u"], op.conn_t, op.gN_t, op.dV_t, out, op.E, op.lam, op.mu,
                                   s)}[k]
            conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
            call = _checked(lambda f=f, conv=conv: f(*conv), f"{k}[{v}]")
            call()
            torch.cuda.synchronize()
            rel = float((out - ref[k]).abs().max() / ref[k].abs().max())
            if not rel <= 1e-5:
                raise AssertionError(f"{k}[{v}] disagrees with its twin: {rel:.3e}")
            row.append(f"{k} {cs._device_ms(call, 256)[0] * 1e3:.2f} us")
        print(f"{tag} {v}: " + ", ".join(row), flush=True)


def _tiles(lib, cs, tag, system, variants, variants_f64):
    """K1 and K5 of `tag` in the shipped tile and in `variants[tag]`
    (tlfea_{primal_prep,contrib}_<family>_<variant>[_mr]_<sfx>), float32
    (float64: `variants_f64`, if it names the tag): each output bit for bit
    the shipped kernel's (and the shipped within 1e-5, float64 1e-12, of its
    twin), each timed twice in the order A B C ... C B A; then the floor of
    an empty launch of the same grid."""
    dev = torch.device("cuda")
    family, kind = fk._untag(tag)
    mr = "_mr" if kind == "mr" else ""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    empty = lib.tlfea_empty_launch
    empty.argtypes, empty.restype = [I, I, I, P], ctypes.c_int
    s = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.float64):
        if dtype == torch.float64 and tag not in variants_f64:
            continue
        op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
        sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        nm = len(op.mat_args)
        x = _inputs(cs, op, tag, dtype, dev)
        shipped = {"primal_prep": fk.primal_prep(op, x["packed"])[0],
                   "contrib": fk.contrib(op, x["packed"])}
        fe_ref, prep_ref = fk.primal_prep_plain(op, x["packed"])
        torch.cuda.synchronize()
        rel = float((shipped["primal_prep"] - fe_ref).abs().max() / fe_ref.abs().max())
        if not rel <= (1e-5 if dtype == torch.float32 else 1e-12):
            raise AssertionError(f"primal_prep[{tag}] {sfx} disagrees with its twin: {rel:.3e}")
        names = ["shipped"] + (variants if dtype == torch.float32 else variants_f64)[tag]
        calls = {}
        for v in names:
            for k in TILE_TIMED:
                out = torch.empty_like(shipped[k])
                prep = torch.empty_like(prep_ref) if k == "primal_prep" else None
                if v == "shipped":
                    f = getattr(fk.build_kernels()[op.source], f"tlfea_{k}_{tag}_{sfx}")
                else:
                    f = getattr(lib, f"tlfea_{k}_{family}_{v}{mr}_{sfx}")
                    f.argtypes = [P] * (7 if prep is not None else 6) + [I] + [D] * nm + [P]
                    f.restype = ctypes.c_int
                conv = _tile_args(op, x, out, prep, s)
                call = _checked(lambda f=f, conv=conv: f(*conv), f"{k}[{tag} {v} {sfx}]")
                call()
                torch.cuda.synchronize()
                same = torch.equal(out, shipped[k])
                if prep is not None:
                    same = same and torch.equal(prep, fk.primal_prep(op, x["packed"])[1])
                if not same:
                    raise AssertionError(f"{k}[{tag}] {v} {sfx} differs from the shipped kernel "
                                         f"in {int((out != shipped[k]).sum())} entries")
                calls[(v, k)] = call
        keys = list(calls)
        times = {key: [] for key in keys}
        for key in keys + keys[::-1]:
            times[key].append(cs._device_ms(calls[key], 256)[0] * 1e3)
        for v in names:
            print(f"{tag} {sfx} E={op.E} {v} (bitwise the shipped): " + ", ".join(
                f"{k} {min(times[(v, k)]):.2f} us ({times[(v, k)][0]:.2f}/{times[(v, k)][1]:.2f})"
                for k in TILE_TIMED), flush=True)
        # the grid of K1 and K5, with the shared memory of the tile that loads
        # the gradients where used: xs (S 9 rows) and the NG S 3 partials
        blocks, threads = -(-op.E // 32), 32 * NG[family]
        smem = (op.S * 9 + NG[family] * op.S * 3) * 32 * dtype.itemsize
        call = _checked(lambda: empty(blocks, threads, smem, s), "empty")
        print(f"{tag} {sfx} empty launch of {blocks} blocks x {threads} threads, {smem} B: "
              f"{cs._device_ms(call, 256)[0] * 1e3:.2f} us", flush=True)


def elements(lib):
    cs = _cs()
    mr = cs.mooney_rivlin()
    for tag, system in (("feat10", cs.flagship_problem("cpu", torch.float64)[0]),
                        ("ancf3443", cs.shell_problem("cpu", torch.float64)[0])):
        _svk_variants(lib, cs, tag, system)
        _tiles(lib, cs, tag, system, SVK_TILES, {})
    for tag, system in (("feat10_mr", cs.flagship_problem("cpu", torch.float64, material=mr)[0]),
                        ("ancf3443_mr", cs.shell_problem("cpu", torch.float64, material=mr)[0]),
                        ("ancf3243_mr", cs.ancf_beam_problem("cpu", torch.float64,
                                                             material=mr)[0])):
        _tiles(lib, cs, tag, system, MR_TILE_VARIANTS, MR_TILE_VARIANTS_F64)


def beams(lib):
    cs = _cs()
    for n in BEAMS:
        system = cs.ancf_beam_problem("cpu", torch.float64, n, material=cs.mooney_rivlin())[0]
        _tiles(lib, cs, "ancf3243_mr", system, MR_TILE_VARIANTS, MR_TILE_VARIANTS_F64)


def hv(lib):
    """K2 `[<family>_mr]` in each form of HV_FORMS beside the shipped kernel
    at HV_CASES, float32 and float64 (see the module's docstring)."""
    cs = _cs()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    empty = lib.tlfea_empty_launch
    empty.argtypes, empty.restype = [I, I, I, P], ctypes.c_int
    s = torch.cuda.current_stream().cuda_stream
    spills = _hv_spills()
    mr = cs.mooney_rivlin()
    for tag, builder, size in HV_CASES:
        family = fk._untag(tag)[0]
        system = getattr(cs, builder)("cpu", torch.float64,
                                      *(() if size is None else (getattr(cs, size),)),
                                      material=mr)[0]
        for dtype in (torch.float32, torch.float64):
            op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
            sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
            x = _inputs(cs, op, tag, dtype, dev)
            prep = fk.primal_prep(op, x["packed"])[1]
            shipped = fk.hv(op, x["p"], prep, HV_DT)
            want = fk.hv_plain(op, x["p"], prep, HV_DT)
            torch.cuda.synchronize()
            rel = float((shipped - want).abs().max() / want.abs().max())
            if not rel <= (1e-5 if dtype == torch.float32 else 1e-12):
                raise AssertionError(f"hv[{tag}] {sfx} E={op.E} disagrees with its twin: "
                                     f"{rel:.3e}")
            calls = {"shipped": lambda op=op, x=x, prep=prep: fk.hv(op, x["p"], prep, HV_DT)}
            occ = {"shipped": fk.occupancy("hv", tag, dtype, op.E)}
            notes = {"shipped": f"twin rel err {rel:.2e}"}
            for v in HV_FORMS:
                f = getattr(lib, f"tlfea_hv_{family}_{v}_mr_{sfx}")
                f.argtypes = [P] * 7 + [I] + [D] * (1 + len(op.mat_args)) + [P]
                f.restype = ctypes.c_int
                out = torch.empty_like(shipped)
                conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in
                        (x["p"], op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, out, op.E, HV_DT,
                         *op.mat_args, s)]
                call = _checked(lambda f=f, conv=conv: f(*conv), f"hv[{tag} {v} {sfx}]")
                call()
                torch.cuda.synchronize()
                if torch.equal(out, shipped):
                    notes[v] = "bitwise the shipped"
                else:
                    diff = float((out - shipped).abs().max() / shipped.abs().max())
                    notes[v] = (f"DIFFERS from the shipped in {int((out != shipped).sum())} of "
                                f"{out.numel()} entries, max rel {diff:.2e}")
                o = getattr(lib, f"tlfea_occupancy_hv_{family}_{v}_mr_{sfx}")
                o.argtypes, o.restype = [ctypes.POINTER(I)], ctypes.c_int
                res = (I * 5)()
                if o(res) != 0:
                    raise RuntimeError(f"hv[{tag} {v} {sfx}]: occupancy query failed")
                occ[v] = {"regs": res[0], "local_bytes": res[1], "blocks_per_sm": res[2]}
                calls[v] = call
            keys = list(calls)
            times = {k: [] for k in keys}
            for k in keys + keys[::-1]:
                times[k].append(cs._device_ms(calls[k], 256)[0] * 1e3)
            blocks = fk.launch_blocks("hv", op)
            for v in keys:
                o = occ[v]
                waves = -(-blocks // (o["blocks_per_sm"] * n_sm)) if o["blocks_per_sm"] else 0
                sp = spills.get(_form_key(dtype, op.S, "parent" if v == "shipped" else v))
                print(f"hv[{tag}] {sfx} E={op.E} {v}: {min(times[v]):.2f} us "
                      f"({times[v][0]:.2f}/{times[v][1]:.2f}), {o['regs']} registers, "
                      f"{o['local_bytes']} B local"
                      + ("" if sp is None or v == "shipped" else f" ({sp} B spill stores)")
                      + f", {o['blocks_per_sm']} blocks an SM, {waves} wave(s) of {blocks} "
                      f"blocks; {notes[v]}", flush=True)
            threads = 32 * NG[family]
            for label, stream in (("parent", False), ("smem", True)):
                rows = op.S * 3 + NG[family] * op.S * 3
                if stream:
                    rounds = op.Q // NG[family]
                    rows += min(rounds, 2) * NG[family] * (op.S * 3 + 1 + op.prep_rows)
                smem = rows * 32 * dtype.itemsize
                call = _checked(lambda smem=smem: empty(blocks, threads, smem, s), "empty")
                print(f"hv[{tag}] {sfx} empty launch of {blocks} blocks x {threads} threads, "
                      f"{smem} B ({label}): {cs._device_ms(call, 256)[0] * 1e3:.2f} us",
                      flush=True)


def _split_case(op, kernel, x, s):
    """(shipped output(s), the plain twin's, the C entry's arguments before
    and after the output(s), its argtypes, a call of the shipped wrapper, a
    note) of one `split` kernel on op."""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    nm = len(op.mat_args)
    if kernel == "hv":
        prep = fk.primal_prep(op, x["packed"])[1]
        shipped = (fk.hv(op, x["p"], prep, HV_DT),)
        want = (fk.hv_plain(op, x["p"], prep, HV_DT),)
        return (shipped, want, (x["p"], op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t),
                (op.E, HV_DT, *op.mat_args, s), [P] * 7 + [I] + [D] * (1 + nm) + [P],
                lambda: fk.hv(op, x["p"], prep, HV_DT), "")
    fn = getattr(fk, kernel)
    got = fn(op, x["packed"])
    shipped = got if isinstance(got, tuple) else (got,)
    want = getattr(fk, kernel + "_plain")(op, x["packed"])
    want = want if isinstance(want, tuple) else (want,)
    k5 = fk.contrib(op, x["packed"]) if kernel == "primal_prep" else shipped[0]
    if not torch.equal(k5, fk.primal_prep(op, x["packed"])[0]):
        raise AssertionError(f"contrib[{op.tag}] E={op.E} differs from K1's fe")
    return (shipped, want, (x["packed"], op.conn_t, op.gN_t, op.dV_t, op.Me_t),
            (op.E, *op.mat_args, s), [P] * (5 + len(shipped)) + [I] + [D] * nm + [P],
            lambda: fn(op, x["packed"]), ", K5 equal to K1's fe")


def split(lib):
    """`split`'s kernels in their forms beside the shipped kernel on beams
    of SPLIT_BEAMS elements, float32 and float64 (see the module's
    docstring)."""
    cs = _cs()
    for n in SPLIT_BEAMS:
        systems = {}
        for label, kernel, material, beams in SPLIT_KERNELS:
            if n not in beams:
                continue
            if material not in systems:
                mat = cs.mooney_rivlin() if material == "mr" else None
                systems[material] = cs.ancf_beam_problem("cpu", torch.float64, n,
                                                         material=mat)[0]
            forms = [v for v in SPLIT_FORMS[label] if n == SPLIT_BEAMS[0] or "split32" not in v]
            _split_kernel(lib, cs, label, kernel, systems[material], forms)


def _split_kernel(lib, cs, label, kernel, system, forms):
    """One `split` kernel on one beam in `forms` beside the shipped kernel,
    float32 and float64."""
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    I = ctypes.c_int
    empty = lib.tlfea_empty_launch
    empty.argtypes, empty.restype = [I, I, I, ctypes.c_void_p], ctypes.c_int
    s = torch.cuda.current_stream().cuda_stream
    spills = _split_spills()
    for dtype in (torch.float32, torch.float64):
        op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
        sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        mr = "_mr" if op.kind == "mr" else ""
        x = _inputs(cs, op, op.tag, dtype, dev)
        shipped, want, head, tail, argtypes, call, k5 = _split_case(op, kernel, x, s)
        torch.cuda.synchronize()
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(shipped, want))
        if not rel <= (1e-5 if dtype == torch.float32 else 1e-12):
            raise AssertionError(f"{kernel}[{op.tag}] {sfx} E={op.E}: twin rel err {rel:.3e}")
        calls = {"shipped": call}
        occ = {"shipped": fk.occupancy(kernel, op.tag, dtype, op.E)}
        notes = {"shipped": f"twin rel err {rel:.2e}{k5}"}
        for v in forms:
            f = getattr(lib, f"tlfea_{kernel}_ancf3243_{v}{mr}_{sfx}")
            f.argtypes, f.restype = argtypes, ctypes.c_int
            outs = [torch.empty_like(t) for t in shipped]
            conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in (*head, *outs, *tail)]
            call = _checked(lambda f=f, conv=conv: f(*conv), f"{kernel}[{op.tag} {v} {sfx}]")
            call()
            torch.cuda.synchronize()
            if all(torch.equal(o, t) for o, t in zip(outs, shipped)):
                notes[v] = "bitwise the shipped"
            else:
                notes[v] = "DIFFERS from the shipped in " + ", ".join(
                    f"{int((o != t).sum())} of {o.numel()} entries (max rel "
                    f"{float((o - t).abs().max() / t.abs().max()):.2e})"
                    for o, t in zip(outs, shipped))
            o = getattr(lib, f"tlfea_occupancy_{kernel}_ancf3243_{v}{mr}_{sfx}")
            o.argtypes, o.restype = [ctypes.POINTER(I)], ctypes.c_int
            res = (I * 5)()
            if o(res) != 0:
                raise RuntimeError(f"{kernel}[{op.tag} {v} {sfx}]: occupancy query failed")
            occ[v] = {"regs": res[0], "local_bytes": res[1], "blocks_per_sm": res[2],
                      "threads": res[3], "elements": res[4]}
            calls[v] = call
        same = [v for v in forms if occ[v] == occ["shipped"]
                and notes[v] == "bitwise the shipped"]
        notes["shipped"] += "; launches the block of " + (" / ".join(same) or "no form")
        keys = list(calls)
        times = {k: [] for k in keys}
        for k in keys + keys[::-1]:
            times[k].append(cs._device_ms(calls[k], 256)[0] * 1e3)
        for v in keys:
            o = occ[v]
            blocks = -(-op.E // o["elements"])
            waves = -(-blocks // (o["blocks_per_sm"] * n_sm)) if o["blocks_per_sm"] else 0
            sp = spills.get((label, "f" if dtype == torch.float32 else "d", v))
            line = (f"{label}[{op.tag}] {sfx} E={op.E} {v}: {min(times[v]):.2f} us "
                    f"({times[v][0]:.2f}/{times[v][1]:.2f}), {o['regs']} registers, "
                    f"{o['local_bytes']} B local"
                    + ("" if sp is None else f" ({sp} B spill stores)")
                    + f", {o['blocks_per_sm']} blocks an SM, {waves} wave(s) of {blocks} "
                    f"blocks of {o['threads']} threads ({o['elements']} elements)")
            if v != "shipped":
                smem = _split_smem(kernel, v, op, dtype.itemsize)
                call = _checked(lambda b=blocks, t=o["threads"], m=smem: empty(b, t, m, s),
                                "empty")
                line += (f", {smem} B shared; empty launch "
                         f"{cs._device_ms(call, 256)[0] * 1e3:.2f} us")
            print(f"{line}; {notes[v]}", flush=True)


# `blocks`: K3's forms in kernel_variants.cu
# (tlfea_svk_blocks_<family>_<form>_<sfx>) at (tag, chip_smoke problem
# function, its size arguments as `tangent` takes them, forms):
# `[ancf3443]` on SVK shells of BLOCKS_SHELLS x BLOCKS_SHELLS elements (576,
# 5,184 and 20,736); `[feat10]` at FEAT10_SIZES: the bench.py 1k box (864),
# the 10k flagship (10,584) and the 100k box (101,376, ablate_hv's "100k":
# its 60 MB gradient table exceeds the 50 MB L2).
BLOCKS_SHELLS = (24, 72, 144)
BLOCKS_FORMS = ["parent", "stream"] + [f"slots{te}_{nq}{c}" for c in ("", "_nocopy")
                                       for te in (8, 16) for nq in (4, 8)]
FEAT10_SIZES = ("RESIDENT_DIMS", None, (ablate_hv.CONFIGS["100k"],))
# K3's and K5t's (SVK) cases at FEAT10_SIZES, in the same forms
FEAT10_CASES = tuple(("feat10", "flagship_problem", size,
                      ["parent", "stream", "slots16_5", "slots32_5"]) for size in FEAT10_SIZES)
BLOCKS_CASES = tuple(("ancf3443", "shell_problem", (n, n), BLOCKS_FORMS)
                     for n in BLOCKS_SHELLS) + FEAT10_CASES
# `tangent`: K5t's forms (tlfea_contrib_tangent_<family>_<form>[_mr]_<sfx>)
# at (tag, chip_smoke problem function, its size arguments: the name of one in
# chip_smoke, a tuple of the arguments, or None, forms): K5t `[feat10_mr]` at the
# bunny's 96-element fallback mesh, the bench.py 1k box (864) and the 10k
# flagship (10,584); K5t `[feat10]` (SVK) in the parent, `stream` and the
# slots at FEAT10_SIZES (FEAT10_CASES); K5t `[ancf3443]` (SVK) and
# `[ancf3443_mr]` on the shells of BLOCKS_SHELLS (576, 5,184 and 20,736
# elements), damped as chip_smoke's shells are. The `_lb3` forms, and the
# slot forms that fit fewer than two blocks an SM in float64, are float32
# only (TANGENT_F32_ONLY).
TANGENT_FORMS = ["parent", "stream", "stream_fused", "stream_lb3", "stream_fused_lb3"]
TANGENT_SHELL_FORMS = ["parent", "stream", "slots8_8", "slots8_16", "slots16_8", "slots8_4"]
TANGENT_F32_ONLY = ("stream_lb3", "stream_fused_lb3", "slots8_16", "slots16_8")
TANGENT_CASES = (("feat10_mr", "flagship_problem", "BUNNY_DIMS", TANGENT_FORMS),
                 ("feat10_mr", "flagship_problem", "RESIDENT_DIMS", TANGENT_FORMS),
                 ("feat10_mr", "flagship_problem", None, TANGENT_FORMS),
                 *FEAT10_CASES,
                 *((tag, "shell_problem", (n, n), TANGENT_SHELL_FORMS)
                   for tag in ("ancf3443", "ancf3443_mr") for n in BLOCKS_SHELLS))
# `tangent_gate`: K5t `[ancf3443]` (SVK) in the parent and the float64
# shipped slots between the shells of BLOCKS_SHELLS (7,056 to 17,424
# elements), where fem_ancf3443.cu places its float64 gate.
TANGENT_GATE_CASES = tuple(("ancf3443", "shell_problem", (n, n), ["parent", "slots8_8"])
                           for n in (84, 96, 108, 120, 132))
# `blocks_beam` / `tangent_beam`: K3 `[ancf3243]`, K5t `[ancf3243_mr]` (damped,
# as chip_smoke's Mooney-Rivlin is) and K5t `[ancf3243]` (SVK) on the
# cantilevers of SPLIT_BEAMS, in the parent and the slot layouts of
# kernel_variants.cu VARIANTS_BLOCKS_BEAM / VARIANTS_TANGENT_BEAM.
BEAM_SLOT_FORMS = (["parent"] + [f"slots{te}_4" for te in (4, 8, 16)]
                   + [f"slots{te}_12" for te in (4, 8)])
BEAM_BLOCKS_CASES = tuple(("ancf3243", "ancf_beam_problem", (n,), BEAM_SLOT_FORMS)
                          for n in SPLIT_BEAMS)
BEAM_TANGENT_CASES = tuple((tag, "ancf_beam_problem", (n,), BEAM_SLOT_FORMS)
                           for tag in ("ancf3243_mr", "ancf3243") for n in SPLIT_BEAMS)
# `tangent_beam_gate`: K5t `[ancf3243]` (SVK) in the parent and `slots8_12`
# between the beams where fem_ancf3243.cu places its float32 gate.
GATE_BEAMS = (64, 1024, 2048, 4096, 8192, 16384, 32768)
BEAM_GATE_CASES = tuple(("ancf3243", "ancf_beam_problem", (n,), ["parent", "slots8_12"])
                        for n in GATE_BEAMS)


def _ptxas_spills(pattern, key):
    """{key(match): ptxas's spill stores in bytes} of the entry functions
    whose mangled names match `pattern`."""
    out, k = {}, None
    for line in PTXAS:
        if "Compiling entry" in line:
            m = pattern.search(line)
            k = key(m) if m else None
        elif k is not None and "spill stores" in line:
            out[k] = int(line.split(" bytes spill stores")[0].split(",")[-1])
            k = None
    return out


# The mangled families of the variants' kernels (kernel_variants.cu F10Mr,
# the shipped FEAT10's; S4Mr, the ANCF3443 family with register partials;
# B4Mr, the shipped ANCF3243's): their slot counts.
VARIANT_FAMILIES = {"Li10ELi5ELj1023ELi5ELi0E": 10, "Li16ELi48ELj4369ELi4ELi240E": 16,
                    "Li8ELi12ELj17ELi4ELi240E": 8}


def _blocks_spills():
    """{(T "f" or "d", S, form): spill stores} of `blocks`' forms: the parent
    svk_blocks_kernel<T, F>, svk_blocks_stream_kernel<T, F>,
    svk_slots_kernel<T, F, TE, NQ> and svk_slots_nocopy_kernel<T, F, TE, NQ>,
    F a family of VARIANT_FAMILIES."""
    fams = VARIANT_FAMILIES
    pat = re.compile(r"svk_(blocks|blocks_stream|slots|slots_nocopy)_kernelI([fd])N(?:S_6|5tlfea6)"
                     r"FamilyI(" + "|".join(fams) + r")E(?:ELi(\d+)ELi(\d+)E)?")

    def key(m):
        if m[1].startswith("slots"):
            return (m[2], fams[m[3]],
                    f"slots{m[4]}_{m[5]}" + ("_nocopy" if m[1] == "slots_nocopy" else ""))
        return m[2], fams[m[3]], "parent" if m[1] == "blocks" else "stream"
    return _ptxas_spills(pat, key)


def _slot_buffers(op, nq):
    """SlotSmem's and TangentSlotSmem's NBUF: two chunk buffers, or one when
    a chunk holds all of op's points."""
    return 2 if op.Q // nq > 1 else 1


def _blocks_smem(form, op, itemsize):
    """The dynamic shared memory of a `blocks` form's launch (fem_kernels.cuh
    smem_bytes<T, F, 3, 6>, kernel_variants.cu stream_blocks_smem, SlotSmem)."""
    S, Q, ng, rows = op.S, op.Q, NG[op.family], op.S * 3 + 1
    if form in ("parent", "stream"):
        words = (S * 3 + ng * S * 6) * 32
        return (words + (min(Q // ng, 2) * ng * rows * 32 if form == "stream" else 0)) * itemsize
    te, nq = (int(v) for v in form[5:].split("_")[:2])
    buf = 0 if form.endswith("_nocopy") else _slot_buffers(op, nq) * nq * rows * te
    return (S * 3 * te + buf + nq * te * (16 + 16 // itemsize)) * itemsize


def _tangent_spills():
    """{(T, S, material, form): spill stores} of K5t's forms: the library's
    contrib_tangent_kernel<T, F, M, STREAM> (`parent`, `stream`) and
    contrib_tangent_slots_kernel<T, F, M, TE, NQ> (`slots<TE>_<NQ>`), and
    kernel_variants.cu's contrib_tangent_form_kernel<T, F, M, FUSED, MINB>
    (`stream_fused`, `stream_lb3`, `stream_fused_lb3`), at the FEAT10,
    ANCF3443 and ANCF3243 families the forms run at (not the NG and
    REG_BYTES variants of `elements`)."""
    fams = VARIANT_FAMILIES
    pat = re.compile(r"contrib_tangent_(form_|slots_)?kernelI([fd]).*?FamilyI("
                     + "|".join(fams) + r")E.*?(SvkMat|MrMat)I[fd]EE(?:Lb([01])E|Li(\d+)E)"
                     r"(?:Li(\d+)E)?")

    def key(m):
        if m[1] == "slots_":
            form = f"slots{m[6]}_{m[7]}"
        elif m[1]:
            form = ("stream_fused" if m[5] == "1" else "stream") + ("_lb3" if m[7] == "3" else "")
        else:
            form = "stream" if m[5] == "1" else "parent"
        return m[2], fams[m[3]], m[4], form
    return _ptxas_spills(pat, key)


def _tangent_key(dtype, op, form):
    """The _tangent_spills key of a form of TANGENT_FORMS or
    TANGENT_SHELL_FORMS on op."""
    return ("f" if dtype == torch.float32 else "d", op.S,
            "MrMat" if op.kind == "mr" else "SvkMat", form)


def _tangent_smem(form, op, itemsize):
    """The dynamic shared memory of a K5t form's launch (TangentSmem, or
    TangentSlotSmem for `slots<TE>_<NQ>`)."""
    if form.startswith("slots"):
        te, nq = (int(v) for v in form[5:].split("_"))
        v = 16 // itemsize
        pt = -(-9 // v) * v
        return (op.S * 15 * te + _slot_buffers(op, nq) * nq * (op.S * 3 + 1) * te
                + nq * te * pt) * itemsize
    ng = NG[op.family]
    words = op.S * 15 + ng * op.S * 3
    if form != "parent":
        words += min(op.Q // ng, 2) * ng * (op.S * 3 + 1)
    return words * 32 * itemsize


def _form_rows(lib, cs, label, op, dtype, shipped, calls, occ, notes, forms, smem, spills,
               entry, occ_entry):
    """Run, hold bit for bit against `shipped` and time each of `forms`
    beside the shipped call (`calls`["shipped"], its occupancy and note
    given): entry(form) -> a call that launches the form into `out` and
    returns it; occ_entry(form) -> its occupancy() record. Timed twice in
    the order A B C ... C B A; one line a form, with its registers, local
    bytes, ptxas's spill stores (spills(form)), blocks an SM, waves, block
    shape, shared memory and the empty launch of its grid."""
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    I = ctypes.c_int
    empty = lib.tlfea_empty_launch
    empty.argtypes, empty.restype = [I, I, I, ctypes.c_void_p], ctypes.c_int
    s = torch.cuda.current_stream().cuda_stream
    for v in forms:
        call, out = entry(v)
        call()
        torch.cuda.synchronize()
        if torch.equal(out, shipped):
            notes[v] = "bitwise the shipped"
        else:
            notes[v] = (f"DIFFERS from the shipped in {int((out != shipped).sum())} of "
                        f"{out.numel()} entries (max rel "
                        f"{float((out - shipped).abs().max() / shipped.abs().max()):.2e})")
        occ[v] = occ_entry(v)
        calls[v] = call
    same = [v for v in forms if occ[v] == occ["shipped"] and notes[v] == "bitwise the shipped"]
    notes["shipped"] += "; launches the block of " + (" / ".join(same) or "no form")
    keys = list(calls)
    times = {k: [] for k in keys}
    for k in keys + keys[::-1]:
        times[k].append(cs._device_ms(calls[k], 256)[0] * 1e3)
    sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    for v in keys:
        o = occ[v]
        blocks = -(-op.E // o["elements"])
        waves = -(-blocks // (o["blocks_per_sm"] * n_sm)) if o["blocks_per_sm"] else 0
        sp = None if v == "shipped" else spills(v)
        line = (f"{label}[{op.tag}] {sfx} E={op.E} {v}: {min(times[v]):.2f} us "
                f"({times[v][0]:.2f}/{times[v][1]:.2f}), {o['regs']} registers, "
                f"{o['local_bytes']} B local" + ("" if sp is None else f" ({sp} B spill stores)")
                + f", {o['blocks_per_sm']} blocks an SM, {waves} wave(s) of {blocks} blocks of "
                f"{o['threads']} threads ({o['elements']} elements)")
        if v != "shipped":
            m = smem(v)
            call = _checked(lambda b=blocks, t=o["threads"], m=m: empty(b, t, m, s), "empty")
            line += f", {m} B shared; empty launch {cs._device_ms(call, 256)[0] * 1e3:.2f} us"
        print(f"{line}; {notes[v]}", flush=True)


def _occ(fn, *args):
    res = (ctypes.c_int * 5)()
    fn.restype = ctypes.c_int
    if fn(*args, res) != 0:
        raise RuntimeError(f"{fn.__name__}: occupancy query failed")
    return {"regs": res[0], "local_bytes": res[1], "blocks_per_sm": res[2], "threads": res[3],
            "elements": res[4]}


def _case_system(cs, make, size, material=None):
    """The float64 system on the CPU of a `blocks` or `tangent` case."""
    args = () if size is None else size if isinstance(size, tuple) else (getattr(cs, size),)
    return getattr(cs, make)("cpu", torch.float64, *args, material=material)[0]


def blocks(lib, cases=BLOCKS_CASES):
    """K3 `svk_blocks` in its forms beside the shipped kernel at `cases`,
    float32 and float64 (see the module's docstring)."""
    cs = _cs()
    dev = torch.device("cuda")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    spills = _blocks_spills()
    for tag, make, size, forms in cases:
        system = _case_system(cs, make, size)
        for dtype in (torch.float32, torch.float64):
            op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
            assert op.tag == tag, (op.tag, tag)
            sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
            t = "f" if dtype == torch.float32 else "d"
            u = _inputs(cs, op, op.tag, dtype, dev)["u"]
            shipped = fk.svk_blocks(op, u)
            want = fk.svk_blocks_plain(op, u)
            torch.cuda.synchronize()
            rel = float((shipped - want).abs().max() / want.abs().max())
            if not rel <= (1e-5 if dtype == torch.float32 else 1e-12):
                raise AssertionError(f"svk_blocks[{tag}] {sfx} E={op.E} disagrees with its "
                                     f"twin: {rel:.3e}")
            s = torch.cuda.current_stream().cuda_stream

            def entry(v, op=op, u=u, s=s, sfx=sfx, like=shipped):
                f = getattr(lib, f"tlfea_svk_blocks_{op.family}_{v}_{sfx}")
                f.argtypes, f.restype = [P] * 5 + [I] + [D] * 2 + [P], ctypes.c_int
                out = torch.empty_like(like)
                conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in
                        (u, op.conn_t, op.gN_t, op.dV_t, out, op.E, op.lam, op.mu, s)]
                return _checked(lambda: f(*conv), f"svk_blocks[{op.tag} {v} {sfx}]"), out

            def occ_entry(v, op=op, sfx=sfx):
                fn = getattr(lib, f"tlfea_occupancy_svk_blocks_{op.family}_{v}_{sfx}")
                fn.argtypes = [I, ctypes.POINTER(I)]
                return _occ(fn, op.E)

            _form_rows(lib, cs, "svk_blocks", op, dtype, shipped,
                       {"shipped": lambda op=op, u=u: fk.svk_blocks(op, u)},
                       {"shipped": fk.occupancy("svk_blocks", op.tag, dtype, op.E)},
                       {"shipped": f"twin rel err {rel:.2e}"}, forms,
                       lambda v, op=op, dtype=dtype: _blocks_smem(v, op, dtype.itemsize),
                       lambda v, t=t, op=op: spills.get((t, op.S, v)), entry, occ_entry)


def tangent(lib, cases=TANGENT_CASES):
    """K5t `contrib_tangent` in its forms beside the shipped kernel at
    `cases`, float32 and float64 (see the module's docstring)."""
    cs = _cs()
    dev = torch.device("cuda")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    spills = _tangent_spills()
    mr = cs.mooney_rivlin()
    for tag, make, size, forms in cases:
        family, kind = fk._untag(tag)
        system = _case_system(cs, make, size, mr if kind == "mr" else None)
        for dtype in (torch.float32, torch.float64):
            op = fk.FemOperator(system.elems.to(dev, dtype), system.material)
            sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
            x = _inputs(cs, op, tag, dtype, dev)
            shipped = fk.contrib_tangent(op, x["packed"], x["dp"])
            want = fk.contrib_tangent_plain(op, x["packed"], x["dp"])
            torch.cuda.synchronize()
            rel = float((shipped - want).abs().max() / want.abs().max())
            if not rel <= (1e-5 if dtype == torch.float32 else 1e-12):
                raise AssertionError(f"contrib_tangent[{tag}] {sfx} E={op.E} disagrees with "
                                     f"its twin: {rel:.3e}")
            s = torch.cuda.current_stream().cuda_stream
            mat = list(op.mat_args) + [0.0] * (5 - len(op.mat_args))
            mtag = "_mr" if kind == "mr" else ""

            def entry(v, op=op, x=x, s=s, sfx=sfx, like=shipped, mat=mat, mtag=mtag):
                f = getattr(lib, f"tlfea_contrib_tangent_{op.family}_{v}{mtag}_{sfx}")
                f.argtypes, f.restype = [P] * 7 + [I] + [D] * 5 + [P], ctypes.c_int
                out = torch.empty_like(like)
                conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in
                        (x["packed"], x["dp"], op.conn_t, op.gN_t, op.dV_t, op.Me_t, out, op.E,
                         *mat, s)]
                return _checked(lambda: f(*conv), f"contrib_tangent[{op.tag} {v} {sfx}]"), out

            def occ_entry(v, op=op, sfx=sfx, mtag=mtag):
                fn = getattr(lib, f"tlfea_occupancy_contrib_tangent_{op.family}_{v}{mtag}_{sfx}")
                fn.argtypes = [I, ctypes.POINTER(I)]
                return _occ(fn, op.E)

            fs = [v for v in forms if dtype == torch.float32 or v not in TANGENT_F32_ONLY]
            _form_rows(lib, cs, "contrib_tangent", op, dtype, shipped,
                       {"shipped": lambda op=op, x=x: fk.contrib_tangent(op, x["packed"],
                                                                         x["dp"])},
                       {"shipped": fk.occupancy("contrib_tangent", op.tag, dtype, op.E)},
                       {"shipped": f"twin rel err {rel:.2e}"}, fs,
                       lambda v, op=op, dtype=dtype: _tangent_smem(v, op, dtype.itemsize),
                       lambda v, op=op, dtype=dtype: spills.get(_tangent_key(dtype, op, v)),
                       entry, occ_entry)


def k4(lib):
    """K4's forms, float32, C = 3 (the gradient's and Hv's node sums) and C =
    6 (the block-Jacobi blocks', and `[kernels]`' random values)."""
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


PARTS = {"elements": elements, "beams": beams, "hv": hv, "split": split, "blocks": blocks,
         "tangent": tangent, "tangent_gate": lambda lib: tangent(lib, TANGENT_GATE_CASES),
         "blocks_feat10": lambda lib: blocks(lib, FEAT10_CASES),
         "tangent_feat10": lambda lib: tangent(lib, FEAT10_CASES),
         "blocks_beam": lambda lib: blocks(lib, BEAM_BLOCKS_CASES),
         "tangent_beam": lambda lib: tangent(lib, BEAM_TANGENT_CASES),
         "tangent_beam_gate": lambda lib: tangent(lib, BEAM_GATE_CASES),
         "k4": k4, "barriers": barriers, "resident": resident}


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
