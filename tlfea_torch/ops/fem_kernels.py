"""FEM element kernels of the implicit solvers, with their plain PyTorch twins.

The port of `tlfea/ops/pallas_fem.py` and `tlfea/ops/pallas_banded.py` for
SVK and Mooney-Rivlin, each with Kelvin-Voigt damping. Six CUDA kernels
(sources in `tlfea_torch/csrc/`, design notes at the top of
`fem_kernels.cuh`) carry the element work:

    K1 primal_prep  <- pallas_fem._primal_prep_body (:888),
                       _primal_prep_chunked_body (:1018),
                       pallas_banded._primal_banded_body (:801)
    K2 hv           <- pallas_fem._hv_body (:956), _hv_chunked_body (:1054),
                       pallas_banded._hv_banded_body (:763)
    K3 svk_blocks   <- pallas_fem._precond_body (:673), the chunked
                       make_precond_blocks kernel (:725),
                       pallas_banded._blocks_banded_body (:839)
    K4 node_reduce  <- the scatter half of K1-K3 (pallas_banded
                       ._window_scatter :689, the flat path's `.at[].add`)
    K5 contrib      <- pallas_fem._body (:519) with tangent=False: K1's
                       per-element gradient without the prep cache
    K5t contrib_tangent <- _body with tangent=True (the custom JVP of
                       make_element_contrib, :819-838)

Newton-PCG runs K1-K4 (`g_and_hvp`); the first-order solvers' gradient
`solvers.common.grad_L` runs K5 + K4 through `ElementContrib`, an
autograd Function whose forward-mode derivative is K5t + K4, so that
`torch.func.jvp` of `grad_L` runs through the kernels too.

A fifth kernel, the persistent Newton-PCG solve of `tlfea_torch.ops.resident`
(csrc/resident.cuh, sources in `RESIDENT_SOURCES`, one per (family,
material) pair that the JAX package runs resident: FEAT10 and ANCF3243,
each with SVK and Mooney-Rivlin), runs the K1/K2 tile code and K4's node
sums inside one launch of one thread-block cluster; it is built and launched
through this module too.

K1-K3, K5 and K5t are templates instantiated for the element families in
`FAMILIES` (FEAT10, ANCF3243, ANCF3443) and, K1, K2, K5 and K5t, for the
material: one CUDA source per (family, material) in `SOURCES`. SVK
(`svk.cuh`) and Mooney-Rivlin (`mr.cuh`, the port of `pallas_fem._MRTile`)
run in every family; Mooney-Rivlin has no K3: as in the JAX package, its
preconditioner blocks are plain tensor code
(`solvers.common.precond_blocks`). `FemOperator` refuses any other (Q, S,
translation mask), any other material and a (family, material) pair
without a source.

Each of the six element kernels is a `torch.library` operator,
`torch.ops.tlfea.<kernel>`, that takes the tensors the kernel reads, the
kernel's tag (a str) and the material's constants (a float[]); the wrapper
of the same name checks its arguments against the `FemOperator` and calls
it. The dispatcher routes the call by the inputs' device: the CPU kernel is
the plain twin (`*_plain`, same module) on tables rebuilt from those
tensors and the tag (`_Tables`; K4 also takes conn, which only its CPU
kernel reads), the CUDA kernel the launch, which raises
if the launch fails; a CUDA tensor never reaches the twin, and nothing
falls back. Being operators, the calls are recorded by `make_fx`, so
`torch.func.linearize` of `grad_L` replays K5t + K4 at every call of the
linearized function. Every launch adds one to `LAUNCHES["<kernel>[<tag>]"]`,
the tag being the family for SVK and "<family>_mr" for Mooney-Rivlin (K4,
which knows no material, counts under the family; the persistent kernel
under the tag), so a run can show which kernels it went through.

The prep cache K1 writes and K2 reads holds `op.prep_rows` rows per
quadrature point: SVK 27 (Du, the total second Piola S, Fd), Mooney-Rivlin
30 (Du, F^{-T}, [J - 1, I1, I2], Fd). The JAX package's Mooney-Rivlin cache
drops Fd when undamped (21 rows); the port always keeps the 30, so that one
instantiation serves damped and undamped materials.

Kernel layouts are element-minor: a table row r is stored as [r * E + e]
(see `FemOperator`), and per-(element, slot) outputs are (S * C, E). The
kernels are built on first use with nvcc for sm_90a into `tlfea_torch/_build`
(one shared library per source, built in parallel) and bound with ctypes
(`build_kernels`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
from torch._functorch.pyfunctorch import temporarily_pop_interpreter_stack

from tlfea_torch.elements.assembly import ElementBatch, mass_diag
from tlfea_torch.materials.mooney_rivlin import MooneyRivlin
from tlfea_torch.materials.svk import SVK
from tlfea_torch.ops.linalg import _adjugate3x3, cbrt, det3x3
from tlfea_torch.ops.segment import coef_scatter_add

__all__ = [
    "FemOperator", "FAMILIES", "SOURCES", "RESIDENT_SOURCES", "PROFILING_SOURCES", "LAUNCHES",
    "LAUNCHES_F64", "reset_launch_counts",
    "build_kernels", "occupancy", "launch_blocks",
    "primal_prep", "primal_prep_plain", "hv", "hv_plain",
    "svk_blocks", "svk_blocks_plain", "tangent_blocks_plain", "node_reduce",
    "node_reduce_plain",
    "contrib", "contrib_plain", "contrib_tangent", "contrib_tangent_plain",
    "ElementContrib", "element_fns", "unpack_sym6", "g_and_hvp",
]

SYM6 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]

# (Q, S, translation-slot bits) -> family.
FAMILIES = {(5, 10, 0x3FF): "feat10", (12, 8, 0x11): "ancf3243", (48, 16, 0x1111): "ancf3443"}
# material class -> (kind, prep rows per quadrature point, constants the
# kernels take in this order)
MATERIALS = {SVK: ("svk", 27, ("lam", "mu", "eta_damp", "lam_damp")),
             MooneyRivlin: ("mr", 30, ("mu10", "mu01", "kappa", "eta_damp", "lam_damp"))}
# (family, material kind) -> the CUDA source that instantiates its kernels
# (csrc/*.cu).
SOURCES = {("feat10", "svk"): "fem_kernels.cu", ("ancf3243", "svk"): "fem_ancf3243.cu",
           ("ancf3443", "svk"): "fem_ancf3443.cu", ("feat10", "mr"): "fem_feat10_mr.cu",
           ("ancf3243", "mr"): "fem_ancf3243_mr.cu", ("ancf3443", "mr"): "fem_ancf3443_mr.cu"}
KERNEL_NAMES = ("primal_prep", "hv", "svk_blocks", "node_reduce", "contrib", "contrib_tangent")
# The kernels that read the material; K3 exists for SVK only.
MATERIAL_KERNELS = {"svk": ("primal_prep", "hv", "svk_blocks", "contrib", "contrib_tangent"),
                    "mr": ("primal_prep", "hv", "contrib", "contrib_tangent")}
# (family, material kind) -> CUDA source of its persistent Newton-PCG kernel
# (csrc/resident.cuh, wrapped in tlfea_torch/ops/resident.py). No ANCF3443:
# the JAX package never runs it resident (see `resident.eligible`).
RESIDENT_SOURCES = {("feat10", "svk"): "fem_resident.cu", ("feat10", "mr"): "fem_resident.cu",
                    ("ancf3243", "svk"): "fem_resident_ancf3243.cu",
                    ("ancf3243", "mr"): "fem_resident_ancf3243.cu"}
# K4's batch, by family: the incidences a thread loads at once. A FEAT10 node
# has up to 24 (a mean of 5.5-6.9 on the box meshes), an ANCF coefficient row
# at most 4 (a shell) or 2 (a beam); batches of 8 and 4 were the fastest
# there (tools/kernel_variants k4, PERF.md). Any batch walks any degree.
K4_BATCH = {"feat10": 8, "ancf3243": 4, "ancf3443": 4}
# Sources of profiling kernels, built and launched with the others: the
# phase ablation of K2 + K4 (`tlfea_torch.ops.hv_phases`).
PROFILING_SOURCES = ("hv_phases.cu",)
# The launch shapes of csrc/fem_kernels.cuh: an element kernel's block in the
# parent layout takes a tile of TILE elements (EX there; a kernel in the
# split layout, `Points`, or K3 in the slot layout, `Slots`, takes fewer:
# `occupancy`'s "elements"), K4's block
# K4_THREADS threads (THREADS), each thread one node and 3 channels.
TILE, K4_THREADS = 32, 128


def _tag(family: str, kind: str) -> str:
    return family if kind == "svk" else f"{family}_{kind}"


def _untag(tag: str) -> tuple:
    """(family, material kind) of a kernel tag."""
    return (tag[:-3], "mr") if tag.endswith("_mr") else (tag, "svk")


LAUNCHES = {f"{k}[{fam}]": 0 for fam in FAMILIES.values() for k in KERNEL_NAMES}
LAUNCHES.update({f"{k}[{_tag(fam, kind)}]": 0 for fam, kind in SOURCES if kind != "svk"
                 for k in MATERIAL_KERNELS[kind]})
LAUNCHES.update({f"newton_resident[{_tag(fam, kind)}]": 0 for fam, kind in RESIDENT_SOURCES})
# The launches of the float64 instantiations alone, by the same keys: the
# accuracy mode (`System.accum_dtype`) runs them under a float32 problem.
LAUNCHES_F64 = dict.fromkeys(LAUNCHES, 0)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(os.path.dirname(_CSRC), "_build")
_HEADERS = ("fem_kernels.cuh", "svk.cuh", "mr.cuh", "resident.cuh")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_libs: dict = {}
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = LAUNCHES_F64[k] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the FEM kernels need the CUDA toolkit")


def _bind(lib, family: str | None, kind: str = "svk", resident: bool = False) -> None:
    """Set the ctypes signatures of a library's entry points: K4 (family
    None), the phase ablation (family "hv_phase", float32 only), the
    persistent kernel of (family, kind) (resident), or the element kernels
    of (family, kind)."""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    rec = ctypes.POINTER(I)  # an occupancy entry's record (`occupancy`; 5 ints)
    if family == "hv_phase":
        fn = lib.tlfea_hv_phase_f32
        fn.argtypes, fn.restype = [I] + [P] * 10 + [I] * 2 + [D] * 5 + [P], ctypes.c_int
        fn = lib.tlfea_hv_phase_occupancy_f32
        fn.argtypes, fn.restype = [I, rec], ctypes.c_int
        return
    if family is None:
        sigs = {"tlfea_node_reduce_{}": [P] * 4 + [I] * 4 + [P],
                "tlfea_occupancy_node_reduce_{}": [I, rec]}
    elif resident:
        name = f"tlfea_newton_resident_{_tag(family, kind)}_{{}}"
        sigs = {name: [P] * 16 + [I] * 2 + [ctypes.POINTER(D)] + [D] * 5 + [I] * 4 + [P],
                name + "_max_cluster": [ctypes.POINTER(I)], name + "_occupancy": [I, I, rec]}
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name.format(sfx)}_smem")
            fn.argtypes, fn.restype = [I, I], ctypes.c_longlong
    else:
        nm = len(next(names for k, _, names in MATERIALS.values() if k == kind))
        args = {"primal_prep": [P] * 7 + [I] + [D] * nm, "hv": [P] * 7 + [I] + [D] * (1 + nm),
                "svk_blocks": [P] * 5 + [I] + [D] * 2, "contrib": [P] * 6 + [I] + [D] * nm,
                "contrib_tangent": [P] * 7 + [I] + [D] * nm}
        sigs = {f"tlfea_{k}_{_tag(family, kind)}_{{}}": args[k] + [P]
                for k in MATERIAL_KERNELS[kind]}
        sigs[f"tlfea_occupancy_{_tag(family, kind)}_{{}}"] = [I, I, rec]
    for name, args in sigs.items():
        for sfx in ("f32", "f64"):
            fn = getattr(lib, name.format(sfx))
            fn.argtypes = args
            fn.restype = ctypes.c_int


def _read(name: str) -> bytes:
    with open(os.path.join(_CSRC, name), "rb") as fh:
        return fh.read()


def build_kernels() -> dict:
    """Compile the CUDA source of every (family, material) in SOURCES, of
    every persistent kernel in RESIDENT_SOURCES and of PROFILING_SOURCES for
    sm_90a into a shared library (once per source content; all nvcc
    processes run at once) and load them. Returns {source: ctypes library};
    BUILD_INFO gets the wall seconds of the build and, per source, its
    seconds and ptxas report."""
    if _libs:
        return _libs
    sources = set(SOURCES.values()) | set(RESIDENT_SOURCES.values()) | set(PROFILING_SOURCES)
    headers = b"".join(_read(h) for h in _HEADERS)
    os.makedirs(_BUILD, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for src in sorted(sources):
        digest = hashlib.sha1(_read(src) + headers + " ".join(_NVCC_FLAGS).encode())
        so = os.path.join(_BUILD, f"lib{src[:-3]}_{digest.hexdigest()[:12]}.so")
        proc = None
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[src] = (so, proc, time.perf_counter())
    per_src, failed = {}, []
    for src, (so, proc, t_start) in jobs.items():  # wait for every nvcc, then report
        info = {"path": so, "ptxas": "", "seconds": 0.0}
        if proc is not None:
            _, err = proc.communicate()
            info["seconds"] = time.perf_counter() - t_start
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
                continue
            os.replace(f"{so}.{os.getpid()}.tmp", so)  # atomic: never load a partial file
            info["ptxas"] = err
        per_src[src] = info
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["sources"] = per_src
    libs = {}
    for src, info in per_src.items():
        lib = ctypes.CDLL(info["path"])
        for table, resident in ((SOURCES, False), (RESIDENT_SOURCES, True)):
            for fam, kind in (key for key, s in table.items() if s == src):
                _bind(lib, fam, kind, resident=resident)
        if src == "fem_kernels.cu":
            _bind(lib, None)
        if src == "hv_phases.cu":
            _bind(lib, "hv_phase")
        libs[src] = lib
    _libs.update(libs)
    return _libs


def _launch(name: str, tag: str, x: torch.Tensor, *args) -> None:
    """Launch kernel `name` of `tag` (the bracket of its LAUNCHES key) in x's
    dtype on the current stream of x's card; args are tensors (passed as
    device pointers), None (a null pointer) and numbers (passed as they
    are). name "hv_phase" is the phase ablation's entry, tag its variant."""
    sfx = {torch.float32: "f32", torch.float64: "f64"}.get(x.dtype)
    if sfx is None:
        raise TypeError(f"{name}: kernels take float32 or float64, got {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {x.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()} (torch.cuda.set_device)")
    if any(isinstance(a, torch.Tensor) and (a.device != x.device or not a.is_contiguous())
           for a in args):
        raise ValueError(f"{name}: the kernel takes contiguous tensors on {x.device}")
    libs = build_kernels()
    if name == "hv_phase":
        fn = getattr(libs["hv_phases.cu"], f"tlfea_hv_phase_{sfx}")
    elif name == "node_reduce":
        fn = getattr(libs["fem_kernels.cu"], f"tlfea_node_reduce_{sfx}")
    else:
        table = RESIDENT_SOURCES if name == "newton_resident" else SOURCES
        fn = getattr(libs[table[_untag(tag)]], f"tlfea_{name}_{tag}_{sfx}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*conv, torch.cuda.current_stream().cuda_stream)
    key = f"{name}[{tag}]"
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    if sfx == "f64":
        LAUNCHES_F64[key] += 1


def occupancy(name: str, tag: str, dtype: torch.dtype, launch=None) -> dict:
    """The CUDA runtime's record of kernel `name` of `tag` (a LAUNCHES
    bracket) in dtype at its launch shape: {"regs": registers a thread,
    "local_bytes": local memory a thread (spills and stack), "blocks_per_sm":
    blocks resident on one SM, "threads": threads a block, "elements":
    elements a block (an element kernel's tile; 0 for K4)}. An element
    kernel's launch on `launch` = E elements (an instantiation may launch
    one thread a quadrature point up to some E and the parent tile above;
    None: the largest E); name "node_reduce" is K4 at the family's batch;
    "newton_resident" the persistent kernel launched as `launch` = (E,
    cluster), whose record has no block shape; "hv_phase" the phase
    ablation, tag its mode (float32)."""
    sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    libs = build_kernels()
    out = (ctypes.c_int * 5)()
    if name == "node_reduce":
        err = getattr(libs["fem_kernels.cu"], f"tlfea_occupancy_node_reduce_{sfx}")(
            K4_BATCH[_untag(tag)[0]], out)
    elif name == "hv_phase":
        err = libs["hv_phases.cu"].tlfea_hv_phase_occupancy_f32(int(tag), out)
    elif name == "newton_resident":
        fn = getattr(libs[RESIDENT_SOURCES[_untag(tag)]],
                     f"tlfea_newton_resident_{tag}_{sfx}_occupancy")
        err = fn(*launch, out)
    else:
        fn = getattr(libs[SOURCES[_untag(tag)]], f"tlfea_occupancy_{tag}_{sfx}")
        err = fn(KERNEL_NAMES.index(name), 2**31 - 1 if launch is None else launch, out)
    if err != 0:
        raise RuntimeError(f"{name}[{tag}]: occupancy query failed: CUDA error {err}")
    rec = {"regs": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}
    if name != "newton_resident":
        rec.update(threads=out[3], elements=out[4])
    return rec


def launch_blocks(name: str, op: "FemOperator", C: int = 3) -> int:
    """The blocks of one launch of element kernel `name` on op (K4 on C
    channels a node): an element kernel's tile is the one its instantiation
    launches on op.E elements in op's dtype (`occupancy`'s "elements"), so
    this builds the kernels."""
    if name == "node_reduce":
        return -(-op.n * (C // 3) // K4_THREADS)
    return -(-op.E // occupancy(name, op.tag, op.gN_t.dtype, op.E)["elements"])


def launch_key(name: str, op: "FemOperator") -> str:
    """The LAUNCHES key of kernel `name` on op: "<name>[<op.tag>]" for the
    kernels that read the material (and the persistent kernel),
    "<name>[<op.family>]" for the others."""
    reads_material = name in MATERIAL_KERNELS[op.kind] or name == "newton_resident"
    return f"{name}[{op.tag if reads_material else op.family}]"


class FemOperator(torch.nn.Module):
    """The element tables of one batch in the kernels' layout.

    The batch's (Q, S, trans_mask) must be one of `FAMILIES` and the
    material an `SVK` or a `MooneyRivlin` whose (family, kind) has a source
    in `SOURCES`; anything else raises, on any device. Attributes: family,
    kind ("svk" or "mr"), tag (the kernels' name suffix), source,
    prep_rows, material, mat_args (the constants the kernels take), and
    lam, mu, eta, lam_d (SVK's constants; for Mooney-Rivlin the
    small-strain equivalents and its viscosities, which no kernel reads).
    Buffers: conn (E, S) int64 for the twins; tmask (S,) bool, the
    translation slots; conn_t (S, E) int32, gN_t (Q*S*3, E), dV_t (Q, E),
    Me_t (S*S, E) element-minor for the kernels; the node -> incidence CSR
    (inc_ptr, inc) of the node reduce, incidences encoded a * E + e and
    ordered by node, then slot, then element; and md, the diagonal of the
    assembled mass matrix.
    """

    def __init__(self, elems: ElementBatch, material):
        super().__init__()
        E, Q, S, _ = elems.grad_N.shape
        tm = elems.trans_mask
        bits = None if tm is None else sum(1 << a for a, t in enumerate(tm) if t)
        if (Q, S, bits) not in FAMILIES:
            known = ", ".join(f"{fam} (Q={q}, S={s}, mask {b:#x})"
                              for (q, s, b), fam in FAMILIES.items())
            raise ValueError(f"no FEM kernel is instantiated for Q={Q}, S={S}, "
                             f"trans_mask={tm}; the CUDA library has {known}")
        if type(material) not in MATERIALS:
            raise TypeError(f"no FEM kernel for material {type(material).__name__}; the CUDA "
                            f"library has {', '.join(c.__name__ for c in MATERIALS)}")
        if elems.n_coef * 6 >= 2**31 or E * S >= 2**31 or Q * S * 3 * E >= 2**31:
            raise ValueError("mesh too large for the kernels' int32 indices")
        self.family = FAMILIES[(Q, S, bits)]
        self.kind, self.prep_rows, names = MATERIALS[type(material)]
        if (self.family, self.kind) not in SOURCES:
            raise ValueError(f"no FEM kernel is instantiated for {type(material).__name__} "
                             f"with {self.family} elements")
        self.source = SOURCES[(self.family, self.kind)]
        self.tag = _tag(self.family, self.kind)
        self.material = material
        self.mat_args = tuple(float(getattr(material, k)) for k in names)
        self.E, self.Q, self.S, self.n = E, Q, S, elems.n_coef
        self.lam, self.mu = float(material.lam), float(material.mu)
        self.eta, self.lam_d = float(material.eta_damp), float(material.lam_damp)
        dev = elems.device
        conn = elems.conn
        self.register_buffer("conn", conn)
        self.register_buffer("tmask", torch.tensor(tm, dtype=torch.bool, device=dev))
        self.register_buffer("conn_t", conn.t().contiguous().to(torch.int32))
        self.register_buffer("gN_t", elems.grad_N.permute(1, 2, 3, 0).reshape(Q * S * 3, E).contiguous())
        self.register_buffer("dV_t", elems.dV.t().contiguous())
        self.register_buffer("Me_t", elems.mass_elem.permute(1, 2, 0).reshape(S * S, E).contiguous())
        flat = conn.t().reshape(-1).cpu().numpy()  # incidence a * E + e -> node
        order = np.argsort(flat, kind="stable")
        ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(flat, minlength=self.n), out=ptr[1:])
        self.register_buffer("inc", torch.as_tensor(order.astype(np.int32), device=dev))
        self.register_buffer("inc_ptr", torch.as_tensor(ptr.astype(np.int32), device=dev))
        # Host-side sum: fixed order, so the mass diagonal is repeatable.
        self.register_buffer("md", mass_diag(elems.to("cpu")).to(dev))

    def _check(self, name: str, t: torch.Tensor, shape) -> None:
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {tuple(shape)} tensor, got "
                             f"{tuple(t.shape)} (contiguous={t.is_contiguous()})")
        if t.device != self.gN_t.device or t.dtype != self.gN_t.dtype:
            raise ValueError(f"{name}: tensor is {t.dtype} on {t.device}, tables are "
                             f"{self.gN_t.dtype} on {self.gN_t.device}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: no kernel for device {t.device}")


# --- plain twins (element-minor layout, same arithmetic as the kernels) ----


def _centre(op: FemOperator, xe: torch.Tensor) -> torch.Tensor:
    """Gathered slot values (S, k, E) with the translation slots centred on
    slot 0 (`pallas_fem._center`) and the gradient slots raw."""
    return torch.where(op.tmask[:, None, None], xe - xe[0:1], xe)


def _centred_slots(op: FemOperator, x: torch.Tensor) -> torch.Tensor:
    """Gather node values x (n, k) to (S, k, E), centred by `_centre`."""
    return _centre(op, x[op.conn].permute(1, 2, 0))


def _grad(xc: torch.Tensor, op: FemOperator) -> torch.Tensor:
    """sum_a x_a (x) gradN_a at every QP: (S, 3, E) -> (Q, E, 3, 3)."""
    return torch.einsum("aie,qaje->qeij", xc, op.gN_t.view(op.Q, op.S, 3, op.E))


def _to_slots(M: torch.Tensor, op: FemOperator, extra: torch.Tensor) -> torch.Tensor:
    """sum_q M gradN dV + extra, for per-QP 3x3 tensors M (Q, E, 3, 3) and
    extra (S, 3, E) -> (S, 3, E)."""
    return torch.einsum("qeij,qaje,qe->aie", M, op.gN_t.view(op.Q, op.S, 3, op.E),
                        op.dV_t) + extra


def _svk_stress(Du, Fd, lam, mu, eta, lam_d):
    """Total P and S from Du and Fd (see csrc/svk.cuh `svk_stress`)."""
    eye = torch.eye(3, dtype=Du.dtype, device=Du.device)
    DuT, FdT = Du.transpose(-1, -2), Fd.transpose(-1, -2)
    Em = 0.5 * (Du + DuT + DuT @ Du)
    Ed = 0.5 * (Fd + FdT + FdT @ Du + DuT @ Fd)
    trE = torch.diagonal(Em, dim1=-2, dim2=-1).sum(-1)
    trEd = torch.diagonal(Ed, dim1=-2, dim2=-1).sum(-1)
    Sm = 2.0 * mu * Em + 2.0 * eta * Ed + (lam * trE + lam_d * trEd)[..., None, None] * eye
    return Sm + Du @ Sm, Sm


def _svk_stress_tangent(Du, dF, Fd, dFd, lam, mu, eta, lam_d):
    """dP at (Du, Fd) along (dF, dFd) (see csrc/svk.cuh `svk_stress_tangent`)."""
    eye = torch.eye(3, dtype=Du.dtype, device=Du.device)
    DuT, FdT = Du.transpose(-1, -2), Fd.transpose(-1, -2)
    dFT, dFdT = dF.transpose(-1, -2), dFd.transpose(-1, -2)
    _, S0 = _svk_stress(Du, Fd, lam, mu, eta, lam_d)
    dE = 0.5 * (dF + dFT + dFT @ Du + DuT @ dF)
    dEd = 0.5 * (dFd + dFdT + dFdT @ Du + DuT @ dFd + FdT @ dF + dFT @ Fd)
    trdE = torch.diagonal(dE, dim1=-2, dim2=-1).sum(-1)
    trdEd = torch.diagonal(dEd, dim1=-2, dim2=-1).sum(-1)
    dS = 2.0 * mu * dE + 2.0 * eta * dEd + (lam * trdE + lam_d * trdEd)[..., None, None] * eye
    return dF @ S0 + dS + Du @ dS


def _mr_elastic(Du):
    """(F, C, FC, G = F^{-T}, I1, I2, J - 1) from Du, the exact J - 1 = tr Du
    + c2(Du) + det Du (see csrc/mr.cuh `mr_elastic`)."""
    F = Du + torch.eye(3, dtype=Du.dtype, device=Du.device)
    d = torch.diagonal(Du, dim1=-2, dim2=-1)
    c2 = (d[..., 0] * d[..., 1] - Du[..., 0, 1] * Du[..., 1, 0]
          + d[..., 0] * d[..., 2] - Du[..., 0, 2] * Du[..., 2, 0]
          + d[..., 1] * d[..., 2] - Du[..., 1, 2] * Du[..., 2, 1])
    Jm1 = d[..., 0] + d[..., 1] + d[..., 2] + c2 + det3x3(Du)
    G = _adjugate3x3(F).transpose(-1, -2) * (1.0 / (1.0 + Jm1))[..., None, None]
    C = F.transpose(-1, -2) @ F
    I1 = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    I2 = 0.5 * (I1 * I1 - (C * C.transpose(-1, -2)).sum((-2, -1)))
    return F, C, F @ C, G, I1, I2, Jm1


def _mr_viscous_S(F, Fd, eta, lam_d):
    """S_v = 2 eta Edot + lam_d tr(Edot) I, Edot = sym(Fd^T F)."""
    X = Fd.transpose(-1, -2) @ F
    tr = torch.diagonal(X, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    return (2.0 * eta) * (0.5 * (X + X.transpose(-1, -2))) + (lam_d * tr)[..., None, None] * eye


def _mr_coefs(Jm1, m):
    """t1 = 2 mu10 J^{-2/3}, t2 = 2 mu01 J^{-4/3}, t3 = kappa (J - 1) J, with
    the real cube root of J (negative at an inverted point, as CUDA `cbrt`)."""
    J = 1.0 + Jm1
    J13 = cbrt(J)
    Jm23 = 1.0 / (J13 * J13)
    return ((2.0 * m.mu10) * Jm23)[..., None, None], \
        ((2.0 * m.mu01) * (Jm23 * Jm23))[..., None, None], (m.kappa * Jm1 * J)[..., None, None]


def _mr_stress(Du, Fd, m):
    """Total P, G = F^{-T} and [J - 1, I1, I2] (..., 3) from Du and Fd (see
    csrc/mr.cuh `mr_stress`)."""
    F, _, FC, G, I1, I2, Jm1 = _mr_elastic(Du)
    t1, t2, t3 = _mr_coefs(Jm1, m)
    c1, c2, i1 = (I1 * (1.0 / 3.0))[..., None, None], (I2 * (2.0 / 3.0))[..., None, None], \
        I1[..., None, None]
    P = t1 * (F - c1 * G) + t2 * (i1 * F - FC - c2 * G) + t3 * G
    P = P + F @ _mr_viscous_S(F, Fd, m.eta_damp, m.lam_damp)
    return P, G, torch.stack([Jm1, I1, I2], dim=-1)


def _mr_dP(F, C, FC, G, I1, I2, Jm1, dF, Fd, dFd, Sv, m):
    """Exact derivative of the total P along (dF, dFd) at the primal (see
    csrc/mr.cuh `mr_dP`)."""
    J = (1.0 + Jm1)[..., None, None]
    s = (G * dF).sum((-2, -1))[..., None, None]
    FdotdF = (F * dF).sum((-2, -1))[..., None, None]
    dI1 = 2.0 * FdotdF
    i1 = I1[..., None, None]
    dI2 = 2.0 * (i1 * FdotdF - (FC * dF).sum((-2, -1))[..., None, None])
    t1, t2, t3 = _mr_coefs(Jm1, m)
    dt1, dt2 = (-2.0 / 3.0) * t1 * s, (-4.0 / 3.0) * t2 * s
    dt3 = m.kappa * (2.0 * J - 1.0) * J * s
    c1, c2 = i1 * (1.0 / 3.0), I2[..., None, None] * (2.0 / 3.0)
    dc1, dc2 = dI1 * (1.0 / 3.0), dI2 * (2.0 / 3.0)
    dFT = dF.transpose(-1, -2)
    dG = -(G @ (dFT @ G))
    dFC = dF @ C + F @ (dFT @ F) + (F @ F.transpose(-1, -2)) @ dF
    T1, dT1 = F - c1 * G, dF - dc1 * G - c1 * dG
    T2 = i1 * F - FC - c2 * G
    dT2 = dI1 * F + i1 * dF - dFC - dc2 * G - c2 * dG
    dP = dt1 * T1 + t1 * dT1 + dt2 * T2 + t2 * dT2 + dt3 * G + t3 * dG
    X = dFd.transpose(-1, -2) @ F + Fd.transpose(-1, -2) @ dF
    tr = torch.diagonal(X, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    dSv = (2.0 * m.eta_damp) * (0.5 * (X + X.transpose(-1, -2))) \
        + (m.lam_damp * tr)[..., None, None] * eye
    return dP + dF @ Sv + F @ dSv


def _mr_stress_tangent(Du, dF, Fd, dFd, m):
    """dP at (Du, Fd) along (dF, dFd) (see csrc/mr.cuh `mr_stress_tangent`)."""
    F, C, FC, G, I1, I2, Jm1 = _mr_elastic(Du)
    Sv = _mr_viscous_S(F, Fd, m.eta_damp, m.lam_damp)
    return _mr_dP(F, C, FC, G, I1, I2, Jm1, dF, Fd, dFd, Sv, m)


def _mass_term(op: FemOperator, x: torch.Tensor) -> torch.Tensor:
    """Me x_e per (slot, channel, element) from node values x (n, 3), raw."""
    return torch.einsum("abe,bie->aie", op.Me_t.view(op.S, op.S, op.E),
                        x[op.conn].permute(1, 2, 0))


def _primal(op: FemOperator, packed: torch.Tensor):
    """K1's and K5's f_e (S*3, E) from packed (n, 9) [u|v|dv/dt], with the
    per-QP tensors of the prep cache in its row order: SVK Du, total S, Fd;
    Mooney-Rivlin Du, F^{-T}, [J - 1, I1, I2], Fd."""
    Du = _grad(_centred_slots(op, packed[:, 0:3]), op)
    Fd = _grad(_centred_slots(op, packed[:, 3:6]), op)
    if op.kind == "svk":
        P, Sm = _svk_stress(Du, Fd, op.lam, op.mu, op.eta, op.lam_d)
        rows = (Du, Sm, Fd)
    else:
        P, G, s3 = _mr_stress(Du, Fd, op.material)
        rows = (Du, G, s3, Fd)
    fe = _to_slots(P, op, _mass_term(op, packed[:, 6:9]))
    return fe.reshape(op.S * 3, op.E).contiguous(), rows


def primal_prep_plain(op: FemOperator, packed: torch.Tensor):
    """Twin of K1: packed (n, 9) [u|v|dv/dt] -> (fe (S*3, E), prep
    (Q*prep_rows, E))."""
    fe, rows = _primal(op, packed)
    prep = torch.cat([r.reshape(op.Q, op.E, -1) for r in rows], dim=-1)  # (Q, E, PR)
    return fe, prep.permute(0, 2, 1).reshape(op.Q * op.prep_rows, op.E).contiguous()


def contrib_plain(op: FemOperator, packed: torch.Tensor) -> torch.Tensor:
    """Twin of K5: K1's fe (S*3, E) without the prep cache."""
    return _primal(op, packed)[0]


def contrib_tangent_plain(op: FemOperator, packed: torch.Tensor,
                          dpacked: torch.Tensor) -> torch.Tensor:
    """Twin of K5t: the derivative of K5's fe at packed along dpacked (n, 9)
    [du | dv | d(dv/dt)], (S*3, E)."""
    Du = _grad(_centred_slots(op, packed[:, 0:3]), op)
    Fd = _grad(_centred_slots(op, packed[:, 3:6]), op)
    dF = _grad(_centred_slots(op, dpacked[:, 0:3]), op)
    dFd = _grad(_centred_slots(op, dpacked[:, 3:6]), op)
    if op.kind == "svk":
        dP = _svk_stress_tangent(Du, dF, Fd, dFd, op.lam, op.mu, op.eta, op.lam_d)
    else:
        dP = _mr_stress_tangent(Du, dF, Fd, dFd, op.material)
    fe = _to_slots(dP, op, _mass_term(op, dpacked[:, 6:9]))
    return fe.reshape(op.S * 3, op.E).contiguous()


def hv_plain(op: FemOperator, p: torch.Tensor, prep: torch.Tensor, dt: float):
    """Twin of K2: direction p (n, 3) and the K1 prep cache -> (S*3, E)."""
    G = _grad(_centred_slots(op, p), op)
    pr = prep.view(op.Q, op.prep_rows, op.E).permute(0, 2, 1)  # (Q, E, PR)
    if op.kind == "mr":
        return _hv_plain_mr(op, p, G, pr, dt)
    Du, S0, Fd = (pr[..., 9 * k:9 * k + 9].reshape(op.Q, op.E, 3, 3) for k in range(3))
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    GT, DuT, FdT = G.transpose(-1, -2), Du.transpose(-1, -2), Fd.transpose(-1, -2)
    sym2 = 0.5 * (G + GT + GT @ Du + DuT @ G)
    dEd = sym2 + (0.5 * dt) * (FdT @ G + GT @ Fd)
    tr2 = torch.diagonal(sym2, dim1=-2, dim2=-1).sum(-1)
    trd = torch.diagonal(dEd, dim1=-2, dim2=-1).sum(-1)
    dS = (2.0 * op.mu * dt) * sym2 + (2.0 * op.eta) * dEd \
        + ((op.lam * dt) * tr2 + op.lam_d * trd)[..., None, None] * eye
    dP = dS + dt * (G @ S0) + Du @ dS
    fe = _to_slots(dP, op, (1.0 / dt) * _mass_term(op, p))
    return fe.reshape(op.S * 3, op.E).contiguous()


def _hv_plain_mr(op: FemOperator, p, Gp, pr, dt):
    """K2's Mooney-Rivlin twin from the prep rows pr (Q, E, 30): Du, G, [J -
    1, I1, I2], Fd read; F, C, FC and S_v recomputed (csrc/mr.cuh `mr_hv`)."""
    Du, G, Fd = (pr[..., k:k + 9].reshape(op.Q, op.E, 3, 3) for k in (0, 9, 21))
    Jm1, I1, I2 = pr[..., 18], pr[..., 19], pr[..., 20]
    F = Du + torch.eye(3, dtype=p.dtype, device=p.device)
    C = F.transpose(-1, -2) @ F
    m = op.material
    Sv = _mr_viscous_S(F, Fd, m.eta_damp, m.lam_damp)
    dP = _mr_dP(F, C, F @ C, G, I1, I2, Jm1, Gp * dt, Fd, Gp, Sv, m)
    fe = _to_slots(dP, op, (1.0 / dt) * _mass_term(op, p))
    return fe.reshape(op.S * 3, op.E).contiguous()


def _require_svk(name: str, op: FemOperator) -> None:
    if op.kind != "svk":
        raise ValueError(f"{name}: the SVK diagonal-block kernel K3 takes no "
                         f"{type(op.material).__name__}; its blocks come from "
                         f"solvers.common.precond_blocks")


def svk_blocks_plain(op: FemOperator, u: torch.Tensor) -> torch.Tensor:
    """Twin of K3: displacements u (n, 3) -> SYM6 blocks (S*6, E), through
    `SVK.tangent_diag_block` (the reference einsum branch)."""
    _require_svk("svk_blocks_plain", op)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    F = _grad(_centred_slots(op, u), op) + eye  # (Q, E, 3, 3)
    h = op.gN_t.view(op.Q, op.S, 3, op.E).permute(0, 1, 3, 2)  # (Q, S, E, 3)
    Kb = SVK(op.lam, op.mu).tangent_diag_block(F[:, None], h) * op.dV_t[:, None, :, None, None]
    Kb = Kb.sum(0)  # (S, E, 3, 3)
    sym = torch.stack([Kb[..., d, e] for d, e in SYM6], dim=1)  # (S, 6, E)
    return sym.reshape(op.S * 6, op.E).contiguous()


def tangent_blocks_plain(op: FemOperator, u: torch.Tensor) -> torch.Tensor:
    """The exact diagonal tangent blocks of any material, sum_q
    material.tangent_diag_block(F_q, gradN_qa) dV_q per (element, slot), full
    3x3 row-major, (S*9, E): the XLA branch of the JAX package's
    `precond_blocks` (`common.py:263-270`), which preconditions Mooney-Rivlin.
    Plain tensor code on any device; F from the centred slots, as K3's."""
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    F = _grad(_centred_slots(op, u), op) + eye  # (Q, E, 3, 3)
    h = op.gN_t.view(op.Q, op.S, 3, op.E).permute(0, 1, 3, 2)  # (Q, S, E, 3)
    Kb = op.material.tangent_diag_block(F[:, None], h) * op.dV_t[:, None, :, None, None]
    return Kb.sum(0).permute(0, 2, 3, 1).reshape(op.S * 9, op.E).contiguous()


def node_reduce_plain(op: FemOperator, vals: torch.Tensor) -> torch.Tensor:
    """Twin of K4: per-(element, slot) values (S*C, E) -> node sums (n, C),
    each node's in a fixed order (`coef_scatter_add`)."""
    C = vals.shape[0] // op.S
    return coef_scatter_add(vals.view(op.S, C, op.E).permute(2, 0, 1), op.conn, op.n)


# --- operators: CPU kernel (the twin), CUDA kernel (the launch), fake ------


class _Tables:
    """What a twin reads of a `FemOperator`, rebuilt from an operator's
    tensors, its tag and its constants: conn from conn_t, the translation
    mask from `FAMILIES`, the material from the tag's kind (K3 passes SVK's
    lam and mu only)."""

    def __init__(self, tag, mat, n, conn_t, gN_t, dV_t, Me_t=None):
        family, self.kind = _untag(tag)
        bits = next(b for (_, _, b), f in FAMILIES.items() if f == family)
        self.S, self.E = conn_t.shape
        self.Q, self.n = dV_t.shape[0], n
        self.conn = conn_t.t().to(torch.int64).contiguous()
        self.tmask = torch.tensor([bool(bits >> a & 1) for a in range(self.S)],
                                  device=conn_t.device)
        self.gN_t, self.dV_t, self.Me_t = gN_t, dV_t, Me_t
        cls = next(c for c, (k, _, _) in MATERIALS.items() if k == self.kind)
        self.prep_rows = _prep_rows(tag)
        self.material = cls(*mat)
        self.lam, self.mu = float(self.material.lam), float(self.material.mu)
        self.eta, self.lam_d = float(self.material.eta_damp), float(self.material.lam_damp)


def _primal_prep_cpu(packed, conn_t, gN_t, dV_t, Me_t, tag, mat):
    return primal_prep_plain(_Tables(tag, mat, packed.shape[0], conn_t, gN_t, dV_t, Me_t),
                             packed)


def _hv_cpu(p, conn_t, prep, gN_t, dV_t, Me_t, dt, tag, mat):
    return hv_plain(_Tables(tag, mat, p.shape[0], conn_t, gN_t, dV_t, Me_t), p, prep, dt)


def _svk_blocks_cpu(u, conn_t, gN_t, dV_t, tag, mat):
    return svk_blocks_plain(_Tables(tag, mat, u.shape[0], conn_t, gN_t, dV_t), u)


def _node_reduce_cpu(vals, conn, inc_ptr, inc, tag):
    E, S = conn.shape
    return coef_scatter_add(vals.view(S, -1, E).permute(2, 0, 1), conn, inc_ptr.numel() - 1)


def _contrib_cpu(packed, conn_t, gN_t, dV_t, Me_t, tag, mat):
    return contrib_plain(_Tables(tag, mat, packed.shape[0], conn_t, gN_t, dV_t, Me_t), packed)


def _contrib_tangent_cpu(packed, dpacked, conn_t, gN_t, dV_t, Me_t, tag, mat):
    return contrib_tangent_plain(_Tables(tag, mat, packed.shape[0], conn_t, gN_t, dV_t, Me_t),
                                 packed, dpacked)


def _prep_rows(tag: str) -> int:
    return next(pr for k, pr, _ in MATERIALS.values() if k == _untag(tag)[1])


def _primal_prep_cuda(packed, conn_t, gN_t, dV_t, Me_t, tag, mat):
    (S, E), Q = conn_t.shape, dV_t.shape[0]
    fe = packed.new_empty((S * 3, E))
    prep = packed.new_empty((Q * _prep_rows(tag), E))
    _launch("primal_prep", tag, packed, packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E, *mat)
    return fe, prep


def _hv_cuda(p, conn_t, prep, gN_t, dV_t, Me_t, dt, tag, mat):
    S, E = conn_t.shape
    out = p.new_empty((S * 3, E))
    _launch("hv", tag, p, p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt, *mat)
    return out


def _svk_blocks_cuda(u, conn_t, gN_t, dV_t, tag, mat):
    S, E = conn_t.shape
    out = u.new_empty((S * 6, E))
    _launch("svk_blocks", tag, u, u, conn_t, gN_t, dV_t, out, E, *mat)
    return out


def _node_reduce_cuda(vals, conn, inc_ptr, inc, tag):
    E, n = vals.shape[1], inc_ptr.numel() - 1
    C = vals.shape[0] * E // inc.numel()
    if C % 3:
        raise ValueError(f"node_reduce: the kernel reduces a multiple of 3 channels, got {C}")
    out = vals.new_empty((n, C))
    _launch("node_reduce", tag, vals, vals, inc_ptr, inc, out, n, E, C, K4_BATCH[tag])
    return out


def _contrib_cuda(packed, conn_t, gN_t, dV_t, Me_t, tag, mat):
    S, E = conn_t.shape
    fe = packed.new_empty((S * 3, E))
    _launch("contrib", tag, packed, packed, conn_t, gN_t, dV_t, Me_t, fe, E, *mat)
    return fe


def _contrib_tangent_cuda(packed, dpacked, conn_t, gN_t, dV_t, Me_t, tag, mat):
    S, E = conn_t.shape
    out = packed.new_empty((S * 3, E))
    _launch("contrib_tangent", tag, packed, packed, dpacked, conn_t, gN_t, dV_t, Me_t, out, E,
            *mat)
    return out


def _slots_fake(C, conn_at=1):
    """The fake kernel of an operator that returns (S*C, E) values like its
    first argument, conn_t (S, E) being argument conn_at."""
    def fake(x, *args):
        S, E = args[conn_at - 1].shape
        return x.new_empty((S * C, E))
    return fake


def _primal_prep_fake(packed, conn_t, gN_t, dV_t, Me_t, tag, mat):
    S, E = conn_t.shape
    return packed.new_empty((S * 3, E)), packed.new_empty((dV_t.shape[0] * _prep_rows(tag), E))


def _node_reduce_fake(vals, conn, inc_ptr, inc, tag):
    return vals.new_empty((inc_ptr.shape[0] - 1, vals.shape[0] * vals.shape[1] // inc.shape[0]))


# name -> (schema, CPU kernel, CUDA kernel, fake)
_OPS = {
    "primal_prep": ("(Tensor packed, Tensor conn_t, Tensor gN_t, Tensor dV_t, Tensor Me_t, "
                    "str tag, float[] mat) -> (Tensor, Tensor)",
                    _primal_prep_cpu, _primal_prep_cuda, _primal_prep_fake),
    "hv": ("(Tensor p, Tensor conn_t, Tensor prep, Tensor gN_t, Tensor dV_t, Tensor Me_t, "
           "float dt, str tag, float[] mat) -> Tensor", _hv_cpu, _hv_cuda, _slots_fake(3)),
    "svk_blocks": ("(Tensor u, Tensor conn_t, Tensor gN_t, Tensor dV_t, str tag, float[] mat) "
                   "-> Tensor", _svk_blocks_cpu, _svk_blocks_cuda, _slots_fake(6)),
    "node_reduce": ("(Tensor vals, Tensor conn, Tensor inc_ptr, Tensor inc, str tag) -> Tensor",
                    _node_reduce_cpu, _node_reduce_cuda, _node_reduce_fake),
    "contrib": ("(Tensor packed, Tensor conn_t, Tensor gN_t, Tensor dV_t, Tensor Me_t, "
                "str tag, float[] mat) -> Tensor", _contrib_cpu, _contrib_cuda, _slots_fake(3)),
    "contrib_tangent": ("(Tensor packed, Tensor dpacked, Tensor conn_t, Tensor gN_t, "
                        "Tensor dV_t, Tensor Me_t, str tag, float[] mat) -> Tensor",
                        _contrib_tangent_cpu, _contrib_tangent_cuda, _slots_fake(3, conn_at=2)),
}
_LIB = torch.library.Library("tlfea", "DEF")
for _name, (_schema, _cpu, _cuda, _fake) in _OPS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"tlfea::{_name}", _fake, lib=_LIB)
del _name, _schema, _cpu, _cuda, _fake


# --- wrappers --------------------------------------------------------------


def primal_prep(op: FemOperator, packed: torch.Tensor):
    """K1: element ALM contribution f_int + Me dv/dt per (element, slot),
    (S*3, E), and the per-QP prep cache (Q*prep_rows, E) that K2 reads."""
    op._check("primal_prep", packed, (op.n, 9))
    return torch.ops.tlfea.primal_prep.default(packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t,
                                               op.tag, op.mat_args)


def hv(op: FemOperator, p: torch.Tensor, prep: torch.Tensor, dt: float) -> torch.Tensor:
    """K2: Hessian-vector product of the element contribution along p,
    per (element, slot), (S*3, E)."""
    op._check("hv", p, (op.n, 3))
    op._check("hv", prep, (op.Q * op.prep_rows, op.E))
    return torch.ops.tlfea.hv.default(p, op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, float(dt),
                                      op.tag, op.mat_args)


def svk_blocks(op: FemOperator, u: torch.Tensor) -> torch.Tensor:
    """K3: SVK diagonal tangent blocks per (element, slot), SYM6, (S*6, E)."""
    _require_svk("svk_blocks", op)
    op._check("svk_blocks", u, (op.n, 3))
    return torch.ops.tlfea.svk_blocks.default(u, op.conn_t, op.gN_t, op.dV_t, op.tag,
                                              (op.lam, op.mu))


def node_reduce(op: FemOperator, vals: torch.Tensor) -> torch.Tensor:
    """K4: sum per-(element, slot) values (S*C, E) onto the nodes, (n, C),
    in a fixed order (bitwise repeatable)."""
    C = vals.shape[0] // op.S
    op._check("node_reduce", vals, (op.S * C, op.E))
    return torch.ops.tlfea.node_reduce.default(vals, op.conn, op.inc_ptr, op.inc, op.family)


def contrib(op: FemOperator, packed: torch.Tensor) -> torch.Tensor:
    """K5: element ALM contribution f_int + Me dv/dt per (element, slot),
    (S*3, E): K1's fe without the prep cache."""
    op._check("contrib", packed, (op.n, 9))
    return torch.ops.tlfea.contrib.default(packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, op.tag,
                                           op.mat_args)


def contrib_tangent(op: FemOperator, packed: torch.Tensor, dpacked: torch.Tensor) -> torch.Tensor:
    """K5t: the derivative of K5 at packed along dpacked (n, 9) [du | dv |
    d(dv/dt)], per (element, slot), (S*3, E)."""
    op._check("contrib_tangent", packed, (op.n, 9))
    op._check("contrib_tangent", dpacked, (op.n, 9))
    return torch.ops.tlfea.contrib_tangent.default(packed, dpacked, op.conn_t, op.gN_t, op.dV_t,
                                                   op.Me_t, op.tag, op.mat_args)


_KERNELS = {f.__name__: f for f in (primal_prep, hv, svk_blocks, node_reduce, contrib,
                                    contrib_tangent)}
_PLAIN = {name: globals()[name + "_plain"] for name in _KERNELS}


def element_fns(plain: bool) -> dict:
    """{kernel name: function} of the kernel wrappers (KERNEL_NAMES), or of
    the plain twins on any device when `plain` (the on-card reference)."""
    return _PLAIN if plain else _KERNELS


class ElementContrib(torch.autograd.Function):
    """Node sums of the element ALM contributions, K4(K5(packed)) -> (n, 3),
    with the forward-mode derivative K4(K5t(packed, dpacked)): the
    counterpart of `make_element_contrib`'s `jax.custom_jvp` (K4 is linear),
    so `torch.func.jvp` of `grad_L` runs through the kernels, and
    `torch.func.linearize` (forward AD traced by make_fx) records the
    `tlfea.contrib_tangent` and `tlfea.node_reduce` operators of the rule in
    its graph, which replays them at every call.

        ElementContrib.apply(op, packed, plain)

    plain=True takes the twins on any device. Under `torch.func.jvp` the
    derivative rule sees its tensors wrapped one transform level deep, and
    every tensor made there would be wrapped too; a kernel reads raw device
    pointers, so the rule steps out of that level and runs K5t + K4 on the
    values under it. A kernel has no derivative of its own, so nested
    transforms raise there (`_level_values`; use plain=True for them)."""

    @staticmethod
    def forward(op, packed, plain):
        fns = element_fns(plain)
        return fns["node_reduce"](op, fns["contrib"](op, packed))

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, packed, plain = inputs
        ctx.op, ctx.plain = op, plain
        ctx.save_for_forward(packed)

    @staticmethod
    def jvp(ctx, _dop, dpacked, _dplain):
        (packed,) = ctx.saved_tensors
        fns = element_fns(ctx.plain)

        def tangent(x, dx):
            return fns["node_reduce"](ctx.op, fns["contrib_tangent"](ctx.op, x, dx.contiguous()))

        if ctx.plain or not is_functorch_wrapped_tensor(packed):
            return tangent(packed, dpacked)
        with temporarily_pop_interpreter_stack():
            return tangent(_level_values(packed), _level_values(dpacked))


def _level_values(t: torch.Tensor) -> torch.Tensor:
    """The tensor under one torch.func transform level (t itself outside
    any transform); raises under nested transforms."""
    if not is_functorch_wrapped_tensor(t):
        return t
    u = get_unwrapped(t)
    if is_functorch_wrapped_tensor(u):
        raise RuntimeError("nested torch.func transforms cannot differentiate a kernel "
                           "launch; use the plain path (system.plain=True)")
    return u


def unpack_sym6(sym: torch.Tensor) -> torch.Tensor:
    """(n, 6) packed upper triangles (SYM6 order) -> (n, 3, 3)."""
    return torch.stack(
        [
            torch.stack([sym[:, 0], sym[:, 1], sym[:, 2]], dim=-1),
            torch.stack([sym[:, 1], sym[:, 3], sym[:, 4]], dim=-1),
            torch.stack([sym[:, 2], sym[:, 4], sym[:, 5]], dim=-1),
        ],
        dim=-2,
    )


def g_and_hvp(v, u_prev, v_prev, f_ext, dt, op: FemOperator, pin_terms=None,
              plain: bool = False):
    """ALM gradient g(v) (n, 3) and its Hessian-vector operator p -> H p.

    Port of `pallas_banded.g_and_hvp_banded` (:930) with the constraint
    terms of `newton._newton_inner` (:183-233): pin_terms = (pin_aff (n, 3),
    pin_lin (n, 1)) gives the pin gradient pin_aff + pin_lin * u and the Hv
    term dt * pin_lin * p, with no scatter of the duals; a callable pin_lin
    (linear rows, `common._pin_terms`) gives pin_aff + pin_lin(u) and dt *
    pin_lin(p). One K1 + K4 pass per gradient; one K2 + K4 pass per Hv,
    reading K1's prep cache.
    u = u_prev + dt * v is formed in displacement space (never x_prev +
    dt * v, whose float32 rounding stalls Newton on stiff problems).

    Everything runs in op's dtype, the pin terms too (pass them in it), and
    g and H p come back in v's: with a float64 op under a float32 v (the
    accuracy mode, `System.fem_wide`) the packed [u | v | dv/dt], p and
    f_ext are widened, K1, K2 and K4 run their float64 instantiations, and
    only the sums are cast down (the XLA path of `common.py:183-201`). u_prev
    may be float64 under a float32 v: it is cast to op's dtype.
    """
    fns = element_fns(plain)
    k2, k4 = fns["hv"], fns["node_reduce"]
    wd = op.gN_t.dtype
    u = (u_prev + dt * v).to(wd)
    packed = torch.cat([u, v.to(wd), ((v - v_prev) / dt).to(wd)], dim=1).contiguous()
    fe, prep = fns["primal_prep"](op, packed)
    g = k4(op, fe)
    pin_lin = None
    if pin_terms is not None:
        pin_aff, pin_lin = pin_terms
        g = g + pin_aff + (pin_lin(u) if callable(pin_lin) else pin_lin * u)
    g = (g - f_ext.to(wd)).to(v.dtype)

    def hvp(p):
        pw = p.to(wd).contiguous()
        h = k4(op, k2(op, pw, prep, dt))
        if callable(pin_lin):
            h = h + dt * pin_lin(pw)
        elif pin_lin is not None:
            h = h + dt * pin_lin * pw
        return h.to(p.dtype)

    return g, hvp
