"""The inner Newton-PCG solve in one persistent kernel, for small meshes.

Port of `tlfea/ops/pallas_resident.py`: its `_kernel` (:64, `pallas_call`
:373) runs the whole inner solve of `newton._newton_inner` with no coarse
correction in one call, for meshes of one banded element block and one
node window, with the material's tile algebra (`bnd.mops`, :326). Here the
kernel is `newton_resident` (csrc/resident.cuh, instantiated per (family,
material) in `fem_kernels.RESIDENT_SOURCES`: FEAT10 and ANCF3243, each with
SVK and Mooney-Rivlin): one launch per inner solve of one thread-block
cluster, cluster barriers between its phases, reductions through
distributed shared memory, the K1/K2 tile code and K4's node sums inside
(design notes at the top of resident.cuh). `plan` gives the launch's shape
from the family, the material, E and the dtype alone. The host launches the
kernel and reads its stats tensor once.

`newton_inner_resident` takes the plain version (`newton_inner_resident_plain`,
the composed Newton loop on the element twins) for a tensor on the CPU or
when `system.plain` is set, and launches the kernel for a CUDA tensor,
raising if the launch fails; it never falls back.

One deliberate difference from the JAX kernel: `hist` is the full
per-iteration ||g|| history, not only its first entry
(`pallas_resident.py:274-279`), so `_step`'s `norm_g_history` is the same on
every path.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from tlfea_torch.constraints import DensePins, FixedCoefs
from tlfea_torch.ops import fem_kernels as fk

__all__ = ["MAX_ELEMS", "STAT_FIELDS", "Plan", "plan", "max_cluster", "eligible", "kernel_args",
           "launch", "read_stats", "newton_inner_resident", "newton_inner_resident_plain"]

# One element block of the JAX banded kernels (pallas_fem.EBLK); such meshes
# also have one node window.
MAX_ELEMS = 1024
# The first entries of the kernel's stats tensor; the per-iteration ||g||
# history follows them. `grid` is the cluster size (blocks) of the launch.
STAT_FIELDS = ("iters", "cg_total", "norm_g", "grad_evals", "hv_evals", "barriers", "grid")
# The kernel's launch shape (csrc/resident.cuh): element tiles of EX
# elements; a cluster of at most MAX_CLUSTER blocks (a power of two); SLABS
# thread slabs a block (RES_SLABS); RES_NV values a reduction.
EX = 32
MAX_CLUSTER = 16
SLABS = 2
RES_NV = 3
# (S, NG) of each family's resident instantiation (fem_resident.cu,
# fem_resident_ancf3243.cu): slots, and quadrature-point groups (threadIdx.y).
FAMILY_SHAPES = {"feat10": (10, 5), "ancf3243": (8, 4)}


@dataclass(frozen=True)
class Plan:
    """The shape of one launch of the persistent kernel.

    cluster: blocks of the launch's one cluster (its grid); n_tiles: the
    virtual grid, one virtual block per element tile; rounds: virtual blocks
    a block runs; tiles[r]: the tiles block r runs (r, r + cluster, ...);
    threads: a block's threads (EX x NG x slabs); smem_bytes: its dynamic
    shared memory; shared: what lives there, as (name, bytes)."""

    cluster: int
    n_tiles: int
    rounds: int
    slabs: int
    tiles: tuple
    threads: int
    smem_bytes: int
    shared: tuple


@functools.lru_cache(maxsize=None)
def plan(family: str, kind: str, E: int, dtype: torch.dtype,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The launch of the persistent kernel at E elements of `family` with
    material `kind` in `dtype`, on a card that schedules clusters of up to
    `max_cluster` blocks (`max_cluster()`; 16 on an H100, else 8). The
    cluster is the power of two of at least n_tiles blocks, capped there;
    shared memory holds SLABS tile stagings (K1's: S 9 inputs and NG S 3
    partial sums a column, EX columns), the warp sums (rounds, NG, RES_NV),
    the two buffers of every virtual block's partials (2, 32, RES_NV) and
    K4's incidence list (S E + 1 row starts, room for the n + 1 of any mesh
    whose nodes all belong to an element, and S E value offsets, int32), as
    `resident_smem_bytes` computes. Reads nothing but its arguments, so it
    is computed once for each of them."""
    if (family, kind) not in fk.RESIDENT_SOURCES:
        raise ValueError(f"no newton_resident kernel for {kind} with {family} elements")
    if not 0 < E <= MAX_ELEMS:
        raise ValueError(f"newton_resident takes 1 to {MAX_ELEMS} elements, not {E}")
    if max_cluster not in (8, 16):
        raise ValueError(f"max_cluster must be 8 or 16, not {max_cluster}")
    S, NG = FAMILY_SHAPES[family]
    size = dtype.itemsize
    n_tiles = -(-E // EX)
    cluster = min(max_cluster, 1 << (n_tiles - 1).bit_length())
    rounds = -(-n_tiles // cluster)
    shared = (("tile staging", SLABS * (S * 9 + NG * S * 3) * EX * size),
              ("warp sums", rounds * NG * RES_NV * size),
              ("partials", 2 * (MAX_ELEMS // EX) * RES_NV * size),
              ("incidence list", (2 * S * E + 1) * 4))
    return Plan(cluster=cluster, n_tiles=n_tiles, rounds=rounds, slabs=SLABS,
                tiles=tuple(tuple(range(r, n_tiles, cluster)) for r in range(cluster)),
                threads=EX * NG * SLABS, smem_bytes=sum(b for _, b in shared), shared=shared)


_MAX_CLUSTER: dict = {}


def max_cluster(tag: str, dtype: torch.dtype) -> int:
    """The largest cluster the card schedules for kernel `tag` in `dtype`
    at its largest plan (16, or 8 where 16 does not fit), asked of the CUDA
    runtime once."""
    key = (tag, dtype)
    if key not in _MAX_CLUSTER:
        sfx = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        lib = fk.build_kernels()[fk.RESIDENT_SOURCES[fk._untag(tag)]]
        out = ctypes.c_int(0)
        err = getattr(lib, f"tlfea_newton_resident_{tag}_{sfx}_max_cluster")(ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"newton_resident[{tag}]: cluster query failed: CUDA error {err}")
        _MAX_CLUSTER[key] = out.value
    return _MAX_CLUSTER[key]


def eligible(system, coarse) -> bool:
    """The resident gate (`pallas_resident.eligible`, `newton.py:245-259`):
    at most MAX_ELEMS elements, no coarse correction, constraints that are
    none or dense pin fields (`FixedCoefs` or `DensePins`, as JAX's
    `cons_dense_ok`; `LinearConstraints`, whose Hv term is a callable, stay
    on the composed path), and a (family, material) pair with a resident kernel
    (`fk.RESIDENT_SOURCES`: FEAT10 and ANCF3243, each with SVK and
    Mooney-Rivlin). ANCF3443 never passes: the JAX gate needs a banded
    handle, and `pallas_banded.build_banded`'s VMEM estimate refuses every
    ANCF3443 mesh (the 48-point block's Q*S*3 and prep rows alone exceed
    8 MB at any E), so the JAX package never runs the shell resident
    either. The accuracy mode (`System.accum_dtype`) never passes, as JAX
    keeps it off the banded path (`newton.py:166-175`). It depends only on
    the problem, never on whether the kernel builds or launches."""
    cons = system.constraints
    return (not system.accum_dtype and system.fem.E <= MAX_ELEMS and coarse is None
            and (cons is None or isinstance(cons, (FixedCoefs, DensePins)))
            and (system.fem.family, system.fem.kind) in fk.RESIDENT_SOURCES)


def kernel_args(v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms):
    """The persistent kernel's arguments, but the cluster size and the
    stream, checked and laid out as its C entry takes them, and its outputs (v (n, 3), stats). Raises for a pair
    without a kernel and under make_fx tracing (see `launch`)."""
    if get_proxy_mode() is not None:
        raise RuntimeError("newton_resident: a kernel launch cannot be traced into a graph; "
                           "use the plain path (system.plain=True)")
    op = system.fem
    if (op.family, op.kind) not in fk.RESIDENT_SOURCES:
        raise ValueError(f"no newton_resident kernel for {type(op.material).__name__} with "
                         f"{op.family} elements")
    dtype, dev = v0.dtype, v0.device
    if pin_terms is None:  # no constraints: zero pin fields
        pin_terms = (torch.zeros((op.n, 3), dtype=dtype, device=dev),
                     torch.zeros((op.n, 1), dtype=dtype, device=dev))
    pin_aff, pin_lin = pin_terms
    ins = {"v0": v0, "u_prev": u_prev, "v_prev": v_prev, "f_ext": f_ext, "pin_aff": pin_aff}
    ins = {k: t.to(dtype).contiguous() for k, t in ins.items()}
    for k, t in ins.items():
        op._check(f"newton_resident {k}", t, (op.n, 3))
    pin_lin = pin_lin.to(dtype).contiguous()
    inv = inv_blocks.to(dtype).contiguous()
    op._check("newton_resident pin_lin", pin_lin, (op.n, 1))
    op._check("newton_resident inv_blocks", inv, (op.n, 3, 3))
    words = 9 * op.n + op.S * 3 * op.E + op.Q * op.prep_rows * op.E + 18 * op.n
    scratch = torch.empty(words, dtype=dtype, device=dev)
    v = torch.empty_like(ins["v0"])
    stats = torch.full((len(STAT_FIELDS) + params.max_inner + 1,), float("nan"),
                       dtype=torch.float64, device=dev)
    mat = (ctypes.c_double * len(op.mat_args))(*op.mat_args)  # the material's constants
    args = (ins["v0"], ins["u_prev"], ins["v_prev"], ins["f_ext"], ins["pin_aff"], pin_lin, inv,
            op.conn_t, op.gN_t, op.dV_t, op.Me_t, op.inc_ptr, op.inc, scratch, v, stats, op.n,
            op.E, mat, float(params.dt), float(params.inner_atol), float(params.inner_rtol),
            float(params.cg_rtol), float(params.ew_eta_max), int(params.max_inner),
            int(params.cg_max_iter), int(params.ls_max))
    return args, v, stats


def launch(v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms):
    """One launch of the kernel on v0's card, without synchronising, in the
    shape of `plan` (one cluster; `stats["grid"]` is its size). Returns (v
    (n, 3), stats): stats is a float64 tensor of STAT_FIELDS followed by
    the ||g|| history (max_inner + 1 entries, NaN where no iteration ran).

    Unlike the element kernels it is no `torch.library` operator: it runs a
    whole solve whose control flow reads its stats on the host, and nothing
    differentiates or linearizes through it. So it raises under make_fx
    tracing, whose graph would keep this launch's output as a constant."""
    args, v, stats = kernel_args(v0, u_prev, v_prev, f_ext, params, system, inv_blocks,
                                 pin_terms)
    op = system.fem
    pl = plan(op.family, op.kind, op.E, v0.dtype, max_cluster(op.tag, v0.dtype))
    fk._launch("newton_resident", op.tag, v0, *args, pl.cluster)
    return v, stats


def read_stats(stats: torch.Tensor) -> dict:
    """The kernel's stats tensor as {field: int or float, "hist": list}
    (one host read)."""
    vals = stats.tolist()
    out = {k: (x if k == "norm_g" else int(x)) for k, x in zip(STAT_FIELDS, vals)}
    out["hist"] = vals[len(STAT_FIELDS):]
    return out


def newton_inner_resident_plain(v0, u_prev, v_prev, f_ext, params, system, inv_blocks,
                                pin_terms):
    """Plain PyTorch version: the composed Newton-PCG loop
    (`newton._composed_inner`) on the element twins, block-Jacobi
    preconditioned. Same return contract as `newton_inner_resident`."""
    from tlfea_torch.solvers.newton import _composed_inner

    return _composed_inner(v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms,
                           plain=True)


def newton_inner_resident(v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms):
    """The inner Newton solve at fixed duals in one kernel launch.

    Returns (v, iters, ||g||, cg_total, hist), the contract of
    `newton._newton_inner`. pin_terms: (pin_aff (n, 3), pin_lin (n, 1)) or
    None; inv_blocks: the inverted block-Jacobi blocks (n, 3, 3)."""
    if system.plain or v0.device.type == "cpu":
        return newton_inner_resident_plain(v0, u_prev, v_prev, f_ext, params, system,
                                           inv_blocks, pin_terms)
    v, stats = launch(v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms)
    st = read_stats(stats)
    return v, st["iters"], st["norm_g"], st["cg_total"], st["hist"]
