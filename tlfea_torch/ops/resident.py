"""The inner Newton-PCG solve in one persistent kernel, for small meshes.

Port of `tlfea/ops/pallas_resident.py`: its `_kernel` (:64, `pallas_call`
:373) runs the whole inner solve of `newton._newton_inner` with no coarse
correction in one call, for meshes of one banded element block and one
node window, with the material's tile algebra (`bnd.mops`, :326). Here the
kernel is `newton_resident` (csrc/resident.cuh, instantiated per (family,
material) in `fem_kernels.RESIDENT_SOURCES`: FEAT10 and ANCF3243, each with
SVK and Mooney-Rivlin): one cooperative launch per inner solve, grid
barriers between its phases, the K1/K2 tile code and K4's node sums inside
(design notes at the top of resident.cuh). The host launches it and reads
its stats tensor once.

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

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.ops import fem_kernels as fk

__all__ = ["MAX_ELEMS", "STAT_FIELDS", "eligible", "launch", "read_stats",
           "newton_inner_resident", "newton_inner_resident_plain"]

# One element block of the JAX banded kernels (pallas_fem.EBLK); such meshes
# also have one node window.
MAX_ELEMS = 1024
# The first entries of the kernel's stats tensor; the per-iteration ||g||
# history follows them.
STAT_FIELDS = ("iters", "cg_total", "norm_g", "grad_evals", "hv_evals", "barriers", "grid")


def eligible(system, coarse) -> bool:
    """The resident gate (`pallas_resident.eligible`, `newton.py:245-259`):
    at most MAX_ELEMS elements, no coarse correction, no constraints or
    `FixedCoefs`, and a (family, material) pair with a resident kernel
    (`fk.RESIDENT_SOURCES`: FEAT10 and ANCF3243, each with SVK and
    Mooney-Rivlin). ANCF3443 never passes: the JAX gate needs a banded
    handle, and `pallas_banded.build_banded`'s VMEM estimate refuses every
    ANCF3443 mesh (the 48-point block's Q*S*3 and prep rows alone exceed
    8 MB at any E), so the JAX package never runs the shell resident
    either. It depends only on the problem, never on whether the kernel
    builds or launches."""
    cons = system.constraints
    return (system.fem.E <= MAX_ELEMS and coarse is None
            and (cons is None or isinstance(cons, FixedCoefs))
            and (system.fem.family, system.fem.kind) in fk.RESIDENT_SOURCES)


def launch(v0, u_prev, v_prev, f_ext, params, system, inv_blocks, pin_terms):
    """One launch of the kernel on v0's card, without synchronising.
    Returns (v (n, 3), stats): stats is a float64 tensor of STAT_FIELDS
    followed by the ||g|| history (max_inner + 1 entries, NaN where no
    iteration ran).

    Unlike the element kernels it is no `torch.library` operator: it runs a
    whole solve whose control flow reads its stats on the host, and nothing
    differentiates or linearizes through it. So it raises under make_fx
    tracing, whose graph would keep this launch's output as a constant."""
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
    partials = torch.empty(2 * -(-op.E // 32) * 3, dtype=dtype, device=dev)
    v = torch.empty_like(ins["v0"])
    stats = torch.full((len(STAT_FIELDS) + params.max_inner + 1,), float("nan"),
                       dtype=torch.float64, device=dev)
    mat = (ctypes.c_double * len(op.mat_args))(*op.mat_args)  # the material's constants
    fk._launch("newton_resident", op.tag, v0, ins["v0"], ins["u_prev"], ins["v_prev"],
               ins["f_ext"], ins["pin_aff"], pin_lin, inv, op.conn_t, op.gN_t, op.dV_t, op.Me_t,
               op.inc_ptr, op.inc, scratch, partials, v, stats, op.n, op.E, mat,
               float(params.dt), float(params.inner_atol),
               float(params.inner_rtol), float(params.cg_rtol), float(params.ew_eta_max),
               int(params.max_inner), int(params.cg_max_iter), int(params.ls_max))
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
