"""Phase ablation of the FEAT10 Hessian-vector product, with plain twins.

The port of `benchmarks/ablate_banded_hv.py`'s TPU kernels (`make_min_fn`
:89, `pallas_call` :121; `make_fn` / `make_body` :194 / :130, `pallas_call`
:221): seven variants of the banded Hv kernel at one launch shape, so that
their times isolate its phases. Here they are variants of K2 `hv` and K4
`node_reduce` (`fem_kernels`) in one CUDA source, `csrc/hv_phases.cu`
(design notes there), float32 and SVK only, as the script runs:

    dma_win     each block's slab of p                     -> (1, G) int32
    dma_wininv  the same plus its slabs of K4's CSR list   -> (3, G) int32
    dma         every word of K2's tables, per element     -> (5, E) int32
    gather      K2's gather of p through conn, per element -> (1, E) int32
    gfe         K2 itself (gather + element algebra)       -> (S*3, E)
    scat        K4's node sums of an (S*3, E) buffer       -> (n, 3)
    full        gfe then scat, the production pair         -> (n, 3)

G = ceil(E / 32) is K2's grid. The touch variants (dma_win, dma_wininv,
dma, gather) write one row per table they read (`ROWS`): the sum of its
raw 32-bit words mod 2^32, as int32. Integer sums are exact in any order,
so the kernels equal their twins bit for bit, table by table, and a table
a kernel skipped, wholly or in part, shows in its own row.

Each wrapper takes its plain twin (`<variant>_plain`) for a tensor on the
CPU and launches its kernel (through `fem_kernels._launch`) for a tensor on
a CUDA device, raising if it cannot; it never falls back. Each launch adds
one to `fem_kernels.LAUNCHES["hv_phase[<variant>]"]` (`full` once for its
two launches).
"""

from __future__ import annotations

import torch

from tlfea_torch.ops import fem_kernels as fk

__all__ = ["VARIANTS", "ROWS", "REPLACES", "SOURCE", "n_blocks", "scat_buffer",
           "dma_win", "dma_win_plain", "dma_wininv", "dma_wininv_plain", "dma", "dma_plain",
           "gather", "gather_plain", "gfe", "gfe_plain", "scat", "scat_plain", "full",
           "full_plain"]

VARIANTS = ("dma_win", "dma_wininv", "dma", "gather", "gfe", "scat", "full")
# touch variant -> the tables whose word sums its rows hold, in order
ROWS = {"dma_win": ("p",), "dma_wininv": ("p", "inc_ptr", "inc"),
        "dma": ("conn_t", "prep", "gN_t", "dV_t", "Me_t"), "gather": ("p[conn]",)}
# variant -> the TPU kernel it replaces
REPLACES = {v: "benchmarks/ablate_banded_hv.py:" + ("121" if v.startswith("dma_win") else "221")
            for v in VARIANTS}
SOURCE = "hv_phases.cu"
fk.LAUNCHES.update({f"hv_phase[{v}]": 0 for v in VARIANTS})


def n_blocks(op: fk.FemOperator) -> int:
    """K2's grid: one block a tile of 32 elements."""
    return -(-op.E // 32)


def _check(name: str, op: fk.FemOperator, **tensors) -> bool:
    """Check each tensor against the operator's tables (`FemOperator._check`:
    shape, contiguity, dtype, device) under its name: p (n, 3), prep
    (Q*prep_rows, E) or fes (S*3, E). True for CUDA tensors (launch), False
    for CPU ones (twin); raises for anything the kernels do not take (the
    launch checks the current device)."""
    if op.family != "feat10" or op.kind != "svk":
        raise ValueError(f"hv_phase[{name}]: instantiated for FEAT10 with SVK, not {op.tag}")
    shapes = {"p": (op.n, 3), "prep": (op.Q * op.prep_rows, op.E), "fes": (op.S * 3, op.E)}
    for k, t in tensors.items():
        op._check(f"hv_phase[{name}] {k}", t, shapes[k])
    cuda = op.gN_t.device.type == "cuda"
    if cuda and op.gN_t.dtype != torch.float32:
        raise TypeError(f"hv_phase[{name}]: the kernels take float32, got {op.gN_t.dtype}")
    return cuda


def _run(mode: str, op: fk.FemOperator, out, p=None, prep=None, fes=None, dt=0.0):
    """One call of the entry point for `mode` on the tables' card, writing
    out (and fes for `full`)."""
    x = next(t for t in (p, prep, fes) if t is not None)
    fk._launch("hv_phase", mode, x, VARIANTS.index(mode), p, op.conn_t, prep, op.gN_t, op.dV_t,
               op.Me_t, op.inc_ptr, op.inc, fes, out, op.n, op.E, float(dt), *op.mat_args)
    return out


def scat_buffer(op: fk.FemOperator, p: torch.Tensor) -> torch.Tensor:
    """The (S*3, E) values `scat` sums: p's words repeated, one cheap copy
    (the script fills its buffer from window rows; the content is
    irrelevant to the time)."""
    flat = p.reshape(-1)
    reps = -(-op.S * 3 * op.E // flat.numel())
    return flat.repeat(reps)[:op.S * 3 * op.E].view(op.S * 3, op.E).contiguous()


# --- plain twins -------------------------------------------------------------


def _words(t: torch.Tensor) -> torch.Tensor:
    """t's raw 32-bit words as int64 in [0, 2^32), shape t.shape + (itemsize
    / 4,)."""
    return (t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF).view(*t.shape, -1)


def _wrap(s: torch.Tensor) -> torch.Tensor:
    """int64 sums of words -> the int32 of their unsigned sum mod 2^32."""
    s = s & 0xFFFFFFFF
    return (s - ((s >> 31) << 32)).to(torch.int32)


def _slab_sums(words: torch.Tensor, G: int) -> torch.Tensor:
    """Sums of the G slabs of ceil(len / G) words (the last ones shorter)."""
    per = -(-words.numel() // G)
    padded = torch.zeros(G * per, dtype=words.dtype, device=words.device)
    padded[:words.numel()] = words
    return padded.view(G, per).sum(1)


def dma_win_plain(op, p):
    """Per block, the word sum of its slab of p's words, (1, G)."""
    return _wrap(_slab_sums(_words(p).reshape(-1), n_blocks(op)))[None]


def dma_wininv_plain(op, p):
    """Per block, the word sums of its slabs of p, inc_ptr and inc, (3, G)."""
    G = n_blocks(op)
    return _wrap(torch.stack([_slab_sums(_words(t).reshape(-1), G)
                              for t in (p, op.inc_ptr, op.inc)]))


def dma_plain(op, prep):
    """Per element, the word sums of its columns of K2's tables conn_t,
    prep, gN_t, dV_t, Me_t, (5, E)."""
    return _wrap(torch.stack([_words(t).sum((0, 2))
                              for t in (op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t)]))


def gather_plain(op, p):
    """Per element, the word sum of its slots' S*3 values of p, (1, E)."""
    return _wrap(_words(p)[op.conn].sum((1, 2, 3)))[None]


def gfe_plain(op, p, prep, dt):
    """K2's twin, (S*3, E)."""
    return fk.hv_plain(op, p, prep, dt)


def scat_plain(op, fes):
    """K4's twin, (n, 3)."""
    return fk.node_reduce_plain(op, fes)


def full_plain(op, p, prep, dt):
    """K4's twin of K2's twin: the node Hv without pin terms, (n, 3)."""
    return fk.node_reduce_plain(op, fk.hv_plain(op, p, prep, dt))


# --- wrappers ----------------------------------------------------------------


def _touch_out(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.empty((rows, cols), dtype=torch.int32, device=x.device)


def dma_win(op, p):
    if not _check("dma_win", op, p=p):
        return dma_win_plain(op, p)
    return _run("dma_win", op, _touch_out(p, 1, n_blocks(op)), p=p)


def dma_wininv(op, p):
    if not _check("dma_wininv", op, p=p):
        return dma_wininv_plain(op, p)
    return _run("dma_wininv", op, _touch_out(p, 3, n_blocks(op)), p=p)


def dma(op, prep):
    if not _check("dma", op, prep=prep):
        return dma_plain(op, prep)
    return _run("dma", op, _touch_out(prep, 5, op.E), prep=prep)


def gather(op, p):
    if not _check("gather", op, p=p):
        return gather_plain(op, p)
    return _run("gather", op, _touch_out(p, 1, op.E), p=p)


def gfe(op, p, prep, dt):
    if not _check("gfe", op, p=p, prep=prep):
        return gfe_plain(op, p, prep, dt)
    return _run("gfe", op, p.new_empty((op.S * 3, op.E)), p=p, prep=prep, dt=dt)


def scat(op, fes):
    if not _check("scat", op, fes=fes):
        return scat_plain(op, fes)
    return _run("scat", op, fes.new_empty((op.n, 3)), fes=fes)


def full(op, p, prep, dt):
    if not _check("full", op, p=p, prep=prep):
        return full_plain(op, p, prep, dt)
    fes = p.new_empty((op.S * 3, op.E))
    return _run("full", op, p.new_empty((op.n, 3)), p=p, prep=prep, fes=fes, dt=dt)
