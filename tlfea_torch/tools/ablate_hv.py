"""Where the time of one Hessian-vector product goes, phase by phase, on the card.

    TLFEA_SCALE=100k python -m tlfea_torch.tools.ablate_hv    # from the repository root
                                                               # (1k | 10k | 100k, default 100k)

The counterpart of `benchmarks/ablate_banded_hv.py`, on the same problem:
bench.py's FEAT10 box at the scale's `CONFIGS` dims (the script's :45-49),
renumbered by `best_order`, damped SVK (E 1e7, nu 0.3, damping 1e3), the
x = 0 face pinned, float32; v = 0.1 N(0, 1), p = N(0, 1) (numpy, seeded by
`chip_smoke.SEED`), dt 1e-3, and the prep cache from one K1 pass at packed
= [0 | v | 0]. It times each variant of `tlfea_torch.ops.hv_phases` (dma_win,
dma_wininv, dma, gather, gfe, scat, full) and `prod`, the production Hv
(`fem_kernels.hv` + `node_reduce` through their wrappers), and prints one
line each: device ms per call (`chip_smoke._device_ms`), host ms per call,
the least time the card could take (`chip_smoke._bound` over the bytes the
variant must read and write, or its operations), the share of that bound,
and the plain twin's device ms. Then it holds each variant to its twin
(`check`): the touch variants' word sums bit for bit, table by table; gfe
bitwise K2's output, full bitwise prod's, scat bitwise K4's on the same
buffer. It needs a card and raises without one.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.ops import hv_phases as hp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# bench.py's boxes (L, W, H, cells along x, y, z), as benchmarks/ablate_banded_hv.py:45-49
CONFIGS = {
    "1k": (1.0, 0.25, 0.25, 12, 4, 3),
    "10k": (2.0, 0.35, 0.3, 42, 7, 6),
    "100k": (4.0, 0.7, 0.6, 96, 16, 11),
}
DT = 1e-3
# gfe, scat and full against their float32 twins (another order of sums),
# relative to the twin's largest entry
TOL = 1e-5


def _cs():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def elements(scale: str) -> int:
    """The box's element count: six tetrahedra a cell (`box_t10_mesh`)."""
    _, _, _, nx, ny, nz = CONFIGS[scale]
    return 6 * nx * ny * nz


def problem(scale: str, device):
    """(op, p, prep, dt) of the scale's box in float32 on `device`: the
    operator of `chip_smoke.flagship_problem` at the scale's dims, the
    direction p and K1's prep cache at [0 | v | 0]."""
    cs = _cs()
    system = cs.flagship_problem(device, torch.float32, CONFIGS[scale])[0]
    op = system.fem
    rng = np.random.default_rng(cs.SEED)
    v = 0.1 * rng.normal(size=(op.n, 3))
    p = rng.normal(size=(op.n, 3))
    zero = np.zeros_like(v)
    packed = torch.as_tensor(np.concatenate([zero, v, zero], axis=1), dtype=torch.float32,
                             device=device)
    _, prep = fk.primal_prep(op, packed)
    return op, torch.as_tensor(p, dtype=torch.float32, device=device), prep, DT


def work(name: str, op: fk.FemOperator):
    """(words read and written, operations) of one call: each input word
    read once, each output word written once (int32 tables and sums are
    words too); the touch variants' operations are their integer
    additions, gfe's and scat's K2's and K4's (`chip_smoke._pass_work`),
    full's and prod's both, their (S*3, E) values kept off memory."""
    cs = _cs()
    E, Q, S, n, G = op.E, op.Q, op.S, op.n, hp.n_blocks(op)
    tables = S * E + Q * op.prep_rows * E + Q * S * 3 * E + Q * E + S * S * E
    if name == "dma_win":
        return 3 * n + G, 3 * n
    if name == "dma_wininv":
        return 3 * n + (n + 1) + S * E + 3 * G, 3 * n + (n + 1) + S * E
    if name == "dma":
        return tables + 5 * E, tables
    if name == "gather":
        return S * E + 3 * n + E, S * 3 * E
    if name == "gfe":
        return cs._pass_work("hv", op)
    if name == "scat":
        return cs._pass_work("node_reduce", op, C=3)
    (w2, f2), (w4, f4) = cs._pass_work("hv", op), cs._pass_work("node_reduce", op, C=3)
    return w2 + w4 - 2 * S * 3 * E, f2 + f4


def _args(op, p, prep, dt):
    """{variant: the arguments of its wrapper and twin after op}."""
    return {"dma_win": (p,), "dma_wininv": (p,), "dma": (prep,), "gather": (p,),
            "gfe": (p, prep, dt), "scat": (hp.scat_buffer(op, p),), "full": (p, prep, dt)}


def calls(op, p, prep, dt):
    """{name: (call through the wrapper, call of the plain twin)}: the seven
    variants, then prod."""
    args = _args(op, p, prep, dt)
    out = {v: (lambda v=v: getattr(hp, v)(op, *args[v]),
               lambda v=v: getattr(hp, v + "_plain")(op, *args[v])) for v in hp.VARIANTS}
    out["prod"] = (lambda: fk.node_reduce(op, fk.hv(op, p, prep, dt)),
                   lambda: hp.full_plain(op, p, prep, dt))
    return out


def profile(op, p, prep, dt, log=print):
    """Time each variant and prod (device ms per call with the stream held,
    host ms per call, the twin's device ms; twin, kernel, kernel, twin) and
    log one line each. Returns {name: record}."""
    cs = _cs()
    smi = cs.card_line()
    log(f"E={op.E} elements, n={op.n} nodes, float32, on {smi}")
    rows = {}
    for name, (k_call, p_call) in calls(op, p, prep, dt).items():
        p1, _ = cs._device_ms(p_call, 16)
        k1, host = cs._device_ms(k_call, 256)
        k2, _ = cs._device_ms(k_call, 256)
        p2, _ = cs._device_ms(p_call, 16)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        b_ms, b_by = cs._bound(*work(name, op), 4)
        log(f"{name:10s} device {ms:.4f} ms, host {host:.4f} ms; bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.3f} of it; twin {plain_ms:.4f} ms")
        rows[name] = dict(ms=ms, host_ms=host, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return rows


def differing_tables(variant: str, got: torch.Tensor, want: torch.Tensor) -> list:
    """The tables (`hv_phases.ROWS`) whose word sums differ between a touch
    variant's output and its twin's."""
    return [t for t, g, w in zip(hp.ROWS[variant], got.cpu(), want.cpu()) if not torch.equal(g, w)]


def plant_skip(op, p, prep, table: str, part: str = "all"):
    """(op, p, prep) as a touch variant that skipped `table` (a name in
    `hv_phases.ROWS`), "all" of it or "every other row", would read them:
    copies with that table zeroed there, since a word sum that skips a word
    adds what a zero word adds. A sound check refuses the variant's output
    on them, naming that table (`check_refuses_skips`)."""
    op, p, prep = copy.deepcopy(op), p.clone(), prep.clone()
    t = {"p": p, "p[conn]": p, "prep": prep}.get(table)
    t = getattr(op, table) if t is None else t
    if part == "all":
        t.zero_()
    else:
        t[::2] = 0
    return op, p, prep


def check_refuses_skips(op, p, prep, dt, log=print):
    """Plant a skip of each table of each touch variant, wholly and every
    other row (`plant_skip`), run the variant on it and require that
    `differing_tables` against the twin on the true tables names exactly
    that table. Raises otherwise. Returns the number of plants."""
    args = _args(op, p, prep, dt)
    n, bad = 0, []
    for v, tables in hp.ROWS.items():
        want = getattr(hp, v + "_plain")(op, *args[v])
        for table in tables:
            for part in ("all", "every other row"):
                sop, sp, sprep = plant_skip(op, p, prep, table, part)
                got = getattr(hp, v)(sop, *_args(sop, sp, sprep, dt)[v])
                seen = differing_tables(v, got, want)
                n += 1
                if seen != [table]:
                    bad.append(f"{v} skipping {part} of {table}: the check saw {seen}")
    log(f"touch check against {n} planted skips: {'all refused' if not bad else bad}")
    if bad:
        raise AssertionError("hv_phases: " + "; ".join(bad))
    return n


def check(op, p, prep, dt, log=print):
    """Hold each variant to its twin on the same inputs: the touch variants'
    word sums bit for bit, table by table; gfe to K2's output and full to
    prod's bit for bit, scat to K4's on the same buffer bit for bit, and
    these three within TOL of their twins' largest entry. Raises on a miss,
    naming the tables whose sums differ. Returns {variant: (max abs err, max
    rel err)}."""
    args = _args(op, p, prep, dt)
    k2 = fk.hv(op, p, prep, dt)
    bitwise = {"gfe": ("K2", k2), "full": ("prod", fk.node_reduce(op, k2)),
               "scat": ("K4", fk.node_reduce(op, *args["scat"]))}
    errs, bad = {}, []
    for v in hp.VARIANTS:
        got = getattr(hp, v)(op, *args[v])
        want = getattr(hp, v + "_plain")(op, *args[v])
        wide = torch.int64 if v in hp.ROWS else torch.float64
        diff = (got.to(wide) - want.to(wide)).abs().max()
        # A block past the end of dma_win's words sums none: 0 against 0.
        rel = float(diff) / max(float(want.to(wide).abs().max()), torch.finfo(torch.float64).tiny)
        errs[v] = (float(diff), rel)
        if v in hp.ROWS:
            tables = differing_tables(v, got, want)
            note = f"word sums of {', '.join(hp.ROWS[v])} bit for bit: {not tables}"
            if tables:
                bad.append(f"{v}: the word sums of {', '.join(tables)} differ from the twin's")
        else:
            ref, ref_out = bitwise[v]
            same = bool(torch.equal(got, ref_out))
            note = f"{rel:.3e} relative (tol {TOL:g}); bit for bit {ref}: {same}"
            if not same:
                bad.append(f"{v} differs from {ref}")
            if not (rel <= TOL and bool(torch.isfinite(got).all())):
                bad.append(f"{v} off its twin: {rel:.3e}")
        log(f"{v:10s} vs its twin: max abs err {errs[v][0]:.3e}; {note}")
    if bad:
        raise AssertionError("hv_phases: " + "; ".join(bad))
    return errs


def main():
    if not torch.cuda.is_available():
        sys.exit("ablate_hv: no CUDA device (torch.cuda.is_available() is false)")
    scale = os.environ.get("TLFEA_SCALE", "100k")
    if scale not in CONFIGS:
        sys.exit(f"ablate_hv: TLFEA_SCALE must be one of {', '.join(CONFIGS)}, not {scale!r}")
    dev = torch.device("cuda")
    op, p, prep, dt = problem(scale, dev)
    profile(op, p, prep, dt, log=lambda m: print(f"[{scale}] {m}", flush=True))
    check(op, p, prep, dt, log=lambda m: print(f"[{scale}] {m}", flush=True))


if __name__ == "__main__":
    main()
