"""Save the SVK element kernels' outputs and float32 device times at the 10k
flagship's shapes, and the FEAT10 SVK persistent kernel's outputs on one
inner solve of the bench.py "1k" problem, or compare two saved files bit for
bit: a check that a change to the kernels' sources leaves their results as
they were.

    python tlfea_torch/tools/kernel_outputs.py save OUT.pt      # from a tree's root
    python tlfea_torch/tools/kernel_outputs.py compare A.pt B.pt

`save` imports `chip_smoke` and `tlfea_torch` from the current directory, so
run from the root of each tree to compare (for example this one and an
unpacked `git archive` of its parent), on the same card, in turns (parent,
this, this, parent). Inputs come from a numpy seed: K1-K5t and K4 in
float32 and float64; device ms per launch from `chip_smoke._device_ms`. The
persistent kernel's inputs are the state after 10 steps from rest through
the plain twins (`system.plain`), so they do not depend on the kernels
compared; its outputs are v and the stats tensor.
"""

import os
import sys

import numpy as np
import torch


def save(path: str) -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tlfea_torch.ops import fem_kernels as fk

    dev = torch.device("cuda")
    system = cs.flagship_problem("cpu", torch.float64)[0]
    res = {}
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
        calls = {"primal_prep": lambda: fk.primal_prep(op, packed),
                 "hv": lambda: fk.hv(op, p, prep, 1e-3),
                 "svk_blocks": lambda: fk.svk_blocks(op, u),
                 "node_reduce": lambda: fk.node_reduce(op, fe),
                 "contrib": lambda: fk.contrib(op, packed),
                 "contrib_tangent": lambda: fk.contrib_tangent(op, packed, dp)}
        out = {"prep": prep}
        for name, fn in calls.items():
            got = fn()
            out[name] = got[0] if isinstance(got, tuple) else got
        out.update(_resident_outputs(cs, dev, dtype))
        res[str(dtype)] = {k: v.cpu() for k, v in out.items()}
        if dtype == torch.float32:
            res["ms"] = {k: cs._device_ms(fn, 256)[0] for k, fn in calls.items()}
    torch.save(res, path)
    print(os.getcwd(), {k: round(v * 1e3, 3) for k, v in res["ms"].items()}, "us per launch")


def _resident_outputs(cs, dev, dtype) -> dict:
    """v and the stats (NaN history slots as -1) of one launch of the FEAT10
    SVK persistent kernel, from the 1k problem's state after 10 steps
    through the twins."""
    from dataclasses import replace

    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton

    system, state, f_ext, params = cs.flagship_problem(dev, dtype, cs.RESIDENT_DIMS)
    plain = replace(system, plain=True)
    state, _ = newton.make_rollout(plain, params, 10, precond_refresh=8)(state, f_ext)
    v, stats = resident.launch(*newton.inner_solve_args(system, state, f_ext, params))
    return {"newton_resident_v": v, "newton_resident_stats": stats.nan_to_num(-1.0)}


def compare(a_path: str, b_path: str) -> bool:
    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for dtype in ("torch.float32", "torch.float64"):
        for k in a[dtype]:
            eq = torch.equal(a[dtype][k], b[dtype][k])
            same &= eq
            print(dtype, k, "bitwise equal" if eq else
                  f"DIFFERS, max {float((a[dtype][k] - b[dtype][k]).abs().max()):.3e}")
    return same


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"]:
        save(sys.argv[2])
    elif sys.argv[1:2] == ["compare"]:
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    else:
        sys.exit(__doc__)
