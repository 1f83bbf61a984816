"""Time other instantiations of K1-K3 beside the shipped ones, in float32 on
the card, at the 10k FEAT10 flagship and the 5,184-element shell shapes.

    python -m tlfea_torch.tools.kernel_variants      # from the repository root

Builds `tlfea_torch/csrc/kernel_variants.cu` (variants of the quadrature-point
split NG and of where the partial sums live) next to the library, checks
each variant against the plain twin, and prints its device time per launch
(`chip_smoke._device_ms`), each variant twice, in the order A B C ... C B A.
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
            "ancf3443": ["s4smem", "s6regs", "s8smem", "s8regs"]}


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # the problem builders and the stream-holding timer

    dev = torch.device("cuda")
    fk.build_kernels()
    so = os.path.join(fk._BUILD, "libkernel_variants.so")
    res = subprocess.run([fk._nvcc(), *fk._NVCC_FLAGS, "-o", so,
                          os.path.join(fk._CSRC, "kernel_variants.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    sigs = {"primal_prep": [P] * 7 + [I] + [D] * 4 + [P], "hv": [P] * 7 + [I] + [D] * 5 + [P],
            "svk_blocks": [P] * 5 + [I] + [D] * 2 + [P]}
    problems = {"feat10": cs.flagship_problem("cpu", torch.float64)[0],
                "ancf3443": cs.shell_problem("cpu", torch.float64)[0]}
    for family, system in problems.items():
        op = fk.FemOperator(system.elems.to(dev, torch.float32), system.material)
        rng = np.random.default_rng(cs.SEED)
        n = op.n
        packed = torch.as_tensor(np.concatenate([rng.normal(size=(n, 3)) * 1e-3,
                                                 rng.normal(size=(n, 3)) * 1e-2,
                                                 rng.normal(size=(n, 3))], 1),
                                 dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
        u = p * 1e-3
        fe_ref, prep = fk.primal_prep_plain(op, packed)
        ref = {"primal_prep": fe_ref, "hv": fk.hv_plain(op, p, prep, 1e-3),
               "svk_blocks": fk.svk_blocks_plain(op, u)}
        names = [family] + VARIANTS[family]
        for v in names + names[::-1]:
            src = fk.build_kernels()[op.source] if v == family else lib
            row = []
            for k in ("primal_prep", "hv", "svk_blocks"):
                f = getattr(src, f"tlfea_{k}_{v}_f32")
                f.argtypes, f.restype = sigs[k], ctypes.c_int
                out, pr = torch.empty_like(ref[k]), torch.empty_like(prep)
                s = torch.cuda.current_stream().cuda_stream
                args = {"primal_prep": (packed, op.conn_t, op.gN_t, op.dV_t, op.Me_t, out, pr, op.E,
                                        op.lam, op.mu, op.eta, op.lam_d, s),
                        "hv": (p, op.conn_t, prep, op.gN_t, op.dV_t, op.Me_t, out, op.E, 1e-3,
                               op.lam, op.mu, op.eta, op.lam_d, s),
                        "svk_blocks": (u, op.conn_t, op.gN_t, op.dV_t, out, op.E, op.lam, op.mu, s)}[k]
                conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

                def call(f=f, conv=conv):
                    err = f(*conv)
                    if err != 0:
                        raise RuntimeError(f"{k}[{v}] launch failed: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                rel = float((out - ref[k]).abs().max() / ref[k].abs().max())
                if not rel <= 1e-5:
                    raise AssertionError(f"{k}[{v}] disagrees with its twin: {rel:.3e}")
                row.append(f"{k} {cs._device_ms(call, 256)[0] * 1e3:.2f} us")
            print(f"{family} {v}: " + ", ".join(row), flush=True)


if __name__ == "__main__":
    main()
