"""Time other instantiations of the element kernels beside the shipped ones,
in float32 on the card: K1-K3 at the 10k FEAT10 flagship and the 5,184-element
shell shapes (SVK), and K1, K2 and K5t with Mooney-Rivlin at the shell's and
at the 64-element ANCF3243 beam's shapes.

    python -m tlfea_torch.tools.kernel_variants      # from the repository root

Builds `tlfea_torch/csrc/kernel_variants.cu` (variants of the quadrature-point
split NG and of where the partial sums live) next to the library, prints
its ptxas report (registers and spills), checks each variant against the
plain twin, and prints its device time per launch (`chip_smoke._device_ms`),
each variant twice, in the order A B C ... C B A.
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
    for line in res.stderr.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("ptxas: " + line.split("ptxas info    :")[-1].strip())
    lib = ctypes.CDLL(so)
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
            print(f"{tag} {v}: " + ", ".join(row), flush=True)

if __name__ == "__main__":
    main()
