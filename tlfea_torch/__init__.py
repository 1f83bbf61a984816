"""tlfea_torch — the PyTorch/CUDA port of tlfea for NVIDIA Hopper (H100).

A second package beside `tlfea/` (JAX + Pallas for the TPU), which stays the
reference. The layout mirrors `tlfea/` module for module, so the counterpart
of `tlfea/x/y.py` is `tlfea_torch/x/y.py`. Host-side NumPy setup code is
copied, not imported: importing any `tlfea.*` module pulls in jax
(`tlfea/__init__.py:28-52`), and this package never imports jax.

The slices ported so far are the implicit step for FEAT10, ANCF3243 and
ANCF3443 elements: damped St. Venant-Kirchhoff and Mooney-Rivlin, pins
(`FixedCoefs`, `DensePins`) and general linear constraint rows, backward
Euler as an augmented-Lagrangian minimisation over velocity, matrix-free
Newton-PCG with a block-Jacobi preconditioner and the frozen
coarse correction, the first-order solvers, and the accuracy mode
(`System.accum_dtype`: float64 kernels under a float32 problem). Its
element work runs in hand-written CUDA kernels (`tlfea_torch/csrc/`,
wrapped by `tlfea_torch.ops.fem_kernels`), each beside a plain PyTorch
twin. Around the solvers: `collision` (the hydroelastic contact pipeline
and the DEM backends, in plain tensor code: the JAX package has no Pallas
kernel there), `simulation.Simulation` (stepping, checkpoints, re-pinning,
collision with capacity regrowth) and `newton.make_coupled_rollout`,
`diagnostics`, the host utilities of `utils` (mesh IO, VTK writers,
scenes, profiling), and every example script of `examples/`
(`tlfea_torch.examples`). Builders and `interop.from_numpy_system` put
their tensors on the card unless given device="cpu".

Precision: float32 matrix products and convolutions run in full float32.
TF32 keeps about three decimal digits — the Hopper form of the bf16-pass
fault recorded in `tlfea/__init__.py:45-52` (1-3 % errors in F and P).
bfloat16 products (the coarse correction's `mm_dtype="bfloat16"` tables)
accumulate in float32: cuBLAS may otherwise reduce them in bfloat16.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from tlfea_torch import utils, materials, elements, ops, constraints, solvers, interop  # noqa: E402,F401
from tlfea_torch import collision, diagnostics, native, simulation  # noqa: E402,F401
