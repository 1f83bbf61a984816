"""Quick proof that the PyTorch/CUDA port (`tlfea_torch`) runs on an NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package `tlfea`. Phases, each
printed on its own lines with its seconds; any failure raises and exits
non-zero:

1. setup: the card's name and power limit (nvidia-smi), the precision
   pins (TF32 off, bfloat16 products reduced in float32), and the nvcc build of the FEM kernels from `tlfea_torch/csrc/`
   (one nvcc per source, all at once; seconds, registers and spills per
   kernel).
2. kernels: each kernel of each element family, with SVK and with
   Mooney-Rivlin, against its plain PyTorch twin on the card, on inputs
   made from a seed (float64 within 1e-12 relative, float32 within 1e-5),
   at the shapes of the 10,584-element FEAT10 flagship mesh, of the
   5,184-element ANCF3443 shell plate and of a 64-element ANCF3243 beam
   (Mooney-Rivlin at a strained state, J - 1 within about +-0.4); each timed beside its twin (device time per
   launch from CUDA events, host time per wrapper call), beside its bound
   (bytes over 3.35 TB/s or flops over 67 TFLOP/s, whichever is larger;
   the float64 K1, K2, K4, K5 and K5t that the accuracy mode launches also
   timed, beside their bound at 33.5 TFLOP/s) and,
   for the node reduce, beside `Tensor.index_add_`; with each kernel's
   registers and local bytes a thread and blocks an SM (the CUDA runtime),
   and the waves its grid takes over the card's SMs (in the kernels' JSON
   record `regs` and `waves`, as for the persistent and phase kernels, and an
   element or phase kernel's block as `block`, [threads, elements]). K5 `contrib` must equal
   K1's fe bit for bit in float32, and K5t `contrib_tangent` + K4 along the
   Newton chain (dt p, p, p/dt) must match K2 + K4 along p.
3. beam: the float32 FEAT10 beam sag (box 10x1x1, dt 1e-3, 150 steps)
   through the kernels, against `tests/fixtures/beam_sag_t10_tip.csv` (the
   float64 CPU trajectory of the JAX package) within 1e-6 of the
   displacement scale.
4. flagship: the `bench.py` "10k" problem (FEAT10 box 42x7x6, damped SVK,
   x=0 face pinned, float32, tolerance 2.5 % of ||f_ext||, frozen coarse
   correction, block-Jacobi refreshed every 8 steps): a warm-up 60-step
   rollout, then a timed one; ms/step, median Newton and CG counts,
   newton_unconverged_frac (the share of steps whose last iterate failed
   the inner test, from each step's converged flag) and the kernels' launch
   counts in the timed rollout,
   which must all be non-zero; a torch.profiler window of 16 more steps
   gives the device busy time per step and the largest device operations
   ([trace] lines). Then 5 steps from rest through the kernels and through
   the plain twins on the card, whose positions must agree within 5e-3 of
   the coordinate scale. Last, the float32 gradient's rounding noise at
   the final state (against the float64 twins, over ||f_ext||) and the
   float64 kernels' Newton and CG medians over the same steps.
5. resident: the `bench.py` "1k" problem (FEAT10 box 12x4x3, 864
   elements, the same material and solver settings, no coarse
   correction, 250 steps) through the persistent Newton-PCG kernel
   (`newton_resident[feat10]`): the rollout as in 4, with one kernel launch
   per inner solve, K2 never launched, K1 + K4 once for each step that
   stopped at the Newton cap (the converged flag's test of its last
   iterate) and K3/K4 at the preconditioner refreshes; one float64
   inner solve from the 10th step's state, kernel against its plain
   version (the same Newton count, CG within 2, positions within 1e-10
   relative); the same in float32, the rollout's dtype (CG within 2, v
   within 1e-3 of the solve's update, or within twice the float32 plain
   version's distance from the float64 one where that is larger, as for
   Mooney-Rivlin, whose isochoric terms cancel to O(strain)), and bitwise
   repeatability; the
   device time per launch beside its bound (`resident_bound_ms`: inputs
   read once, the launch's operations) and the plain version's time; then
   the same inner solve and rollout through the composed K1-K4 path (the
   gate patched off) for comparison.
   resident_mr: the same with the material of 13 (Mooney-Rivlin), through
   `newton_resident[feat10_mr]`; K3/K4 never launched (its blocks are plain
   tensor code).
6. shell: the same as 4 for `bench.py`'s `run_ancf_shell` (ANCF3443 plate
   72x72, 5,184 elements, 21,316 coefficient rows, the x=0 edge clamped,
   the same solver settings, 40 steps).
   shell_mr: the same plate with the material of 13, through the
   `[ancf3443_mr]` kernels, the exact Mooney-Rivlin blocks and the coarse
   correction (ANCF3443 never runs resident, in neither package).
7. shell_theory: the cantilever plate of `tests/test_shell_validation.py`
   (8 ANCF3443 elements, E 2e10, nu 0) in float64 on the card, 66 steps
   (the test's 150 cut; THEORY_STEPS): tip deflection within 5 % of
   q L^4 / (8 E I).
8. ancf_beam, ancf_beam_1024: a clamped 64-element ANCF3243 beam under
   gravity (the bench.py solver settings, no coarse correction), 20 steps
   through `newton_resident[ancf3243]` with the checks of 5; then the same
   beam of 1,024 elements, one element block whose grid is 32 tiles.
   ancf_beam_mr, ancf_beam_mr_1024: both in the material of 13, through
   `newton_resident[ancf3243_mr]`.
9. adamw, nesterov, vbd: the first-order solvers on the 10k flagship with
   `examples/_common.make_solver`'s parameter sets (rho 1e7): a warm step
   capped at 500 inner iterations (a full AdamW step is 60,000), then timed
   steps (ms/step, ms per inner iteration or sweep, outer and
   inner counts, launches: K5 and K4 only, plus K3 for VBD's blocks); a
   torch.profiler window of a capped step of 200 inner iterations (device
   busy share); one capped step from rest through the kernels and through
   the twins (equal counts, positions within 5e-3 of the coordinate scale).
10. jvp: torch.func.jvp of grad_L at the AdamW state along 8 directions,
   through K5t + K4, against the Newton path's K2 + K4 product.
11. first_order_vs_newton: `tests/test_solvers.py:86-130` at the flagship
   size: AdamW and Nesterov (30,000 iterations a step, two steps) within
   10 % of the deformation from Newton's positions.
12. first_order_ancf: one capped AdamW step and the jvp on the shell plate
   and the ANCF3243 beam, with SVK and with the material of 13 (K5, K5t in
   those families).
13. mr_flagship: the 10k problem of 4 with its material swapped for
   Mooney-Rivlin (mapped from E 1e7, nu 0.3 as `examples/bunny_deform.py`
   maps it, damping 1e3): the same rollout, trace and check as 4, through
   the Mooney-Rivlin instantiations of K1 and K2 (`[feat10_mr]`), K4, the
   exact Mooney-Rivlin preconditioner blocks (plain tensor code) and the
   coarse correction. Its kernels sit in 2 beside the others, at the
   flagship's shapes.
14. bunny_mr: `examples/bunny_deform.py --material mooney_rivlin` on its
   fallback mesh (box 1 x 1 x 2, 2 x 2 x 4 cells, 96 elements; E 5e5, nu
   0.4, damping 50, base clamped, 20 N on each ear node, rho_alm 1e8) with
   `make_solver("newton")`'s parameters and the coarse correction, float32:
   the rollout of 4 over 30 steps, then max |dx| every 5 steps as the
   example prints it, beside a float64 run through the plain twins.
15. mr_first_order: one AdamW step of make_solver's parameters (inner cap
   2,000) on the Mooney-Rivlin flagship through K5 `[feat10_mr]` + K4, as in
   9; then the jvp of 10 through K5t `[feat10_mr]`.
16. hv_phases (after 2): `python -m tlfea_torch.tools.ablate_hv`, the port of
   `benchmarks/ablate_banded_hv.py`, at its default box (bench.py "100k",
   96 x 16 x 11 cells, 101,376 elements) and at the flagship's (10,584): the
   seven phase variants of K2 + K4 (`tlfea_torch.ops.hv_phases`:
   dma_win, dma_wininv, dma, gather, gfe, scat, full) and the production
   Hv, each timed beside its bound and its twin (the phase table, with the
   card's name and power limit), every variant launched; then each held to
   its twin: gfe equal to K2's output and full to the production Hv's bit
   for bit, scat to K4's on the same buffer, the touch variants' sums of
   each table's raw words equal to their twins' bit for bit, table by
   table. At 100k also `Tensor.index_add_` beside scat; at 10k gfe's time
   within 2x of K2's in 2, and the touch check must refuse each touch
   variant run on its tables with one of them zeroed, wholly or every other
   row (a planted skip), naming that table.
17. linearize (after 10): `torch.func.linearize(grad_L)` on the 10k
   flagship at the AdamW state, float64 and float32, against
   `torch.func.jvp` along 3 directions (bars 1e-12 and 1e-5 relative); each
   call of the linearized function must launch K5t once (its graph holds
   the `tlfea.contrib_tangent` and `tlfea.node_reduce` operators).
18. dense_pins (after 5): the "1k" problem of 5 pinned by `DensePins` on
   the same pins, 250 steps through `newton_resident[feat10]` beside the
   same rollout pinned by `FixedCoefs`: equal Newton and CG counts,
   positions within 1e-6 of the displacement scale (whether bitwise is
   printed), the dense duals zero off the pins; then prescribed motion,
   the pinned face's targets moved down at 0.05 m/s (`with_targets` every
   step) for 100 steps, through the persistent kernel and through the
   composed K1-K4 path (the gate patched off): positions within 1e-3 of
   the displacement scale (the resident float32 bar of 5).
19. linear_rows (after 8): the 64-element ANCF3243 beam of 8 clamped by
   `fix_dof` rows (`LinearConstraints`, 12 rows), 20 steps on the composed
   path (K1, K2, K3 and K4 `[ancf3243]`; linear rows never run resident),
   twice, bitwise equal (no atomics), against the beam pinned by
   `FixedCoefs` on the same path: positions within 1e-5 of the
   displacement scale.
20. accuracy_mode (after 19): `System.accum_dtype` float64 on float32
   problems. (a) The stiff beam of `tests/test_f32_stiff.py` (8 x 2 x 2
   cells, 192 elements, E 7e8, rho_alm 1e11, 40 steps ramped over 30) in
   the accuracy mode (u in float64; composed K1, K2, K4 in float64, K3
   float32, never resident), to at most 1e-3 of the load, and in pure
   float32 (resident), to at most 1e-2; both final residuals and each
   gradient against the float64 twins at its final state. (b) The 10k
   flagship at bench.py's 10k_tight tolerance (0.5 % of ||f_ext||), pure
   float32 then the accuracy mode: ms/step, median Newton and CG,
   newton_unconverged_frac, the launches and those of the float64
   instantiations (none in pure float32, K1, K2 and K4 in the accuracy
   mode), a [trace] window. (c) `gradient_noise` with and without the
   accuracy mode on the SVK and MR flagships, and against the float64
   twins on the same tables cast up; then grad_L and its jvp at 10k in the
   accuracy mode (float64 K5, K5t, K4).
21. simulation (after 20): the 1k box of 5 pinned by `DensePins` through
   `Simulation` + `newton.stepper` under `gravity_force`, 20 steps
   (resident), bitwise `make_rollout`'s; `save_state` at step 10 and
   `load_state` into a new Simulation, 10 more steps, bitwise the
   uninterrupted run; `energy_report` every 5 steps; `set_pinned` releases
   one pinned node for 5 more steps; a VTU of the final state under `out/`;
   `StepTimer`'s per-phase ms.
22. collision (after 21): the hydroelastic pipeline (`tlfea_torch.collision`)
   coupled to the float32 FEAT10 Newton step, on `bench.py`'s two
   collision scenes without their meshes (the reference's sphere and dragon
   meshes are not in the repository): (a) `collision`, two 0.5 m boxes of 4
   x 4 x 2 cells (192 T10 each), the upper lifted by its height + 2 mm and
   falling at 1 m/s, window 256, max_pairs 4,096, dt 5e-4, friction 0.3,
   the bottom 5 % of the scene pinned (dense broadphase); (b) `dragon`, a
   0.3 x 0.3 x 0.257 m box of 14 x 14 x 12 cells (14,112 T10, the
   reference dragon has 14,273) pressed 0.15 H deep by a floor of 6 x 6 x 2
   cells (432), its top 8 % and the floor's base pinned, window 256,
   max_pairs 8,192, dt 2e-4 (block broadphase: 6.1 M cross pairs). SVK E
   1e6, nu 0.3, damping 1e2, `distance_pressure_field(..., 1e6)`,
   `MeshManager.scene(reorder=True)`, `build_coarse_precond`, bench.py's
   Newton settings. Protocol of `bench.py:505-628`: 15 / 30 warm steps of
   `Simulation` + `newton.stepper` (the capacity regrown on overflow), then
   `make_coupled_rollout(..., precond_refresh=8)` over 40 steps, warm, then
   timed: ms/step, median Newton and CG, overflow events and the timed
   flag (must be false), contacts at the end (must be > 0), the device ms
   of `broadphase_fn`, `narrowphase_fn` and `forces_fn` alone (CUDA events
   over 30 calls, and the profiler's device time over 3, at the end state),
   a [trace] of 2 steps, the K1-K4 launches of the timed rollouts (in the
   kernels' record). Checks: the third law (|sum f| <= 1e-5 max |f|, the
   float32 forces summed in float64) at both end states; scene (b)'s
   collision step at its end state in float64 on the card against the
   port on the CPU (equal masks and patch counts, forces within 1e-10 of
   max |f|); `tests/test_coupled_rollout.py`'s scene, 5 float32 steps of
   `make_coupled_rollout` bitwise the `Simulation` loop; the hairpin of
   `tests/test_self_collision.py` (nx 24, grid broadphase, margin 0.02)
   with its upper leg pressed 4 cm down, the grid's candidates covering the
   brute-force AABB pairs less the neighbours, and its float64 step
   against the CPU as for (b); `NodeSphereDem` (two boxes 0.04 apart) and
   `GranularDem` (a sphere grid over a plate), one float64 step each
   against the CPU within 1e-10, the third law for `NodeSphereDem`, and a
   timed float32 step of each.

23. flagship_100k (after 4): bench.py's "100k" scale (FEAT10 box 96 x 16
   x 11, 101,376 elements, 146,487 nodes, the 10k problem's material,
   pins and Newton settings, float32) with bench.py's coarse correction
   above 50,000 nodes (range flag, 1,024 aggregates, bfloat16 apply
   tables: Agg 299 MB, the inverse Cholesky factor Li): the host setup's
   seconds, the correction's build seconds and bytes, then the rollout of
   4 over 30 steps (ms/step, device busy ms/step from the trace, Newton
   and CG medians, newton_unconverged_frac, K1-K4 launches, which join the
   FEAT10 rows of the kernels' record) and kernels vs twins after 5
   steps. Then the bfloat16 correction against the dense full-precision
   one on the same aggregates, 5 steps from rest each: in float32 at the
   rollout's tolerance, CG per step at most 1.3 x + 2 (the displacements'
   difference printed); in float64 at tests/test_coarse_precond.py's
   tolerances (Newton to 1e-6 of ||f_ext||, CG to 1e-6), CG likewise and
   the displacements within 1e-3 of their scale.
24. coarse_modes (after 22): the 10k flagship for 8 steps from rest with
   each coarse mode (trans, rigid, affine, rigid with bfloat16 tables):
   Newton and CG medians, ms/step; one step of the legacy per-solve
   two-level path (`CoarseSetup`); each mode's float64 apply on the card
   against the CPU's, within max(1e-12, 8 eps kappa(A_c)) of its scale
   (bfloat16 3e-2).
25. native: the port's g++ helper built; its colours and incidence on the
   10k flagship equal to the NumPy functions'; at 100k the helper timed.
26. examples: each ported example script's `main()` on the card in
   float32 (`tlfea_torch.examples`): `beam_sag_feat10` at res 0 with Newton,
   Nesterov and VBD (2 steps each; AdamW's parameter set runs in 9) and at
   res 16 (176,868 T10, 248,745
   nodes, the bfloat16 coarse correction; 5 steps), the two ANCF beam sags
   and `bunny_deform` with SVK and with Mooney-Rivlin (5 steps each); the
   contact scenes on their fallback meshes, in contact within a few steps
   (`CONTACT_RUNS`: the free bodies overlapping 5 mm at the start, the
   gripper closing at 4 m/s): `sphere_drop_collision` 40 steps,
   `item_drop` hydroelastic (block broadphase) 30 and DEM 10,
   `bubble_gripper` 30 (close / hold / reopen at 4 m/s), and
   `self_contact_fold` at nx 24 (576 T10, each inner solve in the
   persistent kernel) 40; the mesh-bound scripts on meshes written to a
   temporary folder (`MESH_RUNS`): `ancf3243_net` on a 20 x 20 net (840
   beams, pinned joints and corner `fix_dof` rows), `ancf3443_tire` on a
   36 x 20 patch (720 shells, welded seams, rim rows) and
   `feat10_resolution_study` at res 0, 2, 4, 5 steps each: end figures,
   seconds, last-step counts, finite states on the card; for the contact
   scenes the contacts of every step (some > 0 by the end) and the third
   law at every step in contact (|sum f| <= 1e-5 max |f|, summed in
   float64); then the fold for 2 steps (pressed 0.1 m) in float64 on the
   card against the CPU, within 1e-9 of the displacement scale. Their
   launches join the kernels' record.

The last three lines are the kernels' JSON record, the nvidia-smi line and
`{"ok": true, "device": {...}}`.
"""

import json
import os
import subprocess
import sys
import time
import warnings
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "beam_sag_t10_tip.csv")
SEED = 0
BEAM_STEPS = 150  # the fixture's length
ROLLOUT = 60  # bench.py's ROLLOUT["10k"]
SHELL_ROLLOUT = 40  # bench.py run_ancf_shell's rollout
# The plate of tests/test_shell_validation.py (150 steps there): its tip
# swings about the static deflection and settles to within 2.7 % of plate
# theory from step 66 on (1.9 % at 80, 0.47 % at 150; float64, the port on
# the CPU and the card alike); 66 steps keep the 5 % bar with room (80 did
# until the run outgrew its time: 170 s of a ~1,016 s run on an H100 host).
THEORY_STEPS = 66
ANCF_BEAM_STEPS = 20
BIG_BEAM = 1024  # the largest ANCF3243 beam of one element block: 32 tiles
RESIDENT_ROLLOUT = 250  # bench.py's ROLLOUT["1k"]
RESIDENT_DIMS = (1.0, 0.25, 0.25, 12, 4, 3)  # bench.py's CONFIGS["1k"]: 864 elements
JAX_1K = (2, 22)  # median Newton / CG per step the JAX package recorded at 1k (BENCH_r04.json)
CHECK_STEPS = 5  # kernels against twins, from rest
# float32 resident kernel against its plain version at the 1k problem's 10th
# step: the largest |v| difference over the inner solve's update max |v - v0|.
# Rounding alone moves v by about 2e-5 of the update there (the plain version
# with v0 or the block inverses perturbed by 1e-7..1e-5 relative keeps the
# counts, Newton 2 / CG 22, and moves v by 1.1e-5..2.2e-5); a kernel that
# computes a wrong gradient or product moves it by order 1.
F32_RESIDENT_TOL = 1e-3
PRESCRIBED_STEPS = 100  # [dense_pins]' prescribed-motion rollout
PRESCRIBED_SPEED = 0.05  # m/s, the pinned face's prescribed downward velocity there
DENSE_PINS_TOL = 1e-6  # DensePins against FixedCoefs, of the displacement scale
LINEAR_ROWS_TOL = 1e-5  # fix_dof rows against FixedCoefs, of the displacement scale
# Mooney-Rivlin's float32 resolution is coarser: its isochoric terms cancel
# to O(strain), so at the 1k problem's strains (about 1e-3) and the ANCF
# beams' first steps the float32 plain version lies 7.5e-3 (1k) and 3.3e-3
# (64-element beam) of the update from the float64 plain version on the same
# inputs (SVK: 1.1e-5 and 2.6e-5; CPU, the plain version). Two float32
# evaluations each within r of the float64 answer differ by at most 2 r, so
# the bar is the larger of F32_RESIDENT_TOL and 2 r, r measured in the run.
TRACE_STEPS = 16  # profiled window
# One cluster barrier (barrier.cluster.arrive.release / wait.acquire) of a
# grid that is one cluster of 2, 8 or 16 blocks of 160 threads, us: 97 of
# them against none, `python -m tlfea_torch.tools.kernel_variants barriers`
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md). The resident
# phases log barriers x this beside the kernel's time, a diagnostic of
# what its barriers alone take, not its bound; it stays out of the
# `kernels` line, which holds only this run's measurements and bounds.
CLUSTER_BARRIER_US = {2: 0.392, 8: 0.4195, 16: 0.4561}

# H100 SXM data sheet, at the full 700 W: HBM bytes/s, float32 and float64
# flop/s outside the tensor cores (the kernels use no float64 tensor cores).
HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 33.5e12
# Floating-point operations per quadrature point of each material's algebra
# in K1/K5 (primal), K2 (hv) and K5t (tangent), an FMA counted as two, a
# divide or a cube root as one: SVK from csrc/svk.cuh (svk_stress 310,
# svk_hv 440, svk_stress_tangent 770); Mooney-Rivlin from csrc/mr.cuh
# (mr_elastic 182, the coefficients 10, P 101, S_v 80 and F S_v 54 make the
# primal 427; mr_dP 922 with F, dF, C, FC and S_v recomputed makes K2's
# 1104; mr_elastic, S_v and mr_dP make the tangent's 1184). The JAX
# package's own counts of `_MRTile` (tlfea/utils/roofline.py:86-88) are
# 420/560 primal and 560/700 Hv, undamped/damped.
MATERIAL_OPS = {"svk": {"primal": 310, "hv": 440, "tangent": 770},
                "mr": {"primal": 427, "hv": 1104, "tangent": 1184}}

# kernel -> the TPU kernel it replaces, per family
REPLACES = {
    "feat10": {"primal_prep": "tlfea/ops/pallas_fem.py:888", "hv": "tlfea/ops/pallas_fem.py:956",
               "svk_blocks": "tlfea/ops/pallas_fem.py:673"},
    "ancf3243": {"primal_prep": "tlfea/ops/pallas_fem.py:888", "hv": "tlfea/ops/pallas_fem.py:956",
                 "svk_blocks": "tlfea/ops/pallas_fem.py:673"},
    "ancf3443": {"primal_prep": "tlfea/ops/pallas_fem.py:1018",
                 "hv": "tlfea/ops/pallas_fem.py:1054",
                 "svk_blocks": "tlfea/ops/pallas_fem.py:725"},
}
NODE_REDUCE_REPLACES = "tlfea/ops/pallas_banded.py:689"
KERNELS = ("primal_prep", "hv", "svk_blocks", "node_reduce")  # the Newton path
# K5 and K5t, the port of pallas_fem._body (primal `pallas_call` :812 built at
# :519, custom-JVP tangent :830), in every family.
FIRST_ORDER = ("contrib", "contrib_tangent")
BODY_REPLACES = {"contrib": "tlfea/ops/pallas_fem.py:519",
                 "contrib_tangent": "tlfea/ops/pallas_fem.py:830"}
FIRST_ORDER_STEPS = {"adamw": 1, "nesterov": 1, "vbd": 2}  # timed steps after a warm one
MR_INNER = 2000  # [mr_first_order]'s inner cap (make_solver's 20,000 cut)
BUNNY_STEPS = 30  # examples/bunny_deform.py's --steps
BUNNY_DIMS = (1.0, 1.0, 2.0, 2, 2, 4)  # its fallback mesh, box_t10_mesh
# float32 kernels against the float64 twins after BUNNY_STEPS, of the
# displacement: both solve each step to rtol 1e-4 and CG to 1e-3, so they
# stop at different iterates; a wrong kernel moves the result by order 1.
BUNNY_TOL = 5e-2
# The [kernels] phase's u scaled up for Mooney-Rivlin at the ANCF shapes so
# that J - 1 spans about +-0.4, as at FEAT10 (the isochoric terms cancel to
# O(strain) in float32): [-0.359, 0.403] on the shell, [-0.371, 0.394] on the
# beam (float64 twins, this seed).
STRAIN_SCALE = {"ancf3443_mr": 2.5, "ancf3243_mr": 4.0}
TRACE_ITERS = 200  # inner iterations (VBD: gradients) in a first-order [trace] window
CHECK_INNER = 500  # the capped step of kernels against twins (VBD: 20 sweeps)
JVP_DIRECTIONS = 8
LIN_DIRECTIONS = 3
HV_SCALES = ("100k", "10k")  # [hv_phases]: the script's default box, then the flagship's
STIFF_STEPS, STIFF_RAMP = 40, 30  # [accuracy_mode] (a): tests/test_f32_stiff.py's rollout
STIFF_BARS = {"accum": 1e-3, "f32": 1e-2}  # its final residuals over ||f_ext||
TIGHT_TOL = 5e-3  # bench.py's "10k_tight": Newton to 0.5 % of ||f_ext||
SIM_STEPS, SIM_EXTRA = 20, 5  # [simulation]: steps, then steps after a pin is released
# [flagship_100k]: bench.py's "100k" scale (CONFIGS, 6 * 96 * 16 * 11 =
# 101,376 elements, 146,487 nodes; ROLLOUT 30 steps) with the coarse
# correction bench.py builds above 50,000 nodes (bench.py:186-195).
DIMS_100K = (4.0, 0.7, 0.6, 96, 16, 11)
ROLLOUT_100K = 30
COARSE_100K = dict(ranges=True, max_agg=1024, mm_dtype="bfloat16")
# bfloat16 tables against the dense full-precision correction: CG per step
# at most 1.3 x + 2 and x within 1e-3 of the displacement scale, the bar of
# tests/test_coarse_precond.py:191-197 (JAX's own, in float64 at a tight
# tolerance; see coarse_bf16_check).
BF16_CG = (1.3, 2)
BF16_X_TOL = 1e-3
MODES_STEPS = 8  # [coarse_modes]: steps of each mode on the 10k flagship
MODES = (("trans", dict(modes="trans")), ("rigid", dict(modes="rigid")),
         ("affine", dict(modes="affine")), ("rigid_bf16", dict(mm_dtype="bfloat16")))
BF16_APPLY_TOL = 3e-2  # the bfloat16 apply, card against CPU, of its scale
# [collision]: bench.py run_collision's protocol (warm-up steps of each
# scene, the timed rollout, calls per phase timing), the dragon stand-in's
# box (0.3 x 0.3 x 0.257 m, 14 x 14 x 12 cells: 14,112 T10, near-cubic cells
# as bench.py's 6 x 6 x 6 fallback has), and the bars.
COLLISION_WARM = {"collision": 15, "dragon": 30}
COLLISION_TIMED, COLLISION_CALLS, COLLISION_TRACE = 40, 30, 2
COLLISION_BUSY_CALLS = 3  # profiled calls a phase (the profiler's own cost grows with events)
DRAGON_ITEM = (0.3, 0.3, 0.257, 14, 14, 12)
HAIRPIN_NX = 24  # tests/test_self_collision.py's hairpin: 576 elements
THIRD_LAW_TOL, CARD_CPU_TOL = 1e-5, 1e-10
# The float64 instantiations the accuracy mode runs on a float32 problem:
# the gradient and its products (K1, K2, K4 on the composed path; K5, K5t,
# K4 on the first-order one). K3 and the persistent kernel stay float32.
ACCUM_KERNELS = ("primal_prep", "hv", "node_reduce", "contrib", "contrib_tangent")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _unconverged(counts) -> float:
    """The share of a rollout's steps whose last iterate failed the inner
    test (`newton.RolloutCounts.converged`)."""
    return 1.0 - float(np.mean(counts.converged))


def _solver_params(f_ext):
    """bench.py's converged-rollout settings: tolerance 2.5 % of ||f_ext||."""
    from tlfea_torch.solvers.newton import NewtonParams

    tol = 2.5e-2 * float(f_ext.norm())
    return NewtonParams(dt=1e-3, rho=1e7, inner_atol=tol, inner_rtol=0.0, outer_tol=0.0,
                        max_outer=1, max_inner=6, cg_rtol=1e-3, cg_max_iter=50,
                        ew_eta_max=0.5)


def _pins(family, fixed, x0):
    """The coefficients `fixed` held at their positions in x0, as the
    constraint family named: "fixed" (`FixedCoefs`), "dense" (`DensePins`)
    or "linear" (`LinearConstraints`, three `fix_dof` rows a coefficient)."""
    from tlfea_torch.constraints import DensePins, FixedCoefs, LinearConstraintBuilder

    if family == "fixed":
        return FixedCoefs.from_indices(fixed, x0)
    if family == "dense":
        return DensePins.from_indices(fixed, x0)
    rows = LinearConstraintBuilder()
    x0_host = x0.cpu()
    for i in fixed:
        for d in range(3):
            rows.fix_dof(int(i), d, float(x0_host[i, d]))
    return rows.build(dtype=x0.dtype, device=x0.device)


def _pinned_problem(elems_cpu, x0_np, fixed, device, material, pins="fixed"):
    """(system, state, f_ext, params) on `device` from a host element batch,
    the coefficients `fixed` held by the constraint family `pins` (`_pins`):
    gravity through the lumped mass, summed on the host in a fixed order."""
    import torch

    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.solvers import StepState, System

    dtype = elems_cpu.grad_N.dtype
    f_ext = torch.zeros((len(x0_np), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems_cpu) * -9.81
    x0 = torch.as_tensor(x0_np, dtype=dtype, device=device)
    system = System(elems=elems_cpu.to(device), material=material,
                    constraints=_pins(pins, fixed, x0))
    return system, StepState.rest(system, x0), f_ext.to(device), _solver_params(f_ext)


def _svk():
    from tlfea_torch.materials import SVK, lame_from_E_nu

    lam, mu = lame_from_E_nu(1e7, 0.3)
    return SVK(lam, mu, 1e3, 1e3)


def mooney_rivlin(E=1e7, nu=0.3, damping=1e3):
    """Mooney-Rivlin mapped from (E, nu) as `examples/bunny_deform.py:58-64`
    maps it: mu10 = 0.4 mu, mu01 = 0.1 mu, kappa = E / (3 (1 - 2 nu)). Its
    small-strain mu and lam are SVK's at (E, nu), so the ALM penalty, the
    coarse space and the viscous fold are the SVK flagship's."""
    from tlfea_torch.materials import MooneyRivlin

    mu = E / (2.0 * (1.0 + nu))
    return MooneyRivlin(mu10=0.4 * mu, mu01=0.1 * mu, kappa=E / (3.0 * (1.0 - 2.0 * nu)),
                        eta_damp=damping, lam_damp=damping)


def flagship_problem(device, dtype, dims=(2.0, 0.35, 0.3, 42, 7, 6), material=None,
                     pins="fixed"):
    """The bench.py "10k" problem: (system, state, f_ext, params); damped SVK
    unless another material is given, the x=0 face pinned by the family
    `pins` names (`_pins`)."""
    from tlfea_torch.elements import feat10
    from tlfea_torch.utils.reorder import apply_node_order, best_order
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(*dims)
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu")
    return _pinned_problem(elems_cpu, nodes, np.nonzero(nodes[:, 0] < 1e-12)[0], device,
                           material or _svk(), pins)


def bunny_problem(device, dtype):
    """`examples/bunny_deform.py --material mooney_rivlin` on its fallback
    mesh with `make_solver("newton")`'s parameters: (system, state, f_ext,
    params). No gravity: 20 N along x on each ear node (the top tenth),
    the base (the bottom twentieth) clamped."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.solvers import StepState, System
    from tlfea_torch.solvers.newton import NewtonParams
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(*BUNNY_DIMS)
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu")
    z = nodes[:, 2]
    zr = z.max() - z.min()
    base = np.nonzero(z < z.min() + 0.05 * zr)[0]
    ears = np.nonzero(z > z.max() - 0.1 * zr)[0]
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(elems=elems_cpu.to(device), material=mooney_rivlin(5e5, 0.4, 50.0),
                    constraints=FixedCoefs.from_indices(base, x0))
    f_ext = torch.zeros_like(x0)
    f_ext[torch.as_tensor(ears, device=device), 0] += 20.0
    params = NewtonParams(dt=1e-3, rho=1e8, inner_atol=1e-7, inner_rtol=1e-4, outer_tol=0.0,
                          max_outer=1, max_inner=6, cg_rtol=1e-3, cg_max_iter=50)
    return system, StepState.rest(system, x0), f_ext, params


def _clamp_rows(edge_nodes):
    """All 4 coefficient rows (position and directors) of the given nodes."""
    return (4 * np.asarray(edge_nodes)[:, None] + np.arange(4)[None, :]).reshape(-1)


def shell_problem(device, dtype, nx=72, ny=72, material=None):
    """bench.py run_ancf_shell: an ANCF3443 plate of nx x ny elements of
    0.05 x 0.05 x 0.01 m, the x=0 edge clamped (all 4 coefficient rows of
    its nodes): (system, state, f_ext, params); damped SVK unless another
    material is given."""
    from tlfea_torch.elements import ancf3443

    coefs, conn = ancf3443.shell_grid(nx, ny, L=0.05, W=0.05)
    elems_cpu = ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0, dtype=dtype,
                               device="cpu")
    edge = np.nonzero(coefs[0::4, 0] < 1e-12)[0]
    return _pinned_problem(elems_cpu, coefs, _clamp_rows(edge), device, material or _svk())


def ancf_beam_problem(device, dtype, n_elem=64, material=None, pins="fixed"):
    """A cantilever of n_elem ANCF3243 beams (0.05 m each, 0.01 x 0.01 m
    section), node 0 clamped by the family `pins` names (`_pins`): (system,
    state, f_ext, params); damped SVK unless another material is given."""
    from tlfea_torch.elements import ancf3243

    coefs, conn = ancf3243.straight_beam(n_elem, L=0.05, origin=(0.0, 0.0, 0.0))
    elems_cpu = ancf3243.build(coefs, conn, 0.05, 0.01, 0.01, rho=1000.0, dtype=dtype,
                               device="cpu")
    return _pinned_problem(elems_cpu, coefs, _clamp_rows([0]), device, material or _svk(),
                           pins)


def _device_ms(fn, n):
    """Device ms per call over n back-to-back calls (CUDA events), and the
    host ms per call. A spin kernel holds the stream while the host queues
    the calls, so the events time the device work and not the host's
    launch overhead. The host gets ahead only while the launch queue has
    room (about a thousand launches), so n halves, and the spin doubles,
    until it does."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    cycles = 1 << 24
    while n >= 1:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        ahead = not start.query()  # the device had not reached the first call yet
        end.record()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / n, host * 1e3 / n
        n, cycles = n // 2, cycles * 2
    raise RuntimeError("the host never got ahead of the device; no device timing")


def _pass_work(name, op, C=6):
    """(words moved, floating-point operations) of one launch of a K1-K5t
    kernel: each input read once, each output written once (the prep cache
    has the material's op.prep_rows rows a quadrature point); the operations
    counted from the kernel's arithmetic per quadrature point, the
    material's from MATERIAL_OPS."""
    E, Q, S, n = op.E, op.Q, op.S, op.n
    gN, dV, Me, prep = Q * S * 3 * E, Q * E, S * S * E, Q * op.prep_rows * E
    ops = MATERIAL_OPS[op.kind]
    if name == "primal_prep":
        return (n * 9 + S * E + gN + dV + Me + S * 3 * E + prep,
                E * (Q * (36 * (S - 1) + ops["primal"] + 24 * S) + 6 * S * S + 6 * S))
    if name == "hv":
        return (n * 3 + S * E + prep + gN + dV + Me + S * 3 * E,
                E * (Q * (18 * (S - 1) + ops["hv"] + 24 * S) + 6 * S * S + 6 * S))
    if name == "svk_blocks":
        return (n * 3 + S * E + gN + dV + S * 6 * E,
                E * (Q * (18 * (S - 1) + 72 + 84 * S) + 3 * S))
    if name == "contrib":  # K1 without the prep cache
        return (n * 9 + S * E + gN + dV + Me + S * 3 * E,
                E * (Q * (36 * (S - 1) + ops["primal"] + 24 * S) + 6 * S * S + 6 * S))
    if name == "contrib_tangent":
        # the tangent's 9 node channels and the primal's u | v (its dv/dt
        # does not enter); per QP four contractions and the material's
        # tangent (SVK: the primal S 256, dE 126, dEd 234, dS 43, dP 108)
        return (n * 9 + n * 6 + S * E + gN + dV + Me + S * 3 * E,
                E * (Q * (72 * (S - 1) + ops["tangent"] + 24 * S) + 6 * S * S + 6 * S))
    # node_reduce: vals, the CSR list (ptr, inc), node sums
    return S * C * E + (n + 1) + S * E + n * C, S * C * E


def _bound(words, flops, itemsize):
    """(ms, "bytes" or "operations"): the larger of words over the HBM rate
    and flops over the float32 rate (itemsize 4) or the float64 rate
    (itemsize 8), on an H100 at 700 W."""
    rate = F64_FLOPS if itemsize == 8 else F32_FLOPS
    t_bytes, t_ops = words * itemsize / HBM_BPS, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(name, op, C=6, itemsize=4):
    """The least time of one launch of a K1-K5t kernel (`_pass_work`).
    Returns (ms, "bytes" or "operations")."""
    return _bound(*_pass_work(name, op, C), itemsize)


def occupancy_fields(name, tag, dtype, blocks, launch=None):
    """({"regs", "waves"[, "block"]}, a log text) of one launch of `blocks`
    blocks of kernel `name` of `tag`: its registers and local bytes a thread
    and its blocks an SM from the CUDA runtime (`fem_kernels.occupancy`;
    launch: an element kernel's E, the persistent kernel's (E, cluster)),
    the waves those blocks take over the card's SMs, and a block's [threads,
    elements] where the record has them (not the persistent kernel's)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk

    o = fk.occupancy(name, tag, dtype, launch)
    n_sm = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    if o["blocks_per_sm"] < 1:
        raise AssertionError(f"{name}[{tag}]: no block of its launch fits an SM: {o}")
    waves = -(-blocks // (o["blocks_per_sm"] * n_sm))
    shape = f" of {o['threads']} threads ({o['elements']} elements)" if "threads" in o else ""
    block = {"block": [o["threads"], o["elements"]]} if "threads" in o else {}
    return ({"regs": o["regs"], "waves": waves, **block},
            f"{o['regs']} registers and {o['local_bytes']} B local a thread, "
            f"{o['blocks_per_sm']} blocks an SM, {waves} wave(s) of {blocks} blocks{shape} over "
            f"{n_sm} SMs")


def phase_kernels(device, tag, system):
    """Each kernel of the system's material against its twin at the shapes
    of `system` (a float64 system on the CPU); K5 against K1's fe (bitwise)
    and K5t + K4 along the Newton chain (dt p, p, p/dt) against K2 + K4
    along p. tag: the kernels' LAUNCHES tag ("feat10", "feat10_mr", ...).
    Returns {kernel: record fields} for float32, with the float64 time and
    bound (ms_f64, bound_ms_f64, bound_by_f64) of each kernel the accuracy
    mode launches in float64 (ACCUM_KERNELS)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk

    n, dt = system.n_coef, 1e-3
    rng = np.random.default_rng(SEED)
    host = dict(packed=np.concatenate([rng.normal(size=(n, 3)) * 1e-3,
                                       rng.normal(size=(n, 3)) * 1e-2,
                                       rng.normal(size=(n, 3))], axis=1),
                p=rng.normal(size=(n, 3)), u=rng.normal(size=(n, 3)) * 1e-3,
                dpacked=rng.normal(size=(n, 9)))
    host["packed"][:, :3] *= STRAIN_SCALE.get(tag, 1.0)
    E, S = system.elems.n_elem, system.elems.n_shape
    host["vals"] = rng.normal(size=(S * 6, E))
    out, f64_rec = {}, {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        op = fk.FemOperator(system.elems.to(device, dtype), system.material)
        if op.tag != tag:
            raise AssertionError(f"expected the {tag} kernels, got {op.tag}")
        x = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in host.items()}
        _, prep = fk.primal_prep_plain(op, x["packed"])
        if op.kind == "mr":
            # The strained state: J - 1 (prep row 18) well inside (-1, 1).
            jm1 = prep.view(op.Q, op.prep_rows, op.E)[:, 18]
            log("kernels", f"{tag} {str(dtype)[6:]}: J - 1 in [{float(jm1.min()):.3e}, "
                f"{float(jm1.max()):.3e}] at the random state")
            if not float(jm1.abs().max()) < 0.5:
                raise AssertionError(f"{tag}: the random state inverts or crushes an element")
        args = {"primal_prep": (x["packed"],), "hv": (x["p"], prep, dt),
                "svk_blocks": (x["u"],), "node_reduce": (x["vals"],),
                "contrib": (x["packed"],), "contrib_tangent": (x["packed"], x["dpacked"])}
        extra = _body_checks(op, x, dt, tol, tag)
        names = KERNELS + FIRST_ORDER if op.kind == "svk" else fk.MATERIAL_KERNELS[op.kind]
        for name in names:
            got = getattr(fk, name)(op, *args[name])
            want = getattr(fk, name + "_plain")(op, *args[name])
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
            ok = all(torch.isfinite(g).all() for g in got) and rel <= tol
            log("kernels", f"{name}[{tag}] {str(dtype)[6:]}: max rel err {rel:.3e} "
                f"(tol {tol:g}), max abs err {abs_err:.3e}")
            if not ok:
                raise AssertionError(f"{name}[{tag}] disagrees with its twin in {dtype}: "
                                     f"{rel:.3e}")
            k4 = name == "node_reduce"
            occ, occ_text = occupancy_fields(name, op.family if k4 else op.tag, dtype,
                                             fk.launch_blocks(name, op, C=6),
                                             None if k4 else op.E)
            log("kernels", f"{name}[{tag}] {str(dtype)[6:]} at E={E}: {occ_text}")

            def k_call(name=name):
                return getattr(fk, name)(op, *args[name])

            if dtype != torch.float32:
                if name in ACCUM_KERNELS:  # the accuracy mode's float64 launches
                    ms64, _ = _device_ms(k_call, 256)
                    b64, by64 = bound_ms(name, op, itemsize=8)
                    f64_rec[name] = dict(ms_f64=ms64, bound_ms_f64=b64, bound_by_f64=by64)
                    log("kernels", f"{name}[{tag}] float64 at E={E}: device {ms64:.4f} ms per "
                        f"launch (bound {b64:.4f} ms by {by64}, {b64 / ms64:.3f} of it)")
                continue

            def p_call(name=name):
                return getattr(fk, name + "_plain")(op, *args[name])

            # In turns on one card: twin, kernel, kernel, twin.
            p1, ph = _device_ms(p_call, 16)
            k1, kh = _device_ms(k_call, 256)
            k2, _ = _device_ms(k_call, 256)
            p2, _ = _device_ms(p_call, 16)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            b_ms, b_by = bound_ms(name, op)
            lib_ms = None
            if name == "node_reduce":
                # The one PyTorch call that computes the same node sums.
                vals_l = x["vals"].view(S, 6, E).permute(2, 0, 1).reshape(E * S, 6).contiguous()
                idx = op.conn.reshape(-1)
                acc = torch.zeros((n, 6), dtype=dtype, device=device)
                lib_ms, _ = _device_ms(lambda: acc.index_add_(0, idx, vals_l), 256)
            log("kernels", f"{name}[{tag}] float32 at E={E}: device {ms:.4f} ms per launch "
                f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.2f} of it), twin {plain_ms:.4f} "
                f"ms ({plain_ms / ms:.1f}x); host {kh:.4f} ms per wrapper call, twin {ph:.4f} ms"
                + ("" if lib_ms is None else f"; index_add_ {lib_ms:.4f} ms"))
            # max_abs_err is in the output's units (K1's entries reach ~1e6);
            # the bar is max_rel_err, over the twin's largest entry, vs tol.
            out[name] = dict(max_abs_err=abs_err, max_rel_err=rel, tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms, **occ)
            if name in extra:
                out[name].update(extra[name])
            out[name].update(f64_rec.get(name, {}))
    return out


def _body_checks(op, x, dt, tol, family):
    """K5 against K1's fe (bitwise; the same tile code with the prep writes
    compiled out) and K5t + K4 along (dt p, p, p/dt) against K2 + K4 along
    p (the same derivative; relative error within tol). Returns the
    figures for the JSON record."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk

    fe1, prep = fk.primal_prep(op, x["packed"])
    fe5 = fk.contrib(op, x["packed"])
    p = x["p"]
    chain = torch.cat([dt * p, p, p / dt], dim=1).contiguous()
    h5 = fk.node_reduce(op, fk.contrib_tangent(op, x["packed"], chain))
    h2 = fk.node_reduce(op, fk.hv(op, p, prep, dt))
    torch.cuda.synchronize()
    same = bool(torch.equal(fe5, fe1))
    rel = float((h5 - h2).abs().max() / h2.abs().max())
    dt_name = str(x["p"].dtype)[6:]
    log("kernels", f"contrib[{family}] {dt_name}: equal to primal_prep's fe bit for bit: {same}"
        f" (max |diff| {float((fe5 - fe1).abs().max()):.3e}); contrib_tangent + node_reduce "
        f"along (dt p, p, p/dt) vs hv + node_reduce along p: max rel err {rel:.3e} (tol {tol:g})")
    if (x["p"].dtype == torch.float32 and not same) or not rel <= tol:
        raise AssertionError(f"{family}: K5 differs from K1's fe ({same}) or K5t from K2 ({rel:.3e})")
    return {"contrib": {"k1_bitwise": same}, "contrib_tangent": {"vs_k2_rel_err": rel}}


def beam_sag(device, dtype):
    """Tip trajectory of the damped cantilever of tests/fixtures/generate.py
    through the kernels; returns (max deviation / displacement scale,
    seconds)."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.solvers import StepState, System, newton
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 10, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu")
    f_ext = torch.zeros((len(nodes), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems_cpu) * -9.81
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(elems=elems_cpu.to(device), material=SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    step = newton.make_step(system, newton.NewtonParams(
        dt=1e-3, rho=1e8, inner_atol=1e-8, inner_rtol=1e-10, outer_tol=1e-10, max_outer=2,
        max_inner=10, cg_rtol=1e-6, cg_max_iter=500, ew_eta_max=0.0))
    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    state = StepState.rest(system, x0)
    f_ext = f_ext.to(device)
    rows = []
    t0 = time.perf_counter()
    for _ in range(BEAM_STEPS):
        state, _ = step(state, f_ext)
        rows.append(state.x[tip])
    rows = torch.stack(rows).double().cpu().numpy()
    secs = time.perf_counter() - t0
    ref = np.loadtxt(FIXTURE, delimiter=",", skiprows=1)[:, 1:4]
    scale = np.abs(ref - nodes[tip]).max()
    return float(np.abs(rows - ref).max() / scale), secs


def _device_profile(fn):
    """fn() under torch.profiler, synchronised: {device operation name:
    (device ms, calls)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the profiler's note on event cycles
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return by_name


def _log_profile(tag, by_name, per, unit, wall_ms):
    """Device busy time per `unit` (by_name summed over `per` units) against
    the untraced wall ms per unit, and the largest device operations."""
    busy = sum(t for t, _ in by_name.values()) / per
    ops = sum(c for _, c in by_name.values()) / per
    log(tag, f"device busy {busy:.4f} ms/{unit} = {busy / wall_ms:.3f} of the untraced "
        f"{wall_ms:.4f} ms/{unit}; {ops:.1f} device operations per {unit}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(tag, f"{t / per:.4f} ms/{unit}, {c / per:.2f} calls/{unit}: {name[:90]}")
    return busy


def trace(roll, state, f_ext, ms_per_step):
    """Where the time goes: a torch.profiler window over TRACE_STEPS of the
    rollout; device busy time per step against the untraced ms/step, and
    the device operations that take the most of it."""
    return _log_profile("trace", _device_profile(lambda: roll(state, f_ext)), TRACE_STEPS,
                        "step", ms_per_step)


def _coarse_desc(co, secs):
    """One line on a built coarse correction: size, form, build time and
    the bytes of its stored tables (Agg, the solve, u0, agg)."""
    form = ("bfloat16 tables, inverse Cholesky factor" if co.mm_dtype is not None
            else "rank-truncated" if co.W is not None else "dense, explicit inverse")
    nbytes = sum(t.numel() * t.element_size() for t in (co.Agg, co.Ainv, co.Li, co.W, co.u0,
                                                         co.agg) if t is not None)
    return (f"coarse: {co.n_agg} aggregates x {co.k_modes} modes (K = {co.n_agg * co.k_modes}; "
            f"{form}{', range flag' if co.ranges else ''}), built in {secs:.2f} s, apply "
            f"tables {nbytes / 1e6:.1f} MB (Agg {co.Agg.numel() * co.Agg.element_size() / 1e6:.1f} MB)")


def rollout_phase(tag, device, problem, n_steps, traced=True, coarse=True, coarse_kw=None):
    """A problem's rollout through the kernels: warm-up, then a timed run
    whose launch counts are returned (each kernel of the path must have
    launched: K1-K4, or the persistent kernel with K3 and K4 where the
    resident gate holds), a traced window, and CHECK_STEPS from rest through
    the kernels and through the twins, which must agree within 5e-3 of the
    coordinate scale. coarse=False runs without the coarse correction;
    coarse_kw: the correction's build options (default max_agg 512).
    Returns {"launches", "ms" (per step), "newton", "cg" (per-step lists),
    "coarse", "state", "busy_ms" (device busy per step, traced on the card)}."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    system, state0, f_ext, params = problem
    op = system.fem
    family = op.family
    t0 = time.perf_counter()
    co, desc = None, "no coarse correction"
    if coarse:
        co = build_coarse_precond(system, state0.x, params.dt, params.rho,
                                  **(coarse_kw or dict(max_agg=512)))
        sync()
        desc = _coarse_desc(co, time.perf_counter() - t0)
    on_resident = resident.eligible(system, co)
    # Mooney-Rivlin has no K3: its blocks are plain tensor code, summed
    # without K4.
    blocks = ("svk_blocks", "node_reduce") if op.kind == "svk" else ()
    path = (("newton_resident",) + blocks if on_resident
            else ("primal_prep", "hv", "node_reduce") + blocks[:1])
    log(tag, f"{system.elems.n_elem} elems ({op.tag}, {type(op.material).__name__}), "
        f"{system.n_coef} nodes, "
        f"{int(system.constraints.idx.numel())} pinned; {desc}; inner solves "
        f"{'in the persistent kernel' if on_resident else 'composed of K1-K4'}")
    roll = newton.make_rollout(system, params, n_steps, coarse=co, precond_refresh=8)
    t0 = time.perf_counter()
    s, _ = roll(state0, f_ext)
    sync()
    log(tag, f"warm-up rollout ({n_steps} steps): {time.perf_counter() - t0:.2f} s")

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    s, counts = roll(s, f_ext)
    sync()
    wall = time.perf_counter() - t0
    nit, cgit = counts
    names = KERNELS + (("newton_resident",) if (family, op.kind) in fk.RESIDENT_SOURCES else ())
    launches = {k: fk.LAUNCHES[fk.launch_key(k, op)] for k in names}
    if not bool(torch.isfinite(s.x).all()) or s.x.shape != state0.x.shape:
        raise AssertionError(f"{tag} rollout state is not finite")
    nit, cgit = np.asarray(nit), np.asarray(cgit)
    ms = wall / n_steps * 1e3
    log(tag, f"timed rollout: {n_steps} steps in {wall:.3f} s = {ms:.3f} ms/step; "
        f"newton/step median {np.median(nit):g}, cg/step median {np.median(cgit):g}, "
        f"newton_unconverged_frac {_unconverged(counts):.3f}, "
        f"max |u| {float(s.u.abs().max()):.4e}")
    log(tag, f"launches in the timed rollout: "
        f"{ {fk.launch_key(k, op): v for k, v in launches.items()} }")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    busy = None
    if traced and device.type == "cuda":
        busy = trace(newton.make_rollout(system, params, TRACE_STEPS, coarse=co,
                                         precond_refresh=8), s, f_ext, ms)

    # The same steps from rest, through the kernels and through the twins.
    finals = {}
    for plain in (False, True):
        sysx = replace(system, plain=plain)
        t0 = time.perf_counter()
        sx, (nx, cx) = newton.make_rollout(sysx, params, CHECK_STEPS, coarse=co,
                                           precond_refresh=8)(state0, f_ext)
        sync()
        log(tag, f"{CHECK_STEPS} steps from rest via {'twins' if plain else 'kernels'}: "
            f"{(time.perf_counter() - t0) / CHECK_STEPS * 1e3:.3f} ms/step, newton {nx}, cg {cx}")
        finals[plain] = sx.x
    diff = float((finals[False] - finals[True]).abs().max())
    rel_coord = diff / float(finals[True].abs().max())
    rel_disp = diff / float((finals[True] - state0.x).abs().max())
    log(tag, f"kernels vs twins after {CHECK_STEPS} steps: max |dx| {diff:.3e}, "
        f"{rel_coord:.3e} of the coordinate scale (bar 5e-3), {rel_disp:.3e} of the "
        f"displacement scale")
    if not rel_coord < 5e-3:
        raise AssertionError(f"kernel path disagrees with the twin path: {rel_coord:.3e}")
    return {"launches": launches, "ms": ms, "newton": nit, "cg": cgit, "coarse": co,
            "state": s, "busy_ms": busy, "capped": int((nit >= params.max_inner).sum())}


def gradient_noise(tag, device, state, material=None, dims=(2.0, 0.35, 0.3, 42, 7, 6),
                   accum=False):
    """The float32 kernels' ALM gradient (K5 + K4, `grad_L` at v = v_prev)
    against the float64 twins' from the same float32 state, over the
    flagship's ||f_ext||: the gradient's rounding noise, beside Newton's
    tolerance of 2.5e-2 ||f_ext||. accum: the accuracy mode's gradient
    (float64 K5 + K4 on the float32 tables cast up, u widened) in place of
    the float32 kernels'. Returns ||dg|| / ||f_ext||."""
    import torch

    from tlfea_torch.solvers.common import grad_L

    sys32, _, f32, prm = flagship_problem(device, torch.float32, dims, material)
    sys64, _, f64, _ = flagship_problem(device, torch.float64, dims, material)
    sys64 = replace(sys64, plain=True)
    x, v, lam, u = (getattr(state, k) for k in ("x", "v", "lam", "u"))
    if accum:
        sys32, u = sys32.replace(accum_dtype=torch.float64), u.double()
    g32 = grad_L(v, x, v, lam, f32, prm.dt, prm.rho, sys32, u_prev=u)
    x, v, lam, u = (t.double() for t in (x, v, lam, u))
    g64 = grad_L(v, x, v, lam, f64, prm.dt, prm.rho, sys64, u_prev=u)
    dg = g32.double() - g64
    rel = float(dg.norm() / f64.norm())
    node = float(dg.norm(dim=1).max() / f64.norm(dim=1).max())
    log(tag, f"{'accuracy-mode' if accum else 'float32'} kernels' gradient vs the float64 "
        f"twins' at the last state: ||dg|| / "
        f"||f_ext|| = {rel:.3e} (Newton's tolerance 2.5e-2), max over nodes |dg| / max |f_ext| "
        f"= {node:.3e}")
    return rel


def float64_counts(tag, device, material=None, dims=(2.0, 0.35, 0.3, 42, 7, 6)):
    """Median Newton and CG per step of the float64 kernels over the steps
    the float32 rollout times (ROLLOUT + 1 .. 2 ROLLOUT): the counts free of
    float32 rounding. Returns (newton, cg) medians."""
    import torch

    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    system, state, f_ext, params = flagship_problem(device, torch.float64, dims, material)
    co = build_coarse_precond(system, state.x, params.dt, params.rho, max_agg=512)
    roll = newton.make_rollout(system, params, ROLLOUT, coarse=co, precond_refresh=8)
    state, _ = roll(state, f_ext)
    _, counts = roll(state, f_ext)
    nit, cgit = counts
    med = float(np.median(nit)), float(np.median(cgit))
    log(tag, f"float64 kernels over the same steps: newton/step median {med[0]:g}, cg/step "
        f"median {med[1]:g}, newton_unconverged_frac {_unconverged(counts):.3f}")
    return med


def flagship(device, dims=(2.0, 0.35, 0.3, 42, 7, 6)):
    """The bench.py 10k rollout through the kernels, its gradient's float32
    noise at the last state and the float64 counts. Returns the launch
    counts of the timed rollout."""
    import torch

    out = rollout_phase("flagship", device, flagship_problem(device, torch.float32, dims),
                        ROLLOUT)
    gradient_noise("flagship", device, out["state"], dims=dims)
    float64_counts("flagship", device, dims=dims)
    return out["launches"]


def shell(device, nx=72, ny=72):
    """The bench.py run_ancf_shell rollout through the kernels. Returns the
    launch counts of the timed rollout."""
    import torch

    return rollout_phase("shell", device, shell_problem(device, torch.float32, nx, ny),
                         SHELL_ROLLOUT)["launches"]


def resident_bound_ms(op, st, itemsize=4):
    """The least time of one persistent-kernel launch, as `_bound`: its
    inputs read once (the five (n, 3) node fields, pin_lin, the inverted
    blocks, the element tables and the CSR list) and v written once,
    against the operations of this launch's st["grad_evals"] gradients (K1
    + K4 and the pin terms, 9 a node) and st["hv_evals"] Hv products (K2 +
    K4 and a CG iteration's node work: the block-Jacobi product 15, three
    dots and three axpys 6 each, the pin term of Hp 9, so 60 a node).
    Returns (ms, "bytes" or "operations", per_pass_ms): per_pass_ms is the
    sum of the byte-or-operation bounds of those passes launched one by one
    (each reading its tables from HBM anew), a diagnostic and not the
    kernel's bound: the kernel's working set stays in L2."""
    E, Q, S, n = op.E, op.Q, op.S, op.n
    words = 5 * n * 3 + n + 9 * n + S * E + Q * S * 3 * E + Q * E + S * S * E + (n + 1) \
        + S * E + n * 3
    (_, k1), (_, k2), (_, k4) = (_pass_work(k, op, C) for k, C in
                                 (("primal_prep", 6), ("hv", 6), ("node_reduce", 3)))
    ops = st["grad_evals"] * (k1 + k4 + 9 * n) + st["hv_evals"] * (k2 + k4 + 60 * n)
    per_pass = (st["grad_evals"] * (bound_ms("primal_prep", op)[0]
                                    + bound_ms("node_reduce", op, C=3)[0])
                + st["hv_evals"] * (bound_ms("hv", op)[0] + bound_ms("node_reduce", op, C=3)[0]))
    return (*_bound(words, ops, itemsize), per_pass)


def _wall_ms(fn, reps=3):
    """Best host-clock ms of fn() over reps calls, each ended by a
    synchronise (for calls that synchronise themselves)."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def resident_phase(tag, device, make_problem, n_steps, composed_tag, jax_counts=None):
    """A problem that passes the resident gate, rolled out through the
    persistent Newton-PCG kernel, its checks and times, and the same rollout
    through the composed K1-K4 path for comparison. make_problem(dtype) ->
    (system, state, f_ext, params); jax_counts: the median Newton / CG per
    step the JAX package recorded for it, if any. Checks: one launch per
    inner solve, K2 never, K1 + K4 once a step that stopped at the cap
    (K3/K4 at the SVK preconditioner refreshes); one float64 inner solve from the 10th step's state, kernel
    against its plain version (the same Newton count, CG within 2,
    positions within 1e-10 relative); the same in float32, the rollout's
    dtype (CG within 2, v within F32_RESIDENT_TOL of the solve's update, or
    twice the plain version's own float32 distance from float64 where that
    is larger), and bitwise repeatability. Returns (the kernel's JSON record fields, its
    launches in the timed rollout, the composed rollout's launches)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton

    problem = make_problem(torch.float32)
    system, state0, f_ext, params = problem
    key = fk.launch_key("newton_resident", system.fem)
    if not resident.eligible(system, None) or params.max_outer != 1:
        raise AssertionError(f"{tag}: the problem must pass the resident gate, one inner solve "
                             f"a step")
    out = rollout_phase(tag, device, problem, n_steps, coarse=False)
    refreshes = -(-n_steps // 8) if system.fem.kind == "svk" else 0
    capped = out["capped"]  # each tests its last iterate: one K1 + K4
    want = {"primal_prep": capped, "hv": 0, "svk_blocks": refreshes,
            "node_reduce": refreshes + capped, "newton_resident": n_steps}
    if out["launches"] != want:
        raise AssertionError(f"launches {out['launches']}, expected {want}")
    log(tag, f"launches as expected: {key} once per inner solve, K2 never, K1 at the "
        f"{capped} steps that stopped at the cap, "
        + (f"K3/K4 at the {refreshes} preconditioner refreshes" if refreshes else
           "K3/K4 never (the Mooney-Rivlin blocks are plain tensor code)")
        + f"; median Newton {np.median(out['newton']):g} / CG {np.median(out['cg']):g} per step"
        + ("" if jax_counts is None else f" beside the JAX package's recorded {jax_counts[0]} / "
           f"{jax_counts[1]} (BENCH_r04.json)"))

    # float64, one inner solve from the 10th step's state: kernel vs plain.
    p64 = make_problem(torch.float64)
    st64, _ = newton.make_rollout(p64[0], p64[3], 10, precond_refresh=8)(p64[1], p64[2])
    args = newton.inner_solve_args(p64[0], st64, p64[2], p64[3])
    v_k, stats = resident.launch(*args)
    sk = resident.read_stats(stats)
    v_p, it_p, _, cg_p, _ = resident.newton_inner_resident_plain(*args)
    x_ref, u, dt = p64[0].elems.x_ref, args[1], p64[3].dt
    x_k, x_p = x_ref + u + dt * v_k, x_ref + u + dt * v_p
    err64 = float((x_k - x_p).abs().max())
    rel64 = err64 / float(x_p.abs().max())
    log(tag, f"float64 inner solve at step 10, kernel vs plain: Newton {sk['iters']} vs {it_p}, "
        f"CG {sk['cg_total']} vs {cg_p} (bar +-2), positions max abs err {err64:.3e}, "
        f"{rel64:.3e} relative (bar 1e-10)")
    if sk["iters"] != it_p or abs(sk["cg_total"] - cg_p) > 2 or not rel64 < 1e-10:
        raise AssertionError(f"{key} disagrees with its plain version in float64")

    # float32, the main path's dtype, at the 10th step's state: kernel vs
    # plain, repeatability, then times.
    st32, _ = newton.make_rollout(system, params, 10, precond_refresh=8)(state0, f_ext)
    args = newton.inner_solve_args(system, st32, f_ext, params)
    v1, s1 = resident.launch(*args)
    v2, _ = resident.launch(*args)
    torch.cuda.synchronize()
    if not torch.equal(v1, v2):
        raise AssertionError(f"the float32 {key} is not bitwise repeatable")
    st = resident.read_stats(s1)
    v_p, it_p, _, cg_p, _ = resident.newton_inner_resident_plain(*args)
    update = float((v_p - args[0]).abs().max())
    err32 = float((v1 - v_p).abs().max())
    rel32 = err32 / update
    # float32's resolution here: the plain version on the same inputs in
    # float64 (the float64 system's tables, everything else widened).
    args64 = [a.double() if torch.is_tensor(a) else a for a in args]
    args64[5] = p64[0]
    args64[7] = None if args[7] is None else tuple(t.double() for t in args[7])
    res32 = float((v_p.double() - resident.newton_inner_resident_plain(*args64)[0])
                  .abs().max()) / update
    f32_tol = max(F32_RESIDENT_TOL, 2.0 * res32)
    log(tag, f"float32 inner solve at step 10, kernel vs plain: Newton {st['iters']} vs {it_p}, "
        f"CG {st['cg_total']} vs {cg_p} (bar +-2), v max abs err {err32:.3e} = {rel32:.3e} of "
        f"the solve's update max |v - v0| (bar {f32_tol:.3e}: the plain version's float32 "
        f"v is {res32:.3e} of it from its float64 v), {err32 / float(v_p.abs().max()):.3e} "
        f"of max |v|")
    if st["iters"] != it_p or abs(st["cg_total"] - cg_p) > 2 or not rel32 < f32_tol:
        raise AssertionError(f"{key} disagrees with its plain version in float32")
    ms, host_ms = _device_ms(lambda: resident.launch(*args), 64)
    b_ms, b_by, pass_ms = resident_bound_ms(system.fem, st)
    op = system.fem
    plan = resident.plan(op.family, op.kind, op.E, torch.float32,
                         resident.max_cluster(op.tag, torch.float32))
    kernel_smem = getattr(fk.build_kernels()[fk.RESIDENT_SOURCES[(op.family, op.kind)]],
                          f"tlfea_newton_resident_{op.tag}_f32_smem")(op.E, plan.cluster)
    if st["grid"] != plan.cluster or kernel_smem != plan.smem_bytes or st["grid"] > 16:
        raise AssertionError(f"{key}: launched a cluster of {st['grid']} blocks with "
                             f"{kernel_smem} B of shared memory, planned {plan}")
    occ, occ_text = occupancy_fields("newton_resident", op.tag, torch.float32, plan.cluster,
                                     (op.E, plan.cluster))
    log(tag, f"float32 kernel: {occ_text}")
    floor_ms = st["barriers"] * CLUSTER_BARRIER_US.get(plan.cluster, float("nan")) * 1e-3
    plain_ms = _wall_ms(lambda: resident.newton_inner_resident_plain(*args))
    res_wall = _wall_ms(lambda: resident.newton_inner_resident(*args))
    log(tag, f"float32 inner solve at step 10: bitwise repeatable; Newton {st['iters']}, CG "
        f"{st['cg_total']} ({st['grad_evals']} gradients, {st['hv_evals']} Hv products, "
        f"{st['barriers']} cluster barriers; one cluster of {st['grid']} blocks x "
        f"{plan.threads} threads, {plan.n_tiles} virtual blocks, {plan.rounds} a block, "
        f"{plan.smem_bytes} B of shared memory a block); device {ms:.4f} ms per "
        f"launch (bound {b_ms:.5f} ms by {b_by}, {b_ms / ms:.4f} of it; the same passes "
        f"launched one by one, each reading HBM: {pass_ms:.4f} ms); host {host_ms:.4f} ms "
        f"per launch call")
    log(tag, f"diagnostic, not the bound: {st['barriers']} cluster barriers x "
        f"{CLUSTER_BARRIER_US.get(plan.cluster, float('nan'))} us (one barrier of a "
        f"{plan.cluster}-block cluster, the barrier probe) = {floor_ms:.4f} ms, "
        f"{floor_ms / ms:.3f} of the launch's {ms:.4f} ms")

    # The same inner solve and rollout through the composed K1-K4 path: the
    # gate patched off, as the JAX package's resident test does.
    orig = resident.eligible
    resident.eligible = lambda *a, **k: False
    try:
        v0, u_prev, v_prev = args[:3]

        def composed():
            return newton._newton_inner(v0, st32.x, v_prev, st32.lam, f_ext, params, system,
                                        inv_blocks=args[6], u_prev=u_prev)

        comp = composed()
        comp_wall = _wall_ms(composed)
        comp_out = rollout_phase(composed_tag, device, problem, n_steps, coarse=False)
    finally:
        resident.eligible = orig
    log(tag, f"wall ms per inner solve: resident {res_wall:.3f} (stats read included), plain "
        f"version {plain_ms:.3f}, composed K1-K4 path {comp_wall:.3f} (Newton {comp[1]}, CG "
        f"{comp[3]})")
    log(tag, f"{system.elems.n_elem}-element rollout ms/step: resident {out['ms']:.3f}, composed "
        f"K1-K4 {comp_out['ms']:.3f} ({comp_out['ms'] / out['ms']:.1f}x)")
    record = dict(max_abs_err=err32, max_rel_err=rel32, tol=f32_tol, f32_vs_f64_plain=res32,
                  max_abs_err_f64=err64, max_rel_err_f64=rel64, tol_f64=1e-10, ms=ms,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                  per_pass_bound_ms=pass_ms, barriers=st["barriers"], grid=st["grid"], **occ)
    return record, out["launches"]["newton_resident"], comp_out["launches"]


def _counted_rollout(roll, system, state0, f_ext):
    """One rollout from state0, the launch counts set to 0 just before it
    and read just after: (state, Newton list, CG list, ms/step, {kernel:
    launches})."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    s, (nit, cgit) = roll(state0, f_ext)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(nit) * 1e3
    if not bool(torch.isfinite(s.x).all()):
        raise AssertionError("rollout state is not finite")
    names = KERNELS + ("newton_resident",)
    return s, nit, cgit, ms, {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in names}


def _rel_disp(x, want, x0):
    """max |x - want| over the displacement scale max |want - x0|."""
    return float((x - want).abs().max()) / float((want - x0).abs().max())


def dense_pins(device):
    """[dense_pins] (the module's docstring, 18). Returns the launches of
    its rollouts, summed by kernel."""
    import torch

    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton

    tag = "dense_pins"
    runs = {}
    for pins in ("fixed", "dense"):
        system, state0, f_ext, params = flagship_problem(device, torch.float32, RESIDENT_DIMS,
                                                         pins=pins)
        if not resident.eligible(system, None):
            raise AssertionError(f"{tag}: the {pins} pins must pass the resident gate")
        roll = newton.make_rollout(system, params, RESIDENT_ROLLOUT, precond_refresh=8)
        runs[pins] = _counted_rollout(roll, system, state0, f_ext)
        s, nit, cgit, ms, la = runs[pins]
        log(tag, f"{type(system.constraints).__name__}: {RESIDENT_ROLLOUT} steps {ms:.3f} ms/step, "
            f"median Newton {np.median(nit):g} / CG {np.median(cgit):g}, launches {la}")
    (xf, lf), (xd, ld) = ((runs[k][0].x, runs[k][0].lam) for k in ("fixed", "dense"))
    la = runs["dense"][4]
    refreshes = -(-RESIDENT_ROLLOUT // 8)
    capped = int((np.asarray(runs["dense"][1]) >= params.max_inner).sum())
    want = {"primal_prep": capped, "hv": 0, "svk_blocks": refreshes,
            "node_reduce": refreshes + capped, "newton_resident": RESIDENT_ROLLOUT}
    if la != want:
        raise AssertionError(f"{tag}: launches {la}, expected {want}")
    pinned = torch.nonzero(system.constraints.mask[:, 0]).squeeze(1)
    off = torch.ones(len(xd), dtype=torch.bool, device=device)
    off[pinned] = False
    rel = _rel_disp(xd, xf, state0.x)
    lam_rel = float((ld[pinned] - lf).abs().max()) / float(lf.abs().max())
    log(tag, f"DensePins against FixedCoefs on the same {len(pinned)} pins: Newton and CG lists "
        f"{'equal' if runs['fixed'][1:3] == runs['dense'][1:3] else 'DIFFER'}; positions "
        f"{'bitwise equal' if torch.equal(xd, xf) else 'not bitwise equal'}, max |dx| "
        f"{rel:.3e} of the displacement scale (bar {DENSE_PINS_TOL:g}); duals at the pins "
        f"{lam_rel:.3e} relative, off the pins max |lam| {float(ld[off].abs().max()):g}")
    if runs["fixed"][1:3] != runs["dense"][1:3] or not rel < DENSE_PINS_TOL or bool(
            ld[off].any()):
        raise AssertionError(f"{tag}: DensePins disagree with FixedCoefs")
    total = {k: runs["fixed"][4][k] + la[k] for k in la}

    # Prescribed motion: the pinned face's targets moved every step, through
    # the persistent kernel, then through K1-K4 (the gate patched off).
    pins0 = system.constraints
    drop = torch.zeros_like(pins0.target)
    drop[:, 2] = -PRESCRIBED_SPEED * params.dt
    moved = {}
    orig = resident.eligible
    for path in ("resident", "composed"):
        if path == "composed":
            resident.eligible = lambda *a, **k: False

        def roll(st, f, n=PRESCRIBED_STEPS):
            step, nits, cgs = newton.make_step(system, params), [], []
            for k in range(1, n + 1):
                system.constraints = pins0.with_targets(pins0.target + k * drop)
                st, d = step(st, f)
                nits.append(d["newton_iters"])
                cgs.append(d["cg_iters"])
            return st, (nits, cgs)

        try:
            moved[path] = _counted_rollout(roll, system, state0, f_ext)
        finally:
            resident.eligible = orig
            system.constraints = pins0
        s, nit, cgit, ms, la = moved[path]
        log(tag, f"prescribed motion, {path}: {PRESCRIBED_STEPS} steps {ms:.3f} ms/step, median "
            f"Newton {np.median(nit):g} / CG {np.median(cgit):g}, launches {la}")
        total = {k: total[k] + la[k] for k in la}
    lr, lc = moved["resident"][4], moved["composed"][4]
    if (lr["newton_resident"] != PRESCRIBED_STEPS or lr["primal_prep"] or lr["hv"]
            or lc["newton_resident"] or min(lc[k] for k in KERNELS) <= 0):
        raise AssertionError(f"{tag}: prescribed-motion launches {lr} / {lc}")
    xr, xc = moved["resident"][0].x, moved["composed"][0].x
    rel = _rel_disp(xr, xc, state0.x)
    travel = PRESCRIBED_SPEED * params.dt * PRESCRIBED_STEPS
    face = float((state0.x[pinned, 2] - xr[pinned, 2]).mean()) / travel
    log(tag, f"prescribed motion, resident against composed: positions max |dx| {rel:.3e} of the "
        f"displacement scale (bar {F32_RESIDENT_TOL:g}); Newton lists "
        f"{'equal' if moved['resident'][1] == moved['composed'][1] else 'differ'}, CG "
        f"{sum(moved['resident'][2])} against {sum(moved['composed'][2])}; the pinned face "
        f"moved {face:.4f} of its prescribed {travel:g} m")
    if not rel < F32_RESIDENT_TOL:
        raise AssertionError(f"{tag}: resident and composed prescribed motion disagree: {rel:.3e}")
    return total


def linear_rows(device):
    """[linear_rows] (the module's docstring, 19). Returns the launches of
    the linear rows' first rollout."""
    import torch

    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton

    tag = "linear_rows"
    runs = []
    orig = resident.eligible
    for pins in ("linear", "linear", "fixed"):
        system, state0, f_ext, params = ancf_beam_problem(device, torch.float32, 64, pins=pins)
        if pins == "linear" and orig(system, None):
            raise AssertionError(f"{tag}: linear rows passed the resident gate")
        resident.eligible = lambda *a, **k: False  # FixedCoefs on the composed path too
        try:
            roll = newton.make_rollout(system, params, ANCF_BEAM_STEPS, precond_refresh=8)
            runs.append(_counted_rollout(roll, system, state0, f_ext))
        finally:
            resident.eligible = orig
        s, nit, cgit, ms, la = runs[-1]
        log(tag, f"{type(system.constraints).__name__} ({system.constraints.n_constraints} rows): "
            f"{ANCF_BEAM_STEPS} steps {ms:.3f} ms/step, median Newton {np.median(nit):g} / CG "
            f"{np.median(cgit):g}, launches {la}")
    la = runs[0][4]
    if la["newton_resident"] or min(la[k] for k in KERNELS) <= 0:
        raise AssertionError(f"{tag}: a kernel of the composed path was never launched: {la}")
    same = torch.equal(runs[0][0].x, runs[1][0].x) and runs[0][1:3] == runs[1][1:3]
    rel = _rel_disp(runs[0][0].x, runs[2][0].x, state0.x)
    counts = "equal" if runs[0][1:3] == runs[2][1:3] else "differ"
    log(tag, f"two runs {'bitwise equal' if same else 'DIFFER'}; against FixedCoefs on the "
        f"composed path: Newton and CG lists {counts}, positions max |dx| {rel:.3e} of the "
        f"displacement scale (bar {LINEAR_ROWS_TOL:g}), "
        f"{'bitwise equal' if torch.equal(runs[0][0].x, runs[2][0].x) else 'not bitwise equal'}")
    if not same or not rel < LINEAR_ROWS_TOL:
        raise AssertionError(f"{tag}: linear rows are not repeatable or disagree with FixedCoefs")
    return la


def stiff_problem(device, accum):
    """[accuracy_mode] (a)'s problem, `tests/test_f32_stiff.py:27-62`: box
    1.0 x 0.2 x 0.15, 8 x 2 x 2 cells (192 FEAT10 elements), SVK at E 7e8,
    nu 0.3, damping 1e5, x = 0 face pinned, gravity, float32 (the material
    and solver constants rounded to float32 as the test's are); accum:
    `System.accum_dtype` float64 with u carried in float64. Returns
    (system, state, f_ext, params)."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.solvers import StepState, System
    from tlfea_torch.solvers.newton import NewtonParams
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    def f32(a):
        return float(np.float32(a))

    nodes, conn = box_t10_mesh(1.0, 0.2, 0.15, 8, 2, 2)
    lam, mu = lame_from_E_nu(7e8, 0.3)
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=torch.float32, device="cpu")
    f_ext = torch.zeros((len(nodes), 3), dtype=torch.float32)
    f_ext[:, 2] = lumped_mass(elems_cpu) * np.float32(-9.81)
    x0 = torch.as_tensor(nodes, dtype=torch.float32, device=device)
    system = System(elems=elems_cpu.to(device), material=SVK(f32(lam), f32(mu), 1e5, 1e5),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0),
                    accum_dtype=torch.float64 if accum else None)
    state = StepState.rest(system, x0)
    if accum:
        state = state.replace(u=state.u.double())
    fs = float(f_ext.norm())
    params = NewtonParams(dt=f32(1e-3), rho=f32(1e11), inner_atol=f32(1e-4 * fs),
                          inner_rtol=0.0, outer_tol=f32(1e-5 * fs), max_outer=2, max_inner=8,
                          cg_rtol=f32(1e-4), cg_max_iter=300, ew_eta_max=0.0)
    return system, state, f_ext.to(device), params


def _grad_vs_f64(system, state, f_ext, params):
    """(||g - g64||, ||g64||) over ||f_ext||: the system's gradient (the
    kernels: K5 + K4, float64 ones in the accuracy mode) at v = v_prev
    against the float64 twins' on the same tables cast up and the same
    state. The accuracy mode's g is a float64 sum cast to float32, so its
    floor is about float32's eps times ||g64||."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.solvers import System
    from tlfea_torch.solvers.common import grad_L

    x, v, lam, u = state.x, state.v, state.lam, state.u
    g = grad_L(v, x, v, lam, f_ext, params.dt, params.rho, system, u_prev=u)
    cons = system.constraints
    sys64 = System(elems=system.elems.to(dtype=torch.float64), material=system.material,
                   constraints=FixedCoefs(cons.idx, cons.target.double()), plain=True)
    x, v, lam, u, f64 = (t.double() for t in (x, v, lam, u, f_ext))
    g64 = grad_L(v, x, v, lam, f64, params.dt, params.rho, sys64, u_prev=u)
    return float((g.double() - g64).norm() / f64.norm()), float(g64.norm() / f64.norm())


def _stiff_rollout(device, accum):
    """(a)'s 40 steps under the load ramped over 30, through `newton.step`:
    (final ||g|| / ||f_ext||, final state, the gradient against the
    float64 twins there, launches, float64 launches, seconds)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers import newton

    system, state, f_ext, params = stiff_problem(device, accum)
    fs = float(f_ext.norm())
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    final = float("nan")
    for k in range(STIFF_STEPS):
        state, diag = newton.step(system, state, params,
                                  f_ext * float(np.float32(min(1.0, (k + 1) / STIFF_RAMP))))
        h = diag["norm_g_history"]
        h = h[torch.isfinite(h)]
        if len(h) == 0:
            raise AssertionError(f"accuracy_mode: the stiff beam diverged at step {k}")
        final = float(h[-1]) / fs
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    la, la64 = dict(fk.LAUNCHES), dict(fk.LAUNCHES_F64)
    if not bool(torch.isfinite(state.x).all()):
        raise AssertionError("accuracy_mode: the stiff beam's state is not finite")
    return final, state, _grad_vs_f64(system, state, f_ext, params), la, la64, secs


def _tight_rollout(device, accum):
    """(b): the 10k flagship at bench.py's 10k_tight tolerance (0.5 % of
    ||f_ext||) with its coarse correction, a warm-up and a timed ROLLOUT,
    the launch counts of the timed one, and a [trace] window."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    tag = "accuracy_mode"
    system, state, f_ext, params = flagship_problem(device, torch.float32)
    params = replace(params, inner_atol=TIGHT_TOL * float(f_ext.norm()))
    if accum:
        system = system.replace(accum_dtype=torch.float64)
        state = state.replace(u=state.u.double())
    co = build_coarse_precond(system, state.x, params.dt, params.rho, max_agg=512)
    roll = newton.make_rollout(system, params, ROLLOUT, coarse=co, precond_refresh=8)
    state, _ = roll(state, f_ext)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    state, counts = roll(state, f_ext)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ROLLOUT * 1e3
    nit, cgit = counts
    la = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in KERNELS}
    la64 = {k: fk.LAUNCHES_F64[fk.launch_key(k, system.fem)] for k in KERNELS}
    if not bool(torch.isfinite(state.x).all()):
        raise AssertionError(f"{tag}: the 10k_tight rollout is not finite")
    nit, cgit = np.asarray(nit), np.asarray(cgit)
    mode = "float32 + accum_dtype float64" if accum else "pure float32"
    log(tag, f"(b) 10k_tight, {mode}: {ms:.3f} ms/step over {ROLLOUT} steps; Newton/step "
        f"median {np.median(nit):g}, CG/step median {np.median(cgit):g}, "
        f"newton_unconverged_frac {_unconverged(counts):.3f} (at the cap "
        f"{float((nit >= params.max_inner).mean()):.3f}); launches {la}, of them float64 {la64}")
    by_name = _device_profile(lambda: newton.make_rollout(
        system, params, TRACE_STEPS, coarse=co, precond_refresh=8)(state, f_ext))
    _log_profile(tag, by_name, TRACE_STEPS, "step", ms)
    return {"ms": ms, "newton": nit, "cg": cgit, "launches": la, "launches_f64": la64,
            "state": state, "unconverged": _unconverged(counts)}


def accuracy_mode(device):
    """[accuracy_mode] (the module's docstring, 20). Returns the accuracy
    mode's launches in its 10k_tight rollout, {kernel: (all, float64)}, and
    in its first-order gradient and jvp, {kernel: float64} (ACCUM_KERNELS;
    every launch there is float64)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.ops import resident
    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.common import grad_L

    tag = "accuracy_mode"
    # (a) the stiff beam, accuracy mode and pure float32.
    runs = {}
    for mode in ("accum", "f32"):
        final, st, (dg, gn), la, la64, secs = runs[mode] = _stiff_rollout(device, mode == "accum")
        used = {k: v for k, v in la.items() if v}
        used64 = {k: v for k, v in la64.items() if v}
        log(tag, f"(a) stiff beam, {mode}: {STIFF_STEPS} steps in {secs:.2f} s, final ||g|| = "
            f"{final:.3e} of the load (bar {STIFF_BARS[mode]:g}); gradient at the final state "
            f"(v = v_prev, ||g64|| {gn:.3e} of the load) against the float64 twins' {dg:.3e} "
            f"of the load; launches {used}, float64 "
            f"{used64}; u {str(st.u.dtype)[6:]}, x {str(st.x.dtype)[6:]}")
    la, la64 = runs["accum"][3], runs["accum"][4]
    if la["newton_resident[feat10]"] or min(la64[f"{k}[feat10]"] for k in
                                            ("primal_prep", "hv", "node_reduce")) <= 0:
        raise AssertionError(f"{tag}: the accuracy mode must run K1, K2, K4 in float64 and "
                             f"never the persistent kernel: {la64}")
    if any(runs["f32"][4].values()) or not runs["f32"][3]["newton_resident[feat10]"]:
        raise AssertionError(f"{tag}: pure float32 must run resident, with no float64 launch")
    if not (runs["accum"][0] <= STIFF_BARS["accum"] and runs["f32"][0] <= STIFF_BARS["f32"]):
        raise AssertionError(f"{tag}: final residuals {runs['accum'][0]:.3e} / "
                             f"{runs['f32'][0]:.3e} over their bars {STIFF_BARS}")
    system, _, _, _ = stiff_problem(device, True)
    if resident.eligible(system, None):
        raise AssertionError(f"{tag}: the resident gate admitted the accuracy mode")

    # (b) the 10k flagship at 10k_tight, pure float32 then the accuracy mode.
    tight = {mode: _tight_rollout(device, mode == "accum") for mode in ("f32", "accum")}
    if any(tight["f32"]["launches_f64"].values()):
        raise AssertionError(f"{tag}: pure float32 launched float64 kernels")
    if min(tight["accum"]["launches_f64"][k] for k in ("primal_prep", "hv", "node_reduce")) <= 0:
        raise AssertionError(f"{tag}: the accuracy mode launched no float64 K1, K2 or K4")

    # (c) the gradient's rounding noise beside float32's, SVK at (b)'s final
    # state and Mooney-Rivlin at the end of a float32 ROLLOUT.
    mr_problem = flagship_problem(device, torch.float32, material=mooney_rivlin())
    mr_state, _ = newton.make_rollout(mr_problem[0], mr_problem[3], ROLLOUT)(mr_problem[1],
                                                                             mr_problem[2])
    for name, st, (system, _, f_ext, prm) in (
            ("flagship", tight["f32"]["state"], flagship_problem(device, torch.float32)),
            ("mr_flagship", mr_state, mr_problem)):
        mat = system.material
        gradient_noise(f"{tag}] [{name}", device, st, mat)
        gradient_noise(f"{tag}] [{name}", device, st, mat, accum=True)
        same = {mode: _grad_vs_f64(sysm, st.replace(u=st.u.to(udt)), f_ext, prm)
                for mode, sysm, udt in (
                    ("float32", system, torch.float32),
                    ("accum", system.replace(accum_dtype=torch.float64), torch.float64))}
        log(tag, f"(c) {name}: the gradient against the float64 twins on the same tables cast "
            f"up (table rounding left out): float32 {same['float32'][0]:.3e}, accuracy mode "
            f"{same['accum'][0]:.3e} of ||f_ext||, where ||g64|| is {same['accum'][1]:.3e} of "
            f"it")

    # The first-order path in the accuracy mode: K5 + K4 and the jvp's K5t +
    # K4 in float64, counted apart.
    fk.reset_launch_counts()
    system, state, f_ext, prm = flagship_problem(device, torch.float32)
    system = system.replace(accum_dtype=torch.float64)
    u = state.u.double()
    p = torch.randn_like(state.v, generator=torch.Generator(device=device).manual_seed(SEED))
    g, jv = torch.func.jvp(lambda v: grad_L(v, state.x, state.v, state.lam, f_ext, prm.dt,
                                            prm.rho, system, u_prev=u), (state.v,), (p,))
    torch.cuda.synchronize()
    first = {k: fk.LAUNCHES_F64[fk.launch_key(k, system.fem)] for k in ACCUM_KERNELS}
    log(tag, f"grad_L and its jvp in the accuracy mode at 10k: {str(g.dtype)[6:]} / "
        f"{str(jv.dtype)[6:]} results, float64 launches {first}")
    if min(first[k] for k in ("contrib", "contrib_tangent", "node_reduce")) <= 0:
        raise AssertionError(f"{tag}: the first-order path launched no float64 K5 / K5t / K4")
    la, la64 = tight["accum"]["launches"], tight["accum"]["launches_f64"]
    return {k: (la[k], la64[k]) for k in KERNELS}, first


def simulation_phase(device):
    """[simulation] (the module's docstring, 21). Returns the launches of
    its rollouts, summed by kernel (KERNELS and newton_resident)."""
    import torch

    from tlfea_torch.diagnostics import energy_report
    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.ops import resident
    from tlfea_torch.simulation import Simulation, gravity_force
    from tlfea_torch.solvers import newton
    from tlfea_torch.utils import io_vtk
    from tlfea_torch.utils.profiling import StepTimer

    tag = "simulation"
    system, state0, _, params = flagship_problem(device, torch.float32, RESIDENT_DIMS,
                                                 pins="dense")
    if not resident.eligible(system, None):
        raise AssertionError(f"{tag}: the DensePins 1k box must pass the resident gate")
    f_ext = gravity_force(system)
    timer = StepTimer()
    names = KERNELS + ("newton_resident",)

    def report(sim, k, diag):
        if (k + 1) % 5 == 0:
            rep = {key: val.tolist() for key, val in energy_report(
                sim.state.x, sim.state.v, sim.system.elems, sim.system.material).items()}
            log(tag, f"step {sim.step_count}: Newton {diag['newton_iters']}, CG "
                f"{diag['cg_iters']}; energy_report {rep}")

    def timed(sim, n, cb=None):
        for k in range(n):
            with timer.phase("step", block_on=sim.state.x):
                diag = sim.step()
            if cb is not None:
                cb(sim, k, diag)

    fk.reset_launch_counts()
    sim = Simulation(system, state0, newton.stepper(params), base_f_ext=f_ext)
    timed(sim, SIM_STEPS, report)
    la = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in names}
    if la["newton_resident"] < SIM_STEPS or la["primal_prep"] or la["hv"]:
        raise AssertionError(f"{tag}: Simulation + stepper left the resident path: {la}")
    ref, _ = newton.make_rollout(system, params, SIM_STEPS)(state0, f_ext)
    same_roll = all(torch.equal(getattr(sim.state, k), getattr(ref, k)) for k in ("x", "v", "u"))
    log(tag, f"Simulation + stepper against make_rollout over {SIM_STEPS} steps: "
        f"{'bitwise equal' if same_roll else 'NOT bitwise equal'} (both resident); launches {la}")

    # Checkpoint at step SIM_STEPS / 2, resumed in a new Simulation.
    half = SIM_STEPS // 2
    path = os.path.join(ROOT, "out", "simulation_checkpoint.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    first = Simulation(system, state0, newton.stepper(params), base_f_ext=f_ext)
    timed(first, half)
    with timer.phase("save_state"):
        first.save_state(path)
    resumed = Simulation(system, state0, newton.stepper(params), base_f_ext=f_ext)
    with timer.phase("load_state", block_on=resumed.state.x):
        resumed.load_state(path)
    timed(resumed, SIM_STEPS - half)
    same_resume = resumed.step_count == SIM_STEPS and all(
        torch.equal(getattr(resumed.state, k), getattr(sim.state, k))
        for k in ("x", "v", "lam", "u", "dv"))
    log(tag, f"save_state at step {half}, load_state, {SIM_STEPS - half} more steps: "
        f"{'bitwise equal' if same_resume else 'NOT bitwise equal'} to the uninterrupted run")
    if not (same_roll and same_resume):
        raise AssertionError(f"{tag}: Simulation is not bitwise make_rollout or its resume")

    # Release one pinned node and step on.
    pinned = torch.nonzero(sim.system.constraints.mask[:, 0]).squeeze(1)
    node = int(pinned[len(pinned) // 2])
    z0 = float(sim.state.x[node, 2])
    sim.set_pinned([node], False)
    timed(sim, SIM_EXTRA, report)
    dz = float(sim.state.x[node, 2]) - z0
    log(tag, f"node {node} released: {SIM_EXTRA} steps moved it {dz:+.3e} m in z; "
        f"{int(sim.system.constraints.mask.sum())} of {len(pinned)} pins left")
    if not bool(torch.isfinite(sim.state.x).all()) or sim.system.constraints.mask[node] != 0:
        raise AssertionError(f"{tag}: set_pinned failed")
    vtu = os.path.join(ROOT, "out", "simulation_final.vtu")
    with timer.phase("write_vtu"):
        io_vtk.write_vtu_t10(vtu, sim.system.elems.x_ref, sim.system.elems.conn,
                             displacement=sim.state.u)
    log(tag, f"wrote {os.path.relpath(vtu, ROOT)} ({os.path.getsize(vtu)} bytes)")
    for line in timer.report().splitlines():
        log(tag, "StepTimer " + line)
    total = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in names}
    return total


def collision_problem(kind, device, dtype):
    """`bench.py:395-500`'s collision scenes without the reference meshes:
    "collision" (the sphere drop's two boxes) or "dragon" (the item drop,
    the box DRAGON_ITEM standing in for the dragon). Returns (system, state,
    f_ext, params, collision, collision params)."""
    import torch

    from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
    from tlfea_torch.elements import feat10
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.solvers.newton import NewtonParams
    from tlfea_torch.utils.mesh_manager import MeshManager
    from tlfea_torch.utils.pressure import distance_pressure_field
    from tlfea_torch.utils.tetmesh import box_t10_mesh

    mm = MeshManager()
    if kind == "collision":
        n0, c0 = box_t10_mesh(0.5, 0.5, 0.5, 4, 4, 2)
        a, b = mm.add_mesh(n0, c0, "a"), mm.add_mesh(n0, c0, "b")
        za = mm.mesh_nodes(a)[:, 2]
        mm.translate_mesh(b, (0.0, 0.0, za.max() - za.min() + 0.002))
        meshes, window, max_pairs, dt = (a, b), 256, 4096, 5e-4
        falling, v_init, rest_nodes = b, -1.0, False
    else:
        ni, ci = box_t10_mesh(*DRAGON_ITEM)
        it = mm.add_mesh(ni, ci, "box_item")
        inodes = mm.mesh_nodes(it)
        ext = inodes.max(axis=0) - inodes.min(axis=0)
        fn, fc = box_t10_mesh(2.5 * ext[0], 2.5 * ext[1], 0.2 * ext[2], 6, 6, 2)
        floor = mm.add_mesh(fn, fc, "floor")
        overlap = 0.15 * ext[2]  # the pressed-contact start
        mm.translate_mesh(floor, (inodes[:, 0].min() - 0.75 * ext[0],
                                  inodes[:, 1].min() - 0.75 * ext[1],
                                  inodes[:, 2].min() - 0.2 * ext[2] + overlap))
        meshes, window, max_pairs, dt = (it, floor), 256, 8192, 2e-4
        falling, v_init, rest_nodes = it, 0.0, True
    for mid in meshes:
        inst = mm.instances[mid]
        lc = mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), lc, 1e6))
    scene = mm.scene(reorder=True)
    nodes, conn = scene.nodes, scene.conn

    lam, mu = lame_from_E_nu(1e6, 0.3)
    zmin = nodes[:, 2].min()
    zext = nodes[:, 2].max() - zmin
    fixed = np.nonzero(nodes[:, 2] < zmin + (0.05 * zext if kind == "collision" else 1e-9))[0]
    if kind == "dragon":
        item_nodes = scene.mesh_node_ids(meshes[0])
        iz = nodes[item_nodes, 2]
        top = item_nodes[iz > iz.max() - 0.08 * (iz.max() - iz.min())]
        fixed = np.unique(np.concatenate([fixed, top]))
    elems_cpu = feat10.build(nodes, conn, rho=1000.0, dtype=dtype, device="cpu")
    system, state, f_ext, _ = _pinned_problem(elems_cpu, nodes, fixed, device,
                                              SVK(lam, mu, 1e2, 1e2))
    v0 = torch.zeros_like(state.v)
    v0[torch.as_tensor(scene.mesh_node_ids(falling), device=device), 2] = v_init
    state = state.replace(v=v0)
    f_scale = float(f_ext.norm())
    params = NewtonParams(dt=dt, rho=1e8, inner_atol=2.5e-2 * f_scale, inner_rtol=0.0,
                          outer_tol=0.0, max_outer=1, max_inner=6, cg_rtol=1e-3,
                          cg_max_iter=50, ew_eta_max=0.5)
    collision = HydroelasticCollision(
        conn, scene.elem_mesh_ids, scene.pressures.astype(np.float32 if dtype == torch.float32
                                                          else np.float64),
        window=window, max_pairs=max_pairs, rest_nodes=nodes if rest_nodes else None,
        device=device)
    return system, state, f_ext, params, collision, HydroelasticParams(friction=0.3)


def _third_law(tag, f):
    """|sum f| over max |f|, the forces summed in float64; raises above
    THIRD_LAW_TOL."""
    scale = float(f.abs().max())
    net = float(f.double().sum(0).abs().max()) / scale
    log(tag, f"third law: |sum f| = {net:.3e} of max |f| = {scale:.4e} N (bar {THIRD_LAW_TOL:g})")
    if not (scale > 0 and net <= THIRD_LAW_TOL):
        raise AssertionError(f"{tag}: the contact forces do not balance ({net:.3e})")


def _event_ms(fn, n):
    """(CUDA-event ms per call over n back-to-back calls after a warm-up,
    the profiler's device-busy ms per call over COLLISION_BUSY_CALLS more)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    busy = sum(t for t, _ in _device_profile(
        lambda: [fn() for _ in range(COLLISION_BUSY_CALLS)]).values())
    return start.elapsed_time(end) / n, busy / COLLISION_BUSY_CALLS


def _card_vs_cpu(tag, make, x, v, params):
    """One collision step in float64 on the card and through the port on
    the CPU, each system from make(device): the same pairs, valid masks,
    contacts (valid and valid_orientation), vertex counts of the valid
    patches and overflow, forces within CARD_CPU_TOL of max |f|. Fields of
    invalid patches are not compared (a pair of one body with parallel
    pressure gradients fits a plane to rounding noise); how many of them
    differ is logged. Returns the contacts."""
    import torch

    t0 = time.perf_counter()
    card, host = make(x.device), make(torch.device("cpu"))
    fc, pc, oc = card.step(x.double(), v.double(), params)
    fh, ph, oh = host.step(x.double().cpu(), v.double().cpu(), params)
    pc = {k: getattr(pc, k).cpu() for k in ("valid", "valid_orientation", "n_verts", "tetA",
                                             "tetB")}
    ph = {k: getattr(ph, k) for k in pc}
    valid = ph["valid"]
    same = (all(torch.equal(pc[k], ph[k]) for k in ("valid", "tetA", "tetB"))
            and torch.equal(pc["valid"] & pc["valid_orientation"],
                            valid & ph["valid_orientation"])
            and torch.equal(pc["n_verts"][valid], ph["n_verts"][valid]))
    loose = {k: int((pc[k] != ph[k])[~valid].sum()) for k in ("valid_orientation", "n_verts")}
    scale = float(fh.abs().max())
    err = float((fc.cpu() - fh).abs().max()) / max(scale, 1e-300)
    n_c = int((pc["valid"] & pc["valid_orientation"]).sum())
    n_h = int((valid & ph["valid_orientation"]).sum())
    log(tag, f"float64 step, card against CPU ({time.perf_counter() - t0:.1f} s): pairs, "
        f"valid masks, contacts and their vertex counts {'equal' if same else 'DIFFER'} "
        f"({int(valid.sum())} valid of {valid.numel()}; invalid slots whose "
        f"orientation / vertex count differ: {loose}), contacts {n_c} / {n_h}, overflow "
        f"{bool(oc)} / {bool(oh)}, forces {err:.3e} of max |f| = {scale:.4e} "
        f"(bar {CARD_CPU_TOL:g})")
    if not (same and bool(oc) == bool(oh) and err <= CARD_CPU_TOL):
        raise AssertionError(f"{tag}: the card's float64 collision step differs from the CPU's")
    return n_c


def collision_scene_phase(kind, device):
    """One scene of [collision] (the module's docstring, 22): returns its
    timed rollout's K1-K4 launches and (collision, end state, params)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.simulation import Simulation
    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    tag = "collision"
    t0 = time.perf_counter()
    system, state, f_ext, params, collision, cp = collision_problem(kind, device,
                                                                    torch.float32)
    coarse = build_coarse_precond(system, state.x, params.dt, params.rho)
    n_elem = system.elems.conn.shape[0]
    log(tag, f"{kind}: {n_elem} elements, {system.n_coef} nodes, broadphase {collision.mode}, "
        f"{int(collision.pressures.gt(0).sum())} nodes of positive pressure; scene, system and "
        f"coarse correction built in {time.perf_counter() - t0:.1f} s")
    sim = Simulation(system, state, newton.stepper(params, coarse=coarse), base_f_ext=f_ext,
                     collision=collision, collision_params=cp)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # each regrowth warns; counted below
        for _ in range(COLLISION_WARM[kind]):
            sim.step()
    torch.cuda.synchronize()
    collision = sim.collision
    caps = {"window": collision.bp.window, "max_pairs": collision.max_pairs}
    if collision.blk is not None:
        caps["block_pair_cap"] = collision.blk.block_pair_cap
    log(tag, f"{kind}: {COLLISION_WARM[kind]} warm Simulation steps in "
        f"{time.perf_counter() - t0:.2f} s, overflow_events {sim.overflow_events}, "
        f"capacities then {caps}")

    def force_fn(x, v):
        f, _, ovf = collision.step(x, v, cp)
        return f, ovf

    roll = newton.make_coupled_rollout(system, params, COLLISION_TIMED, force_fn,
                                       coarse=coarse, precond_refresh=8)
    s, _, _ = roll(sim.state, f_ext)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    s, (nit, cgit), ovf = roll(s, f_ext)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in KERNELS}
    ms = wall / COLLISION_TIMED * 1e3
    f, patches, _ = collision.step(s.x, s.v, cp)
    n_contacts = int(patches.n_contacts)
    log(tag, f"{kind}: make_coupled_rollout(precond_refresh=8), {COLLISION_TIMED} steps: "
        f"{ms:.3f} ms/step, Newton median {float(np.median(nit))}, CG median "
        f"{float(np.median(cgit))}, timed overflow flag {bool(ovf)}, contacts at the end "
        f"{n_contacts}, launches {la}")
    if bool(ovf) or not bool(torch.isfinite(s.x).all()) or n_contacts == 0 or not all(la.values()):
        raise AssertionError(f"{tag}: {kind}'s timed rollout overflowed, diverged, ended "
                             f"without contact or left a kernel unlaunched")
    _third_law(tag, f)

    t0 = time.perf_counter()
    pairs, valid, _ = collision.broadphase_fn(s.x)
    pat = collision.narrowphase_fn(s.x, pairs, valid)
    times = {
        "broadphase_fn": _event_ms(lambda: collision.broadphase_fn(s.x), COLLISION_CALLS),
        "narrowphase_fn": _event_ms(lambda: collision.narrowphase_fn(s.x, pairs, valid),
                                    COLLISION_CALLS),
        "forces_fn": _event_ms(lambda: collision.forces_fn(pat, s.x, s.v, cp), COLLISION_CALLS),
    }
    log(tag, f"{kind}: phases at the end state, ms per call over {COLLISION_CALLS} calls "
        f"(CUDA events) / {COLLISION_BUSY_CALLS} (device busy): " + ", ".join(
            f"{k} {e:.4f} / {b:.4f}" for k, (e, b) in times.items())
        + f"; their sum {sum(e for e, _ in times.values()):.4f} of the {ms:.3f} ms step "
        f"({time.perf_counter() - t0:.1f} s)")
    short = newton.make_coupled_rollout(system, params, COLLISION_TRACE, force_fn,
                                        coarse=coarse, precond_refresh=8)
    short(s, f_ext)
    _log_profile(f"trace {kind}", _device_profile(lambda: short(s, f_ext)), COLLISION_TRACE,
                 "step", ms)
    return la, (collision, s, cp)


def collision_phase(device):
    """[collision] (the module's docstring, 22). Returns the K1-K4 launches
    of the two timed rollouts, summed by kernel, and the persistent
    kernel's launches of the coupled-rollout check."""
    import torch

    from tlfea_torch.collision import dem
    from tlfea_torch.collision.broadphase import setup_broadphase
    from tlfea_torch.collision.gridhash import find_pairs_grid, setup_grid
    from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import feat10
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.simulation import Simulation, gravity_force
    from tlfea_torch.solvers import StepState, System, newton
    from tlfea_torch.utils.mesh_manager import MeshManager
    from tlfea_torch.utils.pressure import distance_pressure_field
    from tlfea_torch.utils.tetmesh import box_t10_mesh, hairpin_t10_mesh, surface_triangles_t10

    tag = "collision"
    launches = {k: 0 for k in KERNELS}
    for kind in ("collision", "dragon"):
        la, (collision, s, cp) = collision_scene_phase(kind, device)
        launches = {k: launches[k] + la[k] for k in KERNELS}
    args = dict(collision._init_args)
    args["pressures"] = args["pressures"].astype(np.float64)
    _card_vs_cpu(tag + " dragon", lambda d: HydroelasticCollision(**dict(args, device=d)),
                 s.x, s.v, cp)

    # tests/test_coupled_rollout.py's scene: the coupled rollout against the
    # Simulation loop, float32, bitwise.
    t0 = time.perf_counter()
    mm = MeshManager()
    n1, c1 = box_t10_mesh(0.3, 0.3, 0.12, 2, 2, 2)
    a, b = mm.add_mesh(n1, c1, "lower"), mm.add_mesh(n1, c1, "upper")
    mm.translate_mesh(b, (0.02, 0.02, 0.11))
    for mid in (a, b):
        inst = mm.instances[mid]
        lc = mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), lc, 5e5))
    nodes, conn = mm.nodes, mm.elements
    lam, mu = lame_from_E_nu(5e5, 0.3)
    x0 = torch.as_tensor(nodes, dtype=torch.float32, device=device)
    system = System(elems=feat10.build(nodes, conn, rho=1000.0, dtype=torch.float32,
                                       device=device),
                    material=SVK(lam, mu, 2e2, 2e2),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 2] < 1e-12)[0], x0))
    params = newton.NewtonParams(dt=1e-3, rho=1e8, inner_atol=1e-8, max_outer=1, max_inner=8,
                                 cg_max_iter=100)
    col = HydroelasticCollision(conn, mm.elem_mesh_ids(), mm.scalar_field().astype(np.float32),
                                window=64, max_pairs=2048, device=device)
    cp = HydroelasticParams(friction=0.3)
    f_base = gravity_force(system)
    sim = Simulation(system, StepState.rest(system, x0), newton.stepper(params),
                     base_f_ext=f_base, collision=col, collision_params=cp)
    fk.reset_launch_counts()
    for _ in range(CHECK_STEPS):
        sim.step()

    def force_fn(x, v):
        f, _, ovf = col.step(x, v, cp)
        return f, ovf

    s, _, ovf = newton.make_coupled_rollout(system, params, CHECK_STEPS, force_fn)(
        StepState.rest(system, x0), f_base)
    resident = fk.LAUNCHES[fk.launch_key("newton_resident", system.fem)]
    differ = [k for k in ("x", "v", "lam", "u", "dv")
              if not torch.equal(getattr(s, k), getattr(sim.state, k))]
    log(tag, f"tests/test_coupled_rollout.py's scene, {CHECK_STEPS} float32 steps "
        f"({time.perf_counter() - t0:.1f} s): "
        f"make_coupled_rollout {'bitwise' if not differ else 'NOT bitwise: ' + str(differ)} "
        f"the Simulation loop ({int(sim.last_patches.n_contacts)} contacts, "
        f"{resident} newton_resident launches)")
    if differ or bool(ovf):
        raise AssertionError(f"{tag}: the coupled rollout is not the Simulation loop")

    # Self-contact: the hairpin with its upper leg pressed 4 cm down.
    t0 = time.perf_counter()
    hn, hc = hairpin_t10_mesh(leg=0.4, gap=0.06, nx=HAIRPIN_NX, ny=2, nz=2)
    xh = hn.copy()
    xh[(hn[:, 2] > 0.08) & (hn[:, 0] > 0.1), 2] -= 0.04
    zeros = np.zeros(hc.shape[0], np.int32)
    margin = 0.02
    bp = setup_broadphase(hc, zeros, margin=margin, device=device)
    pairs, valid, ovf = find_pairs_grid(bp, setup_grid(hn, hc, margin=margin, device=device),
                                        torch.as_tensor(xh, device=device))
    got = {tuple(sorted(p)) for p in pairs[valid].cpu().tolist()}
    pts = xh[hc]
    lo, hi = pts.min(axis=1) - margin, pts.max(axis=1) + margin
    sets = [set(r) for r in hc]
    expect = {(i, j) for i in range(len(hc))
              for j in (i + 1 + np.nonzero(np.all((lo[i] <= hi[i + 1:]) & (hi[i] >= lo[i + 1:]),
                                                  axis=1))[0]).tolist()
              if not sets[i] & sets[j]}
    missed = expect - got
    log(tag, f"hairpin (nx {HAIRPIN_NX}, {len(hc)} elements), pressed "
        f"({time.perf_counter() - t0:.1f} s): grid candidates "
        f"{len(got)}, brute-force AABB pairs less neighbours {len(expect)}, missed "
        f"{len(missed)}, overflow {bool(ovf)}")
    if missed or bool(ovf):
        raise AssertionError(f"{tag}: the grid broadphase missed {len(missed)} pairs")
    pres = distance_pressure_field(hn, hc, 2e6)
    n_c = _card_vs_cpu(tag + " hairpin", lambda d: HydroelasticCollision(
        hc, zeros, pres, enable_self_collision=True, broadphase="grid", rest_nodes=hn,
        max_pairs=32768, margin=0.0, device=d), torch.as_tensor(xh, device=device),
        torch.zeros(xh.shape, device=device), HydroelasticParams(damping=2.0, friction=0.3))
    if n_c == 0:
        raise AssertionError(f"{tag}: the pressed hairpin made no self-contact")

    # DEM: tests/test_dem.py's scenes.
    t0 = time.perf_counter()
    mm = MeshManager()
    n1, c1 = box_t10_mesh(0.4, 0.4, 0.2, 2, 2, 1)
    mm.add_mesh(n1, c1, "a")
    mm.add_mesh(n1, c1, "b")
    mm.translate_mesh(1, (0.0, 0.0, 0.24))
    tris = [mm.surface_triangles(mid) for mid in range(2)]
    xd = torch.as_tensor(mm.nodes, device=device)
    vd = 0.1 * torch.randn(xd.shape, dtype=torch.float64,
                           generator=torch.Generator().manual_seed(SEED)).to(device)
    prm = dem.DemParams(kn=1e5, cn=30.0, mu=0.4)
    fc, ic, _ = dem.NodeSphereDem(mm.nodes, tris, device=device).step(xd, vd, prm)
    fh, ih, _ = dem.NodeSphereDem(mm.nodes, tris, device="cpu").step(xd.cpu(), vd.cpu(), prm)
    err = float((fc.cpu() - fh).abs().max() / fh.abs().max())
    log(tag, f"NodeSphereDem ({dem.NodeSphereDem(mm.nodes, tris, device='cpu').n_spheres} "
        f"spheres), float64 step, card against CPU: {err:.3e} of max |f|, contacts "
        f"{int(ic.n_contacts)} / {int(ih.n_contacts)}")
    if not (err <= CARD_CPU_TOL and int(ic.n_contacts) == int(ih.n_contacts) > 0):
        raise AssertionError(f"{tag}: NodeSphereDem differs on the card")
    _third_law(tag + " NodeSphereDem", fc)
    nsd = dem.NodeSphereDem(mm.nodes, tris, device=device)
    x32, v32 = xd.float(), vd.float()
    e_ms, b_ms = _event_ms(lambda: nsd.step(x32, v32, prm), 10)
    log(tag, f"NodeSphereDem float32 step: {e_ms:.4f} ms (CUDA events), device busy "
        f"{b_ms:.4f} ms")

    pn, pc = box_t10_mesh(0.5, 0.5, 0.1, 2, 2, 1)
    ptris = surface_triangles_t10(pc)
    gp = dem.DemParams(kn=1e5, cn=10.0, mu=0.3)
    out = []
    for d in (device, torch.device("cpu")):
        g = dem.GranularDem(ptris, n_sub=16, device=d)
        g.bind_cloud(dem.SphereCloud.grid(center=(0.25, 0.25, 0.12), extent=(0.2, 0.2, 0.0),
                                          spacing=0.05, radius=0.028, device=d))
        xp = torch.as_tensor(pn, device=d)
        out.append(g.step(xp, torch.zeros_like(xp), gp, dt=1e-3))
    (fg, ig, _), (fgh, igh, _) = out
    err = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for a, b in ((fg, fgh), (ig["cloud"].x, igh["cloud"].x),
                           (ig["cloud"].v, igh["cloud"].v)))
    log(tag, f"GranularDem ({ig['cloud'].x.shape[0]} spheres, {len(ptris)} triangles, 16 "
        f"substeps), float64 step, card against CPU: {err:.3e} (bar {CARD_CPU_TOL:g})")
    if not err <= CARD_CPU_TOL:
        raise AssertionError(f"{tag}: GranularDem differs on the card")
    g = dem.GranularDem(ptris, n_sub=16, device=device)
    g.bind_cloud(dem.SphereCloud.grid(center=(0.25, 0.25, 0.12), extent=(0.2, 0.2, 0.0),
                                      spacing=0.05, radius=0.028, dtype=torch.float32,
                                      device=device))
    xp = torch.as_tensor(pn, dtype=torch.float32, device=device)
    e_ms, b_ms = _event_ms(lambda: g.step(xp, torch.zeros_like(xp), gp, dt=1e-3), 10)
    log(tag, f"GranularDem float32 step: {e_ms:.4f} ms (CUDA events), device busy "
        f"{b_ms:.4f} ms; the DEM checks took {time.perf_counter() - t0:.1f} s")
    return launches, resident


def shell_theory(device, steps=THEORY_STEPS):
    """The float64 cantilever plate of tests/test_shell_validation.py through
    the kernels: returns (tip deflection / plate theory - 1, tip, theory,
    seconds, Newton and CG totals)."""
    import torch

    from tlfea_torch.constraints import FixedCoefs
    from tlfea_torch.elements import ancf3443
    from tlfea_torch.elements.assembly import lumped_mass
    from tlfea_torch.materials import SVK, lame_from_E_nu
    from tlfea_torch.solvers import StepState, System, newton

    L_el, W, H, n_el, E, rho = 0.25, 1.0, 0.02, 8, 2e10, 1000.0
    coefs, conn = ancf3443.shell_strip(n_el, L=L_el, W=W)
    lam, mu = lame_from_E_nu(E, 0.0)
    elems_cpu = ancf3443.build(coefs, conn, L_el, W, H, rho=rho, device="cpu")
    f_ext = torch.zeros((len(coefs), 3), dtype=torch.float64)
    f_ext[:, 2] = lumped_mass(elems_cpu) * -9.81
    x0 = torch.as_tensor(coefs, device=device)
    system = System(elems=elems_cpu.to(device), material=SVK(lam, mu, 2e5, 2e5),
                    constraints=FixedCoefs.from_indices(_clamp_rows([0, 1]), x0))
    step = newton.make_step(system, newton.NewtonParams(
        dt=1e-2, rho=1e10, inner_atol=1e-7, inner_rtol=1e-9, max_outer=2, max_inner=12,
        cg_rtol=1e-5, cg_max_iter=400))
    state = StepState.rest(system, x0)
    f_ext = f_ext.to(device)
    t0 = time.perf_counter()
    newton_tot = cg_tot = 0
    for _ in range(steps):
        state, d = step(state, f_ext)
        newton_tot += d["newton_iters"]
        cg_tot += d["cg_iters"]
    tips = [int(conn[-1][1]), int(conn[-1][2])]
    tz = float(np.mean([float(state.x[4 * k, 2]) - coefs[4 * k, 2] for k in tips]))
    secs = time.perf_counter() - t0
    q = rho * 9.81 * W * H  # load per unit length
    w_theory = q * (n_el * L_el) ** 4 / (8.0 * E * (W * H**3 / 12.0))
    return abs(tz + w_theory) / w_theory, tz, -w_theory, secs, newton_tot, cg_tot


def first_order_params(name, dt=1e-3, rho=1e7):
    """`examples/_common.make_solver`'s parameter sets (:89-108) as the
    port's dataclasses, at the flagship's dt and ALM rho. One change: VBD
    refreshes the gradient after every colour (color_group_size 1, the
    reference CUDA solver's sweep), because make_solver's default groups of
    4 colours diverge on the flagship within the first step (`vbd.py:37-38`
    warns that staler group residuals diverge at omega = 1). The [vbd]
    phase checks that they do; `tests/test_torch_first_order.py` holds the
    port's group-4 sweeps to the JAX package's on a smaller box of the
    flagship's cells, where both diverge alike."""
    from tlfea_torch.solvers import adamw, nesterov, vbd

    if name == "adamw":
        return adamw.AdamWParams(dt=dt, rho=rho, lr=1e-3, inner_tol=1e-8, inner_rtol=1e-8,
                                 outer_tol=1e-8, max_outer=3, max_inner=20000,
                                 convergence_check_interval=50)
    if name == "nesterov":
        return nesterov.NesterovParams(dt=dt, rho=rho, alpha=1e-7, inner_tol=1e-9,
                                       outer_tol=1e-8, max_outer=3, max_inner=20000)
    return vbd.VBDParams(dt=dt, rho=rho, omega=1.0, inner_tol=1e-7, outer_tol=1e-8,
                         max_outer=3, max_sweeps=200, convergence_check_interval=8,
                         color_group_size=1)


def _capped(name, params, n, structures=None):
    """params with one outer pass of n inner iterations; VBD's n counts
    gradients, each sweep taking one per colour group plus one
    at its checks."""
    if name == "vbd":
        per_sweep = len(structures.groups) + 1.0 / params.convergence_check_interval
        return replace(params, max_outer=1, max_sweeps=max(1, round(n / per_sweep)))
    return replace(params, max_outer=1, max_inner=n)


def first_order_phase(name, device, problem, n_steps, params=None, tag=None):
    """A first-order solver on the flagship through K5 + K4: a warm step
    capped at CHECK_INNER inner iterations (VBD: gradients), then n_steps
    timed ones (their launches: K5 and K4, and for VBD K3 for its
    blocks; K1, K2 and K5t never); a torch.profiler window of a capped step
    of TRACE_ITERS inner iterations; and one capped step from rest through
    the kernels and through the twins (equal counts, positions within 5e-3
    of the coordinate scale). params: the solver's parameters
    (`first_order_params(name)` unless given); tag: the phase's name in the
    log (name unless given). Returns {"launches", "state"}: the timed steps'
    launches and the state after them."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers import adamw, nesterov, vbd

    system, state0, f_ext, _ = problem
    op = system.fem
    params = params or first_order_params(name)
    module = {"adamw": adamw, "nesterov": nesterov, "vbd": vbd}[name]
    log_name = tag or name
    inner_key, unit = ("sweeps", "sweep") if name == "vbd" else ("inner_iters", "iteration")
    structures = None
    if name == "vbd":
        t0 = time.perf_counter()
        structures = vbd.prepare(system, group_size=params.color_group_size)
        log(name, f"colouring: {structures.n_colors} colours in {len(structures.groups)} "
            f"groups, built in {time.perf_counter() - t0:.2f} s")
        s4 = replace(params, max_outer=1, color_group_size=4)
        st4, d4 = vbd.make_step(system, s4, vbd.prepare(system, 4))(state0, f_ext)
        v4 = float(st4.v.abs().max())  # NaN once diverged
        log(name, f"make_solver's colour groups of 4, one outer pass from rest: {d4['sweeps']} "
            f"sweeps, max |v| {v4:.4e} (g dt = 9.81e-3)")
        if v4 <= 2 * 9.81 * params.dt:
            raise AssertionError("colour groups of 4 no longer diverge on the flagship: "
                                 "run [vbd] at make_solver's group size")

    def make(sysx, prm):
        if name == "vbd":
            return vbd.make_step(sysx, prm, structures)
        return module.make_step(sysx, prm)

    log(log_name, f"{params}")
    step = make(system, params)
    t0 = time.perf_counter()
    s, d = make(system, _capped(name, params, CHECK_INNER, structures))(state0, f_ext)
    torch.cuda.synchronize()
    log(log_name, f"warm step, capped: {time.perf_counter() - t0:.2f} s, outer "
        f"{d['outer_iters']}, {inner_key} {d[inner_key]}, ||c|| {d['norm_c']:.3e}")

    fk.reset_launch_counts()
    outers, inners = [], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        s, d = step(s, f_ext)
        outers.append(d["outer_iters"])
        inners.append(d[inner_key])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fk.LAUNCHES[fk.launch_key(k, op)] for k in KERNELS + FIRST_ORDER}
    if not bool(torch.isfinite(s.x).all()) or s.x.shape != state0.x.shape:
        raise AssertionError(f"{log_name}: the state is not finite")
    ms, per_inner = wall / n_steps * 1e3, wall / sum(inners) * 1e3
    log(log_name, f"timed: {n_steps} steps in {wall:.3f} s = {ms:.3f} ms/step, {per_inner:.5f} "
        f"ms/{unit}; outer per step {outers}, {inner_key} per step {inners}; ||c|| "
        f"{d['norm_c']:.3e}, max |u| {float(s.u.abs().max()):.4e}")
    log(log_name, f"launches in the timed steps: "
        f"{ {fk.launch_key(k, op): v for k, v in launches.items()} }")
    need = ("contrib", "node_reduce") + (("svk_blocks",) if name == "vbd" else ())
    never = ("primal_prep", "hv", "contrib_tangent") + (() if name == "vbd" else ("svk_blocks",))
    if min(launches[k] for k in need) <= 0 or any(launches[k] for k in never):
        raise AssertionError(f"{log_name}: launches {launches}: expected {need} > 0, {never} = 0")

    capped = _capped(name, params, TRACE_ITERS, structures)
    cstep = make(system, capped)
    cstep(s, f_ext)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dc = cstep(s, f_ext)
    torch.cuda.synchronize()
    wall_c = (time.perf_counter() - t0) * 1e3
    fk.reset_launch_counts()
    by_name = _device_profile(lambda: cstep(s, f_ext))
    grads = fk.LAUNCHES[fk.launch_key("contrib", op)]
    log("trace", f"{log_name}: a capped step of {dc[inner_key]} {unit}s, {grads} gradients: "
        f"{wall_c:.3f} ms untraced")
    _log_profile("trace", by_name, grads, "gradient", wall_c / grads)

    check = _capped(name, params, CHECK_INNER, structures)
    finals = {}
    for plain in (False, True):
        sysx = replace(system, plain=plain)
        t0 = time.perf_counter()
        sx, dx = make(sysx, check)(state0, f_ext)
        torch.cuda.synchronize()
        log(log_name, f"one capped step from rest via {'twins' if plain else 'kernels'}: "
            f"{time.perf_counter() - t0:.3f} s, outer {dx['outer_iters']}, {inner_key} "
            f"{dx[inner_key]}")
        finals[plain] = (sx.x, dx[inner_key])
    diff = float((finals[False][0] - finals[True][0]).abs().max())
    rel_coord = diff / float(finals[True][0].abs().max())
    rel_disp = diff / float((finals[True][0] - state0.x).abs().max())
    log(log_name, f"kernels vs twins: {inner_key} {finals[False][1]} vs {finals[True][1]}, max |dx| "
        f"{diff:.3e} = {rel_coord:.3e} of the coordinate scale (bar 5e-3), {rel_disp:.3e} of "
        f"the displacement scale")
    if finals[False][1] != finals[True][1] or not rel_coord < 5e-3:
        raise AssertionError(f"{log_name}: the kernel path disagrees with the twin path")
    return {"launches": launches, "state": s}


def jvp_phase(tag, device, problem, state, n_dirs=JVP_DIRECTIONS):
    """torch.func.jvp of grad_L at `state` along n_dirs random directions: K5
    + K4 for the gradient, K5t + K4 for its derivative. Each against the
    Newton path's Hessian product (K2 + K4, `g_and_hvp`), relative error
    within 1e-5 (float32). Returns the launches of the jvp run."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers.common import _pin_terms, grad_L

    system, _, f_ext, _ = problem
    op = system.fem
    dt, rho = 1e-3, 1e7

    def g_of(v):
        return grad_L(v, state.x, state.v, state.lam, f_ext, dt, rho, system, u_prev=state.u)

    gen = torch.Generator(device=device).manual_seed(SEED)
    dirs = [torch.randn(state.v.shape, generator=gen, device=device, dtype=state.v.dtype)
            for _ in range(n_dirs)]
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    tangents = [torch.func.jvp(g_of, (state.v,), (p,))[1] for p in dirs]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_dirs
    launches = {k: fk.LAUNCHES[fk.launch_key(k, op)] for k in KERNELS + FIRST_ORDER}
    pins = _pin_terms(system, state.lam, dt, rho, state.v.dtype)
    _, hvp = fk.g_and_hvp(state.v, state.u, state.v, f_ext, dt, system.fem, pins)
    rel = max(float((t - h).abs().max() / h.abs().max())
              for t, h in zip(tangents, (hvp(p) for p in dirs)))
    log(tag, f"{op.tag}: torch.func.jvp(grad_L) along {n_dirs} directions: {wall:.3f} ms "
        f"each; against g_and_hvp's K2 product: max rel err {rel:.3e} (tol 1e-5); launches "
        f"{ {fk.launch_key(k, op): v for k, v in launches.items()} }")
    if launches["contrib_tangent"] != n_dirs or launches["hv"] or not rel <= 1e-5:
        raise AssertionError(f"{tag}: the jvp did not run through K5t or disagrees with K2")
    return launches


def first_order_ancf(device):
    """The ANCF families through the first-order path, with SVK and with
    Mooney-Rivlin: on the bench.py shell plate and the 64-element ANCF3243
    beam, one AdamW step of make_solver's parameters capped at TRACE_ITERS
    iterations (K5 + K4), then the jvp of its gradient (K5t + K4). Returns
    {tag: launches}."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers import adamw

    out = {}
    for tag, make in (("ancf3443", shell_problem), ("ancf3243", ancf_beam_problem),
                      ("ancf3443_mr", shell_problem), ("ancf3243_mr", ancf_beam_problem)):
        material = mooney_rivlin() if tag.endswith("_mr") else None
        problem = make(device, torch.float32, material=material)
        system, state0, f_ext, _ = problem
        params = _capped("adamw", first_order_params("adamw"), TRACE_ITERS)
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        s, d = adamw.make_step(system, params)(state0, f_ext)
        torch.cuda.synchronize()
        launches = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in KERNELS + FIRST_ORDER}
        log("first_order_ancf", f"{tag}: {system.elems.n_elem} elements, one AdamW step of "
            f"{d['inner_iters']} iterations in {time.perf_counter() - t0:.3f} s, max |u| "
            f"{float(s.u.abs().max()):.3e}; launches {launches}")
        if not bool(torch.isfinite(s.x).all()) or min(launches[k] for k in
                                                       ("contrib", "node_reduce")) <= 0:
            raise AssertionError(f"{tag}: the first-order step did not run through K5 + K4")
        jl = jvp_phase("first_order_ancf", device, problem, s, n_dirs=2)
        out[tag] = {k: launches[k] + jl[k] for k in launches}
    return out


def first_order_vs_newton(device):
    """`tests/test_solvers.py:86-130` at the flagship size: the penalty
    subproblem (one outer pass, lam = 0, dt 2e-3, rho 1e6, two steps) has
    one minimiser, so AdamW (lr 1e-3, 30,000 iterations) and Nesterov
    (alpha 1e-5, 30,000) must land within 10 % of the deformation from
    Newton's. Returns the two deviations."""
    import torch

    from tlfea_torch.solvers import adamw, nesterov, newton

    system, state0, f_ext, _ = flagship_problem(device, torch.float32)
    dt, rho = 2e-3, 1e6
    runs = {
        "newton": newton.make_step(system, newton.NewtonParams(
            dt=dt, rho=rho, inner_atol=1e-11, max_outer=1, max_inner=25)),
        "adamw": adamw.make_step(system, adamw.AdamWParams(
            dt=dt, rho=rho, lr=1e-3, inner_tol=1e-12, inner_rtol=0.0, max_outer=1,
            max_inner=30000, convergence_check_interval=100)),
        "nesterov": nesterov.make_step(system, nesterov.NesterovParams(
            dt=dt, rho=rho, alpha=1e-5, inner_tol=1e-12, max_outer=1, max_inner=30000)),
    }
    x = {}
    for name, step in runs.items():
        s, counts = state0, []
        t0 = time.perf_counter()
        for _ in range(2):
            s, d = step(s, f_ext)
            counts.append({k: v for k, v in d.items() if k.endswith("iters")})
        torch.cuda.synchronize()
        x[name] = s.x
        log("first_order_vs_newton", f"{name}: two steps in {time.perf_counter() - t0:.2f} s, "
            f"{counts}")
    scale = float((x["newton"] - state0.x).abs().max())
    devs = {k: float((x[k] - x["newton"]).abs().max()) / scale for k in ("adamw", "nesterov")}
    log("first_order_vs_newton", f"deformation scale {scale:.4e} m; deviation from Newton's "
        f"positions: AdamW {devs['adamw']:.4e}, Nesterov {devs['nesterov']:.4e} of it (bar 0.10)")
    if not max(devs.values()) < 0.10:
        raise AssertionError(f"a first-order solver is off Newton's minimiser: {devs}")
    return devs


def mr_flagship(device):
    """[mr_flagship]: the 10k rollout with the flagship's material swapped
    for Mooney-Rivlin, through K1 and K2 `[feat10_mr]`, K4, the exact
    preconditioner blocks and the coarse correction, its gradient's float32
    noise (`gradient_noise`) and the float64 counts (`float64_counts`).
    Returns the launch counts of the timed rollout."""
    import torch

    out = rollout_phase("mr_flagship", device,
                        flagship_problem(device, torch.float32, material=mooney_rivlin()), ROLLOUT)
    log("mr_flagship", f"median Newton {np.median(out['newton']):g} / CG "
        f"{np.median(out['cg']):g} per step (the SVK flagship's: see [flagship])")
    gradient_noise("mr_flagship", device, out["state"], mooney_rivlin())
    float64_counts("mr_flagship", device, mooney_rivlin())
    return out["launches"]


def bunny_mr(device, n_steps=BUNNY_STEPS):
    """[bunny_mr]: `examples/bunny_deform.py --material mooney_rivlin` on its
    fallback mesh through the Mooney-Rivlin kernels (the rollout of
    `rollout_phase`), then its loop as the example runs it (a step at a
    time, blocks refreshed every step), printing max |dx| every 5 steps, in
    float32 through the kernels beside float64 through the plain twins on
    the card; their displacements must agree within BUNNY_TOL. Returns the
    launch counts of the timed rollout."""
    import torch

    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    tag = "bunny_mr"
    problem = bunny_problem(device, torch.float32)
    out = rollout_phase(tag, device, problem, n_steps)
    system, s32, f_ext, params = problem
    sys64, s64, f64_ext, params64 = bunny_problem(device, torch.float64)
    sys64 = replace(sys64, plain=True)
    co64 = build_coarse_precond(sys64, s64.x, params64.dt, params64.rho, max_agg=512)
    step32 = newton.make_step(system, params, coarse=out["coarse"])
    step64 = newton.make_step(sys64, params64, coarse=co64)
    x0 = s64.x[:, 0]
    t0 = time.perf_counter()
    for k in range(n_steps):
        s32, d32 = step32(s32, f_ext)
        s64, d64 = step64(s64, f64_ext)
        if k % 5 == 0:
            dx32 = float((s32.x[:, 0].double() - x0).abs().max())
            dx64 = float((s64.x[:, 0] - x0).abs().max())
            log(tag, f"step {k:4d} max_dx={dx32:.5f} |c|={d32['norm_c']:.1e} newton "
                f"{d32['newton_iters']} cg {d32['cg_iters']} (float64 twins: max_dx={dx64:.5f} "
                f"|c|={d64['norm_c']:.1e} newton {d64['newton_iters']} cg {d64['cg_iters']})")
    torch.cuda.synchronize()
    diff = float((s32.u.double() - s64.u).abs().max())
    scale = float(s64.u.abs().max())
    log(tag, f"{n_steps} steps a step at a time, both runs: {time.perf_counter() - t0:.2f} s; "
        f"float32 kernels vs float64 twins: max |du| {diff:.3e} = {diff / scale:.3e} of the "
        f"displacement {scale:.4e} m (bar {BUNNY_TOL:g})")
    if not diff / scale < BUNNY_TOL:
        raise AssertionError(f"{tag}: float32 kernels off the float64 twins: {diff / scale:.3e}")
    return out["launches"]


def mr_first_order(device, problem):
    """[mr_first_order]: one AdamW step of make_solver's parameters with the
    inner cap cut to MR_INNER on the Mooney-Rivlin flagship, through K5
    `[feat10_mr]` + K4, as `first_order_phase` runs it (warm step, timed
    step, trace, capped step kernels vs twins). Returns its result."""
    params = replace(first_order_params("adamw"), max_inner=MR_INNER)
    return first_order_phase("adamw", device, problem, 1, params=params, tag="mr_first_order")


def hv_phases(device, k2_ms):
    """[hv_phases]: `tlfea_torch.tools.ablate_hv` at each of HV_SCALES: the
    tool's run (every variant of `ops.hv_phases` and prod timed, the phase
    table printed) between a reset and a read of the launch counts, each of
    which must be above 0; then `ablate_hv.check` holds each variant to its
    twin. At 100k `index_add_` is timed beside scat (K4's library call); at
    10k gfe must take within 2x of k2_ms, [kernels]' K2 at the same shapes,
    and `ablate_hv.check_refuses_skips` must refuse every planted skip.
    Returns {variant: record} (100k's figures, 10k's as *_10k)."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.ops import hv_phases as hp
    from tlfea_torch.tools import ablate_hv

    rec = {v: {"launches": 0} for v in hp.VARIANTS}
    for scale in HV_SCALES:
        t0 = time.perf_counter()
        op, p, prep, dt = ablate_hv.problem(scale, device)
        torch.cuda.synchronize()
        log("hv_phases", f"{scale}: built in {time.perf_counter() - t0:.2f} s: {op.E} elements, "
            f"{op.n} nodes (CONFIGS: {ablate_hv.elements(scale)})")
        if op.E != ablate_hv.elements(scale):
            raise AssertionError(f"hv_phases: {scale} box has {op.E} elements")
        fk.reset_launch_counts()
        rows = ablate_hv.profile(op, p, prep, dt, log=lambda m: log("hv_phases", f"{scale}: {m}"))
        launches = {v: fk.LAUNCHES[f"hv_phase[{v}]"] for v in hp.VARIANTS}
        log("hv_phases", f"{scale}: launches in the profiled run: {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"hv_phases: a variant was never launched: {launches}")
        errs = ablate_hv.check(op, p, prep, dt, log=lambda m: log("hv_phases", f"{scale}: {m}"))
        sfx = "" if scale == "100k" else f"_{scale}"
        for v in hp.VARIANTS:
            r = rec[v]
            r["launches"] += launches[v]
            r.update({k + sfx: rows[v][k] for k in ("ms", "plain_ms", "bound_ms")})
            if not sfx:
                # scat is K4 on 3 channels; full's first launch is gfe's
                blocks = -(-op.n // fk.K4_THREADS) if v == "scat" else hp.n_blocks(op)
                occ, occ_text = occupancy_fields("hv_phase", hp.VARIANTS.index(v), torch.float32,
                                                 blocks)
                log("hv_phases", f"{scale}: {v}: {occ_text}")
                r.update(max_abs_err=errs[v][0], max_rel_err=errs[v][1],
                         bound_by=rows[v]["bound_by"], library_ms=None, **occ)
        if scale == "100k":
            # The one PyTorch call that computes scat's node sums.
            fes = hp.scat_buffer(op, p)
            vals_l = fes.view(op.S, 3, op.E).permute(2, 0, 1).reshape(op.E * op.S, 3).contiguous()
            idx = op.conn.reshape(-1)
            acc = torch.zeros((op.n, 3), dtype=fes.dtype, device=device)
            lib_ms, _ = _device_ms(lambda: acc.index_add_(0, idx, vals_l), 256)
            rec["scat"]["library_ms"] = lib_ms
            log("hv_phases", f"{scale}: index_add_ of scat's values {lib_ms:.4f} ms against scat "
                f"{rows['scat']['ms']:.4f} ms")
        if scale == "10k":
            ratio = rows["gfe"]["ms"] / k2_ms
            log("hv_phases", f"10k: gfe {rows['gfe']['ms']:.4f} ms against [kernels]' K2 "
                f"{k2_ms:.4f} ms: {ratio:.3f}x (bar 0.5-2)")
            if not 0.5 <= ratio <= 2.0:
                raise AssertionError(f"hv_phases: gfe at 10k takes {ratio:.2f}x K2's time")
            ablate_hv.check_refuses_skips(op, p, prep, dt,
                                          log=lambda m: log("hv_phases", f"10k: {m}"))
    return rec


def linearize_phase(device, problem, state, dims=(2.0, 0.35, 0.3, 42, 7, 6)):
    """[linearize]: torch.func.linearize of grad_L at `state` on the 10k
    flagship (`problem`, float32, and the float64 problem at `dims`), against
    torch.func.jvp along LIN_DIRECTIONS directions, relative error within
    1e-12 (float64) and 1e-5 (float32). The linearized function is a graph
    of operators (make_fx); each call must launch K5t once, so the kernels
    ran at the new direction, not constants of the trace. Returns the K5t
    launches of the float32 calls."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers.common import grad_L

    dt, rho = 1e-3, 1e7
    rng = np.random.default_rng(SEED)
    dirs = [rng.normal(size=tuple(state.v.shape)) for _ in range(LIN_DIRECTIONS)]
    lin_launches = 0
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        system, _, f_ext, _ = (problem if dtype == torch.float32
                               else flagship_problem(device, torch.float64, dims))
        x, v, lam, u = (getattr(state, k).to(dtype) for k in ("x", "v", "lam", "u"))

        def g_of(w, system=system, x=x, v=v, lam=lam, u=u, f_ext=f_ext):
            return grad_L(w, x, v, lam, f_ext, dt, rho, system, u_prev=u)

        t0 = time.perf_counter()
        _, lin = torch.func.linearize(g_of, v)
        torch.cuda.synchronize()
        t_lin = time.perf_counter() - t0
        key = fk.launch_key("contrib_tangent", system.fem)
        worst, per_call = 0.0, []
        for d in dirs:
            p = torch.as_tensor(d, dtype=dtype, device=device)
            before = fk.LAUNCHES[key]
            got = lin(p)
            torch.cuda.synchronize()
            per_call.append(fk.LAUNCHES[key] - before)
            want = torch.func.jvp(g_of, (v,), (p,))[1]
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        log("linearize", f"{str(dtype)[6:]}: torch.func.linearize(grad_L) traced in {t_lin:.2f} s; "
            f"{LIN_DIRECTIONS} directions against torch.func.jvp: max rel err {worst:.3e} (tol "
            f"{tol:g}); {key} launches per call {per_call}")
        if per_call != [1] * LIN_DIRECTIONS or not worst <= tol:
            raise AssertionError(f"linearize: K5t launches per call {per_call}, rel err {worst:.3e}")
        if dtype == torch.float32:
            lin_launches = sum(per_call)
    return lin_launches


def _tight_params(f_ext):
    """tests/test_coarse_precond.py's step tolerances at bench.py's dt and
    rho: Newton to 1e-6 of ||f_ext||, CG to 1e-6 with fixed forcing."""
    from tlfea_torch.solvers.newton import NewtonParams

    return NewtonParams(dt=1e-3, rho=1e7, inner_atol=1e-6 * float(f_ext.norm()),
                        inner_rtol=0.0, outer_tol=0.0, max_outer=1, max_inner=8,
                        cg_rtol=1e-6, cg_max_iter=400, ew_eta_max=0.0)


def coarse_bf16_check(tag, device, problem, co, params, enforce_x):
    """CHECK_STEPS from rest through the kernels with the bfloat16
    correction `co` and with the dense full-precision one on the same
    aggregates (mm_dtype None): CG per step of the first at most BF16_CG of
    the second's; the positions, through the displacements u (x itself is
    rounded to the coordinates' scale), within BF16_X_TOL of the
    displacement scale where enforce_x (else printed). Returns that
    relative difference."""
    import torch

    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_coarse_precond

    system, state0, f_ext, _ = problem
    t0 = time.perf_counter()
    dense = build_coarse_precond(system, state0.x, params.dt, params.rho,
                                 **{**COARSE_100K, "mm_dtype": None})
    torch.cuda.synchronize()
    log(tag, "dense comparator " + _coarse_desc(dense, time.perf_counter() - t0))
    if not torch.equal(dense.agg, co.agg):
        raise AssertionError("the dense and bfloat16 corrections differ in their aggregates")
    runs = {}
    for name, c in (("bf16", co), ("dense", dense)):
        t0 = time.perf_counter()
        sx, (nx, cx) = newton.make_rollout(system, params, CHECK_STEPS, coarse=c,
                                           precond_refresh=8)(state0, f_ext)
        torch.cuda.synchronize()
        log(tag, f"{CHECK_STEPS} steps from rest, {name} coarse ({system.fem.gN_t.dtype}): "
            f"{(time.perf_counter() - t0) / CHECK_STEPS * 1e3:.3f} ms/step, newton {nx}, cg {cx}")
        runs[name] = (sx.u, cx)
    del dense
    (ub, cb), (ud, cd) = runs["bf16"], runs["dense"]
    rel = float((ub - ud).abs().max() / (ud - state0.u).abs().max())
    a, b = BF16_CG
    log(tag, f"bfloat16 vs dense: x differs by {rel:.3e} of the displacement scale (bar "
        f"{BF16_X_TOL:g}{'' if enforce_x else ', printed'}); CG per step {cb} vs {cd} (bar "
        f"{a:g} x + {b})")
    if any(x > a * y + b for x, y in zip(cb, cd)):
        raise AssertionError(f"bfloat16 coarse CG {cb} exceeds {a} x {cd} + {b}")
    if enforce_x and not rel < BF16_X_TOL:
        raise AssertionError(f"bfloat16 coarse moves x by {rel:.3e} of the displacement scale")
    return rel


def flagship_100k(device):
    """bench.py's "100k" scale as a rollout through K1-K4 with the bfloat16
    range-flagged coarse correction (`rollout_phase`: warm-up, 30 timed
    steps, trace, kernels against twins); then that correction against the
    dense full-precision one, in float32 at the rollout's tolerance (CG bar)
    and in float64 at tests/test_coarse_precond.py's (CG and x bars).
    Returns (the rollout's record, the mesh's connectivity)."""
    import torch

    t0 = time.perf_counter()
    problem = flagship_problem(device, torch.float32, DIMS_100K)
    system = problem[0]
    log("flagship_100k", f"host setup (box mesh, best_order, feat10.build, the kernels' "
        f"tables): {time.perf_counter() - t0:.2f} s; {system.elems.n_elem} elements, "
        f"{system.n_coef} nodes")
    out = rollout_phase("flagship_100k", device, problem, ROLLOUT_100K, coarse_kw=COARSE_100K)
    busy = out["busy_ms"]
    log("flagship_100k", f"{out['ms']:.3f} ms/step, device busy "
        f"{'not traced' if busy is None else f'{busy:.4f} ms/step'}")
    coarse_bf16_check("flagship_100k", device, problem, out["coarse"], problem[3], False)
    conn = system.elems.conn.cpu().numpy()
    del problem, system
    out["coarse"] = out["state"] = None
    t0 = time.perf_counter()
    p64 = flagship_problem(device, torch.float64, DIMS_100K)
    co64 = build_coarse_precond_timed("flagship_100k", p64, COARSE_100K)
    log("flagship_100k", f"float64 problem and coarse in {time.perf_counter() - t0:.2f} s")
    coarse_bf16_check("flagship_100k", device, p64, co64, _tight_params(p64[2]), True)
    return out, conn


def build_coarse_precond_timed(tag, problem, kw):
    """build_coarse_precond at a problem's rest state, logged."""
    import torch

    from tlfea_torch.solvers.coarse import build_coarse_precond

    system, state0, _, params = problem
    t0 = time.perf_counter()
    co = build_coarse_precond(system, state0.x, params.dt, params.rho, **kw)
    if state0.x.is_cuda:
        torch.cuda.synchronize()
    log(tag, _coarse_desc(co, time.perf_counter() - t0))
    return co


def coarse_modes(device):
    """The 10k flagship for MODES_STEPS from rest with each coarse mode
    (trans, rigid, affine, rigid with bfloat16 tables) through the kernels,
    and one step of the legacy per-solve two-level path (`CoarseSetup`);
    then each mode's float64 apply on the card against the CPU's on the
    same residual: within max(1e-12, 8 eps kappa(A_c)) of its scale (both
    factorisations are exact to eps kappa), bfloat16 within BF16_APPLY_TOL.
    Returns the kernels' launches of the rollouts."""
    import torch

    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.solvers import newton
    from tlfea_torch.solvers.coarse import build_aggregates

    problem = flagship_problem(device, torch.float32)
    system, state0, f_ext, params = problem
    fk.reset_launch_counts()
    for name, kw in MODES:
        co = build_coarse_precond_timed(f"coarse_modes {name}", problem, dict(max_agg=512, **kw))
        t0 = time.perf_counter()
        s, (nit, cgit) = newton.make_rollout(system, params, MODES_STEPS, coarse=co,
                                             precond_refresh=8)(state0, f_ext)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / MODES_STEPS * 1e3
        if not bool(torch.isfinite(s.x).all()):
            raise AssertionError(f"coarse mode {name}: the state is not finite")
        log("coarse_modes", f"{name}: {MODES_STEPS} steps from rest {ms:.3f} ms/step, newton/step "
            f"median {np.median(nit):g}, cg/step median {np.median(cgit):g} (cg {cgit}), "
            f"max |u| {float(s.u.abs().max()):.4e}")
    setup = build_aggregates(state0.x)
    t0 = time.perf_counter()
    s, d = newton.make_step(system, params, coarse=setup)(state0, f_ext)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(s.x).all()):
        raise AssertionError("legacy two-level step: the state is not finite")
    log("coarse_modes", f"legacy CoarseSetup ({setup.n_agg} aggregates x 3, the Galerkin "
        f"operator assembled and factored per inner solve): one step from rest "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, newton {d['newton_iters']}, cg "
        f"{d['cg_iters']}")
    launches = {k: fk.LAUNCHES[fk.launch_key(k, system.fem)] for k in KERNELS}

    p_cpu = flagship_problem("cpu", torch.float64)
    p_dev = flagship_problem(device, torch.float64)
    r = torch.as_tensor(np.random.default_rng(SEED).standard_normal((p_cpu[0].n_coef, 3)))
    for name, kw in MODES:
        built = [build_coarse_precond_timed(f"coarse_modes f64 {name} {p[1].x.device.type}", p,
                                            dict(max_agg=512, **kw)) for p in (p_cpu, p_dev)]
        z_cpu = built[0].apply(r)
        z_dev = built[1].apply(r.to(device)).cpu()
        rel = float((z_dev - z_cpu).abs().max() / z_cpu.abs().max())
        if built[1].Ainv is None:
            tol = BF16_APPLY_TOL
        else:
            kappa = float(torch.linalg.cond(built[1].Ainv))
            tol = max(1e-12, 8 * float(np.finfo(np.float64).eps) * kappa)
        log("coarse_modes", f"float64 apply, {name}: card vs CPU {rel:.3e} of the scale (bar "
            f"{tol:.3e})")
        if not rel < tol:
            raise AssertionError(f"coarse mode {name}: the card's apply is {rel:.3e} off the CPU's")
    return launches


def native_phase(conn_100k):
    """The native host helpers (`tlfea_torch.native`, g++ from the port's
    source): built; on the 10k flagship their colours and incidence equal
    the NumPy functions'; at 100k the native helper timed alone."""
    import torch

    from tlfea_torch import native
    from tlfea_torch.utils import coloring

    if not native.available():
        raise AssertionError(f"the native helper did not build: {native.BUILD_ERROR}")
    log("native", f"library {os.path.relpath(native.library_path(), ROOT)}")
    conn = flagship_problem("cpu", torch.float32)[0].elems.conn.numpy()
    n = int(conn.max()) + 1
    t0 = time.perf_counter()
    colors, inc, mask = coloring.colors_and_incidence(conn, n)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    colors_np = coloring.greedy_coloring(coloring.build_adjacency(conn, n))
    inc_np, mask_np = coloring.build_incidence(conn, n)
    t_np = time.perf_counter() - t0
    if not (np.array_equal(colors, colors_np) and np.array_equal(inc, inc_np)
            and np.array_equal(mask, mask_np)):
        raise AssertionError("native colouring or incidence differs from the NumPy functions")
    log("native", f"10k flagship ({conn.shape[0]} elements, {n} nodes): {int(colors.max()) + 1} "
        f"colours, incidence up to {inc.shape[1]}; native {t_native * 1e3:.1f} ms, NumPy "
        f"{t_np * 1e3:.1f} ms, equal")
    n = int(conn_100k.max()) + 1
    t0 = time.perf_counter()
    colors, inc, _ = coloring.colors_and_incidence(conn_100k, n)
    log("native", f"100k ({conn_100k.shape[0]} elements, {n} nodes): {int(colors.max()) + 1} "
        f"colours, incidence up to {inc.shape[1]}, native {(time.perf_counter() - t0) * 1e3:.1f} ms")


# No AdamW run here: make_solver's 3 x 20,000 iterations a step took 30-44 s
# on this beam, and [adamw] runs the same parameter set on the flagship.
EXAMPLE_RUNS = (
    [("beam_sag_feat10", [f"--solver={s}", "--steps=2"]) for s in ("newton", "nesterov", "vbd")]
    + [("beam_sag_feat10", ["--res=16", "--steps=5", "--vtk_every=0"]),
       ("beam_sag_ancf3243", ["--steps=5"]), ("beam_sag_ancf3443", ["--steps=5"]),
       ("bunny_deform", ["--steps=5"]),
       ("bunny_deform", ["--steps=5", "--material=mooney_rivlin"])])
# The contact scenes on their fallback meshes, in contact within a few
# steps: the free bodies overlapping 5 mm at the start (the scripts' 0.15 m
# and 0.05 m gaps take hundreds of steps to close, and the shallow
# penetration a short fall gives makes no patch on the fallback boxes'
# coarse pressure fields), the gripper closing at 4 m/s (its 0.08 m/s
# closes 1.2 mm of the 0.02 m gap in 30 steps) with the close / hold /
# reopen fractions kept (0.4, 0.3), the fold at its default nx 24 over 40
# steps, so that the whole --press is applied.
CONTACT_RUNS = (
    ("sphere_drop_collision", ["--steps=40", "--drop_height=-5e-3", "--vtk_every=0"]),
    ("item_drop", ["--steps=30", "--drop_height=-5e-3", "--vtk_every=0"]),
    ("item_drop", ["--steps=10", "--collision=deme", "--drop_height=-5e-3", "--vtk_every=0"]),
    ("bubble_gripper", ["--steps=30", "--close_speed=4", "--vtk_every=0"]),
    ("self_contact_fold", ["--steps=40", "--vtk_every=0"]),
)
# The mesh-bound scripts on meshes written to a temporary folder ({meshes}):
# the reference net's 20 x 20 layout (L 0.5), a 36 x 20 shell patch of 5 cm
# (720 shells, the reference tire's count) welded at two seams, the
# resolution study's beams at res 0, 2, 4 (36, 972, 4,500 T10).
MESH_RUNS = (
    ("ancf3243_net", ["--mesh={meshes}/net.ancf3243mesh", "--steps=5", "--vtk_every=0"]),
    ("ancf3443_tire", ["--mesh={meshes}/patch.ancf3443mesh", "--steps=5", "--vtk_every=0"]),
    ("feat10_resolution_study", ["--res=0,2,4", "--steps=5"]),
)
NET_LAYOUT = (20, 20, 0.5)
TIRE_PATCH = dict(nu=36, nv=20, h=0.05, thickness=0.01, seams=(9, 27))
FOLD_CHECK = ["--steps=2", "--press=0.1", "--vtk_every=0", "--dtype=float64"]
FOLD_TOL = 1e-9  # the fold's float64 card vs CPU, of the displacement scale


def _write_example_meshes(folder):
    """The mesh-bound runs' meshes under `folder` (tests/mesh_files.py)."""
    from tests.mesh_files import (write_ancf3243_net, write_ancf3443_patch,
                                  write_resolution_beams)

    net = write_ancf3243_net(os.path.join(folder, "net.ancf3243mesh"), *NET_LAYOUT)
    patch = write_ancf3443_patch(os.path.join(folder, "patch.ancf3443mesh"), **TIRE_PATCH)
    beams = write_resolution_beams(folder, (0, 2, 4))
    log("examples", f"meshes in a temporary folder: net {net[0]} nodes / {net[1]} beams / "
        f"{net[2]} pinned joints, patch {patch[0]} nodes / {patch[1]} shells / {patch[2]} "
        f"welded joints, beams {beams}")


def _recording_simulation(record):
    """`Simulation` whose collision calls append (contacts, the call's
    forces' third-law ratio |sum f| / max |f|, summed in float64) to
    `record`, however the script calls them."""
    from tlfea_torch.simulation import Simulation

    def wrap(collision):
        step = collision.step

        def recorded(x, v=None, params=None):
            f, info, overflow = step(x, v, params)
            scale = float(f.abs().max())
            net = float(f.double().sum(0).abs().max()) / scale if scale > 0 else 0.0
            record.append((int(info.n_contacts), net))
            return f, info, overflow

        collision.step = recorded

    class Recording(Simulation):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            wrap(self.collision)

        def _check_overflow(self):
            before = self.collision
            super()._check_overflow()
            if self.collision is not before:  # regrown after an overflow
                wrap(self.collision)

    return Recording


def _example_line(script, argv, sim, hist, secs):
    """One run's log line: elements, seconds, last step's counts, end figures."""
    from tlfea_torch.examples import _common

    x = sim.state.x
    d = sim.last_diag
    counts = {k: int(d[k]) for k in ("outer_iters", "newton_iters", "cg_iters", "inner_iters",
                                     "sweeps") if k in d}
    if "converged" in d:
        counts["converged"] = bool(d["converged"])
    last = hist[-1] if isinstance(hist, list) else {r: h[-1] for r, h in hist.items()}
    big = sim.system.n_coef > _common.BIG and "--solver" not in " ".join(argv)
    return (f"{script} {' '.join(argv)}: {sim.system.elems.n_elem} elements, "
            f"{sim.system.n_coef} nodes ({sim.system.fem.tag}, {x.dtype}"
            f"{', bfloat16 coarse' if big else ''}), {secs:.2f} s with setup; last {last}, "
            f"last step {counts}, max |u| {float(sim.state.u.abs().max()):.4e}")


def _fold_card_vs_cpu(device):
    """self_contact_fold for 2 steps in float64 on `device` and on the CPU:
    positions within FOLD_TOL of the displacement scale."""
    from tlfea_torch.examples import self_contact_fold

    x = {}
    for dev in (device.type, "cpu"):
        sim, _ = self_contact_fold.main(FOLD_CHECK + [f"--device={dev}"])
        x[dev] = (sim.state.x.cpu(), sim.system.elems.x_ref.cpu(),
                  int(sim.last_patches.n_contacts))
    (xc, x0, nc_card), (xh, _, nc_cpu) = x[device.type], x["cpu"]
    rel = float((xc - xh).abs().max()) / float((xh - x0).abs().max())
    log("examples", f"self_contact_fold {' '.join(FOLD_CHECK)}: {device.type} against cpu, max "
        f"|dx| {rel:.3e} of the displacement scale (bar {FOLD_TOL:g}); contacts at the last "
        f"step {nc_card} / {nc_cpu}")
    if not (rel <= FOLD_TOL and nc_card == nc_cpu):
        raise AssertionError(f"self_contact_fold float64 {device.type} vs cpu: {rel:.3e}")


def examples_phase(device):
    """Each ported example's main() on `device` (float32, the default) for a
    few steps: its end figures, finite states on the device. The contact
    scenes: contacts > 0 at some step by the end, the third law at every
    collision call in contact; the fold in float64 on the card against the
    CPU. Returns the launches the runs made, {tag: {kernel: n}}."""
    import importlib
    import tempfile

    import torch

    from tlfea_torch.ops import fem_kernels as fk

    before = dict(fk.LAUNCHES)
    meshes = tempfile.TemporaryDirectory(prefix="tlfea_meshes_")
    _write_example_meshes(meshes.name)
    runs = ([(s, a, False) for s, a in EXAMPLE_RUNS] + [(s, a, True) for s, a in CONTACT_RUNS]
            + [(s, [v.format(meshes=meshes.name) for v in a], False) for s, a in MESH_RUNS])
    for script, argv, contact in runs:
        mod = importlib.import_module(f"tlfea_torch.examples.{script}")
        record = []
        if contact:
            mod.Simulation = _recording_simulation(record)
        if script == "feat10_resolution_study":
            mod.REF_DATA = meshes.name  # the beams' TLFEA_REF_DATA
        t0 = time.perf_counter()
        sim, hist = mod.main(argv + [f"--device={device.type}"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        x = sim.state.x
        if not (x.device.type == device.type and bool(torch.isfinite(x).all())):
            raise AssertionError(f"{script} {argv}: the state is not finite on {device}")
        log("examples", _example_line(script, argv, sim, hist, secs))
        if contact:
            n = [c for c, _ in record]
            worst = max((net for c, net in record if c > 0), default=float("nan"))
            log("examples", f"{script}: contacts per step {n}; third law over the steps in "
                f"contact: worst |sum f| = {worst:.3e} of max |f| (bar {THIRD_LAW_TOL:g})")
            if not max(n) > 0:
                raise AssertionError(f"{script} {argv}: no contact in {len(n)} steps")
            if not worst <= THIRD_LAW_TOL:
                raise AssertionError(f"{script}: the contact forces do not balance ({worst:.3e})")
    delta = {}
    for key, v in fk.LAUNCHES.items():
        if v - before.get(key, 0) > 0:
            name, tag = key[:-1].split("[")
            delta.setdefault(tag, {})[name] = v - before.get(key, 0)
    log("examples", f"launches: {delta}")
    meshes.cleanup()
    _fold_card_vs_cpu(device)
    return delta


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tlfea_torch")):
        print(f"chip_smoke: no tlfea_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tlfea_torch
    from tlfea_torch.ops import fem_kernels as fk
    from tlfea_torch.ops import hv_phases as hp

    device = torch.device("cuda")
    t_phase = time.perf_counter()

    def done(phase):
        nonlocal t_phase
        log(phase, f"phase took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()

    smi = card_line()
    log("setup", f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    bf16_red = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    log("setup", f"precision pins: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()!r}, "
        f"matmul.allow_bf16_reduced_precision_reduction={bf16_red} "
        f"(tlfea_torch {tlfea_torch.__version__})")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    if bf16_red:
        raise AssertionError("bfloat16 products may reduce in bfloat16")
    fk.build_kernels()
    log("setup", f"built {len(fk.BUILD_INFO['sources'])} libraries in "
        f"{fk.BUILD_INFO['seconds']:.1f} s (nvcc, sm_90a, in parallel)")
    for src, info in fk.BUILD_INFO["sources"].items():
        log("setup", f"{src}: {info['seconds']:.1f} s -> {os.path.relpath(info['path'], ROOT)}")
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("setup", "ptxas: " + line.split("ptxas info    :")[-1].strip())
    done("setup")

    timings = {
        "feat10": phase_kernels(device, "feat10", flagship_problem("cpu", torch.float64)[0]),
        "feat10_mr": phase_kernels(device, "feat10_mr", flagship_problem(
            "cpu", torch.float64, material=mooney_rivlin())[0]),
        "ancf3443": phase_kernels(device, "ancf3443", shell_problem("cpu", torch.float64)[0]),
        "ancf3443_mr": phase_kernels(device, "ancf3443_mr", shell_problem(
            "cpu", torch.float64, material=mooney_rivlin())[0]),
        "ancf3243": phase_kernels(device, "ancf3243", ancf_beam_problem("cpu", torch.float64)[0]),
        "ancf3243_mr": phase_kernels(device, "ancf3243_mr", ancf_beam_problem(
            "cpu", torch.float64, material=mooney_rivlin())[0]),
    }
    done("kernels")
    phases = hv_phases(device, timings["feat10"]["hv"]["ms"])
    done("hv_phases")

    dev, secs = beam_sag(device, torch.float32)
    log("beam", f"float32 beam sag, {BEAM_STEPS} steps in {secs:.2f} s: max tip deviation from the "
        f"float64 fixture {dev:.3e} of the displacement scale (bar 1e-6)")
    if not dev < 1e-6:
        raise AssertionError(f"beam sag deviates {dev:.3e} of the displacement scale")
    done("beam")

    launches = {"feat10": flagship(device)}
    done("flagship")
    out_100k, conn_100k = flagship_100k(device)
    launches["feat10"] = {k: launches["feat10"][k] + out_100k["launches"][k] for k in KERNELS}
    done("flagship_100k")
    # The persistent kernel, one record per (family, material); launches
    # from each phase's timed rollout.
    resident_runs = {}
    resident_runs["feat10"] = resident_phase(
        "resident", device, lambda dt: flagship_problem(device, dt, RESIDENT_DIMS),
        RESIDENT_ROLLOUT, "composed_1k", JAX_1K)
    done("resident")
    resident_runs["feat10_mr"] = resident_phase(
        "resident_mr", device,
        lambda dt: flagship_problem(device, dt, RESIDENT_DIMS, mooney_rivlin()),
        RESIDENT_ROLLOUT, "composed_1k_mr")
    done("resident_mr")
    pinned = dense_pins(device)
    record, res_launches, comp = resident_runs["feat10"]
    resident_runs["feat10"] = (record, res_launches + pinned["newton_resident"], comp)
    launches["feat10"] = {k: launches["feat10"][k] + pinned[k] for k in KERNELS}
    done("dense_pins")
    launches["ancf3443"] = shell(device)
    done("shell")
    launches["ancf3443_mr"] = rollout_phase(
        "shell_mr", device, shell_problem(device, torch.float32, material=mooney_rivlin()),
        SHELL_ROLLOUT)["launches"]
    done("shell_mr")

    rel, tz, w, secs, nt, ct = shell_theory(device)
    log("shell_theory", f"float64 cantilever plate, {THEORY_STEPS} steps in {secs:.2f} s "
        f"({nt} Newton, {ct} CG iterations): tip {tz:+.6e} m vs plate theory {w:+.6e} m, "
        f"off by {rel:.3%} (bar 5%)")
    if not rel < 0.05:
        raise AssertionError(f"shell tip is {rel:.1%} off plate theory")
    done("shell_theory")

    # The ANCF3243 cantilever through the persistent kernel, at 64 elements
    # and at 1,024 (one element block, 32 tiles), with SVK and Mooney-Rivlin;
    # K1-K4 from the composed comparison of the 64-element beam.
    for tag, material in (("ancf3243", None), ("ancf3243_mr", mooney_rivlin())):
        phase = "ancf_beam" + tag[8:]
        for n_elem in (64, BIG_BEAM):
            record, res_launches, comp = resident_phase(
                phase + ("" if n_elem == 64 else f"_{n_elem}"), device,
                lambda dt, n_elem=n_elem, material=material: ancf_beam_problem(
                    device, dt, n_elem, material),
                ANCF_BEAM_STEPS, f"composed_{phase}" + ("" if n_elem == 64 else f"_{n_elem}"))
            if n_elem == 64:
                resident_runs[tag] = (record, res_launches, comp)
                launches[tag] = comp
            else:
                run = resident_runs[tag]
                run[0].update({f"{k}_e{n_elem}": record[k] for k in
                               ("ms", "bound_ms", "max_rel_err_f64", "grid")})
                resident_runs[tag] = (run[0], run[1] + res_launches, run[2])
            done(phase + ("" if n_elem == 64 else f"_{n_elem}"))
    rows = linear_rows(device)
    launches["ancf3243"] = {k: launches["ancf3243"][k] + rows[k] for k in KERNELS}
    done("linear_rows")
    accum_newton, accum_first = accuracy_mode(device)
    launches["feat10"] = {k: launches["feat10"][k] + accum_newton[k][0] for k in KERNELS}
    done("accuracy_mode")
    sim = simulation_phase(device)
    launches["feat10"] = {k: launches["feat10"][k] + sim[k] for k in KERNELS}
    record, res_launches, comp = resident_runs["feat10"]
    resident_runs["feat10"] = (record, res_launches + sim["newton_resident"], comp)
    done("simulation")
    col, col_resident = collision_phase(device)
    launches["feat10"] = {k: launches["feat10"][k] + col[k] for k in KERNELS}
    record, res_launches, comp = resident_runs["feat10"]
    resident_runs["feat10"] = (record, res_launches + col_resident, comp)
    done("collision")
    modes = coarse_modes(device)
    launches["feat10"] = {k: launches["feat10"][k] + modes[k] for k in KERNELS}
    done("coarse_modes")
    native_phase(conn_100k)
    done("native")
    example_launches = examples_phase(device)
    done("examples")

    # The first-order path: K5 + K4 for every gradient, K5t + K4 for its jvp.
    problem = flagship_problem(device, torch.float32)
    first = {}
    for name in ("adamw", "nesterov", "vbd"):
        first[name] = first_order_phase(name, device, problem, FIRST_ORDER_STEPS[name])
        done(name)
    jvp_launches = jvp_phase("jvp", device, problem, first["adamw"]["state"])
    done("jvp")
    lin_launches = linearize_phase(device, problem, first["adamw"]["state"])
    done("linearize")
    first_order_vs_newton(device)
    done("first_order_vs_newton")
    ancf_first = first_order_ancf(device)
    done("first_order_ancf")

    # Mooney-Rivlin on the 10k box: K1/K2 [feat10_mr] in the Newton rollout,
    # K5 in an AdamW step, K5t in the jvp.
    launches["feat10_mr"] = mr_flagship(device)
    done("mr_flagship")
    bunny_mr(device)
    done("bunny_mr")
    mr_problem = flagship_problem(device, torch.float32, material=mooney_rivlin())
    mr_first = mr_first_order(device, mr_problem)
    done("mr_first_order")
    mr_jvp = jvp_phase("jvp", device, mr_problem, mr_first["state"])
    done("jvp (Mooney-Rivlin)")

    launches["feat10"]["contrib"] = (sum(r["launches"]["contrib"] for r in first.values())
                                     + accum_first["contrib"])
    launches["feat10"]["contrib_tangent"] = (jvp_launches["contrib_tangent"] + lin_launches
                                             + accum_first["contrib_tangent"])
    launches["feat10"]["node_reduce"] += accum_first["node_reduce"]
    launches["feat10_mr"]["contrib"] = mr_first["launches"]["contrib"]
    launches["feat10_mr"]["contrib_tangent"] = mr_jvp["contrib_tangent"]
    for tag, fl in ancf_first.items():
        launches[tag].update({k: fl[k] for k in FIRST_ORDER})
    for tag, counts in example_launches.items():  # [examples]: every kernel they launched
        for name, n in counts.items():
            if name in launches.get(tag, {}):
                launches[tag][name] += n
            elif name == "newton_resident":  # the fold's inner solves
                record, res_launches, comp = resident_runs[tag]
                resident_runs[tag] = (record, res_launches + n, comp)

    def src(tag, name):
        family, kind = (tag[:-3], "mr") if tag.endswith("_mr") else (tag, "svk")
        return "tlfea_torch/csrc/" + ("fem_kernels.cu" if name == "node_reduce"
                                      else fk.SOURCES[(family, kind)])

    def replaces(tag, name):
        return BODY_REPLACES.get(name) or (NODE_REDUCE_REPLACES if name == "node_reduce"
                                           else REPLACES[tag.removesuffix("_mr")][name])

    # The accuracy mode's float64 launches on the path ([accuracy_mode]):
    # K1, K2, K4 of the 10k_tight rollout, K5 and K5t of its first-order
    # gradient and jvp.
    for name in ACCUM_KERNELS:
        timings["feat10"][name]["launches_f64"] = (accum_newton.get(name, (0, 0))[1]
                                                   + accum_first[name])
    entries = [(f"{name}[{tag}]", src(tag, name), replaces(tag, name),
                launches[tag][name], timings[tag][name])
               for tag in ("feat10", "ancf3443", "ancf3243", "feat10_mr", "ancf3443_mr",
                           "ancf3243_mr")
               for name in (fk.MATERIAL_KERNELS["mr"] if tag.endswith("_mr")
                            else KERNELS + FIRST_ORDER)]
    for (family, kind), source in fk.RESIDENT_SOURCES.items():
        tag = family if kind == "svk" else f"{family}_{kind}"
        record, res_launches, _ = resident_runs[tag]
        entries.append((f"newton_resident[{tag}]", "tlfea_torch/csrc/" + source,
                        "tlfea/ops/pallas_resident.py:64", res_launches, record))
    for v, r in phases.items():
        entries.append((f"hv_phase[{v}]", "tlfea_torch/csrc/" + hp.SOURCE, hp.REPLACES[v],
                        r["launches"], r))
    # The contract's keys and max_rel_err (the bar), registers, waves and block of
    # the timed launch (float32; the phase kernels' at 100k), the resident kernel's
    # float64 errors, barriers, per-pass bound and its 1,024-element beam
    # figures, and the phase variants' 10k figures; numbers to four digits.
    keys = ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "regs", "waves", "block", "max_abs_err_f64", "max_rel_err_f64", "per_pass_bound_ms", "barriers",
            "grid", "f32_vs_f64_plain", f"ms_e{BIG_BEAM}", f"bound_ms_e{BIG_BEAM}", f"max_rel_err_f64_e{BIG_BEAM}",
            f"grid_e{BIG_BEAM}", "ms_10k", "plain_ms_10k", "bound_ms_10k", "launches_f64",
            "ms_f64", "bound_ms_f64", "bound_by_f64")
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": sr, "replaces": rp, "launches": la,
         **{k: (float(f"{r[k]:.4g}") if isinstance(r[k], float) else r[k])
            for k in keys if k in r}}
        for n, sr, rp, la, r in entries]}, separators=(",", ":")))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
