// ANCF3243 x Mooney-Rivlin instantiation of the element kernels K1
// primal_prep, K2 hv, K5 contrib and K5t contrib_tangent (templates in
// fem_kernels.cuh, material algebra in mr.cuh): `pallas_fem._MRTile` (:282)
// inside the unchunked `_primal_prep_body` (:888), `_hv_body` (:956) and
// `_body` (:519, its tangent :830) at the beam's shapes, as the
// family-agnostic `tile_material` (:466-480) hands it to them. No K3: the JAX
// package builds the Pallas blocks kernel for SVK only, so the Mooney-Rivlin
// blocks stay plain tensor code, as on FEAT10. K4 is in fem_kernels.cu.
//
// The same family as fem_ancf3243.cu: S = 8 slots, translation slots 0 and
// 4, Q = 12, NG = 4 groups of 3 quadrature points, partial sums (24 a
// thread) in registers. K1 and K5 load a quadrature point's shape
// gradients (fem_kernels.cuh `Hold`) as timed fastest on an H100 (PERF.md,
// Findings): K1 streams them through shared memory; K5 holds them in
// registers, the first point's loaded before the gather, in float32, and
// loads them where used in float64. K2 launches one thread a quadrature
// point (fem_kernels.cuh `Points`: 8 elements x 12 points a block) on
// beams of up to 2,048 (float32) or 4,096 (float64) elements, and the
// parent tile, loading where used, above: on an H100 at the 64-element
// beam 6.05 -> 3.72 us in float32, with a point's gradient, volume, prep
// and Me rows loaded into registers before the gather, and 9.82 -> 4.40
// in float64, loading where used (its held and streamed forms fuse other
// multiply-adds than the parent), each bit for bit the parent; slower than
// the parent from 8,192 elements (PERF.md, Findings: the crossover).
//
// K5t `contrib_tangent` launches one thread an (element, slot)
// (fem_kernels.cuh `contrib_tangent_slots_kernel`, `Slots<8, 12>`: all 12
// points one chunk, a block of 8 elements x 12 rows, so that phase A runs
// the 12 points' Mooney-Rivlin tangents at once, one a thread, where the
// parent ran three in a row a thread): in float32 up to 4,096 elements and
// the parent tile above, in float64 at every E. On an H100 (NVIDIA H100
// 80GB HBM3, 700.00 W; `python -m tlfea_torch.tools.kernel_variants
// tangent_beam`, damped, parent -> Slots<8, 12> in one call, us) float32
// 7.65 -> 4.55 at 64 elements, 7.77 -> 4.82 at 1,024, 7.77 -> 5.66 at 2,048
// and 7.98 -> 7.38 at 4,096 (255 registers -> 128), the parent ahead at
// 8,192 (10.64 against 12.98); float64 13.63 -> 5.93, 14.14 -> 6.06, 14.48
// -> 7.95, 16.53 -> 13.28, 34.75 -> 27.08 at 8,192 and 121.15 -> 108.42 at
// 32,768 (255 registers and 712 B of local memory -> 224 and none). Each
// bit for bit the parent. Three chunks of 4 points (`Slots<TE, 4>`) took
// 0.99-1.05x the parent's time at 64-2,048 elements in float32 (PERF.md,
// Findings).

#include "fem_kernels.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
using K2PointsF32 = tlfea::Points<8, tlfea::Hold::early, 2048>;
using K2PointsF64 = tlfea::Points<8, tlfea::Hold::none, 4096>;
using K5tF32 = tlfea::Slots<8, 12, 4096>;
using K5tF64 = tlfea::Slots<8, 12>;
TLFEA_MR_ENTRY_POINTS(ancf3243, Ancf3243, f32, float, stream, early, false,
                      K2PointsF32, false, K5tF32)
TLFEA_MR_ENTRY_POINTS(ancf3243, Ancf3243, f64, double, stream, none, false,
                      K2PointsF64, false, K5tF64)
