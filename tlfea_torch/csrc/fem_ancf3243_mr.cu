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

#include "fem_kernels.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
using K2PointsF32 = tlfea::Points<8, tlfea::Hold::early, 2048>;
using K2PointsF64 = tlfea::Points<8, tlfea::Hold::none, 4096>;
TLFEA_MR_ENTRY_POINTS(ancf3243, Ancf3243, f32, float, stream, early, false,
                      K2PointsF32, false, tlfea::Groups)
TLFEA_MR_ENTRY_POINTS(ancf3243, Ancf3243, f64, double, stream, none, false,
                      K2PointsF64, false, tlfea::Groups)
