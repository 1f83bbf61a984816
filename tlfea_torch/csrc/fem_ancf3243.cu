// ANCF3243 beam instantiation of the element kernels K1-K3 (templates and
// design notes in fem_kernels.cuh). Replaces the unchunked Pallas bodies at
// this element's shapes: pallas_fem.py `_primal_prep_body` (:888),
// `_hv_body` (:956) and `_precond_body` (:673).
//
// S = 8 slots (2 nodes x [r, r_u, r_v, r_w]); translation slots 0 and 4;
// Q = 12 (3x2x2 Gauss); NG = 4 groups of 3 quadrature points.
//
// K5 `contrib` (pallas_fem.py `_body` :519) launches one thread a
// quadrature point (fem_kernels.cuh `Points`: 8 elements x 12 points a
// block, a point's shape gradients, volume and Me rows loaded into
// registers before the gather) up to 4,096 elements, and the parent tile
// above: on an H100 at the 64-element beam 5.48 -> 2.99 us in float32 and
// 6.35 -> 3.31 in float64, bit for bit the parent, but slower than the
// parent from 8,192 elements (PERF.md, Findings: the crossover).

#include "fem_kernels.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
using K5Points = tlfea::Points<8, tlfea::Hold::early, 4096>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f32, float, K5Points)
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f64, double, K5Points)
