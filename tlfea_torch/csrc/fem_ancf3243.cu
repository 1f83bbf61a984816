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
//
// K1 `primal_prep` and K2 `hv` split the same way, each point thread also
// writing (K1) or reading (K2) its point's 27 prep rows. In float32 each
// point thread gathers its own element's slots through conn (fem_kernels.cuh
// `Direct`: no staging and no first barrier), K1 up to 2,048 elements and K2
// up to 4,096; in float64 the block stages them (`Points`), K1 up to 32,768
// and K2 up to 4,096. On an H100 at the 64-element beam (`python -m
// tlfea_torch.tools.kernel_variants split`, parent -> form in one call, us):
// K1 5.62 -> 3.14 and 7.36 -> 3.78, K2 6.00 -> 3.06 and 6.24 -> 3.59, each
// bit for bit the parent; the parent is faster from 4,096 (K1 float32) and
// 8,192 elements (K2); K1's float64 split was ahead at every length timed,
// up to 32,768 elements, by 0.5-2 % above 4,096 (PERF.md, Findings).

#include "fem_kernels.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
using K1F32 = tlfea::Direct<8, tlfea::Hold::early, 2048>;
using K1F64 = tlfea::Points<8, tlfea::Hold::early, 32768>;
using K2F32 = tlfea::Direct<8, tlfea::Hold::early, 4096>;
using K2F64 = tlfea::Points<8, tlfea::Hold::early, 4096>;
using K5Points = tlfea::Points<8, tlfea::Hold::early, 4096>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f32, float, K1F32, K2F32, K5Points,
                          tlfea::Groups, tlfea::Groups)
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f64, double, K1F64, K2F64, K5Points,
                          tlfea::Groups, tlfea::Groups)
