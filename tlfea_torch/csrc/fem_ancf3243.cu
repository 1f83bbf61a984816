// ANCF3243 beam instantiation of the element kernels K1-K3 (templates and
// design notes in fem_kernels.cuh). Replaces the unchunked Pallas bodies at
// this element's shapes: pallas_fem.py `_primal_prep_body` (:888),
// `_hv_body` (:956) and `_precond_body` (:673).
//
// S = 8 slots (2 nodes x [r, r_u, r_v, r_w]); translation slots 0 and 4;
// Q = 12 (3x2x2 Gauss); NG = 4 groups of 3 quadrature points.

#include "fem_kernels.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f32, float)
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f64, double)
