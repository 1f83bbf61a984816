// ANCF3443 shell instantiation of the element kernels K1-K3 (templates and
// design notes in fem_kernels.cuh). Replaces the QP-chunked Pallas bodies:
// pallas_fem.py `_primal_prep_chunked_body` (:1018), `_hv_chunked_body`
// (:1054) and the chunked `make_precond_blocks` kernel (:725).
//
// S = 16 slots (4 nodes x [r, r_u, r_v, r_w]); translation slots 0, 4, 8,
// 12; Q = 48 (4x4x3 Gauss). The TPU splits the 48 points into a grid axis of
// 8 chunks of 6 to fit VMEM; here the block's threadIdx.y takes NG = 4
// groups of 12, whose partial sums meet in shared memory in a fixed order.
// On an H100, float32 at 5,184 elements: 43/40/40 us for K1/K2/K3 with 4
// groups, 47/45/43 with 8 and 54/50/52 with 6.

#include "fem_kernels.cuh"

using Ancf3443 = tlfea::Family<16, 48, 0x1111u, 4>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3443, Ancf3443, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups)
TLFEA_FAMILY_ENTRY_POINTS(ancf3443, Ancf3443, f64, double, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups)
