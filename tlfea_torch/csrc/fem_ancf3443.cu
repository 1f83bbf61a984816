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
//
// K3 `svk_blocks` launches one thread an (element, slot) (fem_kernels.cuh
// `Slots<8, 8>`: 8 elements x 16 slots a block, chunks of 8 points copied
// into shared memory by the block, double-buffered, the 24 sums of a slot in
// registers) at every E: on an H100 (NVIDIA H100 80GB HBM3, 700 W; `python
// -m tlfea_torch.tools.kernel_variants blocks`, parent -> Slots<8, 8> in
// one call, us) float32 21.33 -> 10.49 at 576 elements, 39.37 -> 26.48 at
// 5,184 and 114.33 -> 100.22 at 20,736; float64 62.96 -> 14.76, 104.82 ->
// 50.48 and 372.61 -> 185.26, each bit for bit the parent (PERF.md,
// Findings).

#include "fem_kernels.cuh"

using Ancf3443 = tlfea::Family<16, 48, 0x1111u, 4>;
using K3Slots = tlfea::Slots<8, 8>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3443, Ancf3443, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, K3Slots)
TLFEA_FAMILY_ENTRY_POINTS(ancf3443, Ancf3443, f64, double, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, K3Slots)
