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
//
// K5t `contrib_tangent` launches one thread an (element, slot) too
// (fem_kernels.cuh `contrib_tangent_slots_kernel`, `Slots<8, 8>`: phase A
// one thread a point of the chunk, four contractions and the tangent into
// a dP record; phase B the slot's products; the 3 sums of each group in
// registers): on an H100 (NVIDIA H100 80GB HBM3, 700 W; `python -m
// tlfea_torch.tools.kernel_variants tangent`, parent -> Slots<8, 8> in one
// call, us) float32 33.12 -> 14.94 at 576 elements, 61.71 -> 33.95 at 5,184
// and 187.76 -> 116.49 at 20,736, at every E. In float64 38.99 -> 21.25 at
// 576 and 80.26 -> 76.08 at 5,184, but the parent is ahead by 5-13 % at
// 7,056, 11,664, 14,400 and 20,736 elements (the slots ahead at 9,216 and
// 17,424, where the parent's tiles leave a second wave nearly empty), so in
// float64 the slots run up to 5,184 elements, the last measured size before
// the first loss, and the parent tile above. Each form bit for bit the
// parent (PERF.md, Findings).

#include "fem_kernels.cuh"

using Ancf3443 = tlfea::Family<16, 48, 0x1111u, 4>;
using K3Slots = tlfea::Slots<8, 8>;
using K5tF32 = tlfea::Slots<8, 8>;
using K5tF64 = tlfea::Slots<8, 8, 5184>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3443, Ancf3443, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, K3Slots, K5tF32)
TLFEA_FAMILY_ENTRY_POINTS(ancf3443, Ancf3443, f64, double, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, K3Slots, K5tF64)
