// ANCF3443 x Mooney-Rivlin instantiation of the element kernels K1
// primal_prep, K2 hv, K5 contrib and K5t contrib_tangent (templates in
// fem_kernels.cuh, material algebra in mr.cuh): `pallas_fem._MRTile` (:282)
// inside the QP-chunked `_primal_prep_chunked_body` (:1018) and
// `_hv_chunked_body` (:1054), and in `_body` (:519, its tangent :830) at the
// shell's shapes. No K3 (the Mooney-Rivlin blocks are plain tensor code);
// K4 is in fem_kernels.cu.
//
// The same family as fem_ancf3443.cu: S = 16 slots, translation slots 0, 4,
// 8 and 12, Q = 48, NG = 4 groups of 12 quadrature points whose partial sums
// meet in shared memory in a fixed order. K1 and K5 load a quadrature
// point's shape gradients (fem_kernels.cuh `Hold`) as timed fastest on an
// H100 (PERF.md, Findings): held in registers, K5's first point in
// float64 before the gather. K2 loads where used (no STREAM): its 162
// tiles already run in one wave, and every other form timed was slower or
// not bitwise.
//
// K5t `contrib_tangent` launches one thread an (element, slot) in float32
// (fem_kernels.cuh `contrib_tangent_slots_kernel`, `Slots<8, 16>`: chunks
// of 16 points, so that each of the block's 128 threads runs one point's
// chain in phase A), at every E: on an H100 (NVIDIA H100 80GB HBM3, 700 W;
// `python -m tlfea_torch.tools.kernel_variants tangent`, parent -> Slots<8,
// 16> in one call, us) 37.22 -> 12.61 at 576 elements, 67.89 -> 40.10 at
// 5,184 and 201.61 -> 135.69 at 20,736 (255 registers with 704 B of spill
// stores -> 168, 12 B), bit for bit the parent. In float64 it keeps the
// parent: the slots hold 254 registers, two blocks an SM, and lose at
// 5,184 (87.19 -> 91.44) and 20,736 (229.86 -> 332.39) (PERF.md, Findings).

#include "fem_kernels.cuh"

using Ancf3443 = tlfea::Family<16, 48, 0x1111u, 4>;
using K5tF32 = tlfea::Slots<8, 16>;
TLFEA_MR_ENTRY_POINTS(ancf3443, Ancf3443, f32, float, late, late, false,
                      tlfea::Groups, false, K5tF32)
TLFEA_MR_ENTRY_POINTS(ancf3443, Ancf3443, f64, double, late, early, false,
                      tlfea::Groups, false, tlfea::Groups)
