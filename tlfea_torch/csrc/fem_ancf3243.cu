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
//
// K3 `svk_blocks` launches one thread an (element, slot) (fem_kernels.cuh
// `Slots<8, 12>`: 8 elements a block, all 12 points one chunk copied into
// shared memory by the block, so a block has 12 rows, 8 x 12 threads: phase
// A one thread a point, phase B rows 0-7 one a slot) up to 4,096 elements,
// in float32 and float64, and the parent tile above. On an H100 (NVIDIA H100
// 80GB HBM3, 700.00 W; `python -m tlfea_torch.tools.kernel_variants
// blocks_beam`, parent -> Slots<8, 12> in one call, us) float32 5.07 -> 3.62
// at 64 elements, 5.21 -> 3.76 at 1,024, 5.22 -> 4.19 at 2,048 and 5.42 ->
// 5.21 at 4,096 (168 registers, 3 blocks an SM -> 62, 10), float64 6.96 ->
// 4.55, 7.10 -> 4.69, 7.19 -> 5.57 and 7.51 -> 6.87 (254 -> 98 registers),
// each bit for bit the parent; the parent is ahead at 8,192 (6.73 against
// 7.98, float64 9.22 against 12.56) and 32,768 elements. Three chunks of 4
// points (`Slots<TE, 4>`, phase A on 4 of 8 rows) took 1.02-1.07x the
// parent's time at 64-2,048 elements in float32 (PERF.md, Findings).
//
// K5t `contrib_tangent` launches the same layout (fem_kernels.cuh
// `contrib_tangent_slots_kernel`, `Slots<8, 12>`: the block copies all 12
// points into shared memory in one chunk, phase A runs each point's SVK
// tangent on its own thread where the parent ran three in a row, phase B
// rows 0-7 add their slot's products): in float32 up to 4,096 elements and
// the parent tile above, in float64 at every E. On an H100 (NVIDIA H100
// 80GB HBM3, 700.00 W; `python -m tlfea_torch.tools.kernel_variants
// tangent_beam_gate`, parent -> Slots<8, 12> in one call, us) float32 6.75
// -> 4.50 at 64 elements, 6.86 -> 4.69 at 1,024, 6.86 -> 5.20 at 2,048 and
// 7.10 -> 6.90 at 4,096 (219 registers, 2 blocks an SM -> 64, 10), the
// parent ahead at 8,192 (9.24 against 10.57), level at 16,384 (19.32 against
// 19.36) and behind at 32,768 (44.98 against 39.23); float64 12.49 -> 5.46,
// 13.46 -> 5.64, 13.62 -> 7.10, 15.92 -> 9.38, 32.56 -> 18.19, 58.88 ->
// 36.87 and 110.13 -> 63.73 at 32,768 (255 registers and 648 B of local
// memory -> 123 and none). Each bit for bit the parent (PERF.md, Findings).

#include "fem_kernels.cuh"

using Ancf3243 = tlfea::Family<8, 12, 0x11u, 4>;
using K1F32 = tlfea::Direct<8, tlfea::Hold::early, 2048>;
using K1F64 = tlfea::Points<8, tlfea::Hold::early, 32768>;
using K2F32 = tlfea::Direct<8, tlfea::Hold::early, 4096>;
using K2F64 = tlfea::Points<8, tlfea::Hold::early, 4096>;
using K5Points = tlfea::Points<8, tlfea::Hold::early, 4096>;
using K3Slots = tlfea::Slots<8, 12, 4096>;
using K5tF32 = tlfea::Slots<8, 12, 4096>;
using K5tF64 = tlfea::Slots<8, 12>;
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f32, float, K1F32, K2F32, K5Points, K3Slots,
                          K5tF32)
TLFEA_FAMILY_ENTRY_POINTS(ancf3243, Ancf3243, f64, double, K1F64, K2F64, K5Points, K3Slots,
                          K5tF64)
