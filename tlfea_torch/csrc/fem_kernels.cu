// FEAT10 instantiation of the element kernels K1-K3, and the node reduce K4
// (templates and design notes in fem_kernels.cuh).
//
// FEAT10: S = 10 Lagrange slots, all translation slots; Q = 5 (Keast);
// NG = 5, so one thread per (element, quadrature point); partial sums in
// shared memory (REG_BYTES = 0): on an H100 that keeps K2, the kernel of
// every CG iteration, at 7.1 us instead of 9.6 us with register partials.
//
// K3 `svk_blocks` and K5t `contrib_tangent` launch one thread an (element,
// slot) (fem_kernels.cuh `Slots<16, 5>`: 16 elements x 10 slots a block, all
// 5 points one chunk copied into shared memory by the block into one buffer;
// phase A one thread a point, phase B the slot's sums in registers) at
// every E, in float32 and float64. The parent tile held 167-168 registers
// (float64 253-254), 2 blocks an SM (float64 1), so the 10k flagship's 331
// tiles took 2 waves (float64 3); the slots hold 56 (float64 84 for K3, 124
// for K5t), 7 blocks an SM (float64 4 and 3). On an H100 (NVIDIA H100 80GB
// HBM3, 700 W; `python -m tlfea_torch.tools.kernel_variants blocks_feat10
// tangent_feat10`, parent -> Slots<16, 5> in one call, us): K3 float32 5.21
// -> 3.67 at 864 elements, 10.12 -> 6.93 at 10,584 and 74.00 -> 48.97 at
// 101,376, float64 6.28 -> 4.36, 16.00 -> 10.88, 158.65 -> 86.89; K5t
// float32 6.20 -> 4.77, 11.96 -> 9.99, 100.23 -> 74.48, float64 7.83 ->
// 5.53, 21.48 -> 16.73, 215.43 -> 129.96; each bit for bit the parent
// (PERF.md, Findings).

#include "fem_kernels.cuh"

using Feat10 = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
using Feat10Slots = tlfea::Slots<16, 5>;
TLFEA_FAMILY_ENTRY_POINTS(feat10, Feat10, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, Feat10Slots, Feat10Slots)
TLFEA_FAMILY_ENTRY_POINTS(feat10, Feat10, f64, double, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, Feat10Slots, Feat10Slots)

// K4, batch: the incidences a thread loads at once, 4 or 8 (the wrapper
// takes 4 for the ANCF families, whose coefficient rows have at most 4);
// tlfea_occupancy_node_reduce_<SUFFIX>(batch, out): its occupancy().
#define TLFEA_NODE_REDUCE(SUFFIX, T)                                                    \
  extern "C" int tlfea_node_reduce_##SUFFIX(const void* vals, const void* ptr,          \
                                            const void* inc, void* out, int n, int E,   \
                                            int C, int batch, void* stream) {           \
    if (batch == 4)                                                                     \
      return tlfea::launch_node_reduce<T, 4>(vals, ptr, inc, out, n, E, C, stream);     \
    if (batch != 8) return (int)cudaErrorInvalidValue;                                  \
    return tlfea::launch_node_reduce<T, 8>(vals, ptr, inc, out, n, E, C, stream);       \
  }                                                                                     \
  extern "C" int tlfea_occupancy_node_reduce_##SUFFIX(int batch, int* out) {            \
    if (batch == 4) return tlfea::occupancy_node_reduce<T, 4>(out);                     \
    if (batch != 8) return (int)cudaErrorInvalidValue;                                  \
    return tlfea::occupancy_node_reduce<T, 8>(out);                                     \
  }

TLFEA_NODE_REDUCE(f32, float)
TLFEA_NODE_REDUCE(f64, double)
