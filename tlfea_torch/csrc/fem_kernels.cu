// FEAT10 instantiation of the element kernels K1-K3, and the node reduce K4
// (templates and design notes in fem_kernels.cuh).
//
// FEAT10: S = 10 Lagrange slots, all translation slots; Q = 5 (Keast);
// NG = 5, so one thread per (element, quadrature point); partial sums in
// shared memory (REG_BYTES = 0): on an H100 that keeps K2, the kernel of
// every CG iteration, at 7.1 us instead of 9.6 us with register partials.

#include "fem_kernels.cuh"

using Feat10 = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
TLFEA_FAMILY_ENTRY_POINTS(feat10, Feat10, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)
TLFEA_FAMILY_ENTRY_POINTS(feat10, Feat10, f64, double, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)

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
