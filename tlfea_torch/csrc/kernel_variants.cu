// Other instantiations of the element kernels, for timing the choice of NG
// (quadrature-point groups per element) and REG_BYTES (partial sums in
// registers) against the shipped ones (FEAT10: NG 5, shared partials;
// ANCF3443: NG 4, register partials); K1 and K5 with each way of loading
// the shape gradients (`Hold`); the forms of K4's walk; the
// persistent kernel with one thread slab a block; and a probe of the
// barriers the persistent kernel can use:
// `python -m tlfea_torch.tools.kernel_variants`.
// Not part of the library that `build_kernels` builds.
#include <cooperative_groups.h>

#include "resident.cuh"

using F10regs = tlfea::Family<10, 5, 0x3FFu, 5, 240>;
TLFEA_FAMILY_ENTRY_POINTS(f10regs, F10regs, f32, float)
using F10regs1 = tlfea::Family<10, 5, 0x3FFu, 1, 240>;
TLFEA_FAMILY_ENTRY_POINTS(f10regs1, F10regs1, f32, float)
using S4smem = tlfea::Family<16, 48, 0x1111u, 4, 0>;
TLFEA_FAMILY_ENTRY_POINTS(s4smem, S4smem, f32, float)
using S6regs = tlfea::Family<16, 48, 0x1111u, 6, 240>;
TLFEA_FAMILY_ENTRY_POINTS(s6regs, S6regs, f32, float)
using S8smem = tlfea::Family<16, 48, 0x1111u, 8, 0>;
TLFEA_FAMILY_ENTRY_POINTS(s8smem, S8smem, f32, float)
using S8regs = tlfea::Family<16, 48, 0x1111u, 8, 240>;
TLFEA_FAMILY_ENTRY_POINTS(s8regs, S8regs, f32, float)

// K1 and K5 with each way of loading a quadrature point's shape gradients
// (fem_kernels.cuh `Hold`: none, late, early, stream), at each MR family's
// shape: tlfea_{primal_prep,contrib}_<family>_<hold>_mr_<SUFFIX>. The
// shipped instantiations (fem_<family>_mr.cu) pick one per kernel. All give
// the same bits. The stream at ANCF3443 in float64 would need 302,080 bytes
// of shared memory: not instantiated.
#define VARIANT_MR(NAME, FAM, SUFFIX, T, HOLD)                                          \
  extern "C" int tlfea_primal_prep_##NAME##_##HOLD##_mr_##SUFFIX(                       \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, void* prep, int E, double mu10, double mu01,          \
      double kappa, double eta, double lam_d, void* stream) {                           \
    return tlfea::launch_primal_prep<T, FAM, tlfea::Hold::HOLD>(                        \
        packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E,                                  \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);         \
  }                                                                                     \
  extern "C" int tlfea_contrib_##NAME##_##HOLD##_mr_##SUFFIX(                           \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, int E, double mu10, double mu01, double kappa,        \
      double eta, double lam_d, void* stream) {                                         \
    return tlfea::launch_contrib<T, FAM, tlfea::Hold::HOLD>(                            \
        packed, conn_t, gN_t, dV_t, Me_t, fe, E,                                        \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);         \
  }
#define VARIANTS_MR(NAME, FAM, SUFFIX, T) \
  VARIANT_MR(NAME, FAM, SUFFIX, T, none)  \
  VARIANT_MR(NAME, FAM, SUFFIX, T, late)  \
  VARIANT_MR(NAME, FAM, SUFFIX, T, early)

using F10Mr = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
using S4Mr = tlfea::Family<16, 48, 0x1111u, 4>;
using B4Mr = tlfea::Family<8, 12, 0x11u, 4>;
VARIANTS_MR(feat10, F10Mr, f32, float)
VARIANTS_MR(feat10, F10Mr, f64, double)
VARIANT_MR(feat10, F10Mr, f32, float, stream)
VARIANT_MR(feat10, F10Mr, f64, double, stream)
VARIANTS_MR(ancf3443, S4Mr, f32, float)
VARIANTS_MR(ancf3443, S4Mr, f64, double)
VARIANT_MR(ancf3443, S4Mr, f32, float, stream)
VARIANTS_MR(ancf3243, B4Mr, f32, float)
VARIANTS_MR(ancf3243, B4Mr, f64, double)
VARIANT_MR(ancf3243, B4Mr, f32, float, stream)
VARIANT_MR(ancf3243, B4Mr, f64, double, stream)

// SVK's K1 and K5 (shipped loading the gradients where used) with them held
// in registers, late and early: whether holding them would help SVK too.
#define VARIANT_SVK(NAME, FAM, SUFFIX, T, HOLD)                                         \
  extern "C" int tlfea_primal_prep_##NAME##_##HOLD##_##SUFFIX(                          \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, void* prep, int E, double lam, double mu, double eta, \
      double lam_d, void* stream) {                                                     \
    return tlfea::launch_primal_prep<T, FAM, tlfea::Hold::HOLD>(                        \
        packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E,                                  \
        tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}, stream);                     \
  }                                                                                     \
  extern "C" int tlfea_contrib_##NAME##_##HOLD##_##SUFFIX(                              \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, int E, double lam, double mu, double eta, double lam_d, \
      void* stream) {                                                                   \
    return tlfea::launch_contrib<T, FAM, tlfea::Hold::HOLD>(                            \
        packed, conn_t, gN_t, dV_t, Me_t, fe, E,                                        \
        tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}, stream);                     \
  }

VARIANT_SVK(feat10, F10Mr, f32, float, late)
VARIANT_SVK(feat10, F10Mr, f32, float, early)
VARIANT_SVK(ancf3443, S4Mr, f32, float, late)
VARIANT_SVK(ancf3443, S4Mr, f32, float, early)

// An empty kernel on a grid of `blocks` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory: the floor of any launch of that
// shape.
__global__ void empty_kernel() {}

extern "C" int tlfea_empty_launch(int blocks, int threads, int smem, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The persistent kernel with one thread slab a block (the shipped
// instantiations, fem_resident*.cu, run RES_SLABS = 2): a block runs its
// virtual blocks one after another.
using Feat10R = tlfea::Family<10, 5, 0x3FFu, 5, 0>;
TLFEA_RESIDENT_ENTRY_POINTS_SLABS(feat10_s1, Feat10R, tlfea::SvkMat, f32, float, 1)
TLFEA_RESIDENT_ENTRY_POINTS_SLABS(feat10_mr_s1, Feat10R, tlfea::MrMat, f32, float, 1)
using Ancf3243R = tlfea::Family<8, 12, 0x11u, 4>;
TLFEA_RESIDENT_ENTRY_POINTS_SLABS(ancf3243_s1, Ancf3243R, tlfea::SvkMat, f32, float, 1)

// K4's walk in other forms, float32 (every form sums in CSR order, so all
// give the same bits). form 0: one incidence at a time, as a batch of one
// (the loop before batching compiled to a partly unrolled walk; this one
// does not unroll); 1-4: one thread per (node, channel), batches of 4, 8,
// 16, 32; 5-7: one thread per node and 3 channels (the shipped K4: 8 for
// FEAT10, 4 for ANCF), batches of 8, 16, 4. C a multiple of 3.
extern "C" int tlfea_node_reduce_form_f32(int form, const void* vals, const void* ptr,
                                          const void* inc, void* out, int n, int E, int C,
                                          void* stream) {
  using tlfea::launch_node_reduce_groups;
  switch (form) {
    case 0: return launch_node_reduce_groups<float, 1, 1>(vals, ptr, inc, out, n, E, C, stream);
    case 1: return launch_node_reduce_groups<float, 1, 4>(vals, ptr, inc, out, n, E, C, stream);
    case 2: return launch_node_reduce_groups<float, 1, 8>(vals, ptr, inc, out, n, E, C, stream);
    case 3: return launch_node_reduce_groups<float, 1, 16>(vals, ptr, inc, out, n, E, C, stream);
    case 4: return launch_node_reduce_groups<float, 1, 32>(vals, ptr, inc, out, n, E, C, stream);
    case 5: return launch_node_reduce_groups<float, 3, 8>(vals, ptr, inc, out, n, E, C, stream);
    case 6: return launch_node_reduce_groups<float, 3, 16>(vals, ptr, inc, out, n, E, C, stream);
    case 7: return launch_node_reduce_groups<float, 3, 4>(vals, ptr, inc, out, n, E, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Barrier probe: n barriers and nothing else. A grid barrier of a
// cooperative launch (cooperative_groups grid.sync(), through global
// memory), or a cluster barrier (barrier.cluster.arrive.release /
// wait.acquire) of a grid that is one cluster.
__global__ void grid_barrier_probe(int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

__global__ void cluster_barrier_probe(int n) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  for (int i = 0; i < n; ++i) cluster.sync();
}

// cluster 0: a cooperative launch of `blocks` blocks; else one cluster of
// `cluster` blocks. threads a block; n barriers.
extern "C" int tlfea_barrier_probe(int cluster, int blocks, int threads, int n, void* stream) {
  cudaError_t err;
  if (cluster == 0) {
    void* params[] = {(void*)&n};
    err = cudaLaunchCooperativeKernel((const void*)grid_barrier_probe, dim3(blocks),
                                      dim3(threads), params, 0, (cudaStream_t)stream);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        cluster_barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (attr != cudaSuccess) return (int)attr;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cluster_barrier_probe, n);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
