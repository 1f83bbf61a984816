// Phase ablation of the FEAT10 Hessian-vector product (K2 `hv` + K4
// `node_reduce`), float32, SVK: the port of benchmarks/ablate_banded_hv.py,
// whose pallas_call variants (`make_min_fn` :89, call :121; `make_fn` /
// `make_body` :194 / :130, call :221) share one grid and one block spec so
// that their times differ only by the phase each runs. Here the variants of
// K2's phases run at K2's launch shape (grid ceil(E / 32), block 32 x NG,
// K2's dynamic shared memory), and the scatter at K4's:
//
//   mode 0 dma_win     each block reads its contiguous slab of p (the 3n
//                      words split over the grid)                -> (1, G)
//   mode 1 dma_wininv  the same, plus the block's slabs of K4's CSR list
//                      (inc_ptr, inc): the TPU kernel's window + `inv`
//                                                                -> (3, G)
//   mode 2 dma         every table K2 reads (conn_t, prep, gN_t, dV_t,
//                      Me_t), each word once, in K2's coalesced element-minor
//                      order, per element: the bytes without the gather
//                      through conn                              -> (5, E)
//   mode 3 gather      K2's stage of p through conn_t into shared memory,
//                      then the element's S*3 staged values      -> (1, E)
//   mode 4 gfe         K2's tile (`hv_tile`) unchanged: gather + element
//                      algebra, writing (S*3, E); bitwise K2's output
//   mode 5 scat        K4's node sums (`node_reduce_kernel`) of an (S*3, E)
//                      buffer at K4's launch shape; bitwise K4's output
//   mode 6 full        gfe then scat, two launches: the production pair
//                      (K2 and K4 stay apart, no atomics), bitwise K2 + K4
//
// The touch variants (modes 0-3) write one row per table they read: the sum
// of the table's raw 32-bit words as unsigned integers, mod 2^32, over the
// block's slab or the element's words. Integer addition is exact in any
// order, so each row equals its plain twin's bit for bit, and a table that
// a kernel skipped, wholly or in part, changes its own row (a float sum of
// all tables held to a relative tolerance could not see the small tables
// beside the large integer ones). The sums also keep every load alive.
//
// What bounds them: bytes. At the bench.py "100k" box (101,376 elements)
// K2's tables are about 176 MB in float32, three times the 50 MB L2, so
// every variant that reads them streams them from HBM; dma is that floor,
// gather the dependent loads through conn, gfe adds the algebra, scat is
// K4's latency-bound walk of the CSR list.

#include "fem_kernels.cuh"

namespace tlfea {
namespace {

using Feat10Phases = Family<10, 5, 0x3FFu, 5, 0>;  // fem_kernels.cu's FEAT10, exactly

// A table's raw 32-bit words.
template <typename W>
__device__ __forceinline__ const unsigned* words(const W* t) {
  static_assert(sizeof(W) == 4, "the touch variants read 32-bit words");
  return reinterpret_cast<const unsigned*>(t);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's slab [lo, hi) of `count` words split evenly over the grid.
__device__ __forceinline__ void slab(long long count, long long* lo, long long* hi) {
  const long long per = (count + gridDim.x - 1) / gridDim.x;
  const long long a = (long long)blockIdx.x * per, b = a + per;
  *lo = a < count ? a : count;
  *hi = b < count ? b : count;
}

template <typename T, class F, class M, int MODE>
__global__ void __launch_bounds__(EX * F::NG)
hv_phase_kernel(const T* __restrict__ p, const int* __restrict__ conn_t,
                const T* __restrict__ prep, const T* __restrict__ gN_t,
                const T* __restrict__ dV_t, const T* __restrict__ Me_t,
                const int* __restrict__ inc_ptr, const int* __restrict__ inc,
                T* __restrict__ out, int n, int E, T dt, M m) {
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = EX * NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int x = threadIdx.x, g = threadIdx.y, tid = g * EX + x;
  const int e0 = blockIdx.x * EX, e = e0 + x;
  const size_t sE = (size_t)E;

  [[maybe_unused]] unsigned* wout = reinterpret_cast<unsigned*>(out);  // modes 0-3
  if constexpr (MODE == 0 || MODE == 1) {
    constexpr int R = MODE == 0 ? 1 : 3;  // rows: p (, inc_ptr, inc)
    unsigned acc[R] = {};
    long long lo, hi;
    slab(3LL * n, &lo, &hi);
    for (long long i = lo + tid; i < hi; i += NT) acc[0] += words(p)[i];
    if constexpr (MODE == 1) {
      slab((long long)n + 1, &lo, &hi);
      for (long long i = lo + tid; i < hi; i += NT) acc[1] += words(inc_ptr)[i];
      slab((long long)S * E, &lo, &hi);
      for (long long i = lo + tid; i < hi; i += NT) acc[2] += words(inc)[i];
    }
    unsigned* red = reinterpret_cast<unsigned*>(smem);  // (R,)
    if (tid < R) red[tid] = 0u;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned v = warp_sum(acc[r]);
      if ((tid & 31) == 0) atomicAdd(&red[r], v);
    }
    __syncthreads();
    if (tid < R) wout[(size_t)tid * gridDim.x + blockIdx.x] = red[tid];
  } else if constexpr (MODE == 2) {
    unsigned acc[5] = {};  // rows: conn_t, prep, gN_t, dV_t, Me_t
    if (e < E) {
      for (int r = g; r < S; r += NG) acc[0] += words(conn_t)[r * sE + e];
      for (int r = g; r < Q * M::PR; r += NG) acc[1] += words(prep)[r * sE + e];
      for (int r = g; r < Q * S * 3; r += NG) acc[2] += words(gN_t)[r * sE + e];
      for (int r = g; r < Q; r += NG) acc[3] += words(dV_t)[r * sE + e];
      for (int r = g; r < S * S; r += NG) acc[4] += words(Me_t)[r * sE + e];
    }
    unsigned* part = reinterpret_cast<unsigned*>(smem);  // (5, EX)
    if (g == 0)
      for (int k = 0; k < 5; ++k) part[k * EX + x] = 0u;
    __syncthreads();
    for (int k = 0; k < 5; ++k) atomicAdd(&part[k * EX + x], acc[k]);
    __syncthreads();
    if (g == 0 && e < E)
      for (int k = 0; k < 5; ++k) wout[k * sE + e] = part[k * EX + x];
  } else if constexpr (MODE == 3) {
    T* xs = smem;  // (S*3, EX): raw direction, as K2 stages it
    stage<T, F, 3, 0>(p, conn_t, E, e0, xs);
    __syncthreads();
    if (g == 0 && e < E) {
      unsigned s = 0u;
      for (int r = 0; r < S * 3; ++r) s += words(xs)[r * EX + x];
      wout[e] = s;
    }
  } else {
    hv_tile<T, F, M>(p, conn_t, prep, gN_t, dV_t, Me_t, out, E, e0, dt, m, smem);
  }
}

template <int MODE>
int launch_phase(const void* p, const void* conn_t, const void* prep, const void* gN_t,
                 const void* dV_t, const void* Me_t, const void* inc_ptr, const void* inc,
                 void* out, int n, int E, float dt, const SvkMat<float>& m, void* stream) {
  using F = Feat10Phases;
  constexpr size_t smem = smem_bytes<float, F, 3, 3>();  // K2's
  auto kernel = hv_phase_kernel<float, F, SvkMat<float>, MODE>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    kernel<<<n_tiles(E), dim3(EX, F::NG), smem, (cudaStream_t)stream>>>(
        (const float*)p, (const int*)conn_t, (const float*)prep, (const float*)gN_t,
        (const float*)dV_t, (const float*)Me_t, (const int*)inc_ptr, (const int*)inc,
        (float*)out, n, E, dt, m);
  }
  return (int)cudaGetLastError();
}

template <int MODE>
int occupancy_phase(int* out) {
  using F = Feat10Phases;
  return occupancy(hv_phase_kernel<float, F, SvkMat<float>, MODE>, EX * F::NG,
                   smem_bytes<float, F, 3, 3>(), out, EX);
}

}  // namespace
}  // namespace tlfea

// One entry point for the seven variants, bound with ctypes
// (tlfea_torch/ops/hv_phases.py). mode 0-3 write their int32 rows into
// `out`, mode 4 (S*3, E) values (see the table above); mode 5 sums `fes` (S*3, E)
// onto the nodes into `out` (n, 3); mode 6 writes K2's values into `fes`,
// then their node sums into `out`.
extern "C" int tlfea_hv_phase_f32(int mode, const void* p, const void* conn_t,
                                  const void* prep, const void* gN_t, const void* dV_t,
                                  const void* Me_t, const void* inc_ptr, const void* inc,
                                  void* fes, void* out, int n, int E, double dt, double lam,
                                  double mu, double eta, double lam_d, void* stream) {
  using namespace tlfea;
  const SvkMat<float> m{(float)lam, (float)mu, (float)eta, (float)lam_d};
  const float dtf = (float)dt;
  switch (mode) {
    case 0:
      return launch_phase<0>(p, conn_t, prep, gN_t, dV_t, Me_t, inc_ptr, inc, out, n, E, dtf,
                             m, stream);
    case 1:
      return launch_phase<1>(p, conn_t, prep, gN_t, dV_t, Me_t, inc_ptr, inc, out, n, E, dtf,
                             m, stream);
    case 2:
      return launch_phase<2>(p, conn_t, prep, gN_t, dV_t, Me_t, inc_ptr, inc, out, n, E, dtf,
                             m, stream);
    case 3:
      return launch_phase<3>(p, conn_t, prep, gN_t, dV_t, Me_t, inc_ptr, inc, out, n, E, dtf,
                             m, stream);
    case 4:
      return launch_phase<4>(p, conn_t, prep, gN_t, dV_t, Me_t, inc_ptr, inc, out, n, E, dtf,
                             m, stream);
    case 5:
      return launch_node_reduce<float>(fes, inc_ptr, inc, out, n, E, 3, stream);
    case 6: {
      const int err = launch_phase<4>(p, conn_t, prep, gN_t, dV_t, Me_t, inc_ptr, inc, fes, n,
                                      E, dtf, m, stream);
      if (err != 0) return err;
      return launch_node_reduce<float>(fes, inc_ptr, inc, out, n, E, 3, stream);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// occupancy() (fem_kernels.cuh) of mode's kernel at its launch shape: modes
// 0-4 the phase kernel, 5 K4, 6 its first launch (mode 4's kernel).
extern "C" int tlfea_hv_phase_occupancy_f32(int mode, int* out) {
  using namespace tlfea;
  switch (mode) {
    case 0: return occupancy_phase<0>(out);
    case 1: return occupancy_phase<1>(out);
    case 2: return occupancy_phase<2>(out);
    case 3: return occupancy_phase<3>(out);
    case 4: case 6: return occupancy_phase<4>(out);
    case 5: return occupancy_node_reduce<float>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
