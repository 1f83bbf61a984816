// The whole inner Newton-PCG solve of one implicit step in one persistent
// cooperative kernel (Hopper, sm_90a), templated on the element family and
// on the material (`SvkMat`, svk.cuh; `MrMat`, mr.cuh), as K1 and K2 are.
//
// Replaces tlfea/ops/pallas_resident.py `_kernel` (:64; its `pallas_call` is
// at :373): for a mesh of at most 1,024 elements, without the coarse
// correction, it computes what tlfea_torch.solvers.newton._newton_inner
// computes with coarse=None:
//   - g(v) = node_sum(K1(u, v, (v - v_prev)/dt)) + pin_aff + pin_lin * u
//     - f_ext, with u = u_prev + dt * v formed in displacement space;
//   - ||g||, the convergence test (inner_atol, inner_rtol) and the
//     Eisenstat-Walker forcing (first iteration max(ew_eta_max, cg_rtol));
//   - PCG with block-Jacobi z = inv_blocks r, H p = node_sum(K2(p)) + dt *
//     pin_lin * p, the tol2 floor (1e-18 float, 1e-30 double) and the
//     denom > 0 guard;
//   - on non-positive curvature or a non-finite step, backtracking over
//     t = 1, 1/2, ... for ls_max trials, keeping the best t (which starts
//     at 0).
// The element work is the K1/K2 tile code and K4's node sum of
// fem_kernels.cuh, run in grid-stride loops; the JAX kernel takes the
// material's tile algebra the same way (`bnd.mops`, pallas_resident.py:326),
// and S and Q from the family (:300-302). Instantiations: FEAT10 x SVK and
// MR in fem_resident.cu, ANCF3243 x SVK and MR in fem_resident_ancf3243.cu.
// ANCF3443 has none: the JAX package builds no banded handle for it (the
// VMEM estimate of pallas_banded.build_banded refuses every 48-point shell
// block), so it never runs resident there either.
//
// Why one kernel: at 864 elements a CG iteration is a few microseconds of
// device work, but the composed path spends about thirty host operations
// and one host synchronisation on it (several hundred microseconds of host
// time). Here the host launches once per inner solve and reads one small
// stats tensor afterwards.
//
// Design:
//   - One cooperative launch (cudaLaunchCooperativeKernel); phases are
//     separated by cooperative_groups grid.sync(). The grid is the number
//     of co-resident blocks (occupancy times SMs), capped at the number of
//     element tiles; a launch that cannot be co-resident returns an error.
//   - Dots and norms are deterministic two-level reductions: each block
//     writes its partial sums to partials[buffer][blockIdx.x], and after the
//     barrier every thread adds the partials in block order. Every thread
//     then holds bitwise the same scalars, so every branch and loop test is
//     grid-uniform (a block that skipped a grid.sync() would deadlock the
//     grid). Consecutive reductions alternate between two buffers, so that
//     no block overwrites a slot another block is still reading. No float
//     atomics: float32 runs are bitwise repeatable.
//   - The control scalars (norms, tolerances, forcing, line-search t) are
//     doubles, as the Python loop's floats are; vector arithmetic is in T.
//   - State (packed node values, per-(element, slot) values, the prep
//     cache, the CG vectors) lives in one scratch buffer that the caller
//     allocates; the kernel allocates nothing.
//
// What bounds it: barriers and latency, not bytes. A CG iteration crosses
// four grid barriers (after K2, two reductions, after the p update) and
// walks dependent loads in K4's node sums; its inputs (about 1 MB at 864
// elements) stay in the 50 MB L2.
#pragma once

#include <cooperative_groups.h>

#include <cfloat>

#include "fem_kernels.cuh"

namespace tlfea {

constexpr int RES_NV = 3;     // values per reduction
constexpr int RES_STATS = 7;  // iters, cg_total, ||g||, grads, Hvs, barriers, grid; then history

template <typename T, class M>
struct ResidentArgs {
  const T *v0, *u_prev, *v_prev, *f_ext, *pin_aff, *pin_lin, *inv_blocks;
  const int* conn_t;
  const T *gN_t, *dV_t, *Me_t;
  const int *inc_ptr, *inc;
  T *packed, *fe, *prep, *g, *x, *r, *z, *p, *hp;  // scratch
  T* partials;                                      // (2, grid, RES_NV)
  T* v;                                             // (n, 3) out
  double* stats;                                    // (RES_STATS + max_inner + 1) out
  int n, E;
  M mat;  // the material's constants
  T dt;
  double inner_atol, inner_rtol, cg_rtol, ew_eta_max;
  int max_inner, cg_max, ls_max;
};

template <typename T>
__device__ __forceinline__ void block_jacobi(const T* inv, const T r[3], T z[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) z[i] = inv[i * 3] * r[0] + inv[i * 3 + 1] * r[1] + inv[i * 3 + 2] * r[2];
}

template <typename T, class F, class M>
__global__ void __launch_bounds__(EX * F::NG) newton_resident_kernel(ResidentArgs<T, M> a) {
  namespace cg = cooperative_groups;
  constexpr int NT = EX * F::NG, NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ T wsum[NW * RES_NV];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * EX + threadIdx.x;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  const int n = a.n, E = a.E, n3 = 3 * n, n_tiles = (E + EX - 1) / EX;
  const T dt = a.dt;
  int parity = 0;
  long long barriers = 0, n_grad = 0, n_hv = 0;

  auto sync = [&]() {
    grid.sync();
    ++barriers;
  };

  // Sum val[0..nv) over every thread of the grid: warp shuffles, the warps
  // of a block in order, then the blocks in order. The result lands in val
  // on every thread, bitwise the same.
  auto reduce = [&](T* val, int nv) {
    for (int j = 0; j < nv; ++j) {
      T s = val[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if ((tid & 31) == 0) wsum[(tid >> 5) * RES_NV + j] = s;
    }
    __syncthreads();
    T* slot = a.partials + (size_t)parity * gridDim.x * RES_NV;
    if (tid < nv) {
      T s = T(0);
      for (int w = 0; w < NW; ++w) s += wsum[w * RES_NV + tid];
      slot[blockIdx.x * RES_NV + tid] = s;
    }
    sync();
    for (int j = 0; j < nv; ++j) {
      T s = T(0);
      for (int b = 0; b < (int)gridDim.x; ++b) s += slot[b * RES_NV + j];
      val[j] = s;
    }
    parity ^= 1;
  };

  // g at v' and its norm, with the prep cache of v'. kind 0: v' = v0; kind
  // 1: v' = v + s x, which becomes v; kind 2: v' = v + s x, a trial point,
  // v unchanged.
  auto gradient = [&](int kind, T s) -> double {
    for (int t = gtid; t < n3; t += gstride) {
      const int nd = t / 3, c = t - 3 * nd;
      const T vt = kind == 0 ? a.v0[t] : a.v[t] + s * a.x[t];
      if (kind != 2) a.v[t] = vt;
      T* pk = a.packed + (size_t)nd * 9;
      pk[c] = a.u_prev[t] + dt * vt;
      pk[3 + c] = vt;
      pk[6 + c] = (vt - a.v_prev[t]) / dt;
    }
    sync();
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      primal_prep_tile<T, F>(a.packed, a.conn_t, a.gN_t, a.dV_t, a.Me_t, a.fe, a.prep, E,
                             tile * EX, a.mat, smem);
      __syncthreads();
    }
    sync();
    T acc[1] = {T(0)};
    for (int t = gtid; t < n3; t += gstride) {
      const int nd = t / 3, c = t - 3 * nd;
      const T u = a.packed[(size_t)nd * 9 + c];
      const T gv = node_sum(a.fe, a.inc_ptr, a.inc, nd, c, E, 3) + a.pin_aff[t] +
                   a.pin_lin[nd] * u - a.f_ext[t];
      a.g[t] = gv;
      acc[0] += gv * gv;
    }
    reduce(acc, 1);
    ++n_grad;
    return (double)sqrt(acc[0]);
  };

  // hp = H p from the current prep cache; returns p . hp.
  auto hessian_p = [&]() -> T {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      hv_tile<T, F>(a.p, a.conn_t, a.prep, a.gN_t, a.dV_t, a.Me_t, a.fe, E, tile * EX, dt,
                    a.mat, smem);
      __syncthreads();
    }
    sync();
    T acc[1] = {T(0)};
    for (int t = gtid; t < n3; t += gstride) {
      const int nd = t / 3, c = t - 3 * nd;
      const T h = node_sum(a.fe, a.inc_ptr, a.inc, nd, c, E, 3) + (dt * a.pin_lin[nd]) * a.p[t];
      a.hp[t] = h;
      acc[0] += a.p[t] * h;
    }
    reduce(acc, 1);
    ++n_hv;
    return acc[0];
  };

  // PCG for H x = -g (newton._pcg). Returns the iteration count; neg is set
  // on non-positive curvature, xx = x . x.
  auto pcg = [&](double eta, double bnorm, bool& neg, T& xx) -> int {
    T acc[RES_NV] = {T(0), T(0), T(0)};
    for (int nd = gtid; nd < n; nd += gstride) {
      T r[3], z[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        r[i] = -a.g[nd * 3 + i];
        a.r[nd * 3 + i] = r[i];
        a.x[nd * 3 + i] = T(0);
      }
      block_jacobi(a.inv_blocks + (size_t)nd * 9, r, z);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a.z[nd * 3 + i] = z[i];
        a.p[nd * 3 + i] = z[i];
        acc[0] += r[i] * z[i];
        acc[1] += r[i] * r[i];
      }
    }
    reduce(acc, 2);
    T rz = acc[0], rr = acc[1];
    xx = T(0);
    neg = false;
    const double eps_floor = sizeof(T) == 8 ? 1e-30 : 1e-18;
    const double tol = eta * bnorm, b1 = fmax(bnorm, 1.0);
    const double tol2 = fmax(tol * tol, eps_floor * (b1 * b1));
    int k = 0;
    while (k < a.cg_max && (double)rr > tol2 && (double)rz > 0.0) {
      const T denom = hessian_p();
      const bool good = denom > T(0);
      const T alpha = good ? rz / denom : T(0);
      T s3[RES_NV] = {T(0), T(0), T(0)};
      for (int nd = gtid; nd < n; nd += gstride) {
        T r[3], z[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int t = nd * 3 + i;
          const T xv = a.x[t] + alpha * a.p[t];
          a.x[t] = xv;
          r[i] = a.r[t] - alpha * a.hp[t];
          a.r[t] = r[i];
          s3[2] += xv * xv;
        }
        block_jacobi(a.inv_blocks + (size_t)nd * 9, r, z);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a.z[nd * 3 + i] = z[i];
          s3[0] += r[i] * z[i];
          s3[1] += r[i] * r[i];
        }
      }
      reduce(s3, 3);
      const T rz_new = good ? s3[0] : T(0);
      neg = neg || !good;
      ++k;
      xx = s3[2];
      rr = s3[1];
      const bool more = k < a.cg_max && (double)rr > tol2 && (double)rz_new > 0.0;
      if (more) {  // the next direction; not needed when the loop ends
        const T beta = rz_new / rz;
        for (int t = gtid; t < n3; t += gstride) a.p[t] = a.z[t] + beta * a.p[t];
        sync();
      }
      rz = rz_new;
    }
    return k;
  };

  const double tiny = sizeof(T) == 8 ? DBL_MIN : (double)FLT_MIN;
  const double emax = fmax(a.ew_eta_max, a.cg_rtol);
  const bool writer = blockIdx.x == 0 && tid == 0;
  double ng = HUGE_VAL, ng0 = HUGE_VAL, ngp = HUGE_VAL;
  int k = 0, mode = 0;  // mode: the update of v that the next gradient applies first
  long long cg_total = 0;
  T step = T(0);
  while (k < a.max_inner) {
    ng = gradient(mode, step);
    mode = -1;  // applied
    if (k == 0) ng0 = ng;
    if (writer) a.stats[RES_STATS + k] = ng;
    const bool conv = ng < a.inner_atol || (a.inner_rtol > 0.0 && ng <= a.inner_rtol * ng0);
    if (conv) break;
    double eta = emax;
    if (k > 0) {
      const double ratio = ng / fmax(ngp, tiny);
      eta = fmin(fmax(0.9 * ratio * ratio, a.cg_rtol), emax);
    }
    bool neg;
    T xx;
    cg_total += pcg(eta, ng, neg, xx);
    step = T(1);
    if (a.ls_max > 0 && (neg || !isfinite(sqrt(xx)))) {
      double t = 1.0, best_t = 0.0, best_gn = ng;
      for (int j = 0; j < a.ls_max; ++j) {
        const double gn = gradient(2, (T)t);
        if (gn < best_gn) {  // false for NaN: the best stays as it is
          best_t = t;
          best_gn = gn;
        }
        if (gn <= (1.0 - 1e-4 * t) * ng) break;
        t *= 0.5;
      }
      step = (T)best_t;
    }
    mode = 1;
    ngp = ng;
    ++k;
  }
  if (mode >= 0) {  // an update of v that no gradient applied yet
    for (int t = gtid; t < n3; t += gstride) a.v[t] = mode == 0 ? a.v0[t] : a.v[t] + step * a.x[t];
  }
  if (writer) {
    const double st[RES_STATS] = {(double)k, (double)cg_total, ng, (double)n_grad,
                                  (double)n_hv, (double)barriers, (double)gridDim.x};
    for (int i = 0; i < RES_STATS; ++i) a.stats[i] = st[i];
  }
}

namespace {

template <typename T, class F, class M>
int launch_newton_resident(const ResidentArgs<T, M>& args, void* stream) {
  constexpr size_t smem = smem_bytes<T, F, 9, 3>();
  static_assert(smem_bytes<T, F, 9, 3>() >= smem_bytes<T, F, 3, 3>(), "K1's tile is the larger");
  static const cudaError_t attr = allow_smem(newton_resident_kernel<T, F, M>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (args.E <= 0 || args.n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_resident_kernel<T, F, M>,
                                                        EX * F::NG, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms < n_tiles(args.E) ? per_sm * sms : n_tiles(args.E);
  ResidentArgs<T, M> a = args;
  void* params[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)newton_resident_kernel<T, F, M>, dim3(grid),
                                    dim3(EX, F::NG), params, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace tlfea

// Plain C interface of one (family, material)'s resident kernel, bound with
// ctypes (tlfea_torch/ops/resident.py): tlfea_newton_resident_<NAME>_<SUFFIX>,
// NAME the kernels' tag (the family, with "_mr" for Mooney-Rivlin). MAT is
// the material template (tlfea::SvkMat or tlfea::MrMat); mat points to its
// constants as doubles (MAT<T>::from). scratch holds 9 n + S 3 E + Q PR E +
// 6 * 3 n words of T (packed, fe, prep with the material's PR rows, then g,
// x, r, z, p, hp), partials 2 * ceil(E / 32) * 3 words, stats 7 + max_inner
// + 1 doubles (the history slots NaN on entry).
#define TLFEA_RESIDENT_ENTRY_POINTS(NAME, FAM, MAT, SUFFIX, T)                                \
  extern "C" int tlfea_newton_resident_##NAME##_##SUFFIX(                                     \
      const void* v0, const void* u_prev, const void* v_prev, const void* f_ext,              \
      const void* pin_aff, const void* pin_lin, const void* inv_blocks, const void* conn_t,   \
      const void* gN_t, const void* dV_t, const void* Me_t, const void* inc_ptr,              \
      const void* inc, void* scratch, void* partials, void* v, void* stats, int n, int E,     \
      const double* mat, double dt, double inner_atol, double inner_rtol, double cg_rtol,     \
      double ew_eta_max, int max_inner, int cg_max, int ls_max, void* stream) {               \
    tlfea::ResidentArgs<T, MAT<T>> a;                                                         \
    a.v0 = (const T*)v0;                                                                      \
    a.u_prev = (const T*)u_prev;                                                              \
    a.v_prev = (const T*)v_prev;                                                              \
    a.f_ext = (const T*)f_ext;                                                                \
    a.pin_aff = (const T*)pin_aff;                                                            \
    a.pin_lin = (const T*)pin_lin;                                                            \
    a.inv_blocks = (const T*)inv_blocks;                                                      \
    a.conn_t = (const int*)conn_t;                                                            \
    a.gN_t = (const T*)gN_t;                                                                  \
    a.dV_t = (const T*)dV_t;                                                                  \
    a.Me_t = (const T*)Me_t;                                                                  \
    a.inc_ptr = (const int*)inc_ptr;                                                          \
    a.inc = (const int*)inc;                                                                  \
    T* w = (T*)scratch;                                                                       \
    a.packed = w;                                                                             \
    w += 9LL * n;                                                                             \
    a.fe = w;                                                                                 \
    w += (long long)FAM::S * 3 * E;                                                           \
    a.prep = w;                                                                               \
    w += (long long)FAM::Q * MAT<T>::PR * E;                                                  \
    T** vecs[6] = {&a.g, &a.x, &a.r, &a.z, &a.p, &a.hp};                                      \
    for (int i = 0; i < 6; ++i) {                                                             \
      *vecs[i] = w;                                                                           \
      w += 3LL * n;                                                                           \
    }                                                                                         \
    a.partials = (T*)partials;                                                                \
    a.v = (T*)v;                                                                              \
    a.stats = (double*)stats;                                                                 \
    a.n = n;                                                                                  \
    a.E = E;                                                                                  \
    a.mat = MAT<T>::from(mat);                                                                \
    a.dt = (T)dt;                                                                             \
    a.inner_atol = inner_atol;                                                                \
    a.inner_rtol = inner_rtol;                                                                \
    a.cg_rtol = cg_rtol;                                                                      \
    a.ew_eta_max = ew_eta_max;                                                                \
    a.max_inner = max_inner;                                                                  \
    a.cg_max = cg_max;                                                                        \
    a.ls_max = ls_max;                                                                        \
    return tlfea::launch_newton_resident<T, FAM, MAT<T>>(a, stream);                          \
  }
