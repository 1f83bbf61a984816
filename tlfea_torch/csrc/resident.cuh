// The whole inner Newton-PCG solve of one implicit step in one persistent
// kernel that runs as one thread-block cluster (Hopper, sm_90a), templated
// on the element family and on the material (`SvkMat`, svk.cuh; `MrMat`,
// mr.cuh), as K1 and K2 are.
//
// Replaces tlfea/ops/pallas_resident.py `_kernel` (:64; its `pallas_call` is
// at :373): for a mesh of at most 1,024 elements, without the coarse
// correction, it computes what tlfea_torch.solvers.newton._newton_inner
// computes with coarse=None:
//   - g(v) = node_sums(K1(u, v, (v - v_prev)/dt)) + pin_aff + pin_lin * u
//     - f_ext, with u = u_prev + dt * v formed in displacement space;
//   - ||g||, the convergence test (inner_atol, inner_rtol) and the
//     Eisenstat-Walker forcing (first iteration max(ew_eta_max, cg_rtol));
//   - PCG with block-Jacobi z = inv_blocks r, H p = node_sums(K2(p)) + dt *
//     pin_lin * p, the tol2 floor (1e-18 float, 1e-30 double) and the
//     denom > 0 guard;
//   - on non-positive curvature or a non-finite step, backtracking over
//     t = 1, 1/2, ... for ls_max trials, keeping the best t (which starts
//     at 0).
// The element work is the K1/K2 tile code and K4's node sum of
// fem_kernels.cuh; the JAX kernel takes the material's tile algebra the same
// way (`bnd.mops`, pallas_resident.py:326), and S and Q from the family
// (:300-302). Instantiations: FEAT10 x SVK and MR in fem_resident.cu,
// ANCF3243 x SVK and MR in fem_resident_ancf3243.cu. ANCF3443 has none: the
// JAX package builds no banded handle for it (the VMEM estimate of
// pallas_banded.build_banded refuses every 48-point shell block), so it
// never runs resident there either.
//
// Why one kernel: at 864 elements a CG iteration is a few microseconds of
// device work, but the composed path spends about thirty host operations
// and one host synchronisation on it (several hundred microseconds of host
// time). Here the host launches once per inner solve and reads one small
// stats tensor afterwards.
//
// What bounds it: latency, not bytes or operations. Its working set (about
// 1 MB at 864 elements) stays in the 50 MB L2, and its operations take
// 1.6 us of an H100 at the 1k box; one launch there took 383 us as a
// cooperative grid. A CG iteration crosses four barriers (after K2, two
// reductions, after the p update), runs one K2 tile pass and walks K4's
// dependent loads once; a gradient the same with K1. On the same card a
// grid barrier of a cooperative launch of 27 blocks costs 1.09 us and a
// cluster barrier 0.42 us in a cluster of 8 blocks, 0.46 us in one of 16
// (`tools/kernel_variants barriers`, PERF.md): the 97 grid barriers of a
// 1k solve took 106 us of its 383, 97 cluster barriers take 44 us.
//
// Design:
//   - The grid is one cluster of C blocks (cudaLaunchKernelEx with the
//     cluster-dimension attribute; C = 16 needs the non-portable size, and
//     the host takes 8 where the card cannot schedule 16). Phases are
//     separated by cluster barriers (barrier.cluster.arrive.release /
//     wait.acquire), which order every global-memory write of a phase for
//     every block of the cluster. The gate keeps E <= 1,024, so the element
//     tiles (EX = 32 elements each) are at most 32.
//   - Virtual blocks keep the bits of the cooperative grid this kernel
//     replaced, whose grid was always one block per tile. Virtual block b <
//     n_tiles runs tile b, takes the node loops' indices b NT + tid + j
//     n_tiles NT, and forms its own warp-ordered partial of each dot
//     product; the partials are summed over b in order. Block r of the
//     cluster runs the virtual blocks r, r + C, ... (`rounds` of them), on
//     SLABS thread slabs (threadIdx.z) side by side. So every element
//     output, node sum, dot product and control scalar is the same for any
//     C and SLABS.
//   - Dots and norms: each block stores its virtual blocks' partials into
//     the shared memory of every block of the cluster (distributed shared
//     memory, `map_shared_rank`) before the barrier; after it every thread
//     adds the n_tiles partials from its own block's shared memory in order
//     b = 0, 1, ... Every thread then holds bitwise the same
//     scalars, so every branch and loop test is uniform over the cluster (a
//     block that skipped a barrier would deadlock it). Consecutive
//     reductions alternate between two partial buffers: a block writes
//     reduction k + 2's partials only after the barrier of reduction k + 1,
//     which every reader of reduction k has passed. No float atomics:
//     float32 runs are bitwise repeatable. The kernel ends with a cluster
//     barrier that is not counted in the stats, so that no block exits
//     while another may still store into its shared memory.
//   - The control scalars (norms, tolerances, forcing, line-search t) are
//     doubles, as the Python loop's floats are; vector arithmetic is in T.
//   - K4's walk: the incidence list is static, so every block stages it in
//     shared memory once (row starts and each incidence's value offset,
//     the division by E done once); a walk then costs one global round
//     trip a batch of 16 incidences instead of three dependent ones
//     (ptr, inc, then the value). Same adds, same order.
//   - State (packed node values, per-(element, slot) values, the prep
//     cache, the CG vectors) lives in one scratch buffer that the caller
//     allocates; the kernel allocates nothing. Shared memory holds SLABS
//     tile stagings, the warp sums, the partials and the incidence list
//     (`resident_smem_bytes`, mirrored by tlfea_torch/ops/resident.plan).
#pragma once

#include <cooperative_groups.h>

#include <cfloat>

#include "fem_kernels.cuh"

namespace tlfea {

constexpr int RES_NV = 3;     // values per reduction
constexpr int RES_STATS = 7;  // iters, cg_total, ||g||, grads, Hvs, barriers, grid; then history
constexpr int RES_MAX_TILES = 32;    // the gate's 1,024 elements: a partial slot each
constexpr int RES_MAX_CLUSTER = 16;  // the non-portable cluster size of an H100
constexpr int RES_SLABS = 2;         // thread slabs a block (threadIdx.z)
// K4's walk inside the kernel: a thread per (node, channel), as the node
// loops that sum its squares need, over the incidence list staged in shared
// memory, in batches of 16 incidences: the longest walk (24) takes two
// batches of one global round trip each.
constexpr int RES_K4_BATCH = 16;

template <typename T, class M>
struct ResidentArgs {
  const T *v0, *u_prev, *v_prev, *f_ext, *pin_aff, *pin_lin, *inv_blocks;
  const int* conn_t;
  const T *gN_t, *dV_t, *Me_t;
  const int *inc_ptr, *inc;
  T *packed, *fe, *prep, *g, *x, *r, *z, *p, *hp;  // scratch
  T* v;                                             // (n, 3) out
  double* stats;                                    // (RES_STATS + max_inner + 1) out
  int n, E;
  M mat;  // the material's constants
  T dt;
  double inner_atol, inner_rtol, cg_rtol, ew_eta_max;
  int max_inner, cg_max, ls_max;
};

// Dynamic shared memory of one block that runs `rounds` virtual blocks at E
// elements: SLABS tile stagings (K1's, the larger), the warp sums (rounds,
// NW, RES_NV) and the two buffers of every virtual block's partials (2,
// RES_MAX_TILES, RES_NV), in words of T; then K4's incidence list, S E + 1
// row starts (room for n + 1, n <= S E) and S E value offsets, int32.
template <typename T, class F, int SLABS>
constexpr size_t resident_smem_bytes(int rounds, int E) {
  return SLABS * smem_bytes<T, F, 9, 3>() +
         ((size_t)rounds * F::NG + 2 * RES_MAX_TILES) * RES_NV * sizeof(T) +
         (2 * (size_t)F::S * E + 1) * sizeof(int);
}

// K4's ordered walk over the incidence list staged in shared memory: ptr
// the row starts, off[k] = a 3 E + e for incidence k = (a, e), so that
// channel c's value is vals[off[k] + c E]. The adds run in CSR order from
// T(0), as node_sums' do; the NB value loads of a batch are in flight
// together, and the offsets cost no global round trip.
template <typename T, int NB>
__device__ __forceinline__ T node_sum_staged(const T* vals, const int* ptr, const int* off,
                                             int nd, int c, int E) {
  T acc = T(0);
  const T* vc = vals + (size_t)c * E;
  const int k1 = ptr[nd + 1];
  for (int k0 = ptr[nd]; k0 < k1; k0 += NB) {
    T v[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = k0 + j < k1 ? vc[off[k0 + j]] : T(0);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (k0 + j < k1) acc += v[j];
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void block_jacobi(const T* inv, const T r[3], T z[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) z[i] = inv[i * 3] * r[0] + inv[i * 3 + 1] * r[1] + inv[i * 3 + 2] * r[2];
}

template <typename T, class F, class M, int SLABS>
__global__ void __launch_bounds__(EX * F::NG * SLABS, 1)
    newton_resident_kernel(ResidentArgs<T, M> a) {
  namespace cg = cooperative_groups;
  constexpr int NT = EX * F::NG, NW = NT / 32;
  constexpr int TILE_WORDS = (F::S * 9 + F::NG * F::S * 3) * EX;  // smem_bytes<T, F, 9, 3>()
  extern __shared__ __align__(16) unsigned char smem_raw[];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;  // the grid is the cluster
  const int tid = threadIdx.y * EX + threadIdx.x, lane = tid & 31, slab = threadIdx.z;
  const int n = a.n, E = a.E, n3 = 3 * n, n_tiles = (E + EX - 1) / EX;
  const int rounds = (n_tiles + C - 1) / C, vstride = n_tiles * NT;
  T* tile_smem = reinterpret_cast<T*>(smem_raw) + slab * TILE_WORDS;
  T* wsum = reinterpret_cast<T*>(smem_raw) + SLABS * TILE_WORDS;  // (rounds, NW, RES_NV)
  T* part = wsum + rounds * NW * RES_NV;                 // (2, RES_MAX_TILES, RES_NV)
  int* csr_ptr = reinterpret_cast<int*>(part + 2 * RES_MAX_TILES * RES_NV);  // (S E + 1)
  int* csr_off = csr_ptr + F::S * E + 1;                                     // (S E)
  const T dt = a.dt;
  int parity = 0;
  long long barriers = 0, n_grad = 0, n_hv = 0;

  auto sync = [&]() {
    cluster.sync();
    ++barriers;
  };

  // K4's incidence list into shared memory, once: the row starts, and each
  // incidence's value offset a 3 E + e (K4 values have 3 channels here).
  for (int i = slab * NT + tid; i <= n; i += SLABS * NT) csr_ptr[i] = a.inc_ptr[i];
  for (int k = slab * NT + tid; k < F::S * E; k += SLABS * NT) {
    const int i = a.inc[k], slot = i / E;
    csr_off[k] = slot * 3 * E + (i - slot * E);
  }
  __syncthreads();

  // body(m, vb) for each virtual block vb = rank + C m of this slab.
  auto each_vblock = [&](auto&& body) {
    for (int m = slab; m < rounds; m += SLABS) {
      const int vb = rank + C * m;
      if (vb < n_tiles) body(m, vb);
    }
  };

  // Element tiles: every slab takes the same number of turns (a virtual
  // block past the last tile has no elements), so the tile code's
  // __syncthreads() are met by every thread of the block.
  auto each_tile = [&](auto&& fn) {
    for (int m = slab; m < rounds + slab; m += SLABS) {
      fn((rank + C * m) * EX);
      __syncthreads();
    }
  };

  // Warp sums of val[0..nv) of virtual block m (local index), lane order.
  auto warp_sums = [&](int m, const T* val, int nv) {
#pragma unroll
    for (int j = 0; j < RES_NV; ++j) {
      if (j >= nv) break;
      T s = val[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) wsum[(m * NW + (tid >> 5)) * RES_NV + j] = s;
    }
  };

  // Sum val[0..nv) over every thread of every virtual block, after
  // warp_sums of each: the warps of a virtual block in order, then the
  // virtual blocks in order. Each virtual block's partial is stored into
  // every block of the cluster (distributed shared memory) before the
  // barrier, whose release orders those stores; after it every thread adds
  // the n_tiles partials from its own block's shared memory in order b = 0,
  // 1, ... The result lands in val on every thread, bitwise the same.
  auto reduce = [&](T* val, int nv) {
    __syncthreads();
    T* slot = part + parity * RES_MAX_TILES * RES_NV;
    each_vblock([&](int m, int vb) {
      for (int i = tid; i < nv * C; i += NT) {  // (destination block, value)
        const int j = i % nv, dst = i / nv;
        T s = T(0);
        for (int w = 0; w < NW; ++w) s += wsum[(m * NW + w) * RES_NV + j];
        *cluster.map_shared_rank(slot + vb * RES_NV + j, dst) = s;
      }
    });
    sync();
#pragma unroll
    for (int j = 0; j < RES_NV; ++j) {
      if (j >= nv) break;
      T s = T(0);
#pragma unroll
      for (int b = 0; b < RES_MAX_TILES; ++b)
        if (b < n_tiles) s += slot[b * RES_NV + j];
      val[j] = s;
    }
    parity ^= 1;
  };

  // g at v' and its norm, with the prep cache of v'. kind 0: v' = v0; kind
  // 1: v' = v + s x, which becomes v; kind 2: v' = v + s x, a trial point,
  // v unchanged.
  auto gradient = [&](int kind, T s) -> double {
    each_vblock([&](int, int vb) {
      for (int t = vb * NT + tid; t < n3; t += vstride) {
        const int nd = t / 3, c = t - 3 * nd;
        const T vt = kind == 0 ? a.v0[t] : a.v[t] + s * a.x[t];
        if (kind != 2) a.v[t] = vt;
        T* pk = a.packed + (size_t)nd * 9;
        pk[c] = a.u_prev[t] + dt * vt;
        pk[3 + c] = vt;
        pk[6 + c] = (vt - a.v_prev[t]) / dt;
      }
    });
    sync();
    each_tile([&](int e0) {
      primal_prep_tile<T, F>(a.packed, a.conn_t, a.gN_t, a.dV_t, a.Me_t, a.fe, a.prep, E, e0,
                             a.mat, tile_smem);
    });
    sync();
    T acc[1];
    each_vblock([&](int m, int vb) {
      acc[0] = T(0);
      for (int t = vb * NT + tid; t < n3; t += vstride) {
        const int nd = t / 3, c = t - 3 * nd;
        const T u = a.packed[(size_t)nd * 9 + c];
        const T gv = node_sum_staged<T, RES_K4_BATCH>(a.fe, csr_ptr, csr_off, nd, c, E) +
                     a.pin_aff[t] + a.pin_lin[nd] * u - a.f_ext[t];
        a.g[t] = gv;
        acc[0] += gv * gv;
      }
      warp_sums(m, acc, 1);
    });
    reduce(acc, 1);
    ++n_grad;
    return (double)sqrt(acc[0]);
  };

  // hp = H p from the current prep cache; returns p . hp.
  auto hessian_p = [&]() -> T {
    each_tile([&](int e0) {
      hv_tile<T, F>(a.p, a.conn_t, a.prep, a.gN_t, a.dV_t, a.Me_t, a.fe, E, e0, dt, a.mat,
                    tile_smem);
    });
    sync();
    T acc[1];
    each_vblock([&](int m, int vb) {
      acc[0] = T(0);
      for (int t = vb * NT + tid; t < n3; t += vstride) {
        const int nd = t / 3, c = t - 3 * nd;
        const T h = node_sum_staged<T, RES_K4_BATCH>(a.fe, csr_ptr, csr_off, nd, c, E) +
                    (dt * a.pin_lin[nd]) * a.p[t];
        a.hp[t] = h;
        acc[0] += a.p[t] * h;
      }
      warp_sums(m, acc, 1);
    });
    reduce(acc, 1);
    ++n_hv;
    return acc[0];
  };

  // PCG for H x = -g (newton._pcg). Returns the iteration count; neg is set
  // on non-positive curvature, xx = x . x.
  auto pcg = [&](double eta, double bnorm, bool& neg, T& xx) -> int {
    T acc[RES_NV];
    each_vblock([&](int m, int vb) {
      acc[0] = acc[1] = T(0);
      for (int nd = vb * NT + tid; nd < n; nd += vstride) {
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
      warp_sums(m, acc, 2);
    });
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
      T s3[RES_NV];
      each_vblock([&](int m, int vb) {
        s3[0] = s3[1] = s3[2] = T(0);
        for (int nd = vb * NT + tid; nd < n; nd += vstride) {
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
        warp_sums(m, s3, 3);
      });
      reduce(s3, 3);
      const T rz_new = good ? s3[0] : T(0);
      neg = neg || !good;
      ++k;
      xx = s3[2];
      rr = s3[1];
      const bool more = k < a.cg_max && (double)rr > tol2 && (double)rz_new > 0.0;
      if (more) {  // the next direction; not needed when the loop ends
        const T beta = rz_new / rz;
        each_vblock([&](int, int vb) {
          for (int t = vb * NT + tid; t < n3; t += vstride) a.p[t] = a.z[t] + beta * a.p[t];
        });
        sync();
      }
      rz = rz_new;
    }
    return k;
  };

  const double tiny = sizeof(T) == 8 ? DBL_MIN : (double)FLT_MIN;
  const double emax = fmax(a.ew_eta_max, a.cg_rtol);
  const bool writer = rank == 0 && tid == 0 && slab == 0;
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
    each_vblock([&](int, int vb) {
      for (int t = vb * NT + tid; t < n3; t += vstride)
        a.v[t] = mode == 0 ? a.v0[t] : a.v[t] + step * a.x[t];
    });
  }
  if (writer) {
    const double st[RES_STATS] = {(double)k, (double)cg_total, ng, (double)n_grad,
                                  (double)n_hv, (double)barriers, (double)C};
    for (int i = 0; i < RES_STATS; ++i) a.stats[i] = st[i];
  }
  cluster.sync();  // no block leaves while another may store into its shared memory
}

namespace {

// Dynamic shared memory of a launch at E elements on a cluster of `cluster`
// blocks, or 0 when the launch is not possible (E out of (0, 32 * EX],
// cluster not a power of two in [1, RES_MAX_CLUSTER]).
template <typename T, class F, int SLABS>
size_t resident_smem(int E, int cluster) {
  static_assert(smem_bytes<T, F, 9, 3>() >= smem_bytes<T, F, 3, 3>(), "K1's tile is the larger");
  if (E <= 0 || n_tiles(E) > RES_MAX_TILES || cluster < 1 || cluster > RES_MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0)
    return 0;
  return resident_smem_bytes<T, F, SLABS>((n_tiles(E) + cluster - 1) / cluster, E);
}

// Opt in to the largest shared memory of any launch (one block running all
// RES_MAX_TILES virtual blocks) and to clusters of 16 blocks, once per kernel.
template <typename T, class F, class M, int SLABS>
cudaError_t resident_attributes() {
  static const cudaError_t err = [] {
    const auto kernel = newton_resident_kernel<T, F, M, SLABS>;
    cudaError_t e =
        allow_smem(kernel, resident_smem_bytes<T, F, SLABS>(RES_MAX_TILES, RES_MAX_TILES * EX));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

template <class F, int SLABS>
cudaLaunchConfig_t resident_config(int cluster, size_t smem, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(EX, F::NG, SLABS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster the card schedules for this kernel at the gate's
// largest mesh: RES_MAX_CLUSTER if one such cluster fits, else 8.
template <typename T, class F, class M, int SLABS>
int resident_max_cluster(int* out) {
  cudaError_t err = resident_attributes<T, F, M, SLABS>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const int E = RES_MAX_TILES * EX;
  cudaLaunchConfig_t cfg = resident_config<F, SLABS>(
      RES_MAX_CLUSTER, resident_smem<T, F, SLABS>(E, RES_MAX_CLUSTER), nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, newton_resident_kernel<T, F, M, SLABS>, &cfg);
  if (err != cudaSuccess) return (int)err;
  *out = clusters >= 1 ? RES_MAX_CLUSTER : 8;
  return 0;
}

// Registers and local bytes a thread of the kernel, and its blocks an SM at
// the launch of E elements on `cluster` blocks (occupancy() in
// fem_kernels.cuh, without lowering the shared-memory opt-in).
template <typename T, class F, class M, int SLABS>
int resident_occupancy(int E, int cluster, int* out) {
  cudaError_t err = resident_attributes<T, F, M, SLABS>();
  const auto kernel = newton_resident_kernel<T, F, M, SLABS>;
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  const size_t smem = resident_smem<T, F, SLABS>(E, cluster);
  if (err == cudaSuccess && smem == 0) err = cudaErrorInvalidValue;
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, EX * F::NG * SLABS,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  return 0;
}

template <typename T, class F, class M, int SLABS>
int launch_newton_resident(const ResidentArgs<T, M>& args, int cluster, void* stream) {
  cudaError_t err = resident_attributes<T, F, M, SLABS>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = resident_smem<T, F, SLABS>(args.E, cluster);
  if (smem == 0 || args.n <= 0 || args.n > F::S * args.E)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      resident_config<F, SLABS>(cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, newton_resident_kernel<T, F, M, SLABS>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace tlfea

// Plain C interface of one (family, material)'s resident kernel, bound with
// ctypes (tlfea_torch/ops/resident.py): tlfea_newton_resident_<NAME>_<SUFFIX>,
// NAME the kernels' tag (the family, with "_mr" for Mooney-Rivlin), SLABS
// the thread slabs a block. MAT is the material template (tlfea::SvkMat or
// tlfea::MrMat); mat points to its constants as doubles (MAT<T>::from).
// scratch holds 9 n + S 3 E + Q PR E + 6 * 3 n words of T (packed, fe, prep
// with the material's PR rows, then g, x, r, z, p, hp), stats 7 + max_inner
// + 1 doubles (the history slots NaN on entry); cluster is the number of
// blocks, a power of two up to 16. Beside it:
//   ..._max_cluster(int* out): the largest cluster the card schedules (16 or 8);
//   ..._smem(int E, int cluster): the launch's shared memory in bytes (0: refused);
//   ..._occupancy(int E, int cluster, int* out): registers, local bytes a
//   thread and blocks an SM of that launch.
#define TLFEA_RESIDENT_ENTRY_POINTS_SLABS(NAME, FAM, MAT, SUFFIX, T, SLABS)                   \
  extern "C" int tlfea_newton_resident_##NAME##_##SUFFIX(                                     \
      const void* v0, const void* u_prev, const void* v_prev, const void* f_ext,              \
      const void* pin_aff, const void* pin_lin, const void* inv_blocks, const void* conn_t,   \
      const void* gN_t, const void* dV_t, const void* Me_t, const void* inc_ptr,              \
      const void* inc, void* scratch, void* v, void* stats, int n, int E, const double* mat,  \
      double dt, double inner_atol, double inner_rtol, double cg_rtol, double ew_eta_max,     \
      int max_inner, int cg_max, int ls_max, int cluster, void* stream) {                     \
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
    return tlfea::launch_newton_resident<T, FAM, MAT<T>, SLABS>(a, cluster, stream);          \
  }                                                                                           \
  extern "C" int tlfea_newton_resident_##NAME##_##SUFFIX##_max_cluster(int* out) {            \
    return tlfea::resident_max_cluster<T, FAM, MAT<T>, SLABS>(out);                           \
  }                                                                                           \
  extern "C" long long tlfea_newton_resident_##NAME##_##SUFFIX##_smem(int E, int cluster) {   \
    return (long long)tlfea::resident_smem<T, FAM, SLABS>(E, cluster);                        \
  }                                                                                           \
  extern "C" int tlfea_newton_resident_##NAME##_##SUFFIX##_occupancy(int E, int cluster,      \
                                                                     int* out) {              \
    return tlfea::resident_occupancy<T, FAM, MAT<T>, SLABS>(E, cluster, out);                 \
  }

#define TLFEA_RESIDENT_ENTRY_POINTS(NAME, FAM, MAT, SUFFIX, T) \
  TLFEA_RESIDENT_ENTRY_POINTS_SLABS(NAME, FAM, MAT, SUFFIX, T, tlfea::RES_SLABS)
