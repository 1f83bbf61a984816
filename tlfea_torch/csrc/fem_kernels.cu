// FEAT10 element kernels for the implicit Newton-PCG step (Hopper, sm_90a).
//
// Four kernels replace the Pallas TPU kernels on the flagship path:
//
//   K1 primal_prep  <- tlfea/ops/pallas_fem.py `_primal_prep_body` (:888) and
//                      tlfea/ops/pallas_banded.py `_primal_banded_body` (:801)
//   K2 hv           <- pallas_fem.py `_hv_body` (:956) and
//                      pallas_banded.py `_hv_banded_body` (:763)
//   K3 svk_blocks   <- pallas_fem.py `_precond_body` (:673) and
//                      pallas_banded.py `_blocks_banded_body` (:839)
//   K4 node_reduce  <- the scatter half of all of the above
//                      (pallas_banded.py `_window_scatter` :689, and the flat
//                      path's XLA `.at[].add`)
//
// The TPU versions tile the element axis as (8,128) vector registers and,
// in the banded form, gather and scatter through VMEM node windows with
// one-hot lane shuffles. None of that carries over. Here each role is one
// kernel with ONE THREAD PER ELEMENT: the thread loads its element's node
// values through `conn` (an indexed global load, served mostly from L2 since
// a node is shared by ~20 elements and the node order is band-minimised),
// does all quadrature-point algebra in registers, and writes per-(element,
// slot) values. A separate node-side reduce (K4) sums those onto the nodes in
// a fixed order, so results are bitwise repeatable in float32 (no atomics).
//
// What bounds them: K1-K3 are memory-bound streams over the element tables
// (per element: 150 shape-gradient values, 5 volumes, 100 mass entries, plus
// 135 prep values read by K2 / written by K1), at a few hundred flops per
// QP. The design keeps every table element-minor — row r of a table is
// stored as [r * E + e] — so the 32 threads of a warp read 32 consecutive
// words of each row (fully coalesced), and the ragged tail is masked instead
// of padded. The node gathers are the only uncoalesced loads. K4 is bound by
// the latency of its dependent, uncoalesced reads of the per-slot values.
// Shared-memory staging, TMA and wgmma are later work.
//
// Layouts (T = float or double; S = 10 slots, Q = 5 quadrature points):
//   packed  (n, 9)       node-major [u | v | dv/dt]
//   conn_t  (S, E)       int32 node of slot a of element e at [a * E + e]
//   gN_t    (Q*S*3, E)   shape gradients, row (q*S + a)*3 + j
//   dV_t    (Q, E)       quadrature volumes
//   Me_t    (S*S, E)     consistent mass, row a*S + b
//   prep    (Q*27, E)    per-QP cache: Du (9), S0 (9), Fd (9), row q*27 + r
//   fe/out  (S*C, E)     per-(element, slot) values, row a*C + c
//
// Slot 0 is the element-local centring reference (FEAT10's translation mask
// is all true): centred operands x_a - x_0 remove the rigid-motion common
// mode, without which float32 carries an eps*E*theta residual floor.
//
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include "svk.cuh"

namespace tlfea {

constexpr int S = 10;
constexpr int Q = 5;
constexpr int PR = 27;  // prep rows per quadrature point
constexpr int THREADS = 128;

// K1: f_e = sum_q P(Du, Fd) gradN dV + Me dv/dt, and the per-QP prep cache.
// Replaces pallas_fem.py `_primal_prep_body` and pallas_banded.py
// `_primal_banded_body`. Bound by bytes: per element it reads 255 table
// values and writes 30 + 135; the tables stream coalesced, the 10 node rows
// are indexed loads. On an H100 SXM (700 W) at 10,584 elements in float32:
// 8.3 us against 5.6 us of HBM traffic for its ~18.7 MB.
template <typename T>
__global__ void __launch_bounds__(THREADS)
primal_prep_kernel(const T* __restrict__ packed, const int* __restrict__ conn_t,
                   const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                   const T* __restrict__ Me_t, T* __restrict__ fe,
                   T* __restrict__ prep, int E, T lam, T mu, T eta, T lam_d) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = (size_t)E;
  int node[S];
#pragma unroll
  for (int a = 0; a < S; ++a) node[a] = conn_t[a * sE + e];

  T uc[S][3], vc[S][3];  // centred on slot 0 (slot 0 itself is zero)
  {
    const T* p0 = packed + (size_t)node[0] * 9;
    const T u0[3] = {p0[0], p0[1], p0[2]};
    const T v0[3] = {p0[3], p0[4], p0[5]};
#pragma unroll
    for (int a = 1; a < S; ++a) {
      const T* pa = packed + (size_t)node[a] * 9;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        uc[a][c] = pa[c] - u0[c];
        vc[a][c] = pa[3 + c] - v0[c];
      }
    }
  }

  T f[S][3];
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) f[a][i] = T(0);

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    T Du[3][3], Fd[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Du[i][j] = Fd[i][j] = T(0);
#pragma unroll
    for (int a = 1; a < S; ++a) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T g = gN_t[((q * S + a) * 3 + j) * sE + e];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          Du[i][j] += uc[a][i] * g;
          Fd[i][j] += vc[a][i] * g;
        }
      }
    }
    T P[3][3], Sm[3][3];
    svk_stress(Du, Fd, lam, mu, eta, lam_d, P, Sm);
    T* pq = prep + (size_t)q * PR * sE + e;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        pq[(i * 3 + j) * sE] = Du[i][j];
        pq[(9 + i * 3 + j) * sE] = Sm[i][j];
        pq[(18 + i * 3 + j) * sE] = Fd[i][j];
      }
    const T w = dV_t[q * sE + e];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      const T g0 = gN_t[((q * S + a) * 3 + 0) * sE + e];
      const T g1 = gN_t[((q * S + a) * 3 + 1) * sE + e];
      const T g2 = gN_t[((q * S + a) * 3 + 2) * sE + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) f[a][i] += (P[i][0] * g0 + P[i][1] * g1 + P[i][2] * g2) * w;
    }
  }

  // Consistent mass on the (uncentred) dv/dt channel.
  T dv[S][3];
#pragma unroll
  for (int b = 0; b < S; ++b)
#pragma unroll
    for (int i = 0; i < 3; ++i) dv[b][i] = packed[(size_t)node[b] * 9 + 6 + i];
#pragma unroll
  for (int a = 0; a < S; ++a) {
    T m[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T me = Me_t[(a * S + b) * sE + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) m[i] += me * dv[b][i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) fe[(a * 3 + i) * sE + e] = f[a][i] + m[i];
  }
}

// K2: Hv_e = sum_q dP(G) gradN dV + (1/dt) Me p, primal state from prep.
// Replaces pallas_fem.py `_hv_body` and pallas_banded.py `_hv_banded_body`;
// runs once per CG iteration. Bound by bytes: it re-reads the 135-row prep
// cache instead of recomputing the primal, so one contraction (G) per QP is
// all the arithmetic left. H100 SXM, 700 W, 10,584 elements, float32:
// 7.4 us against 5.4 us of HBM traffic for its ~18.2 MB.
template <typename T>
__global__ void __launch_bounds__(THREADS)
hv_kernel(const T* __restrict__ p, const int* __restrict__ conn_t,
          const T* __restrict__ prep, const T* __restrict__ gN_t,
          const T* __restrict__ dV_t, const T* __restrict__ Me_t,
          T* __restrict__ out, int E, T dt, T lam, T mu, T eta, T lam_d) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = (size_t)E;
  int node[S];
#pragma unroll
  for (int a = 0; a < S; ++a) node[a] = conn_t[a * sE + e];

  T pe[S][3];
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) pe[a][c] = p[(size_t)node[a] * 3 + c];

  T f[S][3];
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) f[a][i] = T(0);

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    T G[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) G[i][j] = T(0);
#pragma unroll
    for (int a = 1; a < S; ++a) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T g = gN_t[((q * S + a) * 3 + j) * sE + e];
#pragma unroll
        for (int i = 0; i < 3; ++i) G[i][j] += (pe[a][i] - pe[0][i]) * g;
      }
    }
    T Du[3][3], S0[3][3], Fd[3][3];
    const T* pq = prep + (size_t)q * PR * sE + e;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Du[i][j] = pq[(i * 3 + j) * sE];
        S0[i][j] = pq[(9 + i * 3 + j) * sE];
        Fd[i][j] = pq[(18 + i * 3 + j) * sE];
      }
    T dP[3][3];
    svk_hv(G, Du, S0, Fd, dt, lam, mu, eta, lam_d, dP);
    const T w = dV_t[q * sE + e];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      const T g0 = gN_t[((q * S + a) * 3 + 0) * sE + e];
      const T g1 = gN_t[((q * S + a) * 3 + 1) * sE + e];
      const T g2 = gN_t[((q * S + a) * 3 + 2) * sE + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) f[a][i] += (dP[i][0] * g0 + dP[i][1] * g1 + dP[i][2] * g2) * w;
    }
  }

  const T inv_dt = T(1) / dt;
#pragma unroll
  for (int a = 0; a < S; ++a) {
    T m[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T me = Me_t[(a * S + b) * sE + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) m[i] += me * pe[b][i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(a * 3 + i) * sE + e] = f[a][i] + inv_dt * m[i];
  }
}

// K3: per-(element, slot) SVK diagonal tangent blocks, sum_q K(F_q, h_qa) dV_q,
// packed SYM6 (the caller applies the uniform dt weight). Replaces
// pallas_fem.py `_precond_body` and pallas_banded.py `_blocks_banded_body`;
// runs once per preconditioner refresh. Bound by the shape-gradient stream
// (150 of its ~230 values per element); SYM6 writes 6 channels instead of
// 9. H100 SXM, 700 W, 10,584 elements, float32: 6.6 us against 2.9 us of
// HBM traffic for its ~9.7 MB.
template <typename T>
__global__ void __launch_bounds__(THREADS)
svk_blocks_kernel(const T* __restrict__ u, const int* __restrict__ conn_t,
                  const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                  T* __restrict__ out, int E, T lam, T mu) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = (size_t)E;
  int node[S];
#pragma unroll
  for (int a = 0; a < S; ++a) node[a] = conn_t[a * sE + e];

  T uc[S][3];
  {
    const T* p0 = u + (size_t)node[0] * 3;
    const T u0[3] = {p0[0], p0[1], p0[2]};
#pragma unroll
    for (int a = 1; a < S; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) uc[a][c] = u[(size_t)node[a] * 3 + c] - u0[c];
  }

  T acc[S][6];
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[a][c] = T(0);

#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    T F[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) F[i][j] = T(0);
#pragma unroll
    for (int a = 1; a < S; ++a) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T g = gN_t[((q * S + a) * 3 + j) * sE + e];
#pragma unroll
        for (int i = 0; i < 3; ++i) F[i][j] += uc[a][i] * g;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i][i] += T(1);
    T trFtF = T(0), FFT[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        trFtF += F[i][j] * F[i][j];
        FFT[i][j] = F[i][0] * F[j][0] + F[i][1] * F[j][1] + F[i][2] * F[j][2];
      }
    }
    const T trE = T(0.5) * (trFtF - T(3));
    const T w = dV_t[q * sE + e];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      const T h[3] = {gN_t[((q * S + a) * 3 + 0) * sE + e],
                      gN_t[((q * S + a) * 3 + 1) * sE + e],
                      gN_t[((q * S + a) * 3 + 2) * sE + e]};
      T K[6];
      svk_diag_block(F, FFT, trE, h, lam, mu, K);
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[a][c] += K[c] * w;
    }
  }
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) out[(a * 6 + c) * sE + e] = acc[a][c];
}

// K4: out[node, c] = sum over the node's incidences (a, e), in the fixed
// order of the host-built CSR list, of vals[(a*C + c) * E + e]. One thread
// per (node, channel); inc[k] = a * E + e. Replaces the scatter half of the
// kernels above (pallas_banded.py `_window_scatter`, the flat path's XLA
// `.at[].add`). A fixed order instead of atomics keeps float32 sums bitwise
// repeatable. Bound by latency: each thread walks ~20 dependent, uncoalesced
// loads. H100 SXM, 700 W, 10,584 elements, C = 6: 7.1 us against 1.0 us of
// HBM traffic for its ~3.4 MB.
template <typename T>
__global__ void __launch_bounds__(THREADS)
node_reduce_kernel(const T* __restrict__ vals, const int* __restrict__ ptr,
                   const int* __restrict__ inc, T* __restrict__ out, int n,
                   int E, int C) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * C) return;
  const int nd = t / C;
  const int c = t - nd * C;
  T acc = T(0);
  for (int k = ptr[nd]; k < ptr[nd + 1]; ++k) {
    const int i = inc[k];
    const int a = i / E;
    const int e = i - a * E;
    acc += vals[((size_t)a * C + c) * E + e];
  }
  out[t] = acc;
}

inline int n_blocks(long long work) { return (int)((work + THREADS - 1) / THREADS); }

template <typename T>
int launch_primal_prep(const void* packed, const void* conn_t, const void* gN_t,
                       const void* dV_t, const void* Me_t, void* fe, void* prep,
                       int E, double lam, double mu, double eta, double lam_d,
                       void* stream) {
  if (E > 0) {
    primal_prep_kernel<T><<<n_blocks(E), THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)packed, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t,
        (const T*)Me_t, (T*)fe, (T*)prep, E, (T)lam, (T)mu, (T)eta, (T)lam_d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hv(const void* p, const void* conn_t, const void* prep, const void* gN_t,
              const void* dV_t, const void* Me_t, void* out, int E, double dt,
              double lam, double mu, double eta, double lam_d, void* stream) {
  if (E > 0) {
    hv_kernel<T><<<n_blocks(E), THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)p, (const int*)conn_t, (const T*)prep, (const T*)gN_t,
        (const T*)dV_t, (const T*)Me_t, (T*)out, E, (T)dt, (T)lam, (T)mu,
        (T)eta, (T)lam_d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_svk_blocks(const void* u, const void* conn_t, const void* gN_t,
                      const void* dV_t, void* out, int E, double lam, double mu,
                      void* stream) {
  if (E > 0) {
    svk_blocks_kernel<T><<<n_blocks(E), THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)u, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t,
        (T*)out, E, (T)lam, (T)mu);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_node_reduce(const void* vals, const void* ptr, const void* inc,
                       void* out, int n, int E, int C, void* stream) {
  if (n > 0) {
    node_reduce_kernel<T><<<n_blocks((long long)n * C), THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const T*)vals, (const int*)ptr, (const int*)inc, (T*)out, n, E, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace tlfea

// Plain C interface, bound with ctypes (tlfea_torch/ops/fem_kernels.py).
#define TLFEA_ENTRY_POINTS(SUFFIX, T)                                             \
  extern "C" int tlfea_primal_prep_##SUFFIX(                                      \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t, \
      const void* Me_t, void* fe, void* prep, int E, double lam, double mu,       \
      double eta, double lam_d, void* stream) {                                   \
    return tlfea::launch_primal_prep<T>(packed, conn_t, gN_t, dV_t, Me_t, fe,     \
                                        prep, E, lam, mu, eta, lam_d, stream);    \
  }                                                                               \
  extern "C" int tlfea_hv_##SUFFIX(                                               \
      const void* p, const void* conn_t, const void* prep, const void* gN_t,      \
      const void* dV_t, const void* Me_t, void* out, int E, double dt,            \
      double lam, double mu, double eta, double lam_d, void* stream) {            \
    return tlfea::launch_hv<T>(p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt,     \
                               lam, mu, eta, lam_d, stream);                      \
  }                                                                               \
  extern "C" int tlfea_svk_blocks_##SUFFIX(                                       \
      const void* u, const void* conn_t, const void* gN_t, const void* dV_t,      \
      void* out, int E, double lam, double mu, void* stream) {                    \
    return tlfea::launch_svk_blocks<T>(u, conn_t, gN_t, dV_t, out, E, lam, mu,    \
                                       stream);                                   \
  }                                                                               \
  extern "C" int tlfea_node_reduce_##SUFFIX(const void* vals, const void* ptr,    \
                                            const void* inc, void* out, int n,    \
                                            int E, int C, void* stream) {         \
    return tlfea::launch_node_reduce<T>(vals, ptr, inc, out, n, E, C, stream);    \
  }

TLFEA_ENTRY_POINTS(f32, float)
TLFEA_ENTRY_POINTS(f64, double)
