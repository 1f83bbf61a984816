// Element kernels of the implicit Newton-PCG step (Hopper, sm_90a), templated
// on the element family (the number of slots S, of stiffness quadrature
// points Q, and the mask of translation slots) and, for K1, K2, K5 and K5t,
// on the material: `SvkMat` (svk.cuh) or `MrMat` (mr.cuh, in every family:
// fem_<family>_mr.cu), which carries its prep-row count PR, its constants and
// its stress, Hv and tangent algebra. K3 is SVK only, as in the JAX package.
//
// Six kernels replace the Pallas TPU kernels of the Newton-PCG path and of the
// first-order solvers' gradients:
//
//   K1 primal_prep  <- tlfea/ops/pallas_fem.py `_primal_prep_body` (:888),
//                      `_primal_prep_chunked_body` (:1018) and
//                      pallas_banded.py `_primal_banded_body` (:801)
//   K2 hv           <- pallas_fem.py `_hv_body` (:956), `_hv_chunked_body`
//                      (:1054) and pallas_banded.py `_hv_banded_body` (:763)
//   K3 svk_blocks   <- pallas_fem.py `_precond_body` (:673), the chunked
//                      `make_precond_blocks` kernel (:725) and
//                      pallas_banded.py `_blocks_banded_body` (:839)
//   K4 node_reduce  <- the scatter half of all of the above
//                      (pallas_banded.py `_window_scatter` :689, and the flat
//                      path's XLA `.at[].add`)
//   K5 contrib      <- pallas_fem.py `_body` (:519) with tangent=False: K1's
//                      f_e without the prep cache (the same tile code)
//   K5t contrib_tangent <- `_body` with tangent=True (the custom-JVP tangent
//                      of `make_element_contrib`, :830): the directional
//                      derivative of K5 along [du | dv | d(dv/dt)]
//
// The TPU versions tile the element axis as (8,128) vector registers, gather
// and scatter through VMEM node windows (banded form), and for heavy elements
// (the ANCF3443 shell: Q=48, S=16) split the quadrature points into a grid
// axis of chunks, revisiting the output block across chunks, because the
// unchunked shape-gradient table overflows VMEM. None of that carries over.
//
// Here a block owns a tile of EX = 32 consecutive elements (threadIdx.x) and
// splits their quadrature points over NG groups (threadIdx.y): thread (x, g)
// takes the points q = g, g + NG, ... of element e0 + x. So a warp reads 32
// consecutive words of every element-minor table row (fully coalesced), and
// the block keeps NG warps of loads in flight even when the mesh has few
// elements (5,184 shells are 162 tiles). The block first gathers its
// elements' slot values through `conn` into shared memory (centred, see
// below). Each thread accumulates its points' contributions in registers
// when they are few, else directly in its own slice of a shared-memory
// partial buffer, and leaves them in that slice (K3 and K5t, with S*6 and
// S*3 sums a thread, instead take one thread an (element, slot) at the shell
// and at FEAT10 with SVK: `Slots`, below). Then the block sums the NG
// partials of each (element, slot) in the fixed order g = 0..NG-1, adds the
// q-independent mass term once, and writes per-(element, slot) values. K4
// sums those onto the nodes in a fixed order. No atomics anywhere: float32
// results are bitwise repeatable.
//
// What bounds them: K1-K3 stream the element tables once (per element, Q*S*3
// shape gradients, Q volumes, S*S mass entries, and the Q*PR-row prep cache
// written by K1 and read by K2) at a few hundred flops per quadrature point;
// bytes, not flops, are the bound. At the shell's 5,184 elements the
// shape-gradient table alone is 47.8 MB in float32, about the size of the
// 50 MB L2, so every launch streams it from HBM.
//
// Layouts (T = float or double):
//   packed  (n, 9)       node-major [u | v | dv/dt]
//   conn_t  (S, E)       int32 node of slot a of element e at [a * E + e]
//   gN_t    (Q*S*3, E)   shape gradients, row (q*S + a)*3 + j
//   dV_t    (Q, E)       quadrature volumes
//   Me_t    (S*S, E)     consistent mass, row a*S + b
//   prep    (Q*PR, E)    per-QP cache, row q*PR + r: SVK (PR 27) Du, S0, Fd;
//                        MR (PR 30) Du, F^{-T}, [J-1, I1, I2], Fd
//   dpacked (n, 9)       K5t's tangent [du | dv | d(dv/dt)], node-major
//   fe/out  (S*C, E)     per-(element, slot) values, row a*C + c
//
// Centring: slot 0 is the element-local reference and must be a translation
// slot. Translation slots (all ten of FEAT10; every node's position
// coefficient, a % 4 == 0, for ANCF) enter the gradient contractions as
// x_a - x_0, which is exact because their shape gradients sum to zero and
// removes the rigid-motion common mode (without it float32 carries an
// eps*E*theta residual floor). Gradient slots (ANCF's r_u, r_v, r_w) are
// used raw. The mass terms use the raw, uncentred values.
//
// The per-tile bodies of K1 and K2 (`primal_prep_tile`, `hv_tile`) and K4's
// ordered walk (`node_sums`, for a group of a node's channels) are __device__
// functions, so that the persistent Newton-PCG kernel (resident.cuh) runs
// the same code in its loops. Their pointers to data that the persistent kernel
// writes during its run carry no __restrict__: a load through such a pointer
// must not go through the non-coherent read-only cache.
//
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises on a non-zero code.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mr.cuh"
#include "svk.cuh"

namespace tlfea {

constexpr int EX = 32;       // elements per block (threadIdx.x)
constexpr int THREADS = 128;  // K4 block size

// An element family: S slots, Q stiffness quadrature points, MASK bit a set
// when slot a is a translation slot, NG quadrature-point groups per element,
// and up to REG_BYTES of each thread's partial sums kept in registers.
template <int S_, int Q_, unsigned MASK_, int NG_, int REG_BYTES_ = 240>
struct Family {
  static constexpr int S = S_;
  static constexpr int Q = Q_;
  static constexpr unsigned MASK = MASK_;
  static constexpr int NG = NG_;
  static constexpr int REG_BYTES = REG_BYTES_;
  static_assert(MASK_ & 1u, "slot 0 must be a translation slot (the centring reference)");
  static_assert(S_ <= 32 && NG_ >= 1 && NG_ <= Q_, "unsupported family shape");
};

template <class F>
__device__ __forceinline__ bool trans_slot(int a) {
  return ((F::MASK >> a) & 1u) != 0u;
}

// Shared memory of one block: S*CIN staged slot channels, then NG*S*COUT
// partial sums, each row EX elements wide.
template <typename T, class F, int CIN, int COUT>
constexpr size_t smem_bytes() {
  return (size_t)(F::S * CIN + F::NG * F::S * COUT) * EX * sizeof(T);
}

// Gather the first CIN channels of the tile's slot values (rows of STRIDE
// channels in src) into xs[(a*CIN + c) * W + x], the first NCENT channels
// of a translation slot centred on slot 0 and everything else raw. The tile
// is W elements wide (blockDim.x) and the block NT threads.
template <typename T, class F, int CIN, int NCENT, int STRIDE = CIN, int W = EX,
          int NT = EX * F::NG>
__device__ __forceinline__ void stage(const T* src, const int* __restrict__ conn_t,
                                      int E, int e0, T* xs) {
  constexpr int S = F::S;
  const size_t sE = (size_t)E;
  const int tid = threadIdx.y * W + threadIdx.x;
  for (int t = tid; t < S * W; t += NT) {
    const int a = t / W, x = t - a * W, e = e0 + x;
    if (e >= E) continue;
    const T* pa = src + (size_t)conn_t[a * sE + e] * STRIDE;
    const T* p0 = src + (size_t)conn_t[e] * STRIDE;
    const bool tr = trans_slot<F>(a);
    for (int c = 0; c < CIN; ++c)
      xs[(a * CIN + c) * W + x] = (c < NCENT && tr) ? pa[c] - p0[c] : pa[c];
  }
}

// One thread's N partial sums over its quadrature points: in registers when
// they are few (REGS; every index is a constant once the slot loops are
// unrolled), else in the thread's own slice of the shared partial buffer,
// mine[r * EX]. flush() leaves them in that slice either way.
template <typename T, int N, bool REGS>
struct Partial;

template <typename T, int N>
struct Partial<T, N, true> {
  T v[N];
  T* mine;
  __device__ __forceinline__ explicit Partial(T* m) : mine(m) {
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = T(0);
  }
  __device__ __forceinline__ T& operator[](int r) { return v[r]; }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int r = 0; r < N; ++r) mine[r * EX] = v[r];
  }
};

template <typename T, int N>
struct Partial<T, N, false> {
  T* mine;
  __device__ __forceinline__ explicit Partial(T* m) : mine(m) {
    for (int r = 0; r < N; ++r) mine[r * EX] = T(0);
  }
  __device__ __forceinline__ T& operator[](int r) { return mine[r * EX]; }
  __device__ __forceinline__ void flush() {}
};

template <typename T, class F, int N>
using PartialFor = Partial<T, N, (N * sizeof(T) <= (size_t)F::REG_BYTES)>;

// Where K1 and K5 load a quadrature point's shape gradients and volume:
// `none` from global memory where they are used (the contraction, then
// again in the product after the material's chain); `late` once into
// registers, at the top of the point; `early` the same, with the first
// point's loads issued before the block gathers conn -> packed, so that they
// are in flight during `stage`; `stream` through shared memory by cp.async
// (below). The arithmetic and its order are the same in all four, so are
// the bits. Mooney-Rivlin picks per kernel and instantiation
// (TLFEA_MR_ENTRY_POINTS), since its chain (a division, a cube root, another
// division) holds 168-255 registers around the reloads; each choice is the
// one that timed fastest on an H100 (PERF.md, Findings). SVK and the
// persistent kernel load where used.
//
// With `stream`, each thread issues at block start the copies of the rows
// it will itself read (its element's column of its first STAGES rounds of
// points: the point's S*3 gradient rows and its dV row; and its slots' Me
// rows for the reduce), so that they arrive while `stage` gathers conn ->
// packed, and holds no register for them. It walks its points through a
// ring of STAGES stages, refilling a stage with the point STAGES rounds
// ahead once it has read it. A thread reads only what it copied, so
// completion is its own cp.async.wait_group and a stage is free again in
// program order; a word a copy takes any row stride E * sizeof(T).
enum class Hold { none, late, early, stream };

// One word (4 or 8 bytes) from global into shared memory, asynchronously;
// a commit closes this thread's group of copies, and cp_async_wait<N>
// waits until at most N of its groups are pending.
template <typename T>
__device__ __forceinline__ void cp_async_word(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"((int)sizeof(T))
               : "memory");
}

// 16 bytes from global into shared memory, asynchronously, past L1; both
// addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared memory of K1's and K5's tile, in rows of EX words: xs (S*9
// staged slot channels); with `stream` the ring (STAGES * NG points of
// QP_ROWS rows; STAGES at most 3 and the ROUNDS = Q / NG rounds of points a
// thread walks); the NG*S*3 partial sums (with `stream`, the drained ring
// when they live in registers until the flush: ALIAS); with `stream` Me
// (S*S rows). Without `stream`, smem_bytes<T, F, 9, 3>().
template <typename T, class F, Hold HOLD>
struct TileSmem {
  static constexpr bool STREAM = HOLD == Hold::stream;
  static_assert(!STREAM || F::Q % F::NG == 0, "the stream walks whole rounds of NG points");
  static constexpr int ROUNDS = F::Q / F::NG;
  static constexpr int STAGES = ROUNDS < 3 ? ROUNDS : 3;
  static constexpr int QP_ROWS = F::S * 3 + 1;  // a point's gradient rows, then its dV row
  static constexpr int XS = F::S * 9;
  static constexpr int RING = STREAM ? STAGES * F::NG * QP_ROWS : 0;
  static constexpr int PART = F::NG * F::S * 3;
  static constexpr bool ALIAS =
      STREAM && F::S * 3 * sizeof(T) <= (size_t)F::REG_BYTES && RING >= PART;
  static constexpr int ME = STREAM ? F::S * F::S : 0;
  static constexpr size_t BYTES = (size_t)(XS + RING + (ALIAS ? 0 : PART) + ME) * EX * sizeof(T);
  static_assert(BYTES <= 232448, "the tile exceeds an H100 block's 227 KB of shared memory");
};

// K1 on the tile of elements e0 .. e0 + EX - 1: f_e = sum_q P(Du, Fd) gradN
// dV + Me dv/dt, and the per-QP prep cache. smem holds TileSmem<T, F,
// HOLD>::BYTES; the caller separates two tiles that share it by
// __syncthreads(). PREP = false compiles the prep writes out (K5: `prep` is
// not touched), and leaves f_e's arithmetic as it is, so K5's f_e equals
// K1's bit for bit. M is the material (SvkMat or MrMat); HOLD where the
// shape gradients are loaded.
template <typename T, class F, class M, bool PREP = true, Hold HOLD = Hold::none>
__device__ __forceinline__ void primal_prep_tile(const T* packed, const int* __restrict__ conn_t,
                                                 const T* __restrict__ gN_t,
                                                 const T* __restrict__ dV_t,
                                                 const T* __restrict__ Me_t, T* fe, T* prep,
                                                 int E, int e0, const M& m, T* smem) {
  using L = TileSmem<T, F, HOLD>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = EX * NG;
  constexpr int D = L::STAGES, R = L::QP_ROWS;
  constexpr bool HELD = HOLD == Hold::late || HOLD == Hold::early;
  constexpr bool STREAM = L::STREAM;
  T* xs = smem;                                     // (S*9, EX): centred u | centred v | dv
  T* ring = xs + L::XS * EX;                        // (STAGES, NG, QP_ROWS, EX)
  T* part = L::ALIAS ? ring : ring + L::RING * EX;  // (NG*S*3, EX)
  T* mes = ring + (L::RING + (L::ALIAS ? 0 : L::PART)) * EX;  // (S*S, EX)
  const int x = threadIdx.x, g = threadIdx.y;
  const int e = e0 + x;
  const size_t sE = (size_t)E;
  PartialFor<T, F, S * 3> f(part + g * S * 3 * EX + x);
  T gq[S][3], w;  // HELD: point q's gradients and volume
  auto load = [&](int q) {
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int j = 0; j < 3; ++j) gq[a][j] = gN_t[((size_t)(q * S + a) * 3 + j) * sE + e];
    w = dV_t[(size_t)q * sE + e];
  };
  T* mine = ring + (size_t)g * R * EX + x;  // this thread's column of stage 0
  // STREAM: round k's point q = k NG + g into stage k % D, then one commit
  // (empty past the last round or for a missing element), so that before
  // round k exactly D - 1 younger groups exist.
  auto issue = [&](int k) {
    if (e < E && k < L::ROUNDS) {
      const int q = k * NG + g;
      T* dst = mine + (k % D) * (NG * R * EX);
      const T* src = gN_t + (size_t)q * S * 3 * sE + e;
#pragma unroll
      for (int r = 0; r < S * 3; ++r) cp_async_word(dst + r * EX, src + r * sE);
      cp_async_word(dst + S * 3 * EX, dV_t + (size_t)q * sE + e);
    }
    cp_async_commit();
  };
  if constexpr (HOLD == Hold::early) {
    if (e < E) load(g);
  }
  if constexpr (STREAM) {  // the Me rows of the slots this thread reduces (a = g, g + NG, ...)
    if (e < E)
      for (int a = g; a < S; a += NG)
#pragma unroll
        for (int b = 0; b < S; ++b)
          cp_async_word(mes + (a * S + b) * EX + x, Me_t + (size_t)(a * S + b) * sE + e);
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < D; ++k) issue(k);
  }
  stage<T, F, 9, 6>(packed, conn_t, E, e0, xs);
  __syncthreads();

  if (e < E) {
    const T* xe = xs + x;
#pragma unroll 1
    for (int q = g; q < Q; q += NG) {
      const int k = (q - g) / NG;  // the round
      const T* st = mine + (k % D) * (NG * R * EX);
      if constexpr (HELD) {
        if (HOLD == Hold::late || q != g) load(q);
      }
      if constexpr (STREAM) cp_async_wait<D - 1>();
      T Du[3][3], Fd[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Du[i][j] = Fd[i][j] = T(0);
#pragma unroll
      for (int a = 1; a < S; ++a) {  // centred slot 0 is zero
        T ua[3], va[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ua[i] = xe[(a * 9 + i) * EX];
          va[i] = xe[(a * 9 + 3 + i) * EX];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T gv;
          if constexpr (HELD)
            gv = gq[a][j];
          else if constexpr (STREAM)
            gv = st[(a * 3 + j) * EX];
          else
            gv = gN_t[((size_t)(q * S + a) * 3 + j) * sE + e];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            Du[i][j] += ua[i] * gv;
            Fd[i][j] += va[i] * gv;
          }
        }
      }
      T P[3][3];
      T* pq = nullptr;
      if constexpr (PREP) pq = prep + (size_t)q * M::PR * sE + e;
      m.template primal<PREP>(Du, Fd, P, pq, sE);
      if constexpr (STREAM)
        w = st[S * 3 * EX];
      else if constexpr (!HELD)
        w = dV_t[q * sE + e];
#pragma unroll
      for (int a = 0; a < S; ++a) {
        T g0, g1, g2;
        if constexpr (HELD) {
          g0 = gq[a][0], g1 = gq[a][1], g2 = gq[a][2];
        } else if constexpr (STREAM) {
          g0 = st[(a * 3) * EX], g1 = st[(a * 3 + 1) * EX], g2 = st[(a * 3 + 2) * EX];
        } else {
          const T* ga = gN_t + ((size_t)(q * S + a) * 3) * sE + e;
          g0 = ga[0], g1 = ga[sE], g2 = ga[2 * sE];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          f[a * 3 + i] += (P[i][0] * g0 + P[i][1] * g1 + P[i][2] * g2) * w;
      }
      if constexpr (STREAM) issue(k + D);  // the stage is read: refill it
    }
  }
  if constexpr (STREAM) {
    cp_async_wait<0>();                       // Me in place; no copy left in flight
    if constexpr (L::ALIAS) __syncthreads();  // every thread done with the ring
  }
  f.flush();
  __syncthreads();

  // Fixed-order sum of the NG partials, plus the consistent mass on the
  // (uncentred) dv/dt channel; with `stream` a thread reduces its own
  // element's slots a = g, g + NG, ..., whose Me rows it copied.
  for (int t = g * EX + x; t < S * EX; t += NT) {
    const int a = t / EX, xx = t - a * EX, ee = e0 + xx;
    if (ee >= E) continue;
    T f[3] = {T(0), T(0), T(0)};
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] += part[((h * S + a) * 3 + i) * EX + xx];
    T m[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T me = STREAM ? mes[(a * S + b) * EX + xx] : Me_t[(a * S + b) * sE + ee];
#pragma unroll
      for (int i = 0; i < 3; ++i) m[i] += me * xs[(b * 9 + 6 + i) * EX + xx];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) fe[(a * 3 + i) * sE + ee] = f[i] + m[i];
  }
}

template <typename T, class F, class M, Hold HOLD = Hold::none>
__global__ void __launch_bounds__(EX * F::NG)
primal_prep_kernel(const T* __restrict__ packed, const int* __restrict__ conn_t,
                   const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                   const T* __restrict__ Me_t, T* __restrict__ fe,
                   T* __restrict__ prep, int E, M m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  primal_prep_tile<T, F, M, true, HOLD>(packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E,
                                        blockIdx.x * EX, m, reinterpret_cast<T*>(smem_raw));
}

// K5: K1's f_e without the prep cache, the port of `_body` with tangent=False
// (pallas_fem.py:519, `pallas_call` :812), the element half of every ALM
// gradient of the first-order solvers.
template <typename T, class F, class M, Hold HOLD = Hold::none>
__global__ void __launch_bounds__(EX * F::NG)
contrib_kernel(const T* __restrict__ packed, const int* __restrict__ conn_t,
               const T* __restrict__ gN_t, const T* __restrict__ dV_t,
               const T* __restrict__ Me_t, T* __restrict__ fe, int E, M m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  primal_prep_tile<T, F, M, false, HOLD>(packed, conn_t, gN_t, dV_t, Me_t, fe, nullptr, E,
                                         blockIdx.x * EX, m, reinterpret_cast<T*>(smem_raw));
}

// sum over the non-reference slots a of x_a (x) gradN_qa, x_a staged in
// xs[(a*W + c0 + i) * XST] (the element's column, W channels a slot, rows of
// XST words).
template <typename T, class F, int C0, int W, int XST = EX>
__device__ __forceinline__ void contract(const T* xe, const T* __restrict__ gN_t, int q,
                                         size_t sE, int e, T M[3][3]) {
  constexpr int S = F::S;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = T(0);
#pragma unroll
  for (int a = 1; a < S; ++a) {  // centred slot 0 is zero
    T xa[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) xa[i] = xe[(a * W + C0 + i) * XST];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T gv = gN_t[((size_t)(q * S + a) * 3 + j) * sE + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) M[i][j] += xa[i] * gv;
    }
  }
}

// K5t's shared memory, in rows of EX words: xt (S*9 staged tangent
// channels), xp (S*6 staged primal u | v), the NG*S*3 partial sums, then
// with STREAM the ring (STAGES * NG points of QP_ROWS rows: the point's S*3
// gradient rows, then its dV row). Without STREAM, smem_bytes<T, F, 15, 3>().
template <typename T, class F, bool STREAM>
struct TangentSmem {
  static_assert(!STREAM || F::Q % F::NG == 0, "the stream walks whole rounds of NG points");
  static constexpr int ROUNDS = F::Q / F::NG;
  static constexpr int STAGES = ROUNDS < 2 ? ROUNDS : 2;
  static constexpr int QP_ROWS = F::S * 3 + 1;
  static constexpr int XS = F::S * 15;
  static constexpr int PART = F::NG * F::S * 3;
  static constexpr int RING = STREAM ? STAGES * F::NG * QP_ROWS : 0;
  static constexpr size_t BYTES = (size_t)(XS + PART + RING) * EX * sizeof(T);
  static_assert(BYTES <= 232448, "the tile exceeds an H100 block's 227 KB of shared memory");
};

// K5t's last step, after the barrier that follows the flush of the NG
// partial sums `part` (NG*S*3 rows of EX words): out = the fixed-order sum
// of the partials plus the consistent mass on the (uncentred) d(dv/dt)
// channels of the staged tangent xt, thread (x, g) taking slots g, g + NG,
// ... of element x.
template <typename T, class F>
__device__ __forceinline__ void tangent_reduce(const T* part, const T* xt,
                                               const T* __restrict__ Me_t, T* __restrict__ out,
                                               int E, int e0) {
  constexpr int S = F::S, NG = F::NG, NT = EX * NG;
  const int x = threadIdx.x, g = threadIdx.y;
  const size_t sE = (size_t)E;
  for (int t = g * EX + x; t < S * EX; t += NT) {
    const int a = t / EX, xx = t - a * EX, ee = e0 + xx;
    if (ee >= E) continue;
    T s[3] = {T(0), T(0), T(0)};
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int i = 0; i < 3; ++i) s[i] += part[((h * S + a) * 3 + i) * EX + xx];
    T m[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T me = Me_t[(a * S + b) * sE + ee];
#pragma unroll
      for (int i = 0; i < 3; ++i) m[i] += me * xt[(b * 9 + 6 + i) * EX + xx];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(a * 3 + i) * sE + ee] = s[i] + m[i];
  }
}

// K5t with STREAM (contrib_tangent_kernel below): hv_tile's stream given to
// K5t. Each thread copies its points' operands (the S*3 shape-gradient rows
// and the dV row) into its own column of a ring in shared memory by
// cp.async, the first STAGES rounds at block start, so that they arrive
// while `stage` gathers conn -> dpacked and packed, and the four
// contractions and the product read them there. At FEAT10 with
// Mooney-Rivlin (one round: Q = NG) the loading kernel holds 233 registers
// in float32: the compiler issues the point's gradient loads early and
// keeps them live through the chain, one 160-thread block an SM, so the 10k
// flagship's 331 tiles run in three waves; streamed, 128 registers, three
// blocks an SM, one wave (PERF.md, Findings). The arithmetic and its order
// are the loading kernel's, so are the bits. smem holds TangentSmem<T, F,
// true>::BYTES.
template <typename T, class F, class M>
__device__ __forceinline__ void contrib_tangent_stream_tile(
    const T* __restrict__ packed, const T* __restrict__ dpacked, const int* __restrict__ conn_t,
    const T* __restrict__ gN_t, const T* __restrict__ dV_t, const T* __restrict__ Me_t,
    T* __restrict__ out, int E, int e0, const M& m, T* smem) {
  using L = TangentSmem<T, F, true>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG;
  constexpr int D = L::STAGES, R = L::QP_ROWS;
  T* xt = smem;               // (S*9, EX): tangent du | dv | d(dv/dt)
  T* xp = xt + S * 9 * EX;    // (S*6, EX): primal u | v
  T* part = xp + S * 6 * EX;  // (NG*S*3, EX)
  const int x = threadIdx.x, g = threadIdx.y;
  const int e = e0 + x;
  const size_t sE = (size_t)E;
  PartialFor<T, F, S * 3> f(part + g * S * 3 * EX + x);
  T* mine = part + (L::PART + g * R) * EX + x;  // this thread's column of stage 0
  // Round k's point q = k NG + g into stage k % D, then one commit (empty
  // past the last round or for a missing element), so that before round k
  // exactly D - 1 younger groups exist.
  auto issue = [&](int k) {
    if (e < E && k < L::ROUNDS) {
      const int q = k * NG + g;
      T* dst = mine + (k % D) * (NG * R * EX);
      const T* src = gN_t + (size_t)q * S * 3 * sE + e;
#pragma unroll
      for (int r = 0; r < S * 3; ++r) cp_async_word(dst + r * EX, src + r * sE);
      cp_async_word(dst + S * 3 * EX, dV_t + (size_t)q * sE + e);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < D; ++k) issue(k);
  stage<T, F, 9, 6>(dpacked, conn_t, E, e0, xt);
  stage<T, F, 6, 6, 9>(packed, conn_t, E, e0, xp);
  __syncthreads();

  if (e < E) {
#pragma unroll 1
    for (int q = g; q < Q; q += NG) {
      const int k = (q - g) / NG;  // the round
      const T* st = mine + (k % D) * (NG * R * EX);
      cp_async_wait<D - 1>();
      T dF[3][3], dFd[3][3], Du[3][3], Fd[3][3];
      contract<T, F, 0, 9>(xt + x, st, 0, EX, 0, dF);
      contract<T, F, 3, 9>(xt + x, st, 0, EX, 0, dFd);
      contract<T, F, 0, 6>(xp + x, st, 0, EX, 0, Du);
      contract<T, F, 3, 6>(xp + x, st, 0, EX, 0, Fd);
      T dP[3][3];
      m.tangent(Du, dF, Fd, dFd, dP);
      const T w = st[S * 3 * EX];
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const T g0 = st[(a * 3) * EX], g1 = st[(a * 3 + 1) * EX], g2 = st[(a * 3 + 2) * EX];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          f[a * 3 + i] += (dP[i][0] * g0 + dP[i][1] * g1 + dP[i][2] * g2) * w;
      }
      issue(k + D);  // the stage is read: refill it
    }
  }
  cp_async_wait<0>();  // no copy left in flight
  f.flush();
  __syncthreads();
  tangent_reduce<T, F>(part, xt, Me_t, out, E, e0);
}

// K5t: `_body` with tangent=True (the custom-JVP tangent, pallas_fem.py:830):
// out_e = sum_q dP gradN dV + Me d(dv/dt), dP the exact derivative of P at
// the primal (Du, Fd) of `packed` along (dF, dFd) of `dpacked`
// [du | dv | d(dv/dt)]. The tangent's 9 channels and the primal's u | v
// (its dv/dt does not enter) are staged, translation slots centred and the
// d(dv/dt) channels raw; the primal is recomputed per quadrature point.
// smem holds TangentSmem<T, F, STREAM>::BYTES.
//
// STREAM: hv_tile's stream given to K5t (contrib_tangent_stream_tile,
// above). Without it the kernel loads the gradients where used. The layout
// Slots<TE, NQ> launches one thread an (element, slot) instead
// (contrib_tangent_slots_kernel, below).
template <typename T, class F, class M, bool STREAM = false>
__global__ void __launch_bounds__(EX * F::NG)
contrib_tangent_kernel(const T* __restrict__ packed, const T* __restrict__ dpacked,
                       const int* __restrict__ conn_t, const T* __restrict__ gN_t,
                       const T* __restrict__ dV_t, const T* __restrict__ Me_t,
                       T* __restrict__ out, int E, M m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (STREAM) {
    contrib_tangent_stream_tile<T, F, M>(packed, dpacked, conn_t, gN_t, dV_t, Me_t, out, E,
                                         blockIdx.x * EX, m, reinterpret_cast<T*>(smem_raw));
  } else {
    constexpr int S = F::S, Q = F::Q, NG = F::NG;
    T* xt = reinterpret_cast<T*>(smem_raw);  // (S*9, EX): tangent du | dv | d(dv/dt)
    T* xp = xt + S * 9 * EX;                 // (S*6, EX): primal u | v
    T* part = xp + S * 6 * EX;               // (NG*S*3, EX)
    const int x = threadIdx.x, g = threadIdx.y;
    const int e0 = blockIdx.x * EX, e = e0 + x;
    const size_t sE = (size_t)E;
    PartialFor<T, F, S * 3> f(part + g * S * 3 * EX + x);
    stage<T, F, 9, 6>(dpacked, conn_t, E, e0, xt);
    stage<T, F, 6, 6, 9>(packed, conn_t, E, e0, xp);
    __syncthreads();

    if (e < E) {
#pragma unroll 1
      for (int q = g; q < Q; q += NG) {
        T dF[3][3], dFd[3][3], Du[3][3], Fd[3][3];
        contract<T, F, 0, 9>(xt + x, gN_t, q, sE, e, dF);
        contract<T, F, 3, 9>(xt + x, gN_t, q, sE, e, dFd);
        contract<T, F, 0, 6>(xp + x, gN_t, q, sE, e, Du);
        contract<T, F, 3, 6>(xp + x, gN_t, q, sE, e, Fd);
        T dP[3][3];
        m.tangent(Du, dF, Fd, dFd, dP);
        const T w = dV_t[q * sE + e];
#pragma unroll
        for (int a = 0; a < S; ++a) {
          const T* ga = gN_t + ((size_t)(q * S + a) * 3) * sE + e;
          const T g0 = ga[0], g1 = ga[sE], g2 = ga[2 * sE];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            f[a * 3 + i] += (dP[i][0] * g0 + dP[i][1] * g1 + dP[i][2] * g2) * w;
        }
      }
    }
    f.flush();
    __syncthreads();
    tangent_reduce<T, F>(part, xt, Me_t, out, E, e0);
  }
}

// K2's shared memory, in rows of EX words: xs (S*3 staged direction
// channels), the NG*S*3 partial sums, then with STREAM (hv_tile) the ring
// (STAGES * NG points of QP_ROWS rows: the point's S*3 gradient rows, its
// dV row, its PR prep rows). Without STREAM, smem_bytes<T, F, 3, 3>().
template <typename T, class F, class M, bool STREAM>
struct HvSmem {
  static_assert(!STREAM || F::Q % F::NG == 0, "the stream walks whole rounds of NG points");
  static constexpr int ROUNDS = F::Q / F::NG;
  static constexpr int STAGES = ROUNDS < 2 ? ROUNDS : 2;
  static constexpr int QP_ROWS = F::S * 3 + 1 + M::PR;
  static constexpr int XS = F::S * 3;
  static constexpr int PART = F::NG * F::S * 3;
  static constexpr int RING = STREAM ? STAGES * F::NG * QP_ROWS : 0;
  static constexpr size_t BYTES = (size_t)(XS + PART + RING) * EX * sizeof(T);
  static_assert(BYTES <= 232448, "the tile exceeds an H100 block's 227 KB of shared memory");
};

// K2 on one tile: Hv_e = sum_q dP(G) gradN dV + (1/dt) Me p, primal state
// from prep. Runs once per CG iteration. It re-reads the prep cache instead
// of recomputing the primal, so one contraction (G) per QP is all the
// arithmetic left. smem holds HvSmem<T, F, M, STREAM>::BYTES.
//
// STREAM: each thread copies its points' operands (the S*3 shape-gradient
// rows, the dV row and the material's PR prep rows) from global into its
// own column of a ring in shared memory by cp.async, the first STAGES
// rounds at block start, so that they arrive while `stage` gathers conn ->
// p, and reads them there where it uses them (the ring as K1's `stream`,
// above). The arithmetic and its order are the same, so are the bits.
// Mooney-Rivlin picks STREAM per instantiation (TLFEA_MR_ENTRY_POINTS) as
// timed fastest on an H100 (PERF.md, Findings; `python -m
// tlfea_torch.tools.kernel_variants hv`); the persistent kernel, SVK and
// the phase ablation load where used. At FEAT10 in float32 the loading
// tile holds 233 registers: the compiler issues the point's 30 prep loads
// and the gradient loads of the contraction and the product early, to
// cover their latency, and keeps them live through the chain. That is one
// 160-thread block an SM, so the 10k flagship's 331 tiles ran in three
// waves. Streamed, those loads are copies; the chain reads shared memory
// where it needs a value, in 128 registers and no spill: three blocks an
// SM, one wave. A register cap alone (__launch_bounds__) spills and is
// slower.
template <typename T, class F, class M, bool STREAM = false>
__device__ __forceinline__ void hv_tile(const T* p, const int* __restrict__ conn_t,
                                        const T* prep, const T* __restrict__ gN_t,
                                        const T* __restrict__ dV_t, const T* __restrict__ Me_t,
                                        T* out, int E, int e0, T dt, const M& m, T* smem) {
  using L = HvSmem<T, F, M, STREAM>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = EX * NG;
  constexpr int D = L::STAGES, R = L::QP_ROWS;
  T* xs = smem;               // (S*3, EX): raw direction
  T* part = xs + S * 3 * EX;  // (NG*S*3, EX)
  const int x = threadIdx.x, g = threadIdx.y;
  const int e = e0 + x;
  const size_t sE = (size_t)E;
  PartialFor<T, F, S * 3> f(part + g * S * 3 * EX + x);
  T* mine = part + (L::PART + g * R) * EX + x;  // STREAM: this thread's column of stage 0
  // STREAM: round k's point q = k NG + g into stage k % D, then one commit
  // (empty past the last round or for a missing element), so that before
  // round k exactly D - 1 younger groups exist.
  auto issue = [&](int k) {
    if (e < E && k < L::ROUNDS) {
      const int q = k * NG + g;
      T* dst = mine + (k % D) * (NG * R * EX);
      const T* src = gN_t + (size_t)q * S * 3 * sE + e;
#pragma unroll
      for (int r = 0; r < S * 3; ++r) cp_async_word(dst + r * EX, src + r * sE);
      cp_async_word(dst + S * 3 * EX, dV_t + (size_t)q * sE + e);
      const T* pr = prep + (size_t)q * M::PR * sE + e;
#pragma unroll
      for (int r = 0; r < M::PR; ++r) cp_async_word(dst + (S * 3 + 1 + r) * EX, pr + r * sE);
    }
    cp_async_commit();
  };
  if constexpr (STREAM) {
#pragma unroll
    for (int k = 0; k < D; ++k) issue(k);
  }
  stage<T, F, 3, 0>(p, conn_t, E, e0, xs);
  __syncthreads();

  if (e < E) {
    const T* xe = xs + x;
    const T p0[3] = {xe[0], xe[EX], xe[2 * EX]};
#pragma unroll 1
    for (int q = g; q < Q; q += NG) {
      const int k = (q - g) / NG;  // the round
      const T* st = STREAM ? mine + (k % D) * (NG * R * EX) : nullptr;
      if constexpr (STREAM) cp_async_wait<D - 1>();
      T G[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) G[i][j] = T(0);
#pragma unroll
      for (int a = 1; a < S; ++a) {
        T pc[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pc[i] = trans_slot<F>(a) ? xe[(a * 3 + i) * EX] - p0[i] : xe[(a * 3 + i) * EX];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T gv = STREAM ? st[(a * 3 + j) * EX]
                              : gN_t[((size_t)(q * S + a) * 3 + j) * sE + e];
#pragma unroll
          for (int i = 0; i < 3; ++i) G[i][j] += pc[i] * gv;
        }
      }
      T dP[3][3];
      const T* pq = STREAM ? st + (S * 3 + 1) * EX : prep + (size_t)q * M::PR * sE + e;
      m.hv(G, pq, STREAM ? (size_t)EX : sE, dt, dP);
      const T w = STREAM ? st[S * 3 * EX] : dV_t[q * sE + e];
#pragma unroll
      for (int a = 0; a < S; ++a) {
        T g0, g1, g2;
        if constexpr (STREAM) {
          g0 = st[(a * 3) * EX], g1 = st[(a * 3 + 1) * EX], g2 = st[(a * 3 + 2) * EX];
        } else {
          const T* ga = gN_t + ((size_t)(q * S + a) * 3) * sE + e;
          g0 = ga[0], g1 = ga[sE], g2 = ga[2 * sE];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          f[a * 3 + i] += (dP[i][0] * g0 + dP[i][1] * g1 + dP[i][2] * g2) * w;
      }
      if constexpr (STREAM) issue(k + D);  // the stage is read: refill it
    }
  }
  if constexpr (STREAM) cp_async_wait<0>();  // no copy left in flight
  f.flush();
  __syncthreads();

  const T inv_dt = T(1) / dt;
  for (int t = g * EX + x; t < S * EX; t += NT) {
    const int a = t / EX, xx = t - a * EX, ee = e0 + xx;
    if (ee >= E) continue;
    T f[3] = {T(0), T(0), T(0)};
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] += part[((h * S + a) * 3 + i) * EX + xx];
    T m[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T me = Me_t[(a * S + b) * sE + ee];
#pragma unroll
      for (int i = 0; i < 3; ++i) m[i] += me * xs[(b * 3 + i) * EX + xx];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(a * 3 + i) * sE + ee] = f[i] + inv_dt * m[i];
  }
}

template <typename T, class F, class M, bool STREAM = false>
__global__ void __launch_bounds__(EX * F::NG)
hv_kernel(const T* __restrict__ p, const int* __restrict__ conn_t,
          const T* __restrict__ prep, const T* __restrict__ gN_t,
          const T* __restrict__ dV_t, const T* __restrict__ Me_t,
          T* __restrict__ out, int E, T dt, M m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  hv_tile<T, F, M, STREAM>(p, conn_t, prep, gN_t, dV_t, Me_t, out, E, blockIdx.x * EX, dt, m,
                           reinterpret_cast<T*>(smem_raw));
}

// One thread a quadrature point: K1, K2 and K5 where a mesh has few elements.
//
// In the tiles above a thread walks its Q / NG points in turn, and every
// point's chain waits on loads: at the 64-element ANCF3243 beam K1, K2 and K5
// launch 2 blocks of 4 warps, so 2 of 132 SMs work with one warp a
// sub-partition and nothing hides a stall. Each thread runs about ten
// dependent trips to L2 (conn, the gather, then each of its three points'
// shape gradients and volume, then Me) and three points' chains in turn:
// 5.5-6.3 us a launch against a 1.6-1.9 us empty launch and a 0.03-0.06 us
// bound on an H100 (PERF.md, Findings). Here a block takes TE elements and
// Q points: thread (x, q) runs point q of element e0 + x, one chain, on more
// SMs. With Hold::early it loads its point's operands (the S*3 gradient
// rows and the dV row, K2's PR prep rows, and as a reducer its slot's S Me
// rows) into registers before the block gathers conn -> packed, so they
// arrive while the gather resolves; with Hold::none it loads them where
// used. K1's point thread also writes its point's prep rows. `Direct`
// (below) drops the block's gather and its barrier: each point thread
// gathers its own element's slots. (`kernel_variants.cu` adds
// Hold::stream, the same loads copied into shared memory by cp.async: a
// Step-0 form that no instantiation ships.)
//
// The bits stay the parent's: the point thread writes its per-slot terms
// t_qai = P[i][0] g0 + P[i][1] g1 + P[i][2] g2 (the parent's expression)
// and its volume w_q into shared memory, and the thread that reduces
// (element, slot) replays the parent's order: for each group h of the
// parent's NG, f_h = 0, f_h += t_q w_q over q = h, h + NG, ...; then s = 0,
// s += f_h over h; then the mass term (K2: s + (1/dt) m). So the compiler
// fuses the same multiply-adds as in the parent.

// The parent layout (EX elements x NG groups of points) and the split (TE
// elements x Q points), a compile-time choice per kernel and instantiation
// (TLFEA_FAMILY_ENTRY_POINTS' K1_TILE, K2_TILE and K5_TILE,
// TLFEA_MR_ENTRY_POINTS' K2_TILE). The split runs for E <= MAX_E and the
// parent above: where the parent's tiles fill the card, its three points a
// thread cost less than the split's terms through shared memory (PERF.md,
// Findings: the crossover). `Groups` is also K3's parent layout
// (TLFEA_FAMILY_ENTRY_POINTS' K3_TILE; `Slots`, below, the other).
struct Groups {
  static constexpr bool SPLIT = false;
  static constexpr bool SLOTS = false;
};

template <int TE_, Hold HOLD_ = Hold::none, int MAX_E_ = 0x7fffffff, bool DIRECT_ = false>
struct Points {
  static constexpr bool SPLIT = true;
  static constexpr bool SLOTS = false;
  static constexpr int TE = TE_;
  static constexpr Hold HOLD = HOLD_;
  static constexpr int MAX_E = MAX_E_;
  static constexpr bool DIRECT = DIRECT_;
};

// The split in which each point thread gathers its own element's slots
// (below: no staging, one barrier).
template <int TE, Hold HOLD = Hold::none, int MAX_E = 0x7fffffff>
using Direct = Points<TE, HOLD, MAX_E, true>;

// Whether layout L launches the split at E elements.
template <class L>
constexpr bool split_at(int E) {
  if constexpr (L::SPLIT) return E <= L::MAX_E; else return false;
}

// A point thread's operands: its point's shape gradients and volume (and
// K2's PR prep rows), in registers (early) or in global memory (none).
// ROWS: the rows of the point's column of shared memory, col[r * TE] (its
// S*3 terms, then w); issued() and landed(): after the block's copies of
// operands are issued and before they are read (none here).
template <typename T, class F, int TE, Hold HOLD, int PR>
struct PointOperands {
  static_assert(HOLD == Hold::none || HOLD == Hold::early,
                "a point thread loads where used or early (stream: kernel_variants.cu)");
  static constexpr bool HELD = HOLD == Hold::early;
  static constexpr int ROWS = F::S * 3 + 1;
  T g[F::S][3], w, pr[PR > 0 ? PR : 1];
  const T* gq;  // the point's first gradient row at element e
  const T* dv;  // its volume
  const T* pq;  // its first prep row
  size_t sE;

  __device__ __forceinline__ PointOperands(const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                                           const T* prep, int q, int e, int E, T*)
      : sE((size_t)E) {
    gq = gN_t + (size_t)q * F::S * 3 * sE + e;
    dv = dV_t + (size_t)q * sE + e;
    pq = prep + (size_t)q * PR * sE + e;
    if (!HELD || e >= E) return;
#pragma unroll
    for (int a = 0; a < F::S; ++a)
#pragma unroll
      for (int j = 0; j < 3; ++j) g[a][j] = gq[(a * 3 + j) * sE];
    w = *dv;
#pragma unroll
    for (int r = 0; r < PR; ++r) pr[r] = pq[r * sE];
  }

  __device__ __forceinline__ T grad(int a, int j) const {
    return HELD ? g[a][j] : gq[(a * 3 + j) * sE];
  }
  __device__ __forceinline__ T vol() const { return HELD ? w : *dv; }
  // The material's dP from the point's prep rows (K2).
  template <class M>
  __device__ __forceinline__ void hv(const M& m, const T G[3][3], T dt, T dP[3][3]) const {
    if constexpr (HELD)
      m.hv(G, pr, 1, dt, dP);
    else
      m.hv(G, pq, sE, dt, dP);
  }
  __device__ static void issued() {}
  __device__ static void landed() {}
};

// The reducing thread's Me rows (slot a of element e), in registers
// (early) or read where used (none); ME: its rows of shared memory (none).
template <typename T, class F, int TE, Hold HOLD>
struct PointMass {
  static constexpr int ME = 0;
  T v[F::S];
  const T* row;  // Me row a*S at element e
  size_t sE;

  __device__ __forceinline__ PointMass(const T* __restrict__ Me_t, T*, int a, int, int e, int E,
                                       bool reduces)
      : row(Me_t + (size_t)a * F::S * E + e), sE((size_t)E) {
    if (HOLD == Hold::early && reduces)
#pragma unroll
      for (int b = 0; b < F::S; ++b) v[b] = row[b * sE];
  }
  __device__ __forceinline__ T operator()(int b) const {
    return HOLD == Hold::early ? v[b] : row[b * sE];
  }
};

// The split's shared memory, in rows of TE words: xs (S*CIN staged slot
// channels; none with DIRECT), each point's ROWS rows, then the reducers'
// ME Me rows.
template <typename T, class F, int TE, Hold HOLD, int CIN, int PR, bool DIRECT = false>
struct PointSmem {
  static_assert(F::S <= F::Q, "one reducing thread a (slot, element): S <= Q");
  static constexpr int XS = DIRECT ? 0 : F::S * CIN;
  static constexpr int ROWS = PointOperands<T, F, TE, HOLD, PR>::ROWS;
  static constexpr size_t BYTES =
      (size_t)(XS + F::Q * ROWS + PointMass<T, F, TE, HOLD>::ME) * TE * sizeof(T);
  static_assert(BYTES <= 232448, "the tile exceeds an H100 block's 227 KB of shared memory");
};

// Without DIRECT the block stages its elements' slot channels into shared
// memory (`stage`) and waits at a barrier before any point runs. With
// DIRECT thread (x, q) loads its element's S node indices from conn_t and
// gathers the channels of its point's contraction into registers itself,
// centred as `stage` centres them (the same subtraction, so the same bits);
// as the reducer of (slot q, element x) (tid / TE is q, so a reducer's
// element is its point's) it holds the channels of its mass term too: K1
// and K5 the raw dv/dt, K2 the raw direction its contraction reads anyway.
// Its loads then wait on no other thread, and one barrier is left, the one
// before the reduce. It gathers 8 times the words `stage` gives a thread,
// from L2, and holds them: 128 registers in float32 at ANCF3243 where the
// staging K1 holds 64-72 (PERF.md, Findings).

// The point's terms t_ai = P[i][0] g0 + P[i][1] g1 + P[i][2] g2 and its
// volume w into its rows at tq[r * TE] (term (a, i) at row a*3 + i, w at row
// S*3). Where those rows hold the point's copied gradients (the stream
// form), slot a's three are read before its terms overwrite them.
template <typename T, class F, int TE, Hold HOLD, int PR>
__device__ __forceinline__ void point_terms(const PointOperands<T, F, TE, HOLD, PR>& o,
                                            const T P[3][3], T w, T* tq) {
#pragma unroll
  for (int a = 0; a < F::S; ++a) {
    const T g0 = o.grad(a, 0), g1 = o.grad(a, 1), g2 = o.grad(a, 2);
    T t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = P[i][0] * g0 + P[i][1] * g1 + P[i][2] * g2;
#pragma unroll
    for (int i = 0; i < 3; ++i) tq[(a * 3 + i) * TE] = t[i];
  }
  tq[F::S * 3 * TE] = w;
}

// The reduce of (slot a, element x): the parent's sum of its NG partials
// in its order, from the points' terms (point q's rows at terms[q * ROWS *
// TE], column x), then the consistent mass term over the slots' channels
// xb(b, i) with the Me rows me(b); out = s + m, or s + scale * m if SCALED
// (K2's 1/dt).
template <typename T, class F, int TE, int ROWS, bool SCALED, class ME, class XB>
__device__ __forceinline__ void point_reduce(const T* terms, int a, int x, const ME& me,
                                             const XB& xb, T scale, T* out, size_t sE, int e) {
  constexpr int S = F::S, Q = F::Q, NG = F::NG;
  T f[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int h = 0; h < NG; ++h) {
    T fh[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int q = h; q < Q; q += NG) {
      const T* tq = terms + q * ROWS * TE + x;
      const T w = tq[S * 3 * TE];
#pragma unroll
      for (int i = 0; i < 3; ++i) fh[i] += tq[(a * 3 + i) * TE] * w;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) f[i] += fh[i];
  }
  T m[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int b = 0; b < S; ++b) {
    const T mb = me(b);
#pragma unroll
    for (int i = 0; i < 3; ++i) m[i] += mb * xb(b, i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if constexpr (SCALED)
      out[(a * 3 + i) * sE + e] = f[i] + scale * m[i];
    else
      out[(a * 3 + i) * sE + e] = f[i] + m[i];
  }
}

// K1 and K5 split (layout Points<TE, HOLD, MAX_E, DIRECT>):
// primal_prep_tile's f_e in its arithmetic and order, so K5 (PREP = false:
// `prep` is not touched) equals K1's fe bit for bit. With PREP the point
// thread also writes its point's PR prep rows, prep[(q*PR + r) * E + e], as
// primal_prep_tile does: a warp (TE = 8: 8 elements x 4 points) stores each
// row as four 32-byte sectors in float32. smem holds PointSmem<T, F, TE,
// HOLD, 9, 0, DIRECT>.
template <typename T, class F, class M, bool PREP, int TE, Hold HOLD, bool DIRECT>
__global__ void __launch_bounds__(TE * F::Q)
primal_points_kernel(const T* __restrict__ packed, const int* __restrict__ conn_t,
                     const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                     const T* __restrict__ Me_t, T* __restrict__ fe, T* __restrict__ prep,
                     int E, M m) {
  using O = PointOperands<T, F, TE, HOLD, 0>;
  constexpr int S = F::S, NT = TE * F::Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (S*9, TE): centred u | centred v | dv (staged)
  T* pts = xs + PointSmem<T, F, TE, HOLD, 9, 0, DIRECT>::XS * TE;  // (Q * ROWS, TE)
  T* mes = pts + F::Q * O::ROWS * TE;                              // (ME, TE)
  const int x = threadIdx.x, q = threadIdx.y, tid = q * TE + x;
  const int e0 = blockIdx.x * TE, e = e0 + x;
  const size_t sE = (size_t)E;
  const int ra = tid / TE, rx = tid - ra * TE, re = e0 + rx;  // the reducer's (slot, element)
  const bool reduces = ra < S && re < E;
  T* tq = pts + q * O::ROWS * TE + x;  // this point's rows
  const O o(gN_t, dV_t, nullptr, q, e, E, tq);
  const PointMass<T, F, TE, HOLD> me(Me_t, mes, ra, rx, re, E, reduces);
  O::issued();
  const T* pa[DIRECT ? S : 1];  // DIRECT: the element's slot rows of packed
  T dv[DIRECT ? S : 1][3];      // DIRECT: the reducer's raw dv/dt, slot by slot
  if constexpr (DIRECT) {
    if (e < E) {
#pragma unroll
      for (int a = 0; a < S; ++a) pa[a] = packed + (size_t)conn_t[a * sE + e] * 9;
      if (reduces)
#pragma unroll
        for (int b = 0; b < S; ++b)
#pragma unroll
          for (int i = 0; i < 3; ++i) dv[b][i] = pa[b][6 + i];
    }
  } else {
    stage<T, F, 9, 6, 9, TE, NT>(packed, conn_t, E, e0, xs);
  }
  O::landed();
  if constexpr (!DIRECT) __syncthreads();

  if (e < E) {
    const T* xe = xs + x;
    T Du[3][3], Fd[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Du[i][j] = Fd[i][j] = T(0);
#pragma unroll
    for (int a = 1; a < S; ++a) {  // centred slot 0 is zero
      T ua[3], va[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if constexpr (DIRECT) {
          const bool tr = trans_slot<F>(a);
          ua[i] = tr ? pa[a][i] - pa[0][i] : pa[a][i];
          va[i] = tr ? pa[a][3 + i] - pa[0][3 + i] : pa[a][3 + i];
        } else {
          ua[i] = xe[(a * 9 + i) * TE];
          va[i] = xe[(a * 9 + 3 + i) * TE];
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T gv = o.grad(a, j);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          Du[i][j] += ua[i] * gv;
          Fd[i][j] += va[i] * gv;
        }
      }
    }
    T P[3][3];
    T* pq = nullptr;
    if constexpr (PREP) pq = prep + (size_t)q * M::PR * sE + e;
    m.template primal<PREP>(Du, Fd, P, pq, sE);
    point_terms(o, P, o.vol(), tq);
  }
  __syncthreads();

  if (reduces) {
    auto xb = [&](int b, int i) {
      if constexpr (DIRECT)
        return dv[b][i];
      else
        return xs[(b * 9 + 6 + i) * TE + rx];
    };
    point_reduce<T, F, TE, O::ROWS, false>(pts, ra, rx, me, xb, T(1), fe, sE, re);
  }
}

// K2 split (layout Points<TE, HOLD, MAX_E, DIRECT>): hv_tile's
// Hessian-vector product in its arithmetic and order. smem holds
// PointSmem<T, F, TE, HOLD, 3, M::PR, DIRECT>.
template <typename T, class F, class M, int TE, Hold HOLD, bool DIRECT>
__global__ void __launch_bounds__(TE * F::Q)
hv_points_kernel(const T* __restrict__ p, const int* __restrict__ conn_t,
                 const T* __restrict__ prep, const T* __restrict__ gN_t,
                 const T* __restrict__ dV_t, const T* __restrict__ Me_t, T* __restrict__ out,
                 int E, T dt, M m) {
  using O = PointOperands<T, F, TE, HOLD, M::PR>;
  constexpr int S = F::S, NT = TE * F::Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (S*3, TE): raw direction (staged)
  T* pts = xs + PointSmem<T, F, TE, HOLD, 3, M::PR, DIRECT>::XS * TE;  // (Q * ROWS, TE)
  T* mes = pts + F::Q * O::ROWS * TE;                                  // (ME, TE)
  const int x = threadIdx.x, q = threadIdx.y, tid = q * TE + x;
  const int e0 = blockIdx.x * TE, e = e0 + x;
  const size_t sE = (size_t)E;
  const int ra = tid / TE, rx = tid - ra * TE, re = e0 + rx;
  const bool reduces = ra < S && re < E;
  T* tq = pts + q * O::ROWS * TE + x;
  const O o(gN_t, dV_t, prep, q, e, E, tq);
  const PointMass<T, F, TE, HOLD> me(Me_t, mes, ra, rx, re, E, reduces);
  O::issued();
  T xr[DIRECT ? S : 1][3];  // DIRECT: the element's raw direction, slot by slot
  if constexpr (DIRECT) {
    if (e < E)
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const T* pa = p + (size_t)conn_t[a * sE + e] * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) xr[a][i] = pa[i];
      }
  } else {
    stage<T, F, 3, 0, 3, TE, NT>(p, conn_t, E, e0, xs);
  }
  O::landed();
  if constexpr (!DIRECT) __syncthreads();

  if (e < E) {
    const T* xe = xs + x;
    auto slot = [&](int a, int i) {
      if constexpr (DIRECT)
        return xr[a][i];
      else
        return xe[(a * 3 + i) * TE];
    };
    const T p0[3] = {slot(0, 0), slot(0, 1), slot(0, 2)};
    T G[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) G[i][j] = T(0);
#pragma unroll
    for (int a = 1; a < S; ++a) {
      T pc[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) pc[i] = trans_slot<F>(a) ? slot(a, i) - p0[i] : slot(a, i);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T gv = o.grad(a, j);
#pragma unroll
        for (int i = 0; i < 3; ++i) G[i][j] += pc[i] * gv;
      }
    }
    T dP[3][3];
    o.hv(m, G, dt, dP);
    point_terms(o, dP, o.vol(), tq);
  }
  __syncthreads();

  if (reduces) {
    auto xb = [&](int b, int i) {
      if constexpr (DIRECT)
        return xr[b][i];
      else
        return xs[(b * 3 + i) * TE + rx];
    };
    point_reduce<T, F, TE, O::ROWS, true>(pts, ra, rx, me, xb, T(1) / dt, out, sE, re);
  }
}

// K3: per-(element, slot) SVK diagonal tangent blocks, sum_q K(F_q, h_qa) dV_q,
// packed SYM6 (the caller applies the uniform dt weight). Runs once per
// preconditioner refresh; SYM6 writes 6 channels instead of 9. This is the
// parent layout (`Groups`); `Slots` (below) the other.
template <typename T, class F>
__global__ void __launch_bounds__(EX * F::NG)
svk_blocks_kernel(const T* __restrict__ u, const int* __restrict__ conn_t,
                  const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                  T* __restrict__ out, int E, T lam, T mu) {
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = EX * NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (S*3, EX): centred u
  T* part = xs + S * 3 * EX;               // (NG*S*6, EX)
  const int x = threadIdx.x, g = threadIdx.y;
  const int e0 = blockIdx.x * EX, e = e0 + x;
  const size_t sE = (size_t)E;
  PartialFor<T, F, S * 6> acc(part + g * S * 6 * EX + x);
  stage<T, F, 3, 3>(u, conn_t, E, e0, xs);
  __syncthreads();

  if (e < E) {
    const T* xe = xs + x;
#pragma unroll 1
    for (int q = g; q < Q; q += NG) {
      T F_[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) F_[i][j] = T(0);
#pragma unroll
      for (int a = 1; a < S; ++a) {
        T ua[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) ua[i] = xe[(a * 3 + i) * EX];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T gv = gN_t[((size_t)(q * S + a) * 3 + j) * sE + e];
#pragma unroll
          for (int i = 0; i < 3; ++i) F_[i][j] += ua[i] * gv;
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) F_[i][i] += T(1);
      T trFtF = T(0), FFT[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          trFtF += F_[i][j] * F_[i][j];
          FFT[i][j] = F_[i][0] * F_[j][0] + F_[i][1] * F_[j][1] + F_[i][2] * F_[j][2];
        }
      }
      const T trE = T(0.5) * (trFtF - T(3));
      const T w = dV_t[q * sE + e];
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const T* ga = gN_t + ((size_t)(q * S + a) * 3) * sE + e;
        const T h[3] = {ga[0], ga[sE], ga[2 * sE]};
        T K[6];
        svk_diag_block(F_, FFT, trE, h, lam, mu, K);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[a * 6 + c] += K[c] * w;
      }
    }
  }
  acc.flush();
  __syncthreads();

  for (int t = g * EX + x; t < S * 6 * EX; t += NT) {
    const int r = t / EX, xx = t - r * EX, ee = e0 + xx;
    if (ee >= E) continue;
    T sum = T(0);
    for (int h = 0; h < NG; ++h) sum += part[(h * S * 6 + r) * EX + xx];
    out[r * sE + ee] = sum;
  }
}

// K3 with one thread an (element, slot): layout Slots<TE, NQ>.
//
// In the parent tile thread (x, g) walks the points q = g, g + NG, ... of
// element x, and for each point computes F, then K for all S slots and adds
// them into S*6 sums; at the shell (S = 16, 96 sums) the sums live in
// shared memory, so every point costs a thread 96 shared read-modify-writes,
// and no point's gradient loads are issued before the previous point's
// chain and stores end: at 254 registers (float32) two blocks fit an SM, the
// 5,184-element shell moves its 47.8 MB of gradients at 1.2 TB/s, and its
// 162 tiles leave 30 SMs with two (PERF.md, Findings).
//
// Here a block takes TE elements and S slots, TE * S threads (TE * NQ where a
// chunk holds more points than there are slots, slot_rows): thread (x, a)
// owns slot a of element e0 + x, and its 6 block entries for each of the NG
// groups stay in registers (NG * 6 sums). The block walks its Q points in
// chunks of NQ. One asynchronous copy by the whole block brings a chunk's
// NQ * S*3 gradient rows and its NQ dV rows for the tile's TE columns into
// shared memory (16-byte cp.async where every row segment is whole and
// aligned, else a word at a time), double-buffered: chunk k + 1 is in
// flight while chunk k is computed, and each gradient byte leaves HBM once.
// Where one chunk holds all Q points (FEAT10, Slots<16, 5>) the block has
// one buffer (SlotSmem::NBUF): no next chunk exists to overlap, and the
// blocks resident on an SM overlap one another's copies instead. At FEAT10
// the parent tile held 167 registers in float32, 2 blocks an SM, and the
// 10k flagship's 331 tiles took 2 waves; Slots<16, 5> holds 56, 7 blocks
// an SM, one wave of 662 blocks: 10.12 -> 6.93 us (float64 16.00 -> 10.88;
// fem_kernels.cu, PERF.md, Findings).
// Phase A: thread (x, t), t < NQ, computes point k NQ + t's F, FFT and trE
// (svk_point) into shared memory. Phase B: thread (x, a), a < S, reads its
// slot's h and the point's F, FFT, trE and w, runs `svk_diag_block` and adds
// K[c] w into its sums of group q mod NG, q ascending. At the end it writes
// ((0 + s_0) + s_1) + ... + s_{NG-1}, the parent's reduce. So every entry
// takes the parent's operations in the parent's order: the same bits.
//
// MAX_E: the layout launches on meshes of up to MAX_E elements and the
// parent tile above (a gate at a measured crossover; by default every E).
template <int TE_, int NQ_, int MAX_E_ = 0x7fffffff>
struct Slots {
  static constexpr bool SPLIT = false;
  static constexpr bool SLOTS = true;
  static constexpr int TE = TE_;
  static constexpr int NQ = NQ_;
  static constexpr int MAX_E = MAX_E_;
};

// Whether layout L launches one thread an (element, slot) on E elements.
template <class L>
constexpr bool slots_at(int E) {
  if constexpr (L::SLOTS) return E <= L::MAX_E; else return false;
}

// The y extent of a slot layout's block: S slot rows, or NQ where a chunk
// holds more points than the element has slots (the ANCF3243 beam's one
// chunk of all 12 points, S = 8), so that phase A still takes one thread a
// point; rows a >= S then own no slot and sit out phase B.
template <class F, int NQ>
__host__ __device__ constexpr int slot_rows() {
  return NQ > F::S ? NQ : F::S;
}

// The slot kernel's shared memory: xs (S*3 rows of TE words: the staged,
// centred u); NBUF buffers of NQ points of QP_ROWS rows (the point's S*3
// gradient rows, then its dV row) of TE words; then NQ * TE point records
// of PT words (F 9, the upper FFT 6, trE; padded so that a record starts on
// 16 bytes and eight records hit distinct banks when read 16 bytes at a
// time). Two buffers when the tile walks more than one chunk, so that the
// next is in flight while one is computed; one when a chunk holds all Q
// points (FEAT10's NQ = Q = 5), since no next chunk exists to overlap.
template <typename T, class F, int TE, int NQ>
struct SlotSmem {
  static_assert(F::Q % NQ == 0 && NQ % F::NG == 0 && NQ <= F::Q,
                "chunks of whole groups of points, each point one thread of phase A");
  static constexpr int QP_ROWS = F::S * 3 + 1;
  static constexpr int PT = 16 + 16 / (int)sizeof(T);
  static constexpr int XS = F::S * 3 * TE;
  static constexpr int NBUF = F::Q / NQ > 1 ? 2 : 1;
  static constexpr int BUF = NQ * QP_ROWS * TE;
  static constexpr int PTS = NQ * TE * PT;
  static_assert(XS % (16 / (int)sizeof(T)) == 0 && BUF % (16 / (int)sizeof(T)) == 0,
                "16-byte aligned buffers and records");
  static constexpr size_t BYTES = (size_t)(XS + NBUF * BUF + PTS) * sizeof(T);
  static_assert(BYTES <= 232448, "the tile exceeds an H100 block's 227 KB of shared memory");
};

// N values of shared memory at p (16-byte aligned), 16 bytes a load.
template <typename T, int N>
__device__ __forceinline__ void lds16(const T* p, T* v) {
  static_assert(N % (16 / sizeof(T)) == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N; i += 16 / (int)sizeof(T)) {
    if constexpr (sizeof(T) == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    } else {
      const double2 t = *reinterpret_cast<const double2*>(p + i);
      v[i] = t.x, v[i + 1] = t.y;
    }
  }
}

// N values into shared memory at p (16-byte aligned), 16 bytes a store.
template <typename T, int N>
__device__ __forceinline__ void sts16(T* p, const T* v) {
  static_assert(N % (16 / sizeof(T)) == 0, "whole 16-byte stores");
#pragma unroll
  for (int i = 0; i < N; i += 16 / (int)sizeof(T)) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    else
      *reinterpret_cast<double2*>(p + i) = make_double2(v[i], v[i + 1]);
  }
}

// The slot kernels' copy (K3's svk_slots_kernel, K5t's
// contrib_tangent_slots_kernel): chunk k of the tile's points, NQ points of
// R = S*3 + 1 rows (the point's S*3 gradient rows, then its dV row) for the
// TE columns e0 .. e0 + TE - 1, into rows of TE words at dst, by the block's
// NT threads (thread tid), then one commit. 16 bytes a copy where the tile
// is whole and every row segment starts on 16 bytes, else word by word for
// the tile's elements.
template <typename T, class F, int TE, int NQ, int NT>
struct SlotChunks {
  static constexpr int S = F::S, R = F::S * 3 + 1;
  static constexpr int V = 16 / (int)sizeof(T);  // words a 16-byte copy
  const T* gN_t;
  const T* dV_t;
  size_t sE;
  int e0, ne;
  bool vec;
  __device__ __forceinline__ SlotChunks(const T* g, const T* d, int E, int e0_)
      : gN_t(g), dV_t(d), sE((size_t)E), e0(e0_), ne(E - e0_ < TE ? E - e0_ : TE) {
    vec = ne == TE && TE % V == 0 && (sE * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(g) % 16 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  }
  __device__ __forceinline__ void issue(T* dst, int k, int tid) const {
    auto src = [&](int row, int c) {  // row t * R + r of the chunk, element e0 + c
      const int t = row / R, r = row - t * R, q = k * NQ + t;
      return r < S * 3 ? gN_t + ((size_t)q * S * 3 + r) * sE + e0 + c
                       : dV_t + (size_t)q * sE + e0 + c;
    };
    if (vec) {
      for (int i = tid; i < NQ * R * (TE / V); i += NT) {
        const int row = i / (TE / V), c = (i - row * (TE / V)) * V;
        cp_async_16(dst + row * TE + c, src(row, c));
      }
    } else {
      for (int i = tid; i < NQ * R * TE; i += NT) {
        const int row = i / TE, c = i - row * TE;
        if (c < ne) cp_async_word(dst + row * TE + c, src(row, c));
      }
    }
    cp_async_commit();
  }
};

// A point's F = I + sum_{a >= 1} u_a (x) gradN_qa, F F^T and tr E, in
// svk_blocks_kernel's expressions and order: u_a[i] at xe[(a*3 + i) * xst]
// (staged, centred), gradN_qa[j] at gq[(a*3 + j) * gst].
template <typename T, class F, typename GS>
__device__ __forceinline__ void svk_point(const T* xe, int xst, const T* gq, GS gst, T F_[3][3],
                                          T FFT[3][3], T& trE) {
  constexpr int S = F::S;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F_[i][j] = T(0);
#pragma unroll
  for (int b = 1; b < S; ++b) {
    T ua[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ua[i] = xe[(b * 3 + i) * xst];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T gv = gq[(b * 3 + j) * gst];
#pragma unroll
      for (int i = 0; i < 3; ++i) F_[i][j] += ua[i] * gv;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) F_[i][i] += T(1);
  T trFtF = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      trFtF += F_[i][j] * F_[i][j];
      FFT[i][j] = F_[i][0] * F_[j][0] + F_[i][1] * F_[j][1] + F_[i][2] * F_[j][2];
    }
  }
  trE = T(0.5) * (trFtF - T(3));
}

// Phase A's record of a point at pt: F (9), the upper FFT (6), trE.
template <typename T>
__device__ __forceinline__ void svk_point_record(const T F_[3][3], const T FFT[3][3], T trE,
                                                 T* pt) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) pt[i * 3 + j] = F_[i][j];
  pt[9] = FFT[0][0], pt[10] = FFT[0][1], pt[11] = FFT[0][2];
  pt[12] = FFT[1][1], pt[13] = FFT[1][2], pt[14] = FFT[2][2];
  pt[15] = trE;
}

// Phase B's K of slot h at the point recorded at pt (16-byte aligned).
template <typename T>
__device__ __forceinline__ void svk_slot_block(const T* pt, const T h[3], T lam, T mu, T K[6]) {
  T v[16];
  lds16<T, 16>(pt, v);
  const T F_[3][3] = {{v[0], v[1], v[2]}, {v[3], v[4], v[5]}, {v[6], v[7], v[8]}};
  const T FFT[3][3] = {{v[9], v[10], v[11]}, {v[10], v[12], v[13]}, {v[11], v[13], v[14]}};
  svk_diag_block(F_, FFT, v[15], h, lam, mu, K);
}

template <typename T, class F, int TE, int NQ>
__global__ void __launch_bounds__((TE * slot_rows<F, NQ>()))
svk_slots_kernel(const T* __restrict__ u, const int* __restrict__ conn_t,
                 const T* __restrict__ gN_t, const T* __restrict__ dV_t, T* __restrict__ out,
                 int E, T lam, T mu) {
  using L = SlotSmem<T, F, TE, NQ>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = TE * slot_rows<F, NQ>(), R = L::QP_ROWS;
  constexpr int PT = L::PT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (S*3, TE): centred u
  T* buf = xs + L::XS;                     // (NBUF, NQ, QP_ROWS, TE)
  T* pts = buf + L::NBUF * L::BUF;         // (NQ, TE, PT)
  const int x = threadIdx.x, a = threadIdx.y, tid = a * TE + x;
  const int e0 = blockIdx.x * TE, e = e0 + x;
  const bool owns = slot_rows<F, NQ>() == S || a < S;  // row a owns slot a
  const size_t sE = (size_t)E;
  const SlotChunks<T, F, TE, NQ, NT> chunks(gN_t, dV_t, E, e0);
  auto issue = [&](int k) { chunks.issue(buf + (k & 1) * L::BUF, k, tid); };  // into buffer k % 2
  issue(0);
  stage<T, F, 3, 3, 3, TE, NT>(u, conn_t, E, e0, xs);

  T acc[NG][6];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[h][c] = T(0);
#pragma unroll 1
  for (int k = 0; k < Q / NQ; ++k) {
    cp_async_wait<0>();  // this thread's copies of chunk k
    // Chunk k in place for all; everyone done with chunk k - 1's buffer and
    // point records (and, at k = 0, xs staged).
    __syncthreads();
    if (k + 1 < Q / NQ) issue(k + 1);
    const T* cb = buf + (k & 1) * L::BUF + x;  // this element's column of chunk k
    if (a < NQ && e < E) {  // phase A: point k NQ + a of element x
      T F_[3][3], FFT[3][3], trE;
      svk_point<T, F>(xs + x, TE, cb + a * R * TE, TE, F_, FFT, trE);
      svk_point_record(F_, FFT, trE, pts + (a * TE + x) * PT);
    }
    __syncthreads();
    if (owns && e < E) {  // phase B: slot a of element x at the chunk's points
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        T h[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) h[j] = cb[(t * R + a * 3 + j) * TE];
        const T w = cb[(t * R + S * 3) * TE];
        T K[6];
        svk_slot_block(pts + (t * TE + x) * PT, h, lam, mu, K);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[t % NG][c] += K[c] * w;  // q % NG == t % NG
      }
    }
  }
  if (owns && e < E) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      T sum = T(0);
#pragma unroll
      for (int h = 0; h < NG; ++h) sum += acc[h][c];
      out[(a * 6 + c) * sE + e] = sum;
    }
  }
}

// K5t with one thread an (element, slot): layout Slots<TE, NQ>.
//
// In the parent tile (contrib_tangent_kernel) thread (x, g) walks the points
// q = g, g + NG, ... of element x; for each it runs the four contractions,
// reading the point's gradients from global memory, and the material's
// tangent, then reloads the gradients and adds S*3 products into its sums.
// At the shell (S = 16, Q = 48) the float32 tile holds 255 registers (with
// Mooney-Rivlin it spills), two blocks an SM; no point's loads are issued
// before the previous point's chain ends, and the 5,184-element shell's 162
// tiles leave 30 SMs with two (PERF.md, Findings).
//
// Here, as K3's svk_slots_kernel, a block takes TE elements and S slots, TE
// * S threads (TE * NQ where NQ > S, slot_rows), and walks its Q points in
// chunks of NQ, each chunk's gradient and dV rows brought into shared memory
// by one asynchronous copy of the block (SlotChunks), double-buffered. Phase
// A: thread (x, t), t < NQ, runs the parent's four contractions for point k
// NQ + t of element x on the chunk, then the material's tangent, and records
// dP in shared memory. Phase B: thread (x, a), a < S, reads its slot's
// gradient rows and w from the chunk and the point's dP, and adds (dP[i][0]
// g0 + dP[i][1] g1 + dP[i][2] g2) w into its 3 sums of group q mod NG, q
// ascending. At the end it replays tangent_reduce for its slot: the groups'
// sums in the order g = 0..NG-1, plus the consistent mass on the staged
// d(dv/dt). So every output takes the parent's operations in the parent's
// order. The shell's
// instantiations pick TE, NQ and a gate as timed on an H100
// (fem_ancf3443.cu, fem_ancf3443_mr.cu); FEAT10 with SVK takes Slots<16, 5>,
// one chunk of all 5 points in one buffer, at every E (fem_kernels.cu: 168
// registers, 2 blocks an SM and 2 waves of 331 tiles at the 10k flagship ->
// 56 registers, 7 blocks an SM, one wave of 662 blocks; float32 11.96 ->
// 9.99 us, float64 21.48 -> 16.73).
//
// Its shared memory: xt (S*9 rows of TE words: the staged tangent), xp (S*6
// rows: the staged primal u | v), NBUF buffers of NQ points of QP_ROWS rows
// of TE words (two, or one when a chunk holds all Q points, as SlotSmem),
// then NQ * TE records of PT words (dP, padded so that a record starts on
// 16 bytes).
template <typename T, class F, int TE, int NQ>
struct TangentSlotSmem {
  static_assert(F::Q % NQ == 0 && NQ % F::NG == 0 && NQ <= F::Q,
                "chunks of whole groups of points, each point one thread of phase A");
  static constexpr int V = 16 / (int)sizeof(T);  // words in 16 bytes
  static constexpr int QP_ROWS = F::S * 3 + 1;
  static constexpr int PT = (9 + V - 1) / V * V;
  static constexpr int XT = F::S * 9 * TE;
  static constexpr int XP = F::S * 6 * TE;
  static constexpr int NBUF = F::Q / NQ > 1 ? 2 : 1;
  static constexpr int BUF = NQ * QP_ROWS * TE;
  static constexpr int PTS = NQ * TE * PT;
  static_assert((XT + XP) % V == 0 && BUF % V == 0, "16-byte aligned buffers");
  static constexpr size_t BYTES = (size_t)(XT + XP + NBUF * BUF + PTS) * sizeof(T);
  static_assert(BYTES <= 232448, "the tile exceeds an H100 block's 227 KB of shared memory");
};

template <typename T, class F, class M, int TE, int NQ>
__global__ void __launch_bounds__((TE * slot_rows<F, NQ>()))
contrib_tangent_slots_kernel(const T* __restrict__ packed, const T* __restrict__ dpacked,
                             const int* __restrict__ conn_t, const T* __restrict__ gN_t,
                             const T* __restrict__ dV_t, const T* __restrict__ Me_t,
                             T* __restrict__ out, int E, M m) {
  using L = TangentSlotSmem<T, F, TE, NQ>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = TE * slot_rows<F, NQ>(), R = L::QP_ROWS;
  constexpr int PT = L::PT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xt = reinterpret_cast<T*>(smem_raw);  // (S*9, TE): tangent du | dv | d(dv/dt)
  T* xp = xt + L::XT;                      // (S*6, TE): primal u | v
  T* buf = xp + L::XP;                     // (NBUF, NQ, QP_ROWS, TE)
  T* pts = buf + L::NBUF * L::BUF;         // (NQ, TE, PT): dP
  const int x = threadIdx.x, a = threadIdx.y, tid = a * TE + x;
  const int e0 = blockIdx.x * TE, e = e0 + x;
  const bool owns = slot_rows<F, NQ>() == S || a < S;  // row a owns slot a
  const size_t sE = (size_t)E;
  const SlotChunks<T, F, TE, NQ, NT> chunks(gN_t, dV_t, E, e0);
  chunks.issue(buf, 0, tid);
  stage<T, F, 9, 6, 9, TE, NT>(dpacked, conn_t, E, e0, xt);
  stage<T, F, 6, 6, 9, TE, NT>(packed, conn_t, E, e0, xp);

  T acc[NG][3];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[h][i] = T(0);
#pragma unroll 1
  for (int k = 0; k < Q / NQ; ++k) {
    cp_async_wait<0>();  // this thread's copies of chunk k
    // Chunk k in place for all; everyone done with chunk k - 1's buffer and
    // dP records (and, at k = 0, xt and xp staged).
    __syncthreads();
    if (k + 1 < Q / NQ) chunks.issue(buf + ((k + 1) & 1) * L::BUF, k + 1, tid);
    const T* cb = buf + (k & 1) * L::BUF + x;  // this element's column of chunk k
    if (a < NQ && e < E) {  // phase A: point k NQ + a of element x
      const T* gq = cb + a * R * TE;
      T dF[3][3], dFd[3][3], Du[3][3], Fd[3][3];
      contract<T, F, 0, 9, TE>(xt + x, gq, 0, TE, 0, dF);
      contract<T, F, 3, 9, TE>(xt + x, gq, 0, TE, 0, dFd);
      contract<T, F, 0, 6, TE>(xp + x, gq, 0, TE, 0, Du);
      contract<T, F, 3, 6, TE>(xp + x, gq, 0, TE, 0, Fd);
      T dP[3][3];
      m.tangent(Du, dF, Fd, dFd, dP);
      T v[PT] = {};  // dP, then the padding
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[i * 3 + j] = dP[i][j];
      sts16<T, PT>(pts + (a * TE + x) * PT, v);
    }
    __syncthreads();
    if (owns && e < E) {  // phase B: slot a of element x at the chunk's points
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        const T* gq = cb + t * R * TE;
        const T g0 = gq[(a * 3) * TE], g1 = gq[(a * 3 + 1) * TE], g2 = gq[(a * 3 + 2) * TE];
        const T w = gq[S * 3 * TE];
        T dP[PT];
        lds16<T, PT>(pts + (t * TE + x) * PT, dP);
#pragma unroll
        for (int i = 0; i < 3; ++i)  // q % NG == t % NG
          acc[t % NG][i] += (dP[i * 3] * g0 + dP[i * 3 + 1] * g1 + dP[i * 3 + 2] * g2) * w;
      }
    }
  }
  if (owns && e < E) {  // tangent_reduce's sums for slot a of element x
    T s[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int i = 0; i < 3; ++i) s[i] += acc[h][i];
    T mm[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T me = Me_t[(a * S + b) * sE + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) mm[i] += me * xt[(b * 9 + 6 + i) * TE + x];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(a * 3 + i) * sE + e] = s[i] + mm[i];
  }
}

// K4 walks a node's incidences in batches: the batch's indices are loaded
// together, then all their values, and only then added in order.
constexpr int K4_BATCH = 8;

// K4's sums for G channels c0 .. c0 + G - 1 of node nd (acc[0..G)): over
// the node's incidences (a, e), in the fixed order of the host-built CSR
// list, of vals[(a*C + c) * E + e]; inc[k] = a * E + e. The adds run in CSR
// order from T(0), as a one-by-one walk would, so the bits depend on neither
// NB nor G; one index load serves the G value loads of an incidence.
template <typename T, int G, int NB = K4_BATCH>
__device__ __forceinline__ void node_sums(const T* vals, const int* __restrict__ ptr,
                                          const int* __restrict__ inc, int nd, int c0, int E,
                                          int C, T acc[G]) {
#pragma unroll
  for (int c = 0; c < G; ++c) acc[c] = T(0);
  const int k1 = ptr[nd + 1];
  for (int k0 = ptr[nd]; k0 < k1; k0 += NB) {
    int i[NB];
    T v[NB][G];
#pragma unroll
    for (int j = 0; j < NB; ++j) i[j] = k0 + j < k1 ? inc[k0 + j] : -1;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int a = i[j] / E;
      const T* src = vals + ((size_t)a * C + c0) * E + (i[j] - a * E);
#pragma unroll
      for (int c = 0; c < G; ++c) v[j][c] = i[j] >= 0 ? src[(size_t)c * E] : T(0);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (k0 + j < k1) {
#pragma unroll
        for (int c = 0; c < G; ++c) acc[c] += v[j][c];
      }
  }
}

// K4: out[node, c0 .. c0 + G) = node_sums(node, c0), one thread per node
// and group of G channels (C / G threads a node). A fixed order instead of
// atomics keeps float32 sums bitwise repeatable. Bound by latency and load
// count, not bytes: each thread walks its node's dependent, uncoalesced
// loads (inc[k], then the G values it points at); FEAT10 nodes have 5.5
// (1k box) to 6.4 (10k) incidences on average and at most 24, an ANCF
// coefficient row at most 4. With G = 3 one index load serves 3 channels,
// and a third of the threads walk: on an H100 4.74 us at 10k (C = 3)
// against 6.45-6.84 us for G = 1 at any batch, and 5.62 against 8.34 at C =
// 6, where one thread for all six channels took 8.0 (tools/kernel_variants
// k4, PERF.md).
template <typename T, int G, int NB = K4_BATCH>
__global__ void __launch_bounds__(THREADS)
node_reduce_kernel(const T* __restrict__ vals, const int* __restrict__ ptr,
                   const int* __restrict__ inc, T* __restrict__ out, int n, int E, int C) {
  const int groups = C / G;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * groups) return;
  const int nd = t / groups, c0 = (t - nd * groups) * G;
  T acc[G];
  node_sums<T, G, NB>(vals, ptr, inc, nd, c0, E, C, acc);
#pragma unroll
  for (int c = 0; c < G; ++c) out[(size_t)nd * C + c0 + c] = acc[c];
}

// Internal linkage for the launchers: the once-per-kernel guard of
// allow_smem below is a function-local static, which g++ would otherwise
// make one object for the whole process (STB_GNU_UNIQUE). Two libraries
// that instantiate the same family would then share it, and the second one
// would launch its own kernel without the shared-memory opt-in.
namespace {

inline int n_tiles(int E) { return (E + EX - 1) / EX; }

// Opt in to more than 48 KB of dynamic shared memory, once per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A kernel's registers a thread, local memory a thread in bytes (spills and
// stack) and resident blocks an SM, launched with `threads` threads and
// `smem` bytes of dynamic shared memory: out[0], out[1], out[2]; and the
// launch's block, out[3] threads and out[4] elements (0 where a block takes
// no tile of elements).
template <typename K>
int occupancy(K kernel, int threads, size_t smem, int* out, int elems = 0) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  out[3] = threads;
  out[4] = elems;
  return 0;
}

// K1 and K5 in the split layout L = Points<TE, H, MAX_E, DIRECT> (PREP:
// K1, with the prep cache; else K5).
template <typename T, class F, class L, bool PREP, class M>
int launch_points(const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,
                  const void* Me_t, void* fe, void* prep, int E, const M& m, void* stream) {
  constexpr size_t smem = PointSmem<T, F, L::TE, L::HOLD, 9, 0, L::DIRECT>::BYTES;
  static const cudaError_t attr =
      allow_smem(primal_points_kernel<T, F, M, PREP, L::TE, L::HOLD, L::DIRECT>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    primal_points_kernel<T, F, M, PREP, L::TE, L::HOLD, L::DIRECT>
        <<<(E + L::TE - 1) / L::TE, dim3(L::TE, F::Q), smem, (cudaStream_t)stream>>>(
            (const T*)packed, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t,
            (const T*)Me_t, (T*)fe, (T*)prep, E, m);
  }
  return (int)cudaGetLastError();
}

// K1 in layout L (Groups: the parent tile, loading the gradients as HOLD
// says; Points<TE, H, MAX_E>: the split up to MAX_E elements, the parent
// above).
template <typename T, class F, Hold HOLD = Hold::none, class L = Groups, class M>
int launch_primal_prep(const void* packed, const void* conn_t, const void* gN_t,
                       const void* dV_t, const void* Me_t, void* fe, void* prep, int E,
                       const M& m, void* stream) {
  if constexpr (L::SPLIT) {
    if (split_at<L>(E))
      return launch_points<T, F, L, true>(packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E, m,
                                          stream);
  }
  constexpr size_t smem = TileSmem<T, F, HOLD>::BYTES;
  static const cudaError_t attr = allow_smem(primal_prep_kernel<T, F, M, HOLD>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    primal_prep_kernel<T, F, M, HOLD>
        <<<n_tiles(E), dim3(EX, F::NG), smem, (cudaStream_t)stream>>>(
            (const T*)packed, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t,
            (const T*)Me_t, (T*)fe, (T*)prep, E, m);
  }
  return (int)cudaGetLastError();
}

// K5 in layout L (as K1's).
template <typename T, class F, Hold HOLD = Hold::none, class L = Groups, class M>
int launch_contrib(const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,
                   const void* Me_t, void* fe, int E, const M& m, void* stream) {
  if constexpr (L::SPLIT) {
    if (split_at<L>(E))
      return launch_points<T, F, L, false>(packed, conn_t, gN_t, dV_t, Me_t, fe, nullptr, E, m,
                                           stream);
  }
  constexpr size_t smem = TileSmem<T, F, HOLD>::BYTES;
  static const cudaError_t attr = allow_smem(contrib_kernel<T, F, M, HOLD>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    contrib_kernel<T, F, M, HOLD><<<n_tiles(E), dim3(EX, F::NG), smem, (cudaStream_t)stream>>>(
        (const T*)packed, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t,
        (const T*)Me_t, (T*)fe, E, m);
  }
  return (int)cudaGetLastError();
}

// K5t in layout L (Groups: the parent tile, streaming a point's operands
// through shared memory if STREAM, contrib_tangent_stream_tile; Slots<TE,
// NQ, MAX_E>: one thread an (element, slot) up to MAX_E elements, the
// parent tile above).
template <typename T, class F, bool STREAM = false, class L = Groups, class M>
int launch_contrib_tangent(const void* packed, const void* dpacked, const void* conn_t,
                           const void* gN_t, const void* dV_t, const void* Me_t, void* out,
                           int E, const M& m, void* stream) {
  if constexpr (L::SLOTS) {
    if (slots_at<L>(E)) {
      constexpr size_t smem = TangentSlotSmem<T, F, L::TE, L::NQ>::BYTES;
      static const cudaError_t attr =
          allow_smem(contrib_tangent_slots_kernel<T, F, M, L::TE, L::NQ>, smem);
      if (attr != cudaSuccess) return (int)attr;
      if (E > 0) {
        contrib_tangent_slots_kernel<T, F, M, L::TE, L::NQ>
            <<<(E + L::TE - 1) / L::TE, dim3(L::TE, slot_rows<F, L::NQ>()), smem,
               (cudaStream_t)stream>>>(
                (const T*)packed, (const T*)dpacked, (const int*)conn_t, (const T*)gN_t,
                (const T*)dV_t, (const T*)Me_t, (T*)out, E, m);
      }
      return (int)cudaGetLastError();
    }
  }
  constexpr size_t smem = TangentSmem<T, F, STREAM>::BYTES;
  static const cudaError_t attr = allow_smem(contrib_tangent_kernel<T, F, M, STREAM>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    contrib_tangent_kernel<T, F, M, STREAM>
        <<<n_tiles(E), dim3(EX, F::NG), smem, (cudaStream_t)stream>>>(
            (const T*)packed, (const T*)dpacked, (const int*)conn_t, (const T*)gN_t,
            (const T*)dV_t, (const T*)Me_t, (T*)out, E, m);
  }
  return (int)cudaGetLastError();
}

// K2 in layout L (Groups: the parent tile, streaming its operands if
// STREAM; Points<TE, H, MAX_E>: the split up to MAX_E elements, the parent
// above).
template <typename T, class F, bool STREAM = false, class L = Groups, class M>
int launch_hv(const void* p, const void* conn_t, const void* prep, const void* gN_t,
              const void* dV_t, const void* Me_t, void* out, int E, double dt, const M& m,
              void* stream) {
  if constexpr (L::SPLIT) {
    if (split_at<L>(E)) {
      constexpr size_t smem = PointSmem<T, F, L::TE, L::HOLD, 3, M::PR, L::DIRECT>::BYTES;
      static const cudaError_t attr =
          allow_smem(hv_points_kernel<T, F, M, L::TE, L::HOLD, L::DIRECT>, smem);
      if (attr != cudaSuccess) return (int)attr;
      if (E > 0) {
        hv_points_kernel<T, F, M, L::TE, L::HOLD, L::DIRECT>
            <<<(E + L::TE - 1) / L::TE, dim3(L::TE, F::Q), smem, (cudaStream_t)stream>>>(
                (const T*)p, (const int*)conn_t, (const T*)prep, (const T*)gN_t,
                (const T*)dV_t, (const T*)Me_t, (T*)out, E, (T)dt, m);
      }
      return (int)cudaGetLastError();
    }
  }
  constexpr size_t smem = HvSmem<T, F, M, STREAM>::BYTES;
  static const cudaError_t attr = allow_smem(hv_kernel<T, F, M, STREAM>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    hv_kernel<T, F, M, STREAM><<<n_tiles(E), dim3(EX, F::NG), smem, (cudaStream_t)stream>>>(
        (const T*)p, (const int*)conn_t, (const T*)prep, (const T*)gN_t,
        (const T*)dV_t, (const T*)Me_t, (T*)out, E, (T)dt, m);
  }
  return (int)cudaGetLastError();
}

// occupancy() of each element kernel at its launch on E elements (K1, K2
// and K5: the layout may depend on E).
template <typename T, class F, class M, bool PREP, class L>
int occupancy_points(int* out) {
  return occupancy(primal_points_kernel<T, F, M, PREP, L::TE, L::HOLD, L::DIRECT>, L::TE * F::Q,
                   PointSmem<T, F, L::TE, L::HOLD, 9, 0, L::DIRECT>::BYTES, out, L::TE);
}

template <typename T, class F, class M, Hold HOLD = Hold::none, class L = Groups>
int occupancy_primal_prep(int E, int* out) {
  if constexpr (L::SPLIT) {
    if (split_at<L>(E)) return occupancy_points<T, F, M, true, L>(out);
  }
  return occupancy(primal_prep_kernel<T, F, M, HOLD>, EX * F::NG, TileSmem<T, F, HOLD>::BYTES,
                   out, EX);
}

template <typename T, class F, class M, Hold HOLD = Hold::none, class L = Groups>
int occupancy_contrib(int E, int* out) {
  if constexpr (L::SPLIT) {
    if (split_at<L>(E)) return occupancy_points<T, F, M, false, L>(out);
  }
  return occupancy(contrib_kernel<T, F, M, HOLD>, EX * F::NG, TileSmem<T, F, HOLD>::BYTES, out,
                   EX);
}

template <typename T, class F, class M, bool STREAM = false, class L = Groups>
int occupancy_contrib_tangent(int E, int* out) {
  if constexpr (L::SLOTS) {
    if (slots_at<L>(E))
      return occupancy(contrib_tangent_slots_kernel<T, F, M, L::TE, L::NQ>,
                       L::TE * slot_rows<F, L::NQ>(), TangentSlotSmem<T, F, L::TE, L::NQ>::BYTES,
                       out, L::TE);
  }
  return occupancy(contrib_tangent_kernel<T, F, M, STREAM>, EX * F::NG,
                   TangentSmem<T, F, STREAM>::BYTES, out, EX);
}

template <typename T, class F, class M, bool STREAM = false, class L = Groups>
int occupancy_hv(int E, int* out) {
  if constexpr (L::SPLIT) {
    if (split_at<L>(E))
      return occupancy(hv_points_kernel<T, F, M, L::TE, L::HOLD, L::DIRECT>, L::TE * F::Q,
                       PointSmem<T, F, L::TE, L::HOLD, 3, M::PR, L::DIRECT>::BYTES, out, L::TE);
  }
  return occupancy(hv_kernel<T, F, M, STREAM>, EX * F::NG, HvSmem<T, F, M, STREAM>::BYTES, out,
                   EX);
}

template <typename T, class F, class L = Groups>
int occupancy_svk_blocks(int E, int* out) {
  if constexpr (L::SLOTS) {
    if (slots_at<L>(E))
      return occupancy(svk_slots_kernel<T, F, L::TE, L::NQ>, L::TE * slot_rows<F, L::NQ>(),
                       SlotSmem<T, F, L::TE, L::NQ>::BYTES, out, L::TE);
  }
  return occupancy(svk_blocks_kernel<T, F>, EX * F::NG, smem_bytes<T, F, 3, 6>(), out, EX);
}

// K3 in layout L (Groups: the parent tile; Slots<TE, NQ, MAX_E>: one thread
// an (element, slot) up to MAX_E elements, the parent tile above).
template <typename T, class F, class L = Groups>
int launch_svk_blocks(const void* u, const void* conn_t, const void* gN_t,
                      const void* dV_t, void* out, int E, double lam, double mu,
                      void* stream) {
  if constexpr (L::SLOTS) {
    if (slots_at<L>(E)) {
      constexpr size_t smem = SlotSmem<T, F, L::TE, L::NQ>::BYTES;
      static const cudaError_t attr = allow_smem(svk_slots_kernel<T, F, L::TE, L::NQ>, smem);
      if (attr != cudaSuccess) return (int)attr;
      if (E > 0) {
        svk_slots_kernel<T, F, L::TE, L::NQ>
            <<<(E + L::TE - 1) / L::TE, dim3(L::TE, slot_rows<F, L::NQ>()), smem,
               (cudaStream_t)stream>>>(
                (const T*)u, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t, (T*)out, E,
                (T)lam, (T)mu);
      }
      return (int)cudaGetLastError();
    }
  }
  constexpr size_t smem = smem_bytes<T, F, 3, 6>();
  static const cudaError_t attr = allow_smem(svk_blocks_kernel<T, F>, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (E > 0) {
    svk_blocks_kernel<T, F><<<n_tiles(E), dim3(EX, F::NG), smem, (cudaStream_t)stream>>>(
        (const T*)u, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t,
        (T*)out, E, (T)lam, (T)mu);
  }
  return (int)cudaGetLastError();
}

// K4 with G channels a thread (C a multiple of G).
template <typename T, int G, int NB>
int launch_node_reduce_groups(const void* vals, const void* ptr, const void* inc, void* out,
                              int n, int E, int C, void* stream) {
  if (n > 0) {
    const long long work = (long long)n * (C / G);
    node_reduce_kernel<T, G, NB><<<(int)((work + THREADS - 1) / THREADS), THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const T*)vals, (const int*)ptr, (const int*)inc, (T*)out, n, E, C);
  }
  return (int)cudaGetLastError();
}

// K4: 3 channels a thread; C must be a multiple of 3 (the library reduces 3
// and 6).
template <typename T, int NB = K4_BATCH>
int launch_node_reduce(const void* vals, const void* ptr, const void* inc, void* out, int n,
                       int E, int C, void* stream) {
  if (C <= 0 || C % 3 != 0) return (int)cudaErrorInvalidValue;
  return launch_node_reduce_groups<T, 3, NB>(vals, ptr, inc, out, n, E, C, stream);
}

template <typename T, int NB = K4_BATCH>
int occupancy_node_reduce(int* out) {
  return occupancy(node_reduce_kernel<T, 3, NB>, THREADS, 0, out);
}

}  // namespace

}  // namespace tlfea

// Plain C interface of one family's K1-K3, K5 and K5t with SVK, bound with
// ctypes (tlfea_torch/ops/fem_kernels.py): tlfea_<kernel>_<NAME>_<SUFFIX>;
// and tlfea_occupancy_<NAME>_<SUFFIX>(kernel, E, out), occupancy() of the
// kernel at index `kernel` of fem_kernels.KERNEL_NAMES (K1 0, K2 1, K3 2,
// K5 4, K5t 5) at its launch on E elements (out: 5 ints). K1, K2 and K5 run
// in layouts K1_TILE, K2_TILE and K5_TILE: tlfea::Groups, or a
// tlfea::Points<TE, HOLD, MAX_E> (an alias: the argument holds no comma);
// K3 and K5t in layouts K3_TILE and K5T_TILE: tlfea::Groups, or an alias of
// a tlfea::Slots<TE, NQ>, which may carry a gate, Slots<TE, NQ, MAX_E>.
#define TLFEA_FAMILY_ENTRY_POINTS(NAME, FAM, SUFFIX, T, K1_TILE, K2_TILE, K5_TILE, K3_TILE, \
                                  K5T_TILE)                                               \
  extern "C" int tlfea_primal_prep_##NAME##_##SUFFIX(                                   \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, void* prep, int E, double lam, double mu,             \
      double eta, double lam_d, void* stream) {                                         \
    return tlfea::launch_primal_prep<T, FAM, tlfea::Hold::none, K1_TILE>(               \
        packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E,                                  \
        tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}, stream);                     \
  }                                                                                     \
  extern "C" int tlfea_hv_##NAME##_##SUFFIX(                                            \
      const void* p, const void* conn_t, const void* prep, const void* gN_t,            \
      const void* dV_t, const void* Me_t, void* out, int E, double dt, double lam,      \
      double mu, double eta, double lam_d, void* stream) {                              \
    return tlfea::launch_hv<T, FAM, false, K2_TILE>(                                    \
        p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt,                                  \
        tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}, stream);                     \
  }                                                                                     \
  extern "C" int tlfea_svk_blocks_##NAME##_##SUFFIX(                                    \
      const void* u, const void* conn_t, const void* gN_t, const void* dV_t, void* out, \
      int E, double lam, double mu, void* stream) {                                     \
    return tlfea::launch_svk_blocks<T, FAM, K3_TILE>(u, conn_t, gN_t, dV_t, out, E, lam, \
                                                     mu, stream);                       \
  }                                                                                     \
  extern "C" int tlfea_contrib_##NAME##_##SUFFIX(                                       \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, int E, double lam, double mu, double eta,             \
      double lam_d, void* stream) {                                                     \
    return tlfea::launch_contrib<T, FAM, tlfea::Hold::none, K5_TILE>(                   \
        packed, conn_t, gN_t, dV_t, Me_t, fe, E,                                        \
        tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}, stream);                     \
  }                                                                                     \
  extern "C" int tlfea_contrib_tangent_##NAME##_##SUFFIX(                               \
      const void* packed, const void* dpacked, const void* conn_t, const void* gN_t,    \
      const void* dV_t, const void* Me_t, void* out, int E, double lam, double mu,      \
      double eta, double lam_d, void* stream) {                                         \
    return tlfea::launch_contrib_tangent<T, FAM, false, K5T_TILE>(                      \
        packed, dpacked, conn_t, gN_t, dV_t, Me_t, out, E,                              \
        tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}, stream);                     \
  }                                                                                     \
  extern "C" int tlfea_occupancy_##NAME##_##SUFFIX(int kernel, int E, int* out) {       \
    using M = tlfea::SvkMat<T>;                                                         \
    using tlfea::Hold;                                                                  \
    switch (kernel) {                                                                   \
      case 0: return tlfea::occupancy_primal_prep<T, FAM, M, Hold::none, K1_TILE>(E, out); \
      case 1: return tlfea::occupancy_hv<T, FAM, M, false, K2_TILE>(E, out);            \
      case 2: return tlfea::occupancy_svk_blocks<T, FAM, K3_TILE>(E, out);              \
      case 4: return tlfea::occupancy_contrib<T, FAM, M, Hold::none, K5_TILE>(E, out);  \
      case 5: return tlfea::occupancy_contrib_tangent<T, FAM, M, false, K5T_TILE>(E, out); \
      default: return (int)cudaErrorInvalidValue;                                      \
    }                                                                                   \
  }

// The same with Mooney-Rivlin (no K3: the preconditioner's blocks are plain
// PyTorch, as the JAX package leaves them to XLA):
// tlfea_<kernel>_<NAME>_mr_<SUFFIX>, constants (mu10, mu01, kappa, eta, lam_d).
// K1 and K5 load a quadrature point's shape gradients as K1_HOLD and
// K5_HOLD say (`Hold`: none, late, early or stream); K2 runs in layout
// K2_TILE (tlfea::Groups, or an alias of a tlfea::Points<TE, HOLD, MAX_E>) and, in
// the parent layout, streams a point's operands through shared memory if
// K2_STREAM (hv_tile); K5t runs in layout K5T_TILE (tlfea::Groups, or an
// alias of a tlfea::Slots<TE, NQ>) and, in the parent layout, streams them if
// K5T_STREAM (contrib_tangent_kernel).
#define TLFEA_MR_ENTRY_POINTS(NAME, FAM, SUFFIX, T, K1_HOLD, K5_HOLD, K2_STREAM, K2_TILE,  \
                              K5T_STREAM, K5T_TILE)                                     \
  extern "C" int tlfea_primal_prep_##NAME##_mr_##SUFFIX(                                \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, void* prep, int E, double mu10, double mu01,          \
      double kappa, double eta, double lam_d, void* stream) {                           \
    return tlfea::launch_primal_prep<T, FAM, tlfea::Hold::K1_HOLD>(                     \
        packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E,                                  \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);         \
  }                                                                                     \
  extern "C" int tlfea_hv_##NAME##_mr_##SUFFIX(                                         \
      const void* p, const void* conn_t, const void* prep, const void* gN_t,            \
      const void* dV_t, const void* Me_t, void* out, int E, double dt, double mu10,     \
      double mu01, double kappa, double eta, double lam_d, void* stream) {              \
    return tlfea::launch_hv<T, FAM, K2_STREAM, K2_TILE>(                                \
        p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt,                                  \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);         \
  }                                                                                     \
  extern "C" int tlfea_contrib_##NAME##_mr_##SUFFIX(                                    \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,       \
      const void* Me_t, void* fe, int E, double mu10, double mu01, double kappa,        \
      double eta, double lam_d, void* stream) {                                         \
    return tlfea::launch_contrib<T, FAM, tlfea::Hold::K5_HOLD>(                         \
        packed, conn_t, gN_t, dV_t, Me_t, fe, E,                                        \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);         \
  }                                                                                     \
  extern "C" int tlfea_contrib_tangent_##NAME##_mr_##SUFFIX(                            \
      const void* packed, const void* dpacked, const void* conn_t, const void* gN_t,    \
      const void* dV_t, const void* Me_t, void* out, int E, double mu10, double mu01,   \
      double kappa, double eta, double lam_d, void* stream) {                           \
    return tlfea::launch_contrib_tangent<T, FAM, K5T_STREAM, K5T_TILE>(                 \
        packed, dpacked, conn_t, gN_t, dV_t, Me_t, out, E,                              \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);         \
  }                                                                                     \
  extern "C" int tlfea_occupancy_##NAME##_mr_##SUFFIX(int kernel, int E, int* out) {    \
    using M = tlfea::MrMat<T>;                                                          \
    switch (kernel) {                                                                   \
      case 0: return tlfea::occupancy_primal_prep<T, FAM, M, tlfea::Hold::K1_HOLD>(E, out); \
      case 1: return tlfea::occupancy_hv<T, FAM, M, K2_STREAM, K2_TILE>(E, out);        \
      case 4: return tlfea::occupancy_contrib<T, FAM, M, tlfea::Hold::K5_HOLD>(E, out); \
      case 5:                                                                           \
        return tlfea::occupancy_contrib_tangent<T, FAM, M, K5T_STREAM, K5T_TILE>(E, out); \
      default: return (int)cudaErrorInvalidValue;                                       \
    }                                                                                   \
  }
