// Other instantiations of the element kernels, for timing the choice of NG
// (quadrature-point groups per element) and REG_BYTES (partial sums in
// registers) against the shipped ones (FEAT10: NG 5, shared partials;
// ANCF3443: NG 4, register partials); K1 and K5 with each way of loading
// the shape gradients (`Hold`); K2 with Mooney-Rivlin in each form; K3
// at ANCF3443 and K5t in each form; the forms of K4's walk; the persistent
// kernel with one thread slab a block; and a probe of the barriers the
// persistent kernel can use:
// `python -m tlfea_torch.tools.kernel_variants`.
// Not part of the library that `build_kernels` builds.
#include <cooperative_groups.h>

#include "resident.cuh"

using F10regs = tlfea::Family<10, 5, 0x3FFu, 5, 240>;
TLFEA_FAMILY_ENTRY_POINTS(f10regs, F10regs, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)
using F10regs1 = tlfea::Family<10, 5, 0x3FFu, 1, 240>;
TLFEA_FAMILY_ENTRY_POINTS(f10regs1, F10regs1, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)
using S4smem = tlfea::Family<16, 48, 0x1111u, 4, 0>;
TLFEA_FAMILY_ENTRY_POINTS(s4smem, S4smem, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)
using S6regs = tlfea::Family<16, 48, 0x1111u, 6, 240>;
TLFEA_FAMILY_ENTRY_POINTS(s6regs, S6regs, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)
using S8smem = tlfea::Family<16, 48, 0x1111u, 8, 0>;
TLFEA_FAMILY_ENTRY_POINTS(s8smem, S8smem, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)
using S8regs = tlfea::Family<16, 48, 0x1111u, 8, 240>;
TLFEA_FAMILY_ENTRY_POINTS(s8regs, S8regs, f32, float, tlfea::Groups, tlfea::Groups,
                          tlfea::Groups, tlfea::Groups, tlfea::Groups)

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

// K2 with Mooney-Rivlin in the forms of `python -m
// tlfea_torch.tools.kernel_variants hv` (PERF.md, Findings): the operands
// loaded where used or streamed through shared memory (STREAM, fem_kernels.cuh
// `hv_tile`); the material's Hv chain as mr.cuh runs it (MrMat) or reading
// the prep rows where it uses them (MrRows, below); and no register cap (MINB
// 1: the library's `hv_kernel`) or __launch_bounds__' minimum of MINB blocks
// an SM (`hv_capped_kernel`).
// mr_hv (mr.cuh) with the prep rows read where they are used (row r at
// pq[r * sE]: Du, G, [J - 1, I1, I2], Fd) and dP built row by row: first
// the scalars (s, F : dF, dI1, dI2, the coefficients and their
// derivatives), then S_v and dS_v (symmetric, six entries each: X_ij +
// X_ji = X_ji + X_ij), then each row i of dG, B, dFC and dP, so that dG,
// B, dFC and the viscous X are never held whole. Each entry of dP takes
// mr_dP's operations in mr_dP's order, so the bits are mr_hv's up to the
// compiler's choice of fused multiply-adds.
template <typename T>
__device__ __forceinline__ void mr_hv_rows(const T Gp[3][3], const T* pq, size_t sE, T dt,
                                           T mu10, T mu01, T kappa, T eta, T lam_d,
                                           T dP[3][3]) {
  auto G = [&](int i, int j) { return pq[(9 + i * 3 + j) * sE]; };
  auto Fd = [&](int i, int j) { return pq[(21 + i * 3 + j) * sE]; };
  const T Jm1 = pq[18 * sE], I1 = pq[19 * sE], I2 = pq[20 * sE];
  T F[3][3], dF[3][3], C[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      F[i][j] = pq[(i * 3 + j) * sE] + (i == j ? T(1) : T(0));
      dF[i][j] = Gp[i][j] * dt;
    }
  tlfea::mr_mtm(F, F, C);
  auto FC = [&](int i, int j) { return F[i][0] * C[0][j] + F[i][1] * C[1][j] + F[i][2] * C[2][j]; };

  // The scalars.
  const T J = T(1) + Jm1;
  T s = T(0), FdotdF = T(0), FCdotdF = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s += G(i, j) * dF[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) FdotdF += F[i][j] * dF[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) FCdotdF += FC(i, j) * dF[i][j];
  const T dI1 = T(2) * FdotdF;
  const T dI2 = T(2) * (I1 * FdotdF - FCdotdF);
  T t1, t2, t3;
  tlfea::mr_coefs(Jm1, mu10, mu01, kappa, t1, t2, t3);
  const T dt1 = T(-2.0 / 3.0) * t1 * s;
  const T dt2 = T(-4.0 / 3.0) * t2 * s;
  const T dt3 = kappa * (T(2) * J - T(1)) * J * s;
  const T c1 = I1 * T(1.0 / 3.0), c2 = I2 * T(2.0 / 3.0);
  const T dc1 = dI1 * T(1.0 / 3.0), dc2 = dI2 * T(2.0 / 3.0);

  // S_v (mr_viscous_S) and dS_v, the upper triangle (r = i * 3 + j - i (i + 1) / 2).
  auto X = [&](int i, int j) {  // Fd^T F
    return Fd(0, i) * F[0][j] + Fd(1, i) * F[1][j] + Fd(2, i) * F[2][j];
  };
  auto dX = [&](int i, int j) {  // dFd^T F + Fd^T dF, dFd = Gp
    return Gp[0][i] * F[0][j] + Gp[1][i] * F[1][j] + Gp[2][i] * F[2][j] + Fd(0, i) * dF[0][j] +
           Fd(1, i) * dF[1][j] + Fd(2, i) * dF[2][j];
  };
  T Sv[6], dSv[6];
  {
    const T trEd = X(0, 0) + X(1, 1) + X(2, 2);
    const T trdEd = dX(0, 0) + dX(1, 1) + dX(2, 2);
    int r = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j, ++r) {
        Sv[r] = (T(2) * eta) * (T(0.5) * (X(i, j) + X(j, i)));
        dSv[r] = (T(2) * eta) * (T(0.5) * (dX(i, j) + dX(j, i)));
        if (i == j) {
          Sv[r] += lam_d * trEd;
          dSv[r] += lam_d * trdEd;
        }
      }
  }
  auto sym = [](const T* A, int i, int j) {
    const int a = i < j ? i : j, b = i < j ? j : i;
    return A[a * 3 + b - a * (a + 1) / 2];
  };

  // M1 = dF^T G and M2 = dF^T F, whole; then dP row by row.
  T M1[3][3], M2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M1[i][j] = dF[0][i] * G(0, j) + dF[1][i] * G(1, j) + dF[2][i] * G(2, j);
      M2[i][j] = dF[0][i] * F[0][j] + dF[1][i] * F[1][j] + dF[2][i] * F[2][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T dGi[3], Bi[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dGi[j] = G(i, 0) * M1[0][j] + G(i, 1) * M1[1][j] + G(i, 2) * M1[2][j];
      Bi[j] = F[i][0] * F[j][0] + F[i][1] * F[j][1] + F[i][2] * F[j][2];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T dFC = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dFC += dF[i][k] * C[k][j] + F[i][k] * M2[k][j] + Bi[k] * dF[k][j];
      const T g = G(i, j), dg = -dGi[j];
      const T T1 = F[i][j] - c1 * g;
      const T dT1 = dF[i][j] - dc1 * g - c1 * dg;
      const T T2 = I1 * F[i][j] - FC(i, j) - c2 * g;
      const T dT2 = dI1 * F[i][j] + I1 * dF[i][j] - dFC - dc2 * g - c2 * dg;
      T v = dt1 * T1 + t1 * dT1 + dt2 * T2 + t2 * dT2 + dt3 * g + t3 * dg;
#pragma unroll
      for (int k = 0; k < 3; ++k) v += dF[i][k] * sym(Sv, k, j) + F[i][k] * sym(dSv, k, j);
      dP[i][j] = v;
    }
  }
}

template <typename T>
struct MrRows : tlfea::MrMat<T> {
  __device__ __forceinline__ void hv(const T Gp[3][3], const T* pq, size_t sE, T dt,
                                     T dP[3][3]) const {
    mr_hv_rows(Gp, pq, sE, dt, this->mu10, this->mu01, this->kappa, this->eta, this->lam_d, dP);
  }
};

template <typename T, class F, class M, bool STREAM, int MINB>
__global__ void __launch_bounds__(tlfea::EX * F::NG, MINB)
hv_capped_kernel(const T* __restrict__ p, const int* __restrict__ conn_t,
                 const T* __restrict__ prep, const T* __restrict__ gN_t,
                 const T* __restrict__ dV_t, const T* __restrict__ Me_t, T* __restrict__ out,
                 int E, T dt, M m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tlfea::hv_tile<T, F, M, STREAM>(p, conn_t, prep, gN_t, dV_t, Me_t, out, E,
                                  blockIdx.x * tlfea::EX, dt, m, reinterpret_cast<T*>(smem_raw));
}

template <typename T, class F, bool STREAM, int MINB, class M>
int launch_hv_form(const void* p, const void* conn_t, const void* prep, const void* gN_t,
                   const void* dV_t, const void* Me_t, void* out, int E, double dt, const M& m,
                   void* stream) {
  if constexpr (MINB == 1) {
    return tlfea::launch_hv<T, F, STREAM>(p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt, m,
                                          stream);
  } else {
    constexpr size_t smem = tlfea::HvSmem<T, F, M, STREAM>::BYTES;
    static const cudaError_t attr =
        tlfea::allow_smem(hv_capped_kernel<T, F, M, STREAM, MINB>, smem);
    if (attr != cudaSuccess) return (int)attr;
    if (E > 0) {
      hv_capped_kernel<T, F, M, STREAM, MINB>
          <<<tlfea::n_tiles(E), dim3(tlfea::EX, F::NG), smem, (cudaStream_t)stream>>>(
              (const T*)p, (const int*)conn_t, (const T*)prep, (const T*)gN_t, (const T*)dV_t,
              (const T*)Me_t, (T*)out, E, (T)dt, m);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, class F, class M, bool STREAM, int MINB>
int occupancy_hv_form(int* out) {
  if constexpr (MINB == 1)
    return tlfea::occupancy_hv<T, F, M, STREAM>(0, out);  // the parent layout at any E
  else
    return tlfea::occupancy(hv_capped_kernel<T, F, M, STREAM, MINB>, tlfea::EX * F::NG,
                            tlfea::HvSmem<T, F, M, STREAM>::BYTES, out, tlfea::EX);
}

// tlfea_hv_<family>_<form>_mr_<SUFFIX>, and
// tlfea_occupancy_hv_<family>_<form>_mr_<SUFFIX>(out), occupancy() of its
// launch. MAT: tlfea::MrMat or MrRows. Every form gives the same bits, up
// to the compiler's choice of fused multiply-adds.
#define VARIANT_HV(NAME, FAM, SUFFIX, T, FORM, STREAM, MAT, MINB)                       \
  extern "C" int tlfea_hv_##NAME##_##FORM##_mr_##SUFFIX(                                \
      const void* p, const void* conn_t, const void* prep, const void* gN_t,            \
      const void* dV_t, const void* Me_t, void* out, int E, double dt, double mu10,     \
      double mu01, double kappa, double eta, double lam_d, void* stream) {              \
    MAT<T> m;                                                                           \
    static_cast<tlfea::MrMat<T>&>(m) =                                                  \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d};                  \
    return launch_hv_form<T, FAM, STREAM, MINB>(p, conn_t, prep, gN_t, dV_t, Me_t, out, \
                                                E, dt, m, stream);                      \
  }                                                                                     \
  extern "C" int tlfea_occupancy_hv_##NAME##_##FORM##_mr_##SUFFIX(int* out) {           \
    return occupancy_hv_form<T, FAM, MAT<T>, STREAM, MINB>(out);                        \
  }
#define VARIANTS_HV(NAME, FAM, SUFFIX, T)                                  \
  VARIANT_HV(NAME, FAM, SUFFIX, T, parent, false, tlfea::MrMat, 1)         \
  VARIANT_HV(NAME, FAM, SUFFIX, T, lb2, false, tlfea::MrMat, 2)            \
  VARIANT_HV(NAME, FAM, SUFFIX, T, lb3, false, tlfea::MrMat, 3)            \
  VARIANT_HV(NAME, FAM, SUFFIX, T, smem, true, tlfea::MrMat, 1)            \
  VARIANT_HV(NAME, FAM, SUFFIX, T, smem_lb2, true, tlfea::MrMat, 2)        \
  VARIANT_HV(NAME, FAM, SUFFIX, T, smem_lb3, true, tlfea::MrMat, 3)        \
  VARIANT_HV(NAME, FAM, SUFFIX, T, rows, false, MrRows, 1)                 \
  VARIANT_HV(NAME, FAM, SUFFIX, T, rows_lb2, false, MrRows, 2)             \
  VARIANT_HV(NAME, FAM, SUFFIX, T, rows_lb3, false, MrRows, 3)             \
  VARIANT_HV(NAME, FAM, SUFFIX, T, smem_rows, true, MrRows, 1)             \
  VARIANT_HV(NAME, FAM, SUFFIX, T, smem_rows_lb2, true, MrRows, 2)         \
  VARIANT_HV(NAME, FAM, SUFFIX, T, smem_rows_lb3, true, MrRows, 3)

VARIANTS_HV(feat10, F10Mr, f32, float)
VARIANTS_HV(feat10, F10Mr, f64, double)
VARIANTS_HV(ancf3443, S4Mr, f32, float)
VARIANTS_HV(ancf3443, S4Mr, f64, double)
VARIANTS_HV(ancf3243, B4Mr, f32, float)
VARIANTS_HV(ancf3243, B4Mr, f64, double)

// The split's `stream` form (fem_kernels.cuh `PointOperands`, `PointMass`
// with Hold::stream): each point thread copies its point's S*3 gradient
// rows, its dV row and K2's PR prep rows into its own column of shared
// memory by cp.async before the block gathers conn (each reducer its slot's
// S Me rows too), and reads them there; its terms overwrite its gradient
// rows once read. A Step-0 form of `split`; no instantiation ships it.
namespace tlfea {

template <typename T, class F, int TE, int PR>
struct PointOperands<T, F, TE, Hold::stream, PR> {
  static constexpr int ROWS = F::S * 3 + 1 + PR;
  T* mine;  // this point's column: gradient rows, the dV row, the prep rows

  __device__ __forceinline__ PointOperands(const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                                           const T* prep, int q, int e, int E, T* col)
      : mine(col) {
    if (e >= E) return;
    const size_t sE = (size_t)E;
    const T* gq = gN_t + (size_t)q * F::S * 3 * sE + e;
#pragma unroll
    for (int r = 0; r < F::S * 3; ++r) cp_async_word(mine + r * TE, gq + r * sE);
    cp_async_word(mine + F::S * 3 * TE, dV_t + (size_t)q * sE + e);
#pragma unroll
    for (int r = 0; r < PR; ++r)
      cp_async_word(mine + (F::S * 3 + 1 + r) * TE, prep + ((size_t)q * PR + r) * sE + e);
  }

  __device__ __forceinline__ T grad(int a, int j) const { return mine[(a * 3 + j) * TE]; }
  __device__ __forceinline__ T vol() const { return mine[F::S * 3 * TE]; }
  template <class M>
  __device__ __forceinline__ void hv(const M& m, const T G[3][3], T dt, T dP[3][3]) const {
    m.hv(G, mine + (F::S * 3 + 1) * TE, (size_t)TE, dt, dP);
  }
  __device__ static void issued() { cp_async_commit(); }
  __device__ static void landed() { cp_async_wait<0>(); }
};

template <typename T, class F, int TE>
struct PointMass<T, F, TE, Hold::stream> {
  static constexpr int ME = F::S * F::S;
  const T* mes;  // this thread's column of its slot's Me rows

  __device__ __forceinline__ PointMass(const T* __restrict__ Me_t, T* ms, int a, int x, int e,
                                       int E, bool reduces)
      : mes(ms + a * F::S * TE + x) {
    if (!reduces) return;
    const size_t sE = (size_t)E;
#pragma unroll
    for (int b = 0; b < F::S; ++b)
      cp_async_word(ms + (a * F::S + b) * TE + x, Me_t + ((size_t)a * F::S + b) * sE + e);
  }
  __device__ __forceinline__ T operator()(int b) const { return mes[b * TE]; }
};

}  // namespace tlfea

// `python -m tlfea_torch.tools.kernel_variants split` (PERF.md, Findings):
// K1 `primal_prep[ancf3243]`, K2 `hv[ancf3243]` and K5 `contrib[ancf3243]`
// (SVK) and K2 `hv[ancf3243_mr]` in the parent layout (tlfea::Groups; K2
// `[ancf3243_mr]`'s is the `parent` form above) and with one thread a
// quadrature point (fem_kernels.cuh tlfea::Points<TE, HOLD>): TE elements a
// block and a point's operands loaded where used (`none`), into registers
// before the gather (`early`) or copied into shared memory by cp.async
// (`stream`, above); and `split8_direct` (tlfea::Direct<8, early>: each
// point thread gathers its own element's slots, no staging), at every E
// (no MAX_E): tlfea_{primal_prep,hv,contrib}_ancf3243_<form>_<SUFFIX>,
// tlfea_hv_ancf3243_<form>_mr_<SUFFIX>, and
// tlfea_occupancy_<kernel>_ancf3243_<form>[_mr]_<SUFFIX>(out), form parent,
// split<TE>_<HOLD> or split8_direct. Every form gives the parent's bits, up
// to the compiler's choice of fused multiply-adds.
#define SVK_ARGS(T) tlfea::SvkMat<T>{(T)lam, (T)mu, (T)eta, (T)lam_d}
#define VARIANT_LAYOUT_SVK(FORM, L, SUFFIX, T)                                                    \
  extern "C" int tlfea_primal_prep_ancf3243_##FORM##_##SUFFIX(                                    \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,                 \
      const void* Me_t, void* fe, void* prep, int E, double lam, double mu, double eta,           \
      double lam_d, void* stream) {                                                               \
    return tlfea::launch_primal_prep<T, B4Mr, tlfea::Hold::none, L>(                              \
        packed, conn_t, gN_t, dV_t, Me_t, fe, prep, E, SVK_ARGS(T), stream);                      \
  }                                                                                               \
  extern "C" int tlfea_hv_ancf3243_##FORM##_##SUFFIX(                                             \
      const void* p, const void* conn_t, const void* prep, const void* gN_t,                      \
      const void* dV_t, const void* Me_t, void* out, int E, double dt, double lam, double mu,     \
      double eta, double lam_d, void* stream) {                                                   \
    return tlfea::launch_hv<T, B4Mr, false, L>(p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt,     \
                                               SVK_ARGS(T), stream);                              \
  }                                                                                               \
  extern "C" int tlfea_contrib_ancf3243_##FORM##_##SUFFIX(                                        \
      const void* packed, const void* conn_t, const void* gN_t, const void* dV_t,                 \
      const void* Me_t, void* fe, int E, double lam, double mu, double eta, double lam_d,         \
      void* stream) {                                                                             \
    return tlfea::launch_contrib<T, B4Mr, tlfea::Hold::none, L>(                                  \
        packed, conn_t, gN_t, dV_t, Me_t, fe, E, SVK_ARGS(T), stream);                            \
  }                                                                                               \
  extern "C" int tlfea_occupancy_primal_prep_ancf3243_##FORM##_##SUFFIX(int* out) {               \
    using M = tlfea::SvkMat<T>;                                                                   \
    return tlfea::occupancy_primal_prep<T, B4Mr, M, tlfea::Hold::none, L>(0, out);                \
  }                                                                                               \
  extern "C" int tlfea_occupancy_hv_ancf3243_##FORM##_##SUFFIX(int* out) {                        \
    return tlfea::occupancy_hv<T, B4Mr, tlfea::SvkMat<T>, false, L>(0, out);                      \
  }                                                                                               \
  extern "C" int tlfea_occupancy_contrib_ancf3243_##FORM##_##SUFFIX(int* out) {                   \
    using M = tlfea::SvkMat<T>;                                                                   \
    return tlfea::occupancy_contrib<T, B4Mr, M, tlfea::Hold::none, L>(0, out);                    \
  }
#define VARIANT_SPLIT(TE, HOLD, SUFFIX, T)                                                        \
  VARIANT_LAYOUT_SVK(split##TE##_##HOLD, Split##TE##_##HOLD, SUFFIX, T)                           \
  extern "C" int tlfea_hv_ancf3243_split##TE##_##HOLD##_mr_##SUFFIX(                              \
      const void* p, const void* conn_t, const void* prep, const void* gN_t,                      \
      const void* dV_t, const void* Me_t, void* out, int E, double dt, double mu10,               \
      double mu01, double kappa, double eta, double lam_d, void* stream) {                        \
    return tlfea::launch_hv<T, B4Mr, false, Split##TE##_##HOLD>(                                  \
        p, conn_t, prep, gN_t, dV_t, Me_t, out, E, dt,                                            \
        tlfea::MrMat<T>{(T)mu10, (T)mu01, (T)kappa, (T)eta, (T)lam_d}, stream);                   \
  }                                                                                               \
  extern "C" int tlfea_occupancy_hv_ancf3243_split##TE##_##HOLD##_mr_##SUFFIX(int* out) {         \
    return tlfea::occupancy_hv<T, B4Mr, tlfea::MrMat<T>, false, Split##TE##_##HOLD>(0, out);      \
  }
using Split8_none = tlfea::Points<8, tlfea::Hold::none>;
using Split16_none = tlfea::Points<16, tlfea::Hold::none>;
using Split32_none = tlfea::Points<32, tlfea::Hold::none>;
using Split8_early = tlfea::Points<8, tlfea::Hold::early>;
using Split16_early = tlfea::Points<16, tlfea::Hold::early>;
using Split32_early = tlfea::Points<32, tlfea::Hold::early>;
using Split8_stream = tlfea::Points<8, tlfea::Hold::stream>;
using Split16_stream = tlfea::Points<16, tlfea::Hold::stream>;
using Split32_stream = tlfea::Points<32, tlfea::Hold::stream>;
using Split8_direct = tlfea::Direct<8, tlfea::Hold::early>;
#define VARIANTS_SPLIT(SUFFIX, T)                      \
  VARIANT_LAYOUT_SVK(parent, tlfea::Groups, SUFFIX, T) \
  VARIANT_SPLIT(8, none, SUFFIX, T)                    \
  VARIANT_SPLIT(16, none, SUFFIX, T)                   \
  VARIANT_SPLIT(32, none, SUFFIX, T)                   \
  VARIANT_SPLIT(8, early, SUFFIX, T)                   \
  VARIANT_SPLIT(16, early, SUFFIX, T)                  \
  VARIANT_SPLIT(32, early, SUFFIX, T)                  \
  VARIANT_SPLIT(8, stream, SUFFIX, T)                  \
  VARIANT_SPLIT(16, stream, SUFFIX, T)                 \
  VARIANT_SPLIT(32, stream, SUFFIX, T)                 \
  VARIANT_SPLIT(8, direct, SUFFIX, T)

VARIANTS_SPLIT(f32, float)
VARIANTS_SPLIT(f64, double)

// `python -m tlfea_torch.tools.kernel_variants blocks` (PERF.md, Findings):
// K3 `svk_blocks[ancf3443]` and `svk_blocks[feat10]` in their forms:
// `parent`, the library's parent tile (tlfea::Groups); `stream`, the
// parent's walk with each thread's next round of gradient rows and dV row
// copied by cp.async into its own column of a ring of up to two stages (as
// K1's Hold::stream; FEAT10's one round, one stage), its partial sums still
// in shared memory; `slots<TE>_<NQ>`, fem_kernels.cuh tlfea::Slots<TE, NQ>
// (one thread an (element, slot), each chunk of NQ points copied into
// shared memory by the block; at FEAT10 one chunk of all 5 points);
// `slots<TE>_<NQ>_nocopy` (below, the shell only), the same reading global
// memory where used: tlfea_svk_blocks_<family>_<form>_<SUFFIX> and
// tlfea_occupancy_svk_blocks_<family>_<form>_<SUFFIX>(E, out). Every form
// gives the parent's bits, up to the compiler's choice of fused
// multiply-adds.
template <typename T, class F>
__global__ void __launch_bounds__(tlfea::EX * F::NG)
svk_blocks_stream_kernel(const T* __restrict__ u, const int* __restrict__ conn_t,
                         const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                         T* __restrict__ out, int E, T lam, T mu) {
  using tlfea::EX;
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = EX * NG;
  constexpr int R = S * 3 + 1, ROUNDS = Q / NG, D = ROUNDS < 2 ? ROUNDS : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (S*3, EX): centred u
  T* part = xs + S * 3 * EX;               // (NG*S*6, EX)
  T* ring = part + NG * S * 6 * EX;        // (D, NG, R, EX)
  const int x = threadIdx.x, g = threadIdx.y;
  const int e0 = blockIdx.x * EX, e = e0 + x;
  const size_t sE = (size_t)E;
  tlfea::PartialFor<T, F, S * 6> acc(part + g * S * 6 * EX + x);
  T* mine = ring + g * R * EX + x;
  auto issue = [&](int k) {
    if (e < E && k < ROUNDS) {
      const int q = k * NG + g;
      T* dst = mine + (k % D) * (NG * R * EX);
      const T* src = gN_t + (size_t)q * S * 3 * sE + e;
#pragma unroll
      for (int r = 0; r < S * 3; ++r) tlfea::cp_async_word(dst + r * EX, src + r * sE);
      tlfea::cp_async_word(dst + S * 3 * EX, dV_t + (size_t)q * sE + e);
    }
    tlfea::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < D; ++k) issue(k);
  tlfea::stage<T, F, 3, 3>(u, conn_t, E, e0, xs);
  __syncthreads();

  if (e < E) {
    const T* xe = xs + x;
#pragma unroll 1
    for (int q = g; q < Q; q += NG) {
      const int k = (q - g) / NG;
      const T* st = mine + (k % D) * (NG * R * EX);
      tlfea::cp_async_wait<D - 1>();
      T F_[3][3], FFT[3][3], trE;
      tlfea::svk_point<T, F>(xe, EX, st, EX, F_, FFT, trE);
      const T w = st[S * 3 * EX];
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const T h[3] = {st[(a * 3) * EX], st[(a * 3 + 1) * EX], st[(a * 3 + 2) * EX]};
        T K[6];
        tlfea::svk_diag_block(F_, FFT, trE, h, lam, mu, K);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[a * 6 + c] += K[c] * w;
      }
      issue(k + D);
    }
  }
  tlfea::cp_async_wait<0>();
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

template <typename T, class F>
constexpr size_t stream_blocks_smem() {
  constexpr int R = F::S * 3 + 1, ROUNDS = F::Q / F::NG, D = ROUNDS < 2 ? ROUNDS : 2;
  return tlfea::smem_bytes<T, F, 3, 6>() + (size_t)D * F::NG * R * tlfea::EX * sizeof(T);
}

#define VARIANT_BLOCKS_STREAM(NAME, FAM, SUFFIX, T)                                               \
  extern "C" int tlfea_svk_blocks_##NAME##_stream_##SUFFIX(                                       \
      const void* u, const void* conn_t, const void* gN_t, const void* dV_t, void* out, int E,    \
      double lam, double mu, void* stream) {                                                      \
    constexpr size_t smem = stream_blocks_smem<T, FAM>();                                         \
    static const cudaError_t attr = tlfea::allow_smem(svk_blocks_stream_kernel<T, FAM>, smem);    \
    if (attr != cudaSuccess) return (int)attr;                                                    \
    if (E > 0)                                                                                    \
      svk_blocks_stream_kernel<T, FAM>                                                            \
          <<<tlfea::n_tiles(E), dim3(tlfea::EX, FAM::NG), smem, (cudaStream_t)stream>>>(          \
              (const T*)u, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t, (T*)out, E,        \
              (T)lam, (T)mu);                                                                     \
    return (int)cudaGetLastError();                                                               \
  }                                                                                               \
  extern "C" int tlfea_occupancy_svk_blocks_##NAME##_stream_##SUFFIX(int, int* out) {             \
    return tlfea::occupancy(svk_blocks_stream_kernel<T, FAM>, tlfea::EX * FAM::NG,                \
                            stream_blocks_smem<T, FAM>(), out, tlfea::EX);                        \
  }
#define VARIANT_BLOCKS(NAME, FAM, FORM, L, SUFFIX, T)                                             \
  extern "C" int tlfea_svk_blocks_##NAME##_##FORM##_##SUFFIX(                                     \
      const void* u, const void* conn_t, const void* gN_t, const void* dV_t, void* out, int E,    \
      double lam, double mu, void* stream) {                                                      \
    return tlfea::launch_svk_blocks<T, FAM, L>(u, conn_t, gN_t, dV_t, out, E, lam, mu, stream);   \
  }                                                                                               \
  extern "C" int tlfea_occupancy_svk_blocks_##NAME##_##FORM##_##SUFFIX(int E, int* out) {         \
    return tlfea::occupancy_svk_blocks<T, FAM, L>(E, out);                                        \
  }
// tlfea::Slots<TE, NQ> without the copy: phase A and phase B read the
// gradients and dV from global memory where they use them, so the shared
// memory holds the staged u and the point records only.
template <typename T, class F, int TE, int NQ>
__global__ void __launch_bounds__(TE * F::S)
svk_slots_nocopy_kernel(const T* __restrict__ u, const int* __restrict__ conn_t,
                        const T* __restrict__ gN_t, const T* __restrict__ dV_t,
                        T* __restrict__ out, int E, T lam, T mu) {
  using L = tlfea::SlotSmem<T, F, TE, NQ>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG, NT = TE * S, PT = L::PT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (S*3, TE): centred u
  T* pts = xs + L::XS;                     // (NQ, TE, PT)
  const int x = threadIdx.x, a = threadIdx.y;
  const int e0 = blockIdx.x * TE, e = e0 + x;
  const size_t sE = (size_t)E;
  tlfea::stage<T, F, 3, 3, 3, TE, NT>(u, conn_t, E, e0, xs);

  T acc[NG][6];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[h][c] = T(0);
#pragma unroll 1
  for (int k = 0; k < Q / NQ; ++k) {
    __syncthreads();
    if (a < NQ && e < E) {
      const int q = k * NQ + a;
      T F_[3][3], FFT[3][3], trE;
      tlfea::svk_point<T, F>(xs + x, TE, gN_t + (size_t)q * S * 3 * sE + e, sE, F_, FFT, trE);
      tlfea::svk_point_record(F_, FFT, trE, pts + (a * TE + x) * PT);
    }
    __syncthreads();
    if (e < E) {
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        const int q = k * NQ + t;
        T h[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) h[j] = gN_t[((size_t)(q * S + a) * 3 + j) * sE + e];
        const T w = dV_t[q * sE + e];
        T K[6];
        tlfea::svk_slot_block(pts + (t * TE + x) * PT, h, lam, mu, K);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[t % NG][c] += K[c] * w;
      }
    }
  }
  if (e < E) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      T sum = T(0);
#pragma unroll
      for (int h = 0; h < NG; ++h) sum += acc[h][c];
      out[(a * 6 + c) * sE + e] = sum;
    }
  }
}

template <typename T, int TE, int NQ>
constexpr size_t nocopy_smem() {
  using L = tlfea::SlotSmem<T, S4Mr, TE, NQ>;
  return (size_t)(L::XS + L::PTS) * sizeof(T);
}

#define VARIANT_BLOCKS_NOCOPY(TE, NQ, SUFFIX, T)                                                  \
  extern "C" int tlfea_svk_blocks_ancf3443_slots##TE##_##NQ##_nocopy_##SUFFIX(                    \
      const void* u, const void* conn_t, const void* gN_t, const void* dV_t, void* out, int E,    \
      double lam, double mu, void* stream) {                                                      \
    constexpr size_t smem = nocopy_smem<T, TE, NQ>();                                             \
    static const cudaError_t attr =                                                               \
        tlfea::allow_smem(svk_slots_nocopy_kernel<T, S4Mr, TE, NQ>, smem);                        \
    if (attr != cudaSuccess) return (int)attr;                                                    \
    if (E > 0)                                                                                    \
      svk_slots_nocopy_kernel<T, S4Mr, TE, NQ>                                                    \
          <<<(E + TE - 1) / TE, dim3(TE, S4Mr::S), smem, (cudaStream_t)stream>>>(                 \
              (const T*)u, (const int*)conn_t, (const T*)gN_t, (const T*)dV_t, (T*)out, E,        \
              (T)lam, (T)mu);                                                                     \
    return (int)cudaGetLastError();                                                               \
  }                                                                                               \
  extern "C" int tlfea_occupancy_svk_blocks_ancf3443_slots##TE##_##NQ##_nocopy_##SUFFIX(          \
      int, int* out) {                                                                            \
    return tlfea::occupancy(svk_slots_nocopy_kernel<T, S4Mr, TE, NQ>, TE * S4Mr::S,               \
                            nocopy_smem<T, TE, NQ>(), out, TE);                                   \
  }
using Slots8_4 = tlfea::Slots<8, 4>;
using Slots8_8 = tlfea::Slots<8, 8>;
using Slots16_4 = tlfea::Slots<16, 4>;
using Slots16_8 = tlfea::Slots<16, 8>;
using Slots16_5 = tlfea::Slots<16, 5>;
using Slots32_5 = tlfea::Slots<32, 5>;
#define VARIANTS_BLOCKS(SUFFIX, T)                                     \
  VARIANT_BLOCKS(ancf3443, S4Mr, parent, tlfea::Groups, SUFFIX, T)    \
  VARIANT_BLOCKS_STREAM(ancf3443, S4Mr, SUFFIX, T)                     \
  VARIANT_BLOCKS(ancf3443, S4Mr, slots8_4, Slots8_4, SUFFIX, T)        \
  VARIANT_BLOCKS(ancf3443, S4Mr, slots8_8, Slots8_8, SUFFIX, T)        \
  VARIANT_BLOCKS(ancf3443, S4Mr, slots16_4, Slots16_4, SUFFIX, T)      \
  VARIANT_BLOCKS(ancf3443, S4Mr, slots16_8, Slots16_8, SUFFIX, T)      \
  VARIANT_BLOCKS_NOCOPY(8, 4, SUFFIX, T)                               \
  VARIANT_BLOCKS_NOCOPY(8, 8, SUFFIX, T)                               \
  VARIANT_BLOCKS_NOCOPY(16, 4, SUFFIX, T)                              \
  VARIANT_BLOCKS_NOCOPY(16, 8, SUFFIX, T)                              \
  VARIANT_BLOCKS(feat10, F10Mr, parent, tlfea::Groups, SUFFIX, T)      \
  VARIANT_BLOCKS_STREAM(feat10, F10Mr, SUFFIX, T)                      \
  VARIANT_BLOCKS(feat10, F10Mr, slots16_5, Slots16_5, SUFFIX, T)       \
  VARIANT_BLOCKS(feat10, F10Mr, slots32_5, Slots32_5, SUFFIX, T)

VARIANTS_BLOCKS(f32, float)
VARIANTS_BLOCKS(f64, double)

// `python -m tlfea_torch.tools.kernel_variants blocks_beam` (PERF.md,
// Findings): K3 `svk_blocks[ancf3243]` (S = 8, Q = 12, NG = 4) in the parent
// and the slot layouts, fem_kernels.cuh tlfea::Slots<TE, NQ>: `slots<TE>_4`
// (TE 4, 8, 16; three chunks of 4 points, double-buffered, phase A on 4 of
// the block's 8 slot rows) and `slots<TE>_12` (TE 4, 8; one chunk of all 12
// points in one buffer, a block of TE x 12 threads, so that phase A takes
// every point at once and rows 8-11 sit out phase B).
using Slots4_4 = tlfea::Slots<4, 4>;
using Slots4_12 = tlfea::Slots<4, 12>;
using Slots8_12 = tlfea::Slots<8, 12>;
#define VARIANTS_BLOCKS_BEAM(SUFFIX, T)                              \
  VARIANT_BLOCKS(ancf3243, B4Mr, parent, tlfea::Groups, SUFFIX, T)  \
  VARIANT_BLOCKS(ancf3243, B4Mr, slots4_4, Slots4_4, SUFFIX, T)     \
  VARIANT_BLOCKS(ancf3243, B4Mr, slots8_4, Slots8_4, SUFFIX, T)     \
  VARIANT_BLOCKS(ancf3243, B4Mr, slots16_4, Slots16_4, SUFFIX, T)   \
  VARIANT_BLOCKS(ancf3243, B4Mr, slots4_12, Slots4_12, SUFFIX, T)   \
  VARIANT_BLOCKS(ancf3243, B4Mr, slots8_12, Slots8_12, SUFFIX, T)

VARIANTS_BLOCKS_BEAM(f32, float)
VARIANTS_BLOCKS_BEAM(f64, double)

// `python -m tlfea_torch.tools.kernel_variants tangent` (PERF.md, Findings):
// K5t `contrib_tangent` in its forms: `parent` (fem_kernels.cuh
// contrib_tangent_kernel, the operands loaded where used), `stream` (its
// STREAM: copied into shared memory by cp.async,
// contrib_tangent_stream_tile), `stream_fused` (below: the stream with the
// four contractions in one pass), each of the last two also under
// __launch_bounds__' minimum of 3 blocks an SM (`_lb3`, float32): FEAT10
// with Mooney-Rivlin; at FEAT10 with SVK the parent, `stream` and
// `slots16_5` / `slots32_5` (one chunk of all 5 points); and at
// ANCF3443 with SVK and with Mooney-Rivlin the parent, `stream` and
// `slots<TE>_<NQ>` (fem_kernels.cuh tlfea::Slots<TE, NQ>,
// contrib_tangent_slots_kernel: one thread an (element, slot), each chunk of
// NQ points copied into shared memory by the block; (8, 16) and (16, 8) in
// float32 only, where they fit two blocks an SM):
// tlfea_contrib_tangent_<family>_<form>[_mr]_<SUFFIX>(..., E, the material's
// constants as fem_kernels.MATERIALS orders them, stream) and
// tlfea_occupancy_contrib_tangent_<family>_<form>[_mr]_<SUFFIX>(E, out). Every
// form gives the parent's bits, up to the compiler's choice of fused
// multiply-adds.

// contrib_tangent_stream_tile with dF, dFd, Du and Fd summed in one pass
// over the slots, so that each gradient value leaves shared memory once;
// each of the 36 sums still runs over a ascending from 0.
template <typename T, class F, class M>
__device__ __forceinline__ void contrib_tangent_fused_tile(
    const T* __restrict__ packed, const T* __restrict__ dpacked, const int* __restrict__ conn_t,
    const T* __restrict__ gN_t, const T* __restrict__ dV_t, const T* __restrict__ Me_t,
    T* __restrict__ out, int E, int e0, const M& m, T* smem) {
  using tlfea::EX;
  using L = tlfea::TangentSmem<T, F, true>;
  constexpr int S = F::S, Q = F::Q, NG = F::NG;
  constexpr int D = L::STAGES, R = L::QP_ROWS;
  T* xt = smem;               // (S*9, EX): tangent du | dv | d(dv/dt)
  T* xp = xt + S * 9 * EX;    // (S*6, EX): primal u | v
  T* part = xp + S * 6 * EX;  // (NG*S*3, EX)
  const int x = threadIdx.x, g = threadIdx.y;
  const int e = e0 + x;
  const size_t sE = (size_t)E;
  tlfea::PartialFor<T, F, S * 3> f(part + g * S * 3 * EX + x);
  T* mine = part + (L::PART + g * R) * EX + x;
  auto issue = [&](int k) {
    if (e < E && k < L::ROUNDS) {
      const int q = k * NG + g;
      T* dst = mine + (k % D) * (NG * R * EX);
      const T* src = gN_t + (size_t)q * S * 3 * sE + e;
#pragma unroll
      for (int r = 0; r < S * 3; ++r) tlfea::cp_async_word(dst + r * EX, src + r * sE);
      tlfea::cp_async_word(dst + S * 3 * EX, dV_t + (size_t)q * sE + e);
    }
    tlfea::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < D; ++k) issue(k);
  tlfea::stage<T, F, 9, 6>(dpacked, conn_t, E, e0, xt);
  tlfea::stage<T, F, 6, 6, 9>(packed, conn_t, E, e0, xp);
  __syncthreads();

  if (e < E) {
#pragma unroll 1
    for (int q = g; q < Q; q += NG) {
      const int k = (q - g) / NG;
      const T* st = mine + (k % D) * (NG * R * EX);
      tlfea::cp_async_wait<D - 1>();
      T dF[3][3], dFd[3][3], Du[3][3], Fd[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) dF[i][j] = dFd[i][j] = Du[i][j] = Fd[i][j] = T(0);
#pragma unroll
      for (int a = 1; a < S; ++a) {  // centred slot 0 is zero
        T du[3], dv[3], ua[3], va[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          du[i] = xt[(a * 9 + i) * EX + x];
          dv[i] = xt[(a * 9 + 3 + i) * EX + x];
          ua[i] = xp[(a * 6 + i) * EX + x];
          va[i] = xp[(a * 6 + 3 + i) * EX + x];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T gv = st[(a * 3 + j) * EX];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            dF[i][j] += du[i] * gv;
            dFd[i][j] += dv[i] * gv;
            Du[i][j] += ua[i] * gv;
            Fd[i][j] += va[i] * gv;
          }
        }
      }
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
      issue(k + D);
    }
  }
  tlfea::cp_async_wait<0>();
  f.flush();
  __syncthreads();
  tlfea::tangent_reduce<T, F>(part, xt, Me_t, out, E, e0);
}

// The streamed forms that the library does not launch: the fused tile, and
// either tile under __launch_bounds__' minimum of MINB blocks an SM.
template <typename T, class F, class M, bool FUSED, int MINB>
__global__ void __launch_bounds__(tlfea::EX * F::NG, MINB)
contrib_tangent_form_kernel(const T* __restrict__ packed, const T* __restrict__ dpacked,
                            const int* __restrict__ conn_t, const T* __restrict__ gN_t,
                            const T* __restrict__ dV_t, const T* __restrict__ Me_t,
                            T* __restrict__ out, int E, M m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  if constexpr (FUSED)
    contrib_tangent_fused_tile<T, F, M>(packed, dpacked, conn_t, gN_t, dV_t, Me_t, out, E,
                                        blockIdx.x * tlfea::EX, m, smem);
  else
    tlfea::contrib_tangent_stream_tile<T, F, M>(packed, dpacked, conn_t, gN_t, dV_t, Me_t, out,
                                                E, blockIdx.x * tlfea::EX, m, smem);
}

// L a Slots<TE, NQ>, STREAM false, or STREAM and neither FUSED nor a MINB
// above 1: the library's launch in that layout; else
// contrib_tangent_form_kernel.
template <bool STREAM, bool FUSED, int MINB, class L>
constexpr bool LIBRARY_FORM = L::SLOTS || !STREAM || (!FUSED && MINB == 1);

template <typename T, class F, class M, bool STREAM, bool FUSED, int MINB, class L>
int launch_tangent_form(const void* packed, const void* dpacked, const void* conn_t,
                        const void* gN_t, const void* dV_t, const void* Me_t, void* out, int E,
                        const M& m, void* stream) {
  if constexpr (LIBRARY_FORM<STREAM, FUSED, MINB, L>) {
    return tlfea::launch_contrib_tangent<T, F, STREAM, L>(packed, dpacked, conn_t, gN_t, dV_t,
                                                          Me_t, out, E, m, stream);
  } else {
    constexpr size_t smem = tlfea::TangentSmem<T, F, true>::BYTES;
    static const cudaError_t attr =
        tlfea::allow_smem(contrib_tangent_form_kernel<T, F, M, FUSED, MINB>, smem);
    if (attr != cudaSuccess) return (int)attr;
    if (E > 0) {
      contrib_tangent_form_kernel<T, F, M, FUSED, MINB>
          <<<tlfea::n_tiles(E), dim3(tlfea::EX, F::NG), smem, (cudaStream_t)stream>>>(
              (const T*)packed, (const T*)dpacked, (const int*)conn_t, (const T*)gN_t,
              (const T*)dV_t, (const T*)Me_t, (T*)out, E, m);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, class F, class M, bool STREAM, bool FUSED, int MINB, class L>
int occupancy_tangent_form(int E, int* out) {
  if constexpr (LIBRARY_FORM<STREAM, FUSED, MINB, L>)
    return tlfea::occupancy_contrib_tangent<T, F, M, STREAM, L>(E, out);
  else
    return tlfea::occupancy(contrib_tangent_form_kernel<T, F, M, FUSED, MINB>,
                            tlfea::EX * F::NG, tlfea::TangentSmem<T, F, true>::BYTES, out,
                            tlfea::EX);
}

// MAT_TAG: _mr or nothing; MAT: tlfea::MrMat (five constants) or
// tlfea::SvkMat (four, the fifth ignored); L the layout (tlfea::Groups or a
// Slots alias).
#define VARIANT_TANGENT(NAME, FAM, MAT_TAG, MAT, SUFFIX, T, FORM, STREAM, FUSED, MINB, L)       \
  extern "C" int tlfea_contrib_tangent_##NAME##_##FORM##MAT_TAG##_##SUFFIX(                     \
      const void* packed, const void* dpacked, const void* conn_t, const void* gN_t,            \
      const void* dV_t, const void* Me_t, void* out, int E, double c0, double c1, double c2,    \
      double c3, double c4, void* stream) {                                                     \
    const double c[5] = {c0, c1, c2, c3, c4};                                                   \
    return launch_tangent_form<T, FAM, MAT<T>, STREAM, FUSED, MINB, L>(                         \
        packed, dpacked, conn_t, gN_t, dV_t, Me_t, out, E, MAT<T>::from(c), stream);            \
  }                                                                                             \
  extern "C" int tlfea_occupancy_contrib_tangent_##NAME##_##FORM##MAT_TAG##_##SUFFIX(           \
      int E, int* out) {                                                                        \
    return occupancy_tangent_form<T, FAM, MAT<T>, STREAM, FUSED, MINB, L>(E, out);              \
  }
#define VARIANTS_TANGENT_MR(SUFFIX, T)                                                        \
  VARIANT_TANGENT(feat10, F10Mr, _mr, tlfea::MrMat, SUFFIX, T, parent, false, false, 1,      \
                  tlfea::Groups)                                                             \
  VARIANT_TANGENT(feat10, F10Mr, _mr, tlfea::MrMat, SUFFIX, T, stream, true, false, 1,       \
                  tlfea::Groups)                                                             \
  VARIANT_TANGENT(feat10, F10Mr, _mr, tlfea::MrMat, SUFFIX, T, stream_fused, true, true, 1,  \
                  tlfea::Groups)
// The shell's forms with material MAT (tag MAT_TAG) in every dtype, and those
// that fit two blocks an SM in float32 only.
using Slots8_16 = tlfea::Slots<8, 16>;
#define VARIANTS_TANGENT_SHELL(MAT_TAG, MAT, SUFFIX, T)                                        \
  VARIANT_TANGENT(ancf3443, S4Mr, MAT_TAG, MAT, SUFFIX, T, parent, false, false, 1,           \
                  tlfea::Groups)                                                              \
  VARIANT_TANGENT(ancf3443, S4Mr, MAT_TAG, MAT, SUFFIX, T, stream, true, false, 1,            \
                  tlfea::Groups)                                                              \
  VARIANT_TANGENT(ancf3443, S4Mr, MAT_TAG, MAT, SUFFIX, T, slots8_8, false, false, 1, Slots8_8) \
  VARIANT_TANGENT(ancf3443, S4Mr, MAT_TAG, MAT, SUFFIX, T, slots8_4, false, false, 1, Slots8_4)
#define VARIANTS_TANGENT_SHELL_F32(MAT_TAG, MAT)                                               \
  VARIANT_TANGENT(ancf3443, S4Mr, MAT_TAG, MAT, f32, float, slots8_16, false, false, 1,       \
                  Slots8_16)                                                                  \
  VARIANT_TANGENT(ancf3443, S4Mr, MAT_TAG, MAT, f32, float, slots16_8, false, false, 1,       \
                  Slots16_8)

VARIANTS_TANGENT_MR(f32, float)
VARIANTS_TANGENT_MR(f64, double)
VARIANT_TANGENT(feat10, F10Mr, _mr, tlfea::MrMat, f32, float, stream_lb3, true, false, 3,
                tlfea::Groups)
VARIANT_TANGENT(feat10, F10Mr, _mr, tlfea::MrMat, f32, float, stream_fused_lb3, true, true, 3,
                tlfea::Groups)
#define VARIANTS_TANGENT_SVK(SUFFIX, T)                                                           \
  VARIANT_TANGENT(feat10, F10Mr, , tlfea::SvkMat, SUFFIX, T, parent, false, false, 1,           \
                  tlfea::Groups)                                                                \
  VARIANT_TANGENT(feat10, F10Mr, , tlfea::SvkMat, SUFFIX, T, stream, true, false, 1,            \
                  tlfea::Groups)                                                                \
  VARIANT_TANGENT(feat10, F10Mr, , tlfea::SvkMat, SUFFIX, T, slots16_5, false, false, 1,        \
                  Slots16_5)                                                                    \
  VARIANT_TANGENT(feat10, F10Mr, , tlfea::SvkMat, SUFFIX, T, slots32_5, false, false, 1,        \
                  Slots32_5)
VARIANTS_TANGENT_SVK(f32, float)
VARIANTS_TANGENT_SVK(f64, double)
VARIANTS_TANGENT_SHELL(_mr, tlfea::MrMat, f32, float)
VARIANTS_TANGENT_SHELL(_mr, tlfea::MrMat, f64, double)
VARIANTS_TANGENT_SHELL_F32(_mr, tlfea::MrMat)
VARIANTS_TANGENT_SHELL(, tlfea::SvkMat, f32, float)
VARIANTS_TANGENT_SHELL(, tlfea::SvkMat, f64, double)
VARIANTS_TANGENT_SHELL_F32(, tlfea::SvkMat)

// `tangent_beam`: K5t `[ancf3243_mr]` and `[ancf3243]` (SVK) on the beam in
// the parent and the slot layouts of `blocks_beam` (slots<TE>_4, TE 4, 8, 16;
// slots<TE>_12, TE 4, 8), float32 and float64.
#define VARIANTS_TANGENT_BEAM(MAT_TAG, MAT, SUFFIX, T)                                          \
  VARIANT_TANGENT(ancf3243, B4Mr, MAT_TAG, MAT, SUFFIX, T, parent, false, false, 1,            \
                  tlfea::Groups)                                                               \
  VARIANT_TANGENT(ancf3243, B4Mr, MAT_TAG, MAT, SUFFIX, T, slots4_4, false, false, 1, Slots4_4) \
  VARIANT_TANGENT(ancf3243, B4Mr, MAT_TAG, MAT, SUFFIX, T, slots8_4, false, false, 1, Slots8_4) \
  VARIANT_TANGENT(ancf3243, B4Mr, MAT_TAG, MAT, SUFFIX, T, slots16_4, false, false, 1,         \
                  Slots16_4)                                                                   \
  VARIANT_TANGENT(ancf3243, B4Mr, MAT_TAG, MAT, SUFFIX, T, slots4_12, false, false, 1,         \
                  Slots4_12)                                                                   \
  VARIANT_TANGENT(ancf3243, B4Mr, MAT_TAG, MAT, SUFFIX, T, slots8_12, false, false, 1,         \
                  Slots8_12)
VARIANTS_TANGENT_BEAM(_mr, tlfea::MrMat, f32, float)
VARIANTS_TANGENT_BEAM(_mr, tlfea::MrMat, f64, double)
VARIANTS_TANGENT_BEAM(, tlfea::SvkMat, f32, float)
VARIANTS_TANGENT_BEAM(, tlfea::SvkMat, f64, double)

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
