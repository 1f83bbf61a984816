// Compressible Mooney-Rivlin + Kelvin-Voigt material algebra for the FEM
// element kernels, as per-thread __device__ functions on 3x3 register arrays,
// and `MrMat`, the material parameter that K1 primal_prep, K2 hv, K5 contrib,
// K5t contrib_tangent (fem_feat10_mr.cu, fem_ancf3243_mr.cu,
// fem_ancf3443_mr.cu) and the persistent Newton-PCG kernel (resident.cuh) are
// instantiated with.
//
// The CUDA form of `pallas_fem._MRTile` (tlfea/ops/pallas_fem.py:282-463):
//
//   _MRTile._elastic   (:304)  -> mr_elastic
//   _MRTile._viscous_S (:341)  -> mr_viscous_S
//   _MRTile.primal     (:352)  -> mr_stress (and MrMat::primal's prep writes)
//   _MRTile._dP        (:385)  -> mr_dP
//   _MRTile.tangent    (:441)  -> mr_stress_tangent
//   _MRTile.hv         (:446)  -> mr_hv
//
//   P = 2 mu10 J^{-2/3} (F - I1/3 G) + 2 mu01 J^{-4/3} (I1 F - F C - 2 I2/3 G)
//     + kappa (J - 1) J G + F S_v,
//
// G = F^{-T}, C = F^T F, S_v = 2 eta Edot + lam_d tr(Edot) I, Edot =
// sym(Fd^T F). J - 1 = tr(Du) + c2(Du) + det(Du) is exact (no det(F) - 1
// cancellation). The isochoric terms still cancel to O(strain), so their
// float32 error relative to |P| is about eps / strain: compare float32 at a
// strained state. The plain PyTorch twins (`_mr_stress`,
// `_mr_stress_tangent`, the MR branch of `hv_plain`) are in
// tlfea_torch/ops/fem_kernels.py and follow the same expressions.
//
// Prep cache per quadrature point (MrMat::PR = 30 rows): Du (9), G (9),
// [J - 1, I1, I2] (3), Fd (9). The JAX kernels keep 21 rows when undamped;
// here Fd is always cached (S_v is zero when eta = lam_d = 0), so one
// instantiation serves both. C, F C and B = F F^T are recomputed in K2
// rather than cached: K2 is bound by the bytes it reads.
#pragma once

namespace tlfea {

__device__ __forceinline__ float mr_cbrt(float x) { return cbrtf(x); }
__device__ __forceinline__ double mr_cbrt(double x) { return cbrt(x); }

// C = A B, C = A^T B, C = A B^T
template <typename T>
__device__ __forceinline__ void mr_mm(const T A[3][3], const T B[3][3], T C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

template <typename T>
__device__ __forceinline__ void mr_mtm(const T A[3][3], const T B[3][3], T C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j];
}

template <typename T>
__device__ __forceinline__ void mr_mmt(const T A[3][3], const T B[3][3], T C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[j][0] + A[i][1] * B[j][1] + A[i][2] * B[j][2];
}

template <typename T>
__device__ __forceinline__ T mr_ddot(const T A[3][3], const T B[3][3]) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s += A[i][j] * B[i][j];
  return s;
}

// The primal quantities from Du = F - I: F, C = F^T F, FC = F C, G = F^{-T}
// (cofactor over J), I1, I2 and the exact J - 1.
template <typename T>
__device__ __forceinline__ void mr_elastic(const T Du[3][3], T F[3][3], T C[3][3], T FC[3][3],
                                           T G[3][3], T& I1, T& I2, T& Jm1) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = Du[i][j] + (i == j ? T(1) : T(0));
  const T trDu = Du[0][0] + Du[1][1] + Du[2][2];
  const T c2 = Du[0][0] * Du[1][1] - Du[0][1] * Du[1][0] + Du[0][0] * Du[2][2] -
               Du[0][2] * Du[2][0] + Du[1][1] * Du[2][2] - Du[1][2] * Du[2][1];
  const T detDu = Du[0][0] * (Du[1][1] * Du[2][2] - Du[1][2] * Du[2][1]) -
                  Du[0][1] * (Du[1][0] * Du[2][2] - Du[1][2] * Du[2][0]) +
                  Du[0][2] * (Du[1][0] * Du[2][1] - Du[1][1] * Du[2][0]);
  Jm1 = trDu + c2 + detDu;
  const T invJ = T(1) / (T(1) + Jm1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      G[i][j] = (F[i1][j1] * F[i2][j2] - F[i1][j2] * F[i2][j1]) * invJ;
    }
  }
  mr_mtm(F, F, C);
  I1 = C[0][0] + C[1][1] + C[2][2];
  T trC2 = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) trC2 += C[i][j] * C[j][i];
  I2 = T(0.5) * (I1 * I1 - trC2);
  mr_mm(F, C, FC);
}

// Kelvin-Voigt second Piola S_v = 2 eta Edot + lam_d tr(Edot) I, Edot =
// sym(Fd^T F).
template <typename T>
__device__ __forceinline__ void mr_viscous_S(const T F[3][3], const T Fd[3][3], T eta, T lam_d,
                                             T Sv[3][3]) {
  T X[3][3];
  mr_mtm(Fd, F, X);
  const T trEd = X[0][0] + X[1][1] + X[2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Sv[i][j] = (T(2) * eta) * (T(0.5) * (X[i][j] + X[j][i]));
    Sv[i][i] += lam_d * trEd;
  }
}

// The coefficients of P: t1 = 2 mu10 J^{-2/3}, t2 = 2 mu01 J^{-4/3}, t3 =
// kappa (J - 1) J.
template <typename T>
__device__ __forceinline__ void mr_coefs(T Jm1, T mu10, T mu01, T kappa, T& t1, T& t2, T& t3) {
  const T J = T(1) + Jm1;
  const T J13 = mr_cbrt(J);
  const T Jm23 = T(1) / (J13 * J13);
  t1 = (T(2) * mu10) * Jm23;
  t2 = (T(2) * mu01) * (Jm23 * Jm23);
  t3 = kappa * Jm1 * J;
}

// Total first Piola P from Du and Fd, and the quantities the prep cache
// keeps: G = F^{-T} and s3 = [J - 1, I1, I2].
template <typename T>
__device__ __forceinline__ void mr_stress(const T Du[3][3], const T Fd[3][3], T mu10, T mu01,
                                          T kappa, T eta, T lam_d, T P[3][3], T G[3][3],
                                          T s3[3]) {
  T F[3][3], C[3][3], FC[3][3], I1, I2, Jm1;
  mr_elastic(Du, F, C, FC, G, I1, I2, Jm1);
  T t1, t2, t3;
  mr_coefs(Jm1, mu10, mu01, kappa, t1, t2, t3);
  const T c1 = I1 * T(1.0 / 3.0), c2 = I2 * T(2.0 / 3.0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      P[i][j] = t1 * (F[i][j] - c1 * G[i][j]) + t2 * (I1 * F[i][j] - FC[i][j] - c2 * G[i][j]) +
                t3 * G[i][j];
  T Sv[3][3];
  mr_viscous_S(F, Fd, eta, lam_d, Sv);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      P[i][j] += F[i][0] * Sv[0][j] + F[i][1] * Sv[1][j] + F[i][2] * Sv[2][j];
  s3[0] = Jm1;
  s3[1] = I1;
  s3[2] = I2;
}

// Exact directional derivative of the total P along (dF, dFd), at the
// primal (F, C, FC, G, I1, I2, J - 1, Fd, S_v). With s = G : dF (dJ = J s):
//   dG  = -G dF^T G;  dI1 = 2 F : dF;  dI2 = 2 (I1 F - FC) : dF
//   dFC = dF C + F dF^T F + B dF,  B = F F^T
//   dt1 = -(2/3) t1 s;  dt2 = -(4/3) t2 s;  dt3 = kappa (2J - 1) J s
//   dP  = dt1 T1 + t1 dT1 + dt2 T2 + t2 dT2 + dt3 G + t3 dG
//         + dF S_v + F dS_v,  dS_v from dEdot = sym(dFd^T F + Fd^T dF)
// with T1 = F - (I1/3) G and T2 = I1 F - FC - (2 I2/3) G.
template <typename T>
__device__ __forceinline__ void mr_dP(const T F[3][3], const T C[3][3], const T FC[3][3],
                                      const T G[3][3], T I1, T I2, T Jm1, const T dF[3][3],
                                      const T Fd[3][3], const T dFd[3][3], const T Sv[3][3],
                                      T mu10, T mu01, T kappa, T eta, T lam_d, T dP[3][3]) {
  const T J = T(1) + Jm1;
  const T s = mr_ddot(G, dF);
  const T FdotdF = mr_ddot(F, dF);
  const T dI1 = T(2) * FdotdF;
  const T dI2 = T(2) * (I1 * FdotdF - mr_ddot(FC, dF));
  T t1, t2, t3;
  mr_coefs(Jm1, mu10, mu01, kappa, t1, t2, t3);
  const T dt1 = T(-2.0 / 3.0) * t1 * s;
  const T dt2 = T(-4.0 / 3.0) * t2 * s;
  const T dt3 = kappa * (T(2) * J - T(1)) * J * s;
  const T c1 = I1 * T(1.0 / 3.0), c2 = I2 * T(2.0 / 3.0);
  const T dc1 = dI1 * T(1.0 / 3.0), dc2 = dI2 * T(2.0 / 3.0);
  T M[3][3], dG[3][3];
  mr_mtm(dF, G, M);  // dF^T G
  mr_mm(G, M, dG);
  mr_mtm(dF, F, M);  // dF^T F
  T dFC[3][3], B[3][3];
  mr_mmt(F, F, B);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) v += dF[i][k] * C[k][j] + F[i][k] * M[k][j] + B[i][k] * dF[k][j];
      dFC[i][j] = v;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T g = G[i][j], dg = -dG[i][j];
      const T T1 = F[i][j] - c1 * g;
      const T dT1 = dF[i][j] - dc1 * g - c1 * dg;
      const T T2 = I1 * F[i][j] - FC[i][j] - c2 * g;
      const T dT2 = dI1 * F[i][j] + I1 * dF[i][j] - dFC[i][j] - dc2 * g - c2 * dg;
      dP[i][j] = dt1 * T1 + t1 * dT1 + dt2 * T2 + t2 * dT2 + dt3 * g + t3 * dg;
    }
  // Viscous part: dF S_v + F dS_v.
  T X[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      X[i][j] = dFd[0][i] * F[0][j] + dFd[1][i] * F[1][j] + dFd[2][i] * F[2][j] +
                Fd[0][i] * dF[0][j] + Fd[1][i] * dF[1][j] + Fd[2][i] * dF[2][j];
  const T trdEd = X[0][0] + X[1][1] + X[2][2];
  T dSv[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) dSv[i][j] = (T(2) * eta) * (T(0.5) * (X[i][j] + X[j][i]));
    dSv[i][i] += lam_d * trdEd;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T v = dP[i][j];
#pragma unroll
      for (int k = 0; k < 3; ++k) v += dF[i][k] * Sv[k][j] + F[i][k] * dSv[k][j];
      dP[i][j] = v;
    }
}

// dP at the primal (Du, Fd) along independent tangents dF (of Du) and dFd
// (of Fd): the primal recomputed, then mr_dP (K5t).
template <typename T>
__device__ __forceinline__ void mr_stress_tangent(const T Du[3][3], const T dF[3][3],
                                                  const T Fd[3][3], const T dFd[3][3], T mu10,
                                                  T mu01, T kappa, T eta, T lam_d,
                                                  T dP[3][3]) {
  T F[3][3], C[3][3], FC[3][3], G[3][3], I1, I2, Jm1;
  mr_elastic(Du, F, C, FC, G, I1, I2, Jm1);
  T Sv[3][3];
  mr_viscous_S(F, Fd, eta, lam_d, Sv);
  mr_dP(F, C, FC, G, I1, I2, Jm1, dF, Fd, dFd, Sv, mu10, mu01, kappa, eta, lam_d, dP);
}

// dP along the Newton direction (dx = dt p: dF = dt Gp, dFd = Gp) from the
// prep cache: Du, G, [J - 1, I1, I2] and Fd read; F, C, FC and S_v
// recomputed (K2).
template <typename T>
__device__ __forceinline__ void mr_hv(const T Gp[3][3], const T Du[3][3], const T G[3][3],
                                      const T s3[3], const T Fd[3][3], T dt, T mu10, T mu01,
                                      T kappa, T eta, T lam_d, T dP[3][3]) {
  T F[3][3], C[3][3], FC[3][3], dF[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      F[i][j] = Du[i][j] + (i == j ? T(1) : T(0));
      dF[i][j] = Gp[i][j] * dt;
    }
  mr_mtm(F, F, C);
  mr_mm(F, C, FC);
  T Sv[3][3];
  mr_viscous_S(F, Fd, eta, lam_d, Sv);
  mr_dP(F, C, FC, G, s3[1], s3[2], s3[0], dF, Fd, Gp, Sv, mu10, mu01, kappa, eta, lam_d, dP);
}

// The Mooney-Rivlin material parameter of the element kernels (see SvkMat in
// svk.cuh for the interface): PR prep rows per quadrature point and the
// constants, passed to the kernels by value.
template <typename T>
struct MrMat {
  static constexpr int PR = 30;
  T mu10, mu01, kappa, eta, lam_d;

  static MrMat from(const double* c) {
    return MrMat{(T)c[0], (T)c[1], (T)c[2], (T)c[3], (T)c[4]};
  }

  // P at (Du, Fd); with PREP, the quadrature point's prep rows at pq (row r
  // at pq[r * sE]): Du, G, [J - 1, I1, I2], Fd.
  template <bool PREP>
  __device__ __forceinline__ void primal(const T Du[3][3], const T Fd[3][3], T P[3][3], T* pq,
                                         size_t sE) const {
    T G[3][3], s3[3];
    mr_stress(Du, Fd, mu10, mu01, kappa, eta, lam_d, P, G, s3);
    if constexpr (PREP) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          pq[(i * 3 + j) * sE] = Du[i][j];
          pq[(9 + i * 3 + j) * sE] = G[i][j];
          pq[(21 + i * 3 + j) * sE] = Fd[i][j];
        }
#pragma unroll
      for (int r = 0; r < 3; ++r) pq[(18 + r) * sE] = s3[r];
    }
  }

  // dP along the Newton direction with gradient Gp, from the prep rows at pq.
  __device__ __forceinline__ void hv(const T Gp[3][3], const T* pq, size_t sE, T dt,
                                     T dP[3][3]) const {
    T Du[3][3], G[3][3], Fd[3][3], s3[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Du[i][j] = pq[(i * 3 + j) * sE];
        G[i][j] = pq[(9 + i * 3 + j) * sE];
        Fd[i][j] = pq[(21 + i * 3 + j) * sE];
      }
#pragma unroll
    for (int r = 0; r < 3; ++r) s3[r] = pq[(18 + r) * sE];
    mr_hv(Gp, Du, G, s3, Fd, dt, mu10, mu01, kappa, eta, lam_d, dP);
  }

  __device__ __forceinline__ void tangent(const T Du[3][3], const T dF[3][3], const T Fd[3][3],
                                          const T dFd[3][3], T dP[3][3]) const {
    mr_stress_tangent(Du, dF, Fd, dFd, mu10, mu01, kappa, eta, lam_d, dP);
  }
};

}  // namespace tlfea
