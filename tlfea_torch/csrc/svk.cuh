// St. Venant-Kirchhoff + Kelvin-Voigt material algebra for the FEM element
// kernels, as per-thread __device__ functions on 3x3 register arrays.
//
// The CUDA form of the tile algebra in tlfea/ops/pallas_fem.py:
// `_svk_stress_rows` (:89, the strain-safe primal stress),
// `_svk_stress_tangent_rows` (:126, its derivative along any direction),
// `_SVKTile.hv` (:229, the cached-primal derivative along the Newton chain)
// and `_precond_fe` (:630, the closed-form diagonal tangent block). The
// plain PyTorch twins of the same algebra live in tlfea_torch/ops/fem_kernels.py.
#pragma once

namespace tlfea {

// Total first Piola P and total second Piola S from the displacement
// gradient Du = F - I and the velocity gradient Fd:
//   E  = (Du + Du^T + Du^T Du)/2            (strain-safe: no F^T F - I)
//   Ed = (Fd + Fd^T + Fd^T Du + Du^T Fd)/2
//   S  = lam tr(E) I + 2 mu E + lam_d tr(Ed) I + 2 eta Ed
//   P  = (I + Du) S
template <typename T>
__device__ __forceinline__ void svk_stress(const T Du[3][3], const T Fd[3][3],
                                           T lam, T mu, T eta, T lam_d,
                                           T P[3][3], T S[3][3]) {
  T Em[3][3], Ed[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = Du[0][i] * Du[0][j] + Du[1][i] * Du[1][j] + Du[2][i] * Du[2][j];
      Em[i][j] = T(0.5) * (Du[i][j] + Du[j][i] + s);
      T d = Fd[j][i] + Fd[i][j];
#pragma unroll
      for (int k = 0; k < 3; ++k) d += Fd[k][i] * Du[k][j] + Du[k][i] * Fd[k][j];
      Ed[i][j] = T(0.5) * d;
    }
  }
  const T trE = Em[0][0] + Em[1][1] + Em[2][2];
  const T trEd = Ed[0][0] + Ed[1][1] + Ed[2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S[i][j] = T(2) * mu * Em[i][j] + T(2) * eta * Ed[i][j];
    }
    S[i][i] += lam * trE + lam_d * trEd;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P[i][j] = S[i][j] + Du[i][0] * S[0][j] + Du[i][1] * S[1][j] + Du[i][2] * S[2][j];
    }
  }
}

// Directional derivative of P along the Newton direction p (dx = dt p,
// dv = p), with G = sum_a p_a (x) gradN_a and the primal (Du, S0, Fd) read
// from the prep cache:
//   sym2  = (G + G^T + G^T Du + Du^T G)/2
//   dS    = dt (lam tr(sym2) I + 2 mu sym2) + lam_d tr(dEd) I + 2 eta dEd,
//   dEd   = sym2 + dt (Fd^T G + G^T Fd)/2
//   dP    = dt G S0 + (I + Du) dS
template <typename T>
__device__ __forceinline__ void svk_hv(const T G[3][3], const T Du[3][3],
                                       const T S0[3][3], const T Fd[3][3],
                                       T dt, T lam, T mu, T eta, T lam_d,
                                       T dP[3][3]) {
  T sym2[3][3], dEd[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = G[i][j] + G[j][i];
      T x = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s += G[k][i] * Du[k][j] + Du[k][i] * G[k][j];
        x += Fd[k][i] * G[k][j] + G[k][i] * Fd[k][j];
      }
      sym2[i][j] = T(0.5) * s;
      dEd[i][j] = sym2[i][j] + (T(0.5) * dt) * x;
    }
  }
  const T tr_sym2 = sym2[0][0] + sym2[1][1] + sym2[2][2];
  const T tr_dEd = dEd[0][0] + dEd[1][1] + dEd[2][2];
  T dS[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dS[i][j] = (T(2) * mu * dt) * sym2[i][j] + (T(2) * eta) * dEd[i][j];
    }
    dS[i][i] += (lam * dt) * tr_sym2 + lam_d * tr_dEd;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = dS[i][j];
#pragma unroll
      for (int k = 0; k < 3; ++k) s += dt * G[i][k] * S0[k][j] + Du[i][k] * dS[k][j];
      dP[i][j] = s;
    }
  }
}

// Exact directional derivative of `svk_stress`'s P at the primal (Du, Fd)
// along independent tangents dF (of Du) and dFd (of Fd), the port of
// `_svk_stress_tangent_rows` (pallas_fem.py:126):
//   S0  = lam tr(E) I + 2 mu E + lam_d tr(Ed) I + 2 eta Ed   (svk_stress's S)
//   dE  = (dF + dF^T + dF^T Du + Du^T dF)/2
//   dEd = (dFd + dFd^T + dFd^T Du + Du^T dFd + Fd^T dF + dF^T Fd)/2
//   dS  = lam tr(dE) I + 2 mu dE + lam_d tr(dEd) I + 2 eta dEd
//   dP  = dF S0 + dS + Du dS
// `svk_hv` is this function along the Newton chain dF = dt G, dFd = G, with
// S0 read from the prep cache instead of recomputed.
template <typename T>
__device__ __forceinline__ void svk_stress_tangent(const T Du[3][3], const T dF[3][3],
                                                   const T Fd[3][3], const T dFd[3][3],
                                                   T lam, T mu, T eta, T lam_d,
                                                   T dP[3][3]) {
  T P0[3][3], S0[3][3];
  svk_stress(Du, Fd, lam, mu, eta, lam_d, P0, S0);
  T dE[3][3], dEd[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = dF[i][j] + dF[j][i];
      T d = dFd[i][j] + dFd[j][i];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s += dF[k][i] * Du[k][j] + Du[k][i] * dF[k][j];
        d += dFd[k][i] * Du[k][j] + Du[k][i] * dFd[k][j] + Fd[k][i] * dF[k][j] +
             dF[k][i] * Fd[k][j];
      }
      dE[i][j] = T(0.5) * s;
      dEd[i][j] = T(0.5) * d;
    }
  }
  const T trdE = dE[0][0] + dE[1][1] + dE[2][2];
  const T trdEd = dEd[0][0] + dEd[1][1] + dEd[2][2];
  T dS[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) dS[i][j] = T(2) * mu * dE[i][j] + T(2) * eta * dEd[i][j];
    dS[i][i] += lam * trdE + lam_d * trdEd;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = dS[i][j];
#pragma unroll
      for (int k = 0; k < 3; ++k) s += dF[i][k] * S0[k][j] + Du[i][k] * dS[k][j];
      dP[i][j] = s;
    }
  }
}

// Upper triangle (SYM6 order: 00 01 02 11 12 22) of the closed-form SVK
// diagonal tangent block K[d,e] = A[d,J,e,L] h_J h_L of one node with shape
// gradient h, at deformation gradient F (trE = (|F|^2 - 3)/2, FFT = F F^T).
template <typename T>
__device__ __forceinline__ void svk_diag_block(const T F[3][3], const T FFT[3][3],
                                               T trE, const T h[3], T lam, T mu,
                                               T K[6]) {
  T Fh[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Fh[i] = F[i][0] * h[0] + F[i][1] * h[1] + F[i][2] * h[2];
  const T hij = h[0] * h[0] + h[1] * h[1] + h[2] * h[2];
  const T FhFh = Fh[0] * Fh[0] + Fh[1] * Fh[1] + Fh[2] * Fh[2];
  const T diag = lam * trE * hij + mu * FhFh - mu * hij;
  const int D[6] = {0, 0, 0, 1, 1, 2};
  const int Ee[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int d = D[c], e = Ee[c];
    T k = (lam + mu) * Fh[d] * Fh[e] + mu * hij * FFT[d][e];
    if (d == e) k += diag;
    K[c] = k;
  }
}

// The SVK material parameter of the element kernels. A material parameter
// M of K1 primal_prep, K2 hv, K5 contrib and K5t contrib_tangent
// (fem_kernels.cuh) has PR, its prep rows per quadrature point, its
// constants (passed to the kernels by value; `from` takes them from the
// doubles of the C interface, in the order of fem_kernels.MATERIALS), and
//   primal<PREP>(Du, Fd, P, pq, sE)  P at (Du, Fd); with PREP, the prep rows
//                                    at pq (row r at pq[r * sE])
//   hv(G, pq, sE, dt, dP)            dP along the Newton direction from them
//   tangent(Du, dF, Fd, dFd, dP)     dP along independent tangents (K5t)
// MrMat (mr.cuh) is the other one. SVK's prep rows: Du (9), the total second
// Piola S (9), Fd (9).
template <typename T>
struct SvkMat {
  static constexpr int PR = 27;
  T lam, mu, eta, lam_d;

  static SvkMat from(const double* c) { return SvkMat{(T)c[0], (T)c[1], (T)c[2], (T)c[3]}; }

  template <bool PREP>
  __device__ __forceinline__ void primal(const T Du[3][3], const T Fd[3][3], T P[3][3], T* pq,
                                         size_t sE) const {
    T Sm[3][3];
    svk_stress(Du, Fd, lam, mu, eta, lam_d, P, Sm);
    if constexpr (PREP) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          pq[(i * 3 + j) * sE] = Du[i][j];
          pq[(9 + i * 3 + j) * sE] = Sm[i][j];
          pq[(18 + i * 3 + j) * sE] = Fd[i][j];
        }
    }
  }

  __device__ __forceinline__ void hv(const T G[3][3], const T* pq, size_t sE, T dt,
                                     T dP[3][3]) const {
    T Du[3][3], S0[3][3], Fd[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Du[i][j] = pq[(i * 3 + j) * sE];
        S0[i][j] = pq[(9 + i * 3 + j) * sE];
        Fd[i][j] = pq[(18 + i * 3 + j) * sE];
      }
    svk_hv(G, Du, S0, Fd, dt, lam, mu, eta, lam_d, dP);
  }

  __device__ __forceinline__ void tangent(const T Du[3][3], const T dF[3][3], const T Fd[3][3],
                                          const T dFd[3][3], T dP[3][3]) const {
    svk_stress_tangent(Du, dF, Fd, dFd, lam, mu, eta, lam_d, dP);
  }
};

}  // namespace tlfea
