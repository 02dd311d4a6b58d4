// The MRT collision fragment of the fused collide-and-stream kernel for
// Hopper (sm_90a), with its four moment bases:
//   * "from_feq" (D3Q19 d'Humieres): f' = f - C (f - feq),
//   * "lallemand", "dellar" (D2Q9) and "hermite27" (D3Q27):
//     f' = f - C f + A meq(rho, j), the closed-form equilibrium moments,
// with C = M^-1 diag(1/tau) M and A = M^-1 diag(1/tau).
//
// Replaces the "mrt" fragment of
// lettuce_tpu/ops/pallas/stream_collide.py::_make_collide (:843-995), in
// the periodic and the masked kernel of stream_collide.cuh, in float32 and
// float64; from_feq also as emit-u instances (K1d), the forward of its
// adjoint (adjoint_fragments.cu's matvec).
//
// What bounds it: the matrix-vector products. The matrices are known only
// at run time, so they are kernel parameters (the parameter bank, read at
// compile-time offsets), and no zero coefficient is skipped. The fragment
// keeps the TPU kernel's opposite-pair parity fold: C commutes with the
// opposite permutation, so it maps pair sums to pair sums and pair
// differences to pair differences, and the host (ops/cuda/stream_collide.py)
// folds it into an even block ce [(1 + P) x (1 + P)] on (rest, pair sums)
// and an odd block co [P x P] on pair differences: 181 multiply-adds per
// D3Q19 cell instead of 361. A meq splits the same way by the parity of
// each moment, fixed per basis at compile time (the host checks that the
// transform's matrix has it). The host refuses a transform that fails
// either check.

#include "stream_collide.cuh"

namespace lt {

enum MeqKind : int { kFromFeq = 0, kLallemand = 1, kDellar = 2, kHermite = 3 };

// the 27 tensor-Hermite multi-indices, in the order of the basis
__host__ __device__ constexpr int hermite_index(int k, int a) {
  constexpr int t[27][3] = {
      {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {2, 0, 0}, {1, 1, 0},
      {1, 0, 1}, {0, 2, 0}, {0, 1, 1}, {0, 0, 2}, {2, 1, 0}, {2, 0, 1},
      {1, 2, 0}, {1, 1, 1}, {1, 0, 2}, {0, 2, 1}, {0, 1, 2}, {2, 2, 0},
      {2, 1, 1}, {2, 0, 2}, {1, 2, 1}, {1, 1, 2}, {0, 2, 2}, {2, 2, 1},
      {2, 1, 2}, {1, 2, 2}, {2, 2, 2}};
  return t[k][a];
}

// +1 if moment k of the basis is even under e -> -e, -1 if odd
template <int K>
__host__ __device__ constexpr int moment_parity(int k) {
  if constexpr (K == kLallemand) {
    constexpr int t[9] = {1, -1, -1, 1, 1, 1, -1, -1, 1};
    return t[k];
  } else if constexpr (K == kDellar) {
    constexpr int t[9] = {1, -1, -1, 1, 1, 1, 1, -1, -1};
    return t[k];
  } else {
    return ((hermite_index(k, 0) + hermite_index(k, 1) +
             hermite_index(k, 2)) % 2) ? -1 : 1;
  }
}

// Dellar's equilibrium has no N and J moments (6, 7, 8)
template <int K>
__host__ __device__ constexpr bool meq_zero(int k) {
  return K == kDellar && k >= 6;
}

template <class S_, class T_, int K>
struct Mrt {
  using S = S_;
  using T = T_;
  static constexpr int P = kPairs<S>, R = 1 + P;
  static constexpr bool kAnalytic = K != kFromFeq;
  struct Params {
    T inv_cs2, half_inv_cs2;
    T ce[R][R];                      // C on (rest, pair sums)
    T co[P][P];                      // C on pair differences
    T ae[kAnalytic ? R : 1][S::Q];   // A, rows of the rest and first members
    T ao[kAnalytic ? P : 1][S::Q];   // A, rows of the first members
  };

  // params: ce (R x R), co (P x P), then, for a closed form, ae (R x Q)
  // and ao (P x Q), row-major
  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs;
    Params p{};
    p.inv_cs2 = T(1.0 / cs2);
    p.half_inv_cs2 = T(0.5 / cs2);
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < R; ++c) p.ce[r][c] = T(*params++);
    for (int r = 0; r < P; ++r)
      for (int c = 0; c < P; ++c) p.co[r][c] = T(*params++);
    if constexpr (kAnalytic) {
      for (int r = 0; r < R; ++r)
        for (int k = 0; k < S::Q; ++k) p.ae[r][k] = T(*params++);
      for (int r = 0; r < P; ++r)
        for (int k = 0; k < S::Q; ++k) p.ao[r][k] = T(*params++);
    }
    return p;
  }

  // out = C v through the even and odd blocks
  __device__ __forceinline__ static void apply_c(const Params& p,
                                                 const T (&v)[S::Q],
                                                 T (&out)[S::Q]) {
    T ue[R], uo[P];
    ue[0] = v[0];
    static_for<P>([&](auto K_) {
      constexpr int k = decltype(K_)::value;
      constexpr int a = pair_first<S>(k);
      constexpr int b = opposite<S>(a);
      ue[k + 1] = v[a] + v[b];
      uo[k] = v[a] - v[b];
    });
    static_for<R>([&](auto R_) {
      constexpr int r = decltype(R_)::value;
      T ev = T(0);
#pragma unroll
      for (int c = 0; c < R; ++c) ev = ev + p.ce[r][c] * ue[c];
      if constexpr (r == 0) {
        out[0] = ev;
      } else {
        constexpr int a = pair_first<S>(r - 1);
        constexpr int b = opposite<S>(a);
        T od = T(0);
#pragma unroll
        for (int c = 0; c < P; ++c) od = od + p.co[r - 1][c] * uo[c];
        out[a] = ev + od;
        out[b] = ev - od;
      }
    });
  }

  // the closed-form equilibrium moments from rho and j = rho u
  __device__ __forceinline__ static void equilibrium_moments(
      T rho, const T (&u)[S::D], T (&meq)[S::Q]) {
    T j[S::D];
#pragma unroll
    for (int a = 0; a < S::D; ++a) j[a] = rho * u[a];
    if constexpr (K == kLallemand) {
      const T j2 = j[0] * j[0] + j[1] * j[1];
      meq[0] = rho;
      meq[1] = j[0];
      meq[2] = j[1];
      meq[3] = T(1.0 / 3.0) * (j[0] * j[0] - j[1] * j[1]);
      meq[4] = T(1.0 / 3.0) * (j[0] * j[1]);
      meq[5] = T(-2) * rho + T(3) * j2;
      meq[6] = -j[0];
      meq[7] = -j[1];
      meq[8] = rho - T(3) * j2;
    } else if constexpr (K == kDellar) {
      const T inv_r = T(1) / rho;
      meq[0] = rho;
      meq[1] = j[0];
      meq[2] = j[1];
      meq[3] = j[0] * j[0] * inv_r * T(4.5);
      meq[4] = j[0] * j[1] * inv_r * T(9);
      meq[5] = j[1] * j[1] * inv_r * T(4.5);
      meq[6] = meq[7] = meq[8] = T(0);
    } else {
      // products of momenta over rho^(order - 1)
      const T inv_r = T(1) / rho;
      T inv_pow[6];
      inv_pow[1] = inv_r;
#pragma unroll
      for (int n = 2; n < 6; ++n) inv_pow[n] = inv_pow[n - 1] * inv_r;
      T sq[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) sq[a] = j[a] * j[a];
      meq[0] = rho;
      meq[1] = j[0];
      meq[2] = j[1];
      meq[3] = j[2];
      static_for<S::Q - 4>([&](auto K_) {
        constexpr int k = decltype(K_)::value + 4;
        constexpr int order = hermite_index(k, 0) + hermite_index(k, 1) +
                              hermite_index(k, 2);
        T val = T(0);
        bool first = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int n = hermite_index(k, a);
          if (n == 0) continue;
          const T factor = n == 1 ? j[a] : sq[a];
          val = first ? factor : val * factor;
          first = false;
        }
        meq[k] = val * inv_pow[order - 1];
      });
    }
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 const Store& store) {
    T cv[S::Q];
    if constexpr (!kAnalytic) {
      T up[S::D], dv[S::Q];
#pragma unroll
      for (int a = 0; a < S::D; ++a) up[a] = u[a] * p.inv_cs2;
      feq_pairs<S, T>(rho, rho - rho * (u2 * p.half_inv_cs2), up, dv);
#pragma unroll
      for (int q = 0; q < S::Q; ++q) dv[q] = fv[q] - dv[q];
      apply_c(p, dv, cv);
      static_for<S::Q>([&](auto Q_) {
        constexpr int q = decltype(Q_)::value;
        store.template put<q>(fv[q] - cv[q]);
      });
    } else {
      T meq[S::Q];
      apply_c(p, fv, cv);
      equilibrium_moments(rho, u, meq);
      static_for<R>([&](auto R_) {
        constexpr int r = decltype(R_)::value;
        constexpr int a = r == 0 ? 0 : pair_first<S>(r - 1);
        T ev = T(0), od = T(0);
        static_for<S::Q>([&](auto K_) {
          constexpr int k = decltype(K_)::value;
          if constexpr (!meq_zero<K>(k)) {
            if constexpr (moment_parity<K>(k) > 0) {
              ev = ev + p.ae[r][k] * meq[k];
            } else if constexpr (r > 0) {
              od = od + p.ao[r - 1][k] * meq[k];
            }
          }
        });
        store.template put<a>((fv[a] - cv[a]) + (ev + od));
        if constexpr (r > 0) {
          constexpr int b = opposite<S>(a);
          store.template put<b>((fv[b] - cv[b]) + (ev - od));
        }
      });
    }
  }
};

template <class S, class T>
using MrtFromFeq = Mrt<S, T, kFromFeq>;
template <class S, class T>
using MrtLallemand = Mrt<S, T, kLallemand>;
template <class S, class T>
using MrtDellar = Mrt<S, T, kDellar>;
template <class S, class T>
using MrtHermite = Mrt<S, T, kHermite>;

// The float32 D3Q27 instances take more than 128 registers a thread:
// compiled for each minimum of blocks per SM that chip_smoke.py phase 36
// times (1, none, to 4, at most 128 registers a thread); the host plans
// the fastest (ops/cuda/build.py's MIN_BLOCKS).
template <>
struct BlockChoices<MrtHermite<D3Q27, float>, Same<float>> {
  using type = Ints<1, 2, 3, 4>;
};

}  // namespace lt

// half_*.cu include this source for its policies alone
#ifndef LT_POLICIES_ONLY

extern "C" {

LT_COLLIDE_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq, D3Q19)
LT_COLLIDE_EMIT_U_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq, D3Q19)
LT_COLLIDE_ENTRIES(mrt_lallemand, d2q9, lt::MrtLallemand, D2Q9)
LT_COLLIDE_ENTRIES(mrt_dellar, d2q9, lt::MrtDellar, D2Q9)
LT_COLLIDE_ENTRIES(mrt_hermite27, d3q27, lt::MrtHermite, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
