// Collision fragments of the fused collide-and-stream kernel for Hopper
// (sm_90a) that go through the second moments of f_neq: regularized
// ("reg", Latt & Chopard) and Smagorinsky LES ("smag").
//
// Replaces the "reg" and "smag" fragments of
// lettuce_tpu/ops/pallas/stream_collide.py::_make_collide (:747-798,
// :800-841), in the periodic and the masked kernel of stream_collide.cuh,
// for D2Q9, D3Q15, D3Q19 and D3Q27 in float32 and float64; the regularized
// also as emit-u instances (K1d), the forward of its adjoint.
//
// What bounds them: device memory at small q; the D3Q27 regularized
// fragment is the heaviest here, ~180 flops per cell. The design keeps
// the TPU fragment's algebra, which pays on any chip: the projection
// f' = feq + (1 - 1/tau) P f_neq factors through the d(d+1)/2 symmetric
// second moments (M1: pure adds and subtracts of the pair sums of f_neq;
// M2: a table of d(d+1)/2 coefficients per pair, built once on the host
// and read from the parameter bank), and the correction g is shared by the
// two members of each pair; the q x q projector is never formed.
// Smagorinsky builds Pi_neq the same way, then the 2-step fixed point
// for tau_eff with nu = (tau - 0.5) / 3 as the fragment writes it.

#include "stream_collide.cuh"

namespace lt {

// the d(d+1)/2 components (a, b), a <= b, of a symmetric tensor
template <class S>
constexpr int kComps = S::D * (S::D + 1) / 2;

template <class S>
__host__ __device__ constexpr int comp_a(int c) {
  int n = 0;
  for (int a = 0; a < S::D; ++a)
    for (int b = a; b < S::D; ++b, ++n)
      if (n == c) return a;
  return -1;
}

template <class S>
__host__ __device__ constexpr int comp_b(int c) {
  int n = 0;
  for (int a = 0; a < S::D; ++a)
    for (int b = a; b < S::D; ++b, ++n)
      if (n == c) return b;
  return -1;
}

// the representative direction of rep r: the rest (r = 0), then the first
// member of each pair
template <class S>
__host__ __device__ constexpr int rep_q(int r) {
  return r == 0 ? 0 : pair_first<S>(r - 1);
}

// sum_i e_qa e_qb v[i] over the directions q of i = 0..N-1 (q = i, or
// the representative rep_q(i) when Reps), e_qa e_qb in {-1, 0, 1}: adds
// and subtracts only, in ascending order
template <class S, class T, int N, int A, int B, bool Reps, class V>
__device__ __forceinline__ T second_moment(const V& v) {
  T acc = T(0);
  static_for<N>([&](auto I_) {
    constexpr int i = decltype(I_)::value;
    constexpr int q = Reps ? rep_q<S>(i) : i;
    constexpr int c = S::e(q, A) * S::e(q, B);
    if constexpr (c == 1) {
      acc = acc + v[i];
    } else if constexpr (c == -1) {
      acc = acc - v[i];
    }
  });
  return acc;
}

// Regularized: f_post = feq + g, g_r = sum_c M2[r][c] Pi_c with
//   Pi_c = sum_r e_ra e_rb (f_neq summed over the pair of r)   (M1)
//   M2[r][c] = w_r (1 - 1/tau) / (2 cs^4) (e_ra e_rb - cs^2 delta_ab)
//              * (2 if a != b)
// and g shared within each pair.
// params: [tau]
template <class S_, class T_>
struct Reg {
  using S = S_;
  using T = T_;
  static constexpr int R = 1 + kPairs<S>;
  struct Params {
    T inv_cs2, half_inv_cs2;
    T m2[R][kComps<S>];
  };

  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs;
    const double kk = 1.0 - 1.0 / params[0];
    Params p{};
    p.inv_cs2 = T(1.0 / cs2);
    p.half_inv_cs2 = T(0.5 / cs2);
    for (int r = 0; r < R; ++r) {
      const int q = rep_q<S>(r);
      for (int c = 0; c < kComps<S>; ++c) {
        const int a = comp_a<S>(c), b = comp_b<S>(c);
        p.m2[r][c] = T((S::w(q) * kk / (2.0 * cs2 * cs2)) *
                       (S::e(q, a) * S::e(q, b) - (a == b ? cs2 : 0.0)) *
                       (a != b ? 2.0 : 1.0));
      }
    }
    return p;
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 const Store& store) {
    T up[S::D], feq[S::Q], ue[R];
#pragma unroll
    for (int a = 0; a < S::D; ++a) up[a] = u[a] * p.inv_cs2;
    feq_pairs<S, T>(rho, rho - rho * (u2 * p.half_inv_cs2), up, feq);
    // f_neq on the even basis: the rest, then the pair sums
    ue[0] = fv[0] - feq[0];
    static_for<kPairs<S>>([&](auto K_) {
      constexpr int a = pair_first<S>(decltype(K_)::value);
      constexpr int b = opposite<S>(a);
      ue[decltype(K_)::value + 1] = (fv[a] - feq[a]) + (fv[b] - feq[b]);
    });
    T mom[kComps<S>];
    static_for<kComps<S>>([&](auto C_) {
      constexpr int c = decltype(C_)::value;
      mom[c] = second_moment<S, T, R, comp_a<S>(c), comp_b<S>(c), true>(ue);
    });
    static_for<R>([&](auto R_) {
      constexpr int r = decltype(R_)::value;
      constexpr int q = rep_q<S>(r);
      T g = T(0);
      static_for<kComps<S>>([&](auto C_) {
        constexpr int c = decltype(C_)::value;
        constexpr int a = comp_a<S>(c), b = comp_b<S>(c);
        // M2 vanishes off the diagonal where e_qa e_qb = 0
        if constexpr (a == b || S::e(q, a) * S::e(q, b) != 0) {
          g = g + p.m2[r][c] * mom[c];
        }
      });
      store.template put<q>(feq[q] + g);
      if constexpr (r > 0) {
        constexpr int o = opposite<S>(q);
        store.template put<o>(feq[o] + g);
      }
    });
  }
};

// Smagorinsky: S_ab = Pi_neq_ab / (2 rho cs^2); twice
//   nu_t = C^2 sum_ab (S_ab / tau_eff)^2,  tau_eff = 3 (nu + nu_t) + 1/2,
// from tau_eff = tau; then BGK with tau_eff.
// params: [tau, C]
template <class S_, class T_>
struct Smag {
  using S = S_;
  using T = T_;
  struct Params {
    T tau, nu, c2, inv_2cs2, inv_cs2, half_inv_cs2;
  };

  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs;
    const double tau = params[0], c = params[1];
    return Params{T(tau),          T((tau - 0.5) / 3.0), T(c * c),
                  T(1.0 / (2.0 * cs2)), T(1.0 / cs2),   T(0.5 / cs2)};
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 const Store& store) {
    T up[S::D], feq[S::Q], fneq[S::Q];
#pragma unroll
    for (int a = 0; a < S::D; ++a) up[a] = u[a] * p.inv_cs2;
    feq_pairs<S, T>(rho, rho - rho * (u2 * p.half_inv_cs2), up, feq);
#pragma unroll
    for (int q = 0; q < S::Q; ++q) fneq[q] = fv[q] - feq[q];
    const T inv2rhocs2 = p.inv_2cs2 / rho;
    T shear[kComps<S>];
    static_for<kComps<S>>([&](auto C_) {
      constexpr int c = decltype(C_)::value;
      shear[c] = second_moment<S, T, S::Q, comp_a<S>(c), comp_b<S>(c),
                               false>(fneq) *
                 inv2rhocs2;
    });
    T tau_eff = p.tau;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      T ssum = T(0);
      static_for<kComps<S>>([&](auto C_) {
        constexpr int c = decltype(C_)::value;
        const T s = shear[c] / tau_eff;
        T t2 = s * s;
        if constexpr (comp_a<S>(c) != comp_b<S>(c)) t2 = t2 * T(2);
        ssum = ssum + t2;
      });
      tau_eff = (p.nu + p.c2 * ssum) * T(3) + T(0.5);
    }
    const T tau_eff_inv = T(1) / tau_eff;
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      store.template put<q>(fv[q] - tau_eff_inv * fneq[q]);
    });
  }
};

}  // namespace lt

// half_*.cu include this source for its policies alone
#ifndef LT_POLICIES_ONLY

extern "C" {

LT_COLLIDE_ENTRIES(reg, d2q9, lt::Reg, D2Q9)
LT_COLLIDE_ENTRIES(reg, d3q15, lt::Reg, D3Q15)
LT_COLLIDE_ENTRIES(reg, d3q19, lt::Reg, D3Q19)
LT_COLLIDE_ENTRIES(reg, d3q27, lt::Reg, D3Q27)
LT_COLLIDE_EMIT_U_ENTRIES(reg, d2q9, lt::Reg, D2Q9)
LT_COLLIDE_EMIT_U_ENTRIES(reg, d3q15, lt::Reg, D3Q15)
LT_COLLIDE_EMIT_U_ENTRIES(reg, d3q19, lt::Reg, D3Q19)
LT_COLLIDE_EMIT_U_ENTRIES(reg, d3q27, lt::Reg, D3Q27)
LT_COLLIDE_ENTRIES(smag, d2q9, lt::Smag, D2Q9)
LT_COLLIDE_ENTRIES(smag, d3q15, lt::Smag, D3Q15)
LT_COLLIDE_ENTRIES(smag, d3q19, lt::Smag, D3Q19)
LT_COLLIDE_ENTRIES(smag, d3q27, lt::Smag, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
