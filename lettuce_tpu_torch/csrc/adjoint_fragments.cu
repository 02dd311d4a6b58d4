// Adjoints of the collision fragments of the fused collide-and-stream step
// for Hopper (sm_90a): the identity ("none"), TRT ("trt"), any f-linear
// relaxation through a static matrix ("matvec": the folded MRT from_feq and
// the regularized collision) and Smagorinsky LES ("smag").
//
// Replaces the "none" (:257-267), "trt" (:423-433), "matvec" (:434-446)
// and "smag" (:299-422) specs of
// lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel, in the periodic and
// the masked kernel of adjoint.cuh, for D2Q9, D3Q15, D3Q19 and D3Q27 in
// float32 and float64. Each computes the exact vector-Jacobian product of
// one step of its forward fragment (collide_*.cu):
//   * none: ct = h, the streaming transpose alone; with a no-streaming mask
//     and no code mask it is split mode's S^T (KBC, the closed-form MRT
//     bases and forced BGK, whose pointwise Jacobian runs in torch after
//     it: ops/cuda/adjoint.py::prestream_vjp);
//   * trt: t = (cp + cm) h + (cp - cm) h_opp, the emitted-u residual;
//   * matvec: t = C^T h, C^T folded by opposite-pair parity on the host
//     (ops/cuda/stream_collide.py::_pack_adjoint) into an even block on
//     (rest, pair sums) and an odd block on pair differences, as the
//     forward MRT fragment applies C; the emitted-u residual. C^T commutes
//     with the opposite permutation (the host checks it), so it maps pair
//     sums to pair sums and differences to differences: (1 + P)^2 + P^2
//     multiply-adds per cell instead of q^2 (181 for D3Q19, 365 for D3Q27);
//   * smag: t = s h with s = 1 / tau_eff per cell, plus the derivative of
//     the forward's two-step fixed point for tau_eff (not of the converged
//     tau), in the forward fragment's order; it needs rho and the
//     deviations, so it reads the state residual f.
//
// What bounds them: device memory. D3Q19 float32 with the u residual moves
// 164 B per lattice update (as the BGK adjoint), with the f residual 228 B,
// none 152 B. The matvec's run-time coefficients are a __grid_constant__
// parameter read at compile-time offsets (2.9 KB for D3Q27 float64).

#include "adjoint.cuh"

namespace lt {

// The identity: the cotangent streams back as it is.
template <class S_, class T_>
struct NoneAdjoint {
  using S = S_;
  using T = T_;
  static constexpr Residual kResidual = kResidualNone;
  struct Params {
    int unused;
  };

  static Params load(const double*, double) { return Params{0}; }

  template <class Sink>
  __device__ __forceinline__ static void transpose_u(const Params&,
                                                     T (&h)[S::Q],
                                                     const T (&)[S::D],
                                                     const Sink& sink) {
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      sink.template put<q>(h[q]);
    });
  }

  template <class St>
  __device__ __forceinline__ static void transpose(
      const Params&, T (&h)[S::Q], const T*, int64_t n, int64_t cell,
      typename St::V* __restrict__ out) {
#pragma unroll
    for (int q = 0; q < S::Q; ++q) out[q * n + cell] = St::pack(h[q]);
  }
};

// TRT: M = (cp + cm) I + (cp - cm) O, symmetric (O the opposite
// permutation), cp = 1 / (2 tau_plus), cm = 1 / (2 tau_minus).
// params: [tau_plus, tau_minus]
template <class S_, class T_>
struct TrtAdjoint {
  using S = S_;
  using T = T_;
  static constexpr Residual kResidual = kResidualU;
  struct Params {
    T csum, cdif, two_cp;
    EquilibriumConsts<T> c;
  };

  static Params load(const double* params, double cs) {
    const double cp = 0.5 / params[0], cm = 0.5 / params[1];
    return Params{T(cp + cm), T(cp - cm), T(2.0 * cp),
                  equilibrium_consts<T>(cs)};
  }

  template <class Sink>
  __device__ __forceinline__ static void transpose_u(const Params& p,
                                                     T (&h)[S::Q],
                                                     const T (&u)[S::D],
                                                     const Sink& sink) {
    equilibrium_transpose<S, T, false>(
        h, u, p.c,
        [&](auto K_, T& tp, T& tm) {
          constexpr int q = pair_first<S>(decltype(K_)::value);
          constexpr int o = opposite<S>(q);
          tp = p.csum * h[q] + p.cdif * h[o];
          tm = p.csum * h[o] + p.cdif * h[q];
        },
        [&] { return p.two_cp * h[0]; }, NoExtra{}, NoExtra{}, sink);
  }

  template <class St>
  __device__ __forceinline__ static void transpose(
      const Params& p, T (&h)[S::Q], const T* __restrict__ res, int64_t n,
      int64_t cell, typename St::V* __restrict__ out) {
    T u[S::D];
    load_u<S, T>(res, n, cell, u);
    transpose_u(p, h, u, CellSink<St>{out, n, cell});
  }
};

// t = C^T h through the even and odd blocks of the folded C^T.
// params: ce (R x R), co (P x P), row-major
template <class S_, class T_>
struct MatvecAdjoint {
  using S = S_;
  using T = T_;
  static constexpr Residual kResidual = kResidualU;
  static constexpr int P = kPairs<S>, R = 1 + P;
  struct Params {
    T ce[R][R];  // C^T on (rest, pair sums)
    T co[P][P];  // C^T on pair differences
    EquilibriumConsts<T> c;
  };

  static Params load(const double* params, double cs) {
    Params p{};
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < R; ++c) p.ce[r][c] = T(*params++);
    for (int r = 0; r < P; ++r)
      for (int c = 0; c < P; ++c) p.co[r][c] = T(*params++);
    p.c = equilibrium_consts<T>(cs);
    return p;
  }

  template <class Sink>
  __device__ __forceinline__ static void transpose_u(const Params& p,
                                                     T (&h)[S::Q],
                                                     const T (&u)[S::D],
                                                     const Sink& sink) {
    // the even and odd parts of h, before equilibrium_transpose turns h
    // into h - t pair by pair
    T ue[R], uo[P];
    ue[0] = h[0];
    static_for<P>([&](auto K_) {
      constexpr int k = decltype(K_)::value;
      constexpr int a = pair_first<S>(k);
      constexpr int b = opposite<S>(a);
      ue[k + 1] = h[a] + h[b];
      uo[k] = h[a] - h[b];
    });
    equilibrium_transpose<S, T, false>(
        h, u, p.c,
        [&](auto K_, T& tp, T& tm) {
          constexpr int k = decltype(K_)::value;
          T ev = T(0), od = T(0);
#pragma unroll
          for (int c = 0; c < R; ++c) ev = ev + p.ce[k + 1][c] * ue[c];
#pragma unroll
          for (int c = 0; c < P; ++c) od = od + p.co[k][c] * uo[c];
          tp = ev + od;
          tm = ev - od;
        },
        [&] {
          T ev = T(0);
#pragma unroll
          for (int c = 0; c < R; ++c) ev = ev + p.ce[0][c] * ue[c];
          return ev;
        },
        NoExtra{}, NoExtra{}, sink);
  }

  template <class St>
  __device__ __forceinline__ static void transpose(
      const Params& p, T (&h)[S::Q], const T* __restrict__ res, int64_t n,
      int64_t cell, typename St::V* __restrict__ out) {
    T u[S::D];
    load_u<S, T>(res, n, cell, u);
    transpose_u(p, h, u, CellSink<St>{out, n, cell});
  }
};

// e_q . Pi . e_q from the packed upper triangle of Pi
template <class S, class T, int q>
__device__ __forceinline__ T e_pi_e(const T (&pi)[S::D * (S::D + 1) / 2]) {
  T acc = T(0);
  static_for<S::D>([&](auto A_) {
    constexpr int a = decltype(A_)::value;
    static_for<S::D - a>([&](auto B_) {
      constexpr int b = a + decltype(B_)::value;
      constexpr int c = S::e(q, a) * S::e(q, b);
      if constexpr (c != 0) {
        constexpr int coef = a == b ? c : 2 * c;
        acc = acc + pi[sym<S>(a, b)] * T(coef);
      }
    });
  });
  return acc;
}

// Smagorinsky: f' = f - s(f) d, d = f - feq, s = 1 / tau_eff with the
// forward's two steps tau_{k+1} = tau + a R / tau_k^2 from tau_0 = tau
// (a = 3 C^2, R = |Pi|^2 / (4 cs^4 rho^2), Pi = sum e e d). The transpose is
// the BGK shape with t = s h plus X_q = c0 (base + e_q.Pi.e_q - 2 e_q.Pi u),
// base = u.Pi.u - cs^2 tr Pi - |Pi|^2 / rho,
// c0 = D s^2 (dtau/dR) / (2 cs^4 rho^2), D = d.h.
// params: [tau, C]
template <class S_, class T_>
struct SmagAdjoint {
  using S = S_;
  using T = T_;
  static constexpr Residual kResidual = kResidualF;
  static constexpr int kSym = S::D * (S::D + 1) / 2;
  struct Params {
    T tau0, inv_tau0_2, a_c, two_a_c, cs2, quarter_inv_cs4;
    EquilibriumConsts<T> c;
  };

  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs, tau = params[0], constant = params[1];
    const double a_c = 3.0 * constant * constant;
    return Params{T(tau), T(1.0 / (tau * tau)), T(a_c), T(2.0 * a_c),
                  T(cs2), T(0.25 / (cs2 * cs2)), equilibrium_consts<T>(cs)};
  }

  // res is the step's input f, stored like the cotangent (St)
  template <class St>
  __device__ __forceinline__ static void transpose(
      const Params& p, T (&h)[S::Q], const typename St::V* __restrict__ res,
      int64_t n, int64_t cell, typename St::V* __restrict__ out) {
    constexpr int D = S::D;
    T fv[S::Q];
#pragma unroll
    for (int q = 0; q < S::Q; ++q) fv[q] = St::raw(res + q * n + cell);
    T rho = T(0), jm[D];
#pragma unroll
    for (int a = 0; a < D; ++a) jm[a] = T(0);
    moments<S, T>(fv, rho, jm);
    const T inv_rho = T(1) / rho;
    T u[D];
    T u2 = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      u[a] = jm[a] * inv_rho;
      u2 = u2 + u[a] * u[a];
    }

    // D = d . h and Pi = sum e e d over the pairs (even and odd parts of
    // each pair's equilibrium), then the rest
    T dh = T(0);
    T pi[kSym];
#pragma unroll
    for (int k = 0; k < kSym; ++k) pi[k] = T(0);
    static_for<kPairs<S>>([&](auto K_) {
      constexpr int q = pair_first<S>(decltype(K_)::value);
      constexpr int o = opposite<S>(q);
      const T wq = T(S::w(q));
      const T eu = e_dot<S, T, q>(u, T(0));
      const T ew = wq * rho *
                   (T(1) + p.c.half_inv_cs4 * eu * eu - p.c.half_inv_cs2 * u2);
      const T ow = wq * rho * (p.c.inv_cs2 * eu);
      const T dsum = (fv[q] + fv[o]) - T(2) * ew;
      const T ddif = (fv[q] - fv[o]) - T(2) * ow;
      dh = dh + T(0.5) * (dsum * (h[q] + h[o]) + ddif * (h[q] - h[o]));
      add_s2<S, T, q>(dsum, pi);
    });
    const T d0 = fv[0] - T(S::w(0)) * rho * (T(1) - p.c.half_inv_cs2 * u2);
    dh = dh + d0 * h[0];

    T pp = T(0), tr_pi = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int b = a; b < D; ++b) {
        const T v = pi[sym<S>(a, b)];
        pp = pp + (a == b ? v * v : T(2) * (v * v));
        if (a == b) tr_pi = tr_pi + v;
      }
    }
    const T r = pp * (p.quarter_inv_cs4 * inv_rho * inv_rho);
    // the two steps of the forward's fixed point, with dtau_k / dR
    T dtau = p.a_c * p.inv_tau0_2;
    T tau_c = p.tau0 + p.a_c * r * p.inv_tau0_2;
    {
      const T inv_t2 = T(1) / (tau_c * tau_c);
      dtau = p.a_c * inv_t2 - p.two_a_c * r * inv_t2 * (T(1) / tau_c) * dtau;
      tau_c = p.tau0 + p.a_c * r * inv_t2;
    }
    const T s = T(1) / tau_c;

    T piu[D];
    T upiu = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < D; ++b)
        acc = acc + u[b] * pi[a <= b ? sym<S>(a, b) : sym<S>(b, a)];
      piu[a] = acc;
      upiu = upiu + u[a] * acc;
    }
    const T base = (-p.cs2 * tr_pi - pp * inv_rho) + upiu;
    const T c0 =
        dh * (s * s) * dtau * (p.c.half_inv_cs4 * inv_rho * inv_rho);

    equilibrium_transpose<S, T, true>(
        h, u, p.c,
        [&](auto K_, T& tp, T& tm) {
          constexpr int q = pair_first<S>(decltype(K_)::value);
          tp = s * h[q];
          tm = s * h[opposite<S>(q)];
        },
        [&] { return s * h[0]; },
        [&](auto K_, T& xp, T& xm) {
          constexpr int q = pair_first<S>(decltype(K_)::value);
          const T even = base + e_pi_e<S, T, q>(pi);
          const T godd = e_dot<S, T, q>(piu, T(0));
          xp = c0 * (even - T(2) * godd);
          xm = c0 * (even + T(2) * godd);
        },
        [&] { return c0 * base; }, CellSink<St>{out, n, cell});
  }
};

}  // namespace lt

// adjoint_multi.cu includes this source for its policies alone
#ifndef LT_POLICIES_ONLY

extern "C" {

LT_ADJOINT_ENTRIES(none, d2q9, lt::NoneAdjoint, D2Q9)
LT_ADJOINT_ENTRIES(none, d3q15, lt::NoneAdjoint, D3Q15)
LT_ADJOINT_ENTRIES(none, d3q19, lt::NoneAdjoint, D3Q19)
LT_ADJOINT_ENTRIES(none, d3q27, lt::NoneAdjoint, D3Q27)
LT_ADJOINT_ENTRIES(trt, d2q9, lt::TrtAdjoint, D2Q9)
LT_ADJOINT_ENTRIES(trt, d3q15, lt::TrtAdjoint, D3Q15)
LT_ADJOINT_ENTRIES(trt, d3q19, lt::TrtAdjoint, D3Q19)
LT_ADJOINT_ENTRIES(trt, d3q27, lt::TrtAdjoint, D3Q27)
LT_ADJOINT_ENTRIES(matvec, d2q9, lt::MatvecAdjoint, D2Q9)
LT_ADJOINT_ENTRIES(matvec, d3q15, lt::MatvecAdjoint, D3Q15)
LT_ADJOINT_ENTRIES(matvec, d3q19, lt::MatvecAdjoint, D3Q19)
LT_ADJOINT_ENTRIES(matvec, d3q27, lt::MatvecAdjoint, D3Q27)
LT_ADJOINT_ENTRIES(smag, d2q9, lt::SmagAdjoint, D2Q9)
LT_ADJOINT_ENTRIES(smag, d3q15, lt::SmagAdjoint, D3Q15)
LT_ADJOINT_ENTRIES(smag, d3q19, lt::SmagAdjoint, D3Q19)
LT_ADJOINT_ENTRIES(smag, d3q27, lt::SmagAdjoint, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
