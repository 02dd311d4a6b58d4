// Adjoints of the collision fragments of the fused collide-and-stream step
// for Hopper (sm_90a): the identity ("none"), TRT ("trt"), any f-linear
// relaxation through a static matrix ("matvec": the folded MRT from_feq and
// the regularized collision), Smagorinsky LES ("smag") and the entropic
// KBC collision ("kbc", D2Q9 and D3Q27 only: its forward's stencils).
//
// Replaces the "none" (:257-267), "trt" (:423-433), "matvec" (:434-446)
// and "smag" (:299-422) specs of
// lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel, in the periodic and
// the masked kernel of adjoint.cuh, for D2Q9, D3Q15, D3Q19 and D3Q27 in
// float32 and float64. lettuce_tpu differentiates KBC in split mode
// (build_adjoint_step's jax.vjp of the pointwise map, :785-793); here it
// has a kernel of its own. Each computes the exact vector-Jacobian product of
// one step of its forward fragment (collide_*.cu):
//   * none: ct = h, the streaming transpose alone; with a no-streaming mask
//     and no code mask it is split mode's S^T (the closed-form MRT bases
//     and forced BGK, whose pointwise Jacobian runs in torch after it:
//     ops/cuda/adjoint.py::prestream_vjp);
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
//     deviations, so it reads the state residual f;
//   * kbc: the hand-derived reverse of KBC's forward (KbcAdjoint below),
//     recomputed in registers from the state residual f.
//
// What bounds them: device memory. D3Q19 float32 with the u residual moves
// 164 B per lattice update (as the BGK adjoint), with the f residual 228 B,
// none 152 B; KBC on D3Q27 324 B (27 values each of g, f and the
// cotangent), with registers the constraint, as for its forward. The
// matvec's run-time coefficients are a __grid_constant__
// parameter read at compile-time offsets (2.9 KB for D3Q27 float64).

#include "adjoint.cuh"
#include "kbc.cuh"

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

// KBC (kbc.cuh): f' = f - beta (2 ds + gamma dh), dh = f - feq - ds,
// gamma = 1/beta - c S_s / S_h, c = 2 - 1/beta, S_s = sum ds dh / feq,
// S_h = sum dh^2 / feq. The forward is recomputed from f in registers with
// the forward's own pieces (cell_moments, the tracers, the pair algebra),
// keeping f (then dh) and h, and recomputing feq and its reciprocal pair
// by pair. The reverse, with h the cotangent of f':
//   gamma_bar = -beta sum h dh (0 where the guard set gamma = 2),
//   S_s_bar = -c gamma_bar / S_h,  S_h_bar = -S_s_bar S_s / S_h,
//   dh_bar = -beta gamma h + S_s_bar ds / feq + 2 S_h_bar dh / feq,
//   ds_bar = -2 beta h + S_s_bar dh / feq - dh_bar,
//   feq_bar = -dh_bar - (S_s_bar ds + S_h_bar dh) dh / feq^2.
// Each tracer is linear in the non-equilibrium second moment
// Q = sum e e f - rho u u - rho cs^2 I: ds = -tr Q on the rest direction,
// Q_aa / 2 along axis a, e_a e_b Q_ab / 4 on the (a, b) edge diagonals, 0
// on the corners. So the tracers' adjoints (D_g = sum over group g of
// sgn_q ds_bar_q) give the symmetric R = Q_bar (R_aa = D_axis / 2 - D_rest,
// R_ab = D_ab / 8), and with dQ_ab / df_q = (e_q - u)_a (e_q - u)_b -
// cs^2 delta_ab:
//   ct_q = h_q + dh_bar_q + (A' + e_q . B)(t = feq_bar) + X_q,
//   X_q = (e_q - u) . R . (e_q - u) - cs^2 tr R,
// the middle term the equilibrium's transpose (equilibrium_ab).
// params: [tau]
template <class S_, class T_>
struct KbcAdjoint {
  using S = S_;
  using T = T_;
  using K = Kbc<S, T>;
  using G = KbcGroups<S>;
  static constexpr Residual kResidual = kResidualF;
  static constexpr int kSym = S::D * (S::D + 1) / 2;
  struct Params {
    typename K::Params k;
    EquilibriumConsts<T> c;
    T cs2;
  };

  static Params load(const double* params, double cs) {
    return Params{K::load(params, cs), equilibrium_consts<T>(cs),
                  T(cs * cs)};
  }

  // ds_bar_q into its group's adjoint with q's sign
  template <int q>
  __device__ __forceinline__ static void add_tracer(T ds_bar,
                                                    T (&dbar)[G::n]) {
    constexpr int g = G::group(q);
    if constexpr (g >= 0) {
      if constexpr (G::sign(q) > 0) {
        dbar[g] = dbar[g] + ds_bar;
      } else {
        dbar[g] = dbar[g] - ds_bar;
      }
    }
  }

  // res is the step's input f, stored like the cotangent (St)
  template <class St>
  __device__ __forceinline__ static void transpose(
      const Params& p, T (&h)[S::Q], const typename St::V* __restrict__ res,
      int64_t n, int64_t cell, typename St::V* __restrict__ out) {
    constexpr int D = S::D;
    const typename K::Params& kp = p.k;
    T fv[S::Q];
#pragma unroll
    for (int q = 0; q < S::Q; ++q) fv[q] = St::raw(res + q * n + cell);
    T rho, u[D], u2;
    cell_moments<S, false>(fv, rho, u, u2);
    T ds[G::n];
    K::tracers(kp, fv, rho, u, u2, ds);
    T up[D];
#pragma unroll
    for (int a = 0; a < D; ++a) up[a] = u[a] * kp.inv_cs2;
    const T c_shift = K::shift(kp, rho, u2);

    // the forward's dh (into fv), its stabiliser sums, and h . dh
    T group_acc[G::n];
#pragma unroll
    for (int g = 0; g < G::n; ++g) group_acc[g] = T(0);
    T sum_h = T(0), hdh = T(0);
    const T recip0 = T(1) / (T(S::w(0)) * c_shift);
    fv[0] = K::template deviation<0>(fv[0], T(S::w(0)) * c_shift, recip0,
                                     ds, group_acc, sum_h);
    hdh = hdh + h[0] * fv[0];
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      if constexpr (!is_rest<S>(q) && is_canonical<S>(q)) {
        constexpr int o = opposite<S>(q);
        T fq, fo, rq, ro;
        K::template equilibrium_pair<q>(up, rho, c_shift, fq, fo, rq, ro);
        fv[q] = K::template deviation<q>(fv[q], fq, rq, ds, group_acc, sum_h);
        fv[o] = K::template deviation<o>(fv[o], fo, ro, ds, group_acc, sum_h);
        hdh = hdh + (h[q] * fv[q] + h[o] * fv[o]);
      }
    });
    T sum_s = T(0);
#pragma unroll
    for (int g = 0; g < G::n; ++g) sum_s = sum_s + ds[g] * group_acc[g];
    bool fired;
    const T bg = kp.beta * K::stabiliser(kp, sum_s, sum_h, fired);
    // the stabiliser's adjoint: gamma is the constant 2 where guarded
    T ss_bar = T(0), sh_bar = T(0);
    if (!fired) {
      const T inv_sh = T(1) / sum_h;
      ss_bar = kp.two_minus_inv_beta * (kp.beta * hdh) * inv_sh;
      sh_bar = -ss_bar * sum_s * inv_sh;
    }

    // dh_bar (h becomes h + dh_bar), the tracers' adjoints, and t = feq_bar
    // into its weighted moments
    T dbar[G::n];
#pragma unroll
    for (int g = 0; g < G::n; ++g) dbar[g] = T(0);
    T s0 = T(0), s1[D], s2[kSym];
#pragma unroll
    for (int a = 0; a < D; ++a) s1[a] = T(0);
#pragma unroll
    for (int k = 0; k < kSym; ++k) s2[k] = T(0);
    auto reverse = [&](auto Q_, T recip) {
      constexpr int q = decltype(Q_)::value;
      const T dh = fv[q];
      const T dhr = dh * recip;
      const T dsq = K::template shear<q>(ds);
      T dh_bar = -bg * h[q] + T(2) * sh_bar * dhr;
      if constexpr (G::group(q) >= 0) {
        dh_bar = dh_bar + ss_bar * (dsq * recip);
        KbcAdjoint::template add_tracer<q>(
            (-kp.two_beta * h[q] + ss_bar * dhr) - dh_bar, dbar);
      }
      h[q] = h[q] + dh_bar;
      return -dh_bar - (ss_bar * dsq + sh_bar * dh) * (dhr * recip);
    };
    const T t0 = reverse(std::integral_constant<int, 0>{}, recip0);
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      if constexpr (!is_rest<S>(q) && is_canonical<S>(q)) {
        constexpr int o = opposite<S>(q);
        T fq, fo, rq, ro;
        K::template equilibrium_pair<q>(up, rho, c_shift, fq, fo, rq, ro);
        const T tq = reverse(Q_, rq);
        const T to = reverse(std::integral_constant<int, o>{}, ro);
        add_pair_moments<S, T, q>(tq, to, s0, s1, s2);
      }
    });
    s0 = s0 + T(S::w(0)) * t0;
    T ap, bv[D];
    equilibrium_ab<S, T>(s0, s1, s2, u, p.c, ap, bv);

    // R = Q_bar from the tracers' adjoints, then X's pieces
    T r[kSym];
    r[sym<S>(0, 0)] = T(0.5) * dbar[1] - dbar[0];
    r[sym<S>(1, 1)] = T(0.5) * dbar[2] - dbar[0];
    if constexpr (D == 3) {
      r[sym<S>(2, 2)] = T(0.5) * dbar[3] - dbar[0];
      r[sym<S>(1, 2)] = T(0.125) * dbar[4];
      r[sym<S>(0, 2)] = T(0.125) * dbar[5];
      r[sym<S>(0, 1)] = T(0.125) * dbar[6];
    } else {
      r[sym<S>(0, 1)] = T(0.125) * dbar[3];
    }
    T ru[D];
    T uru = T(0), tr_r = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < D; ++b)
        acc = acc + u[b] * r[a <= b ? sym<S>(a, b) : sym<S>(b, a)];
      ru[a] = acc;
      uru = uru + u[a] * acc;
      tr_r = tr_r + r[sym<S>(a, a)];
    }
    const T base = uru - p.cs2 * tr_r;

    const CellSink<St> sink{out, n, cell};
    sink.template put<0>(h[0] + (ap + base));
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      if constexpr (!is_rest<S>(q) && is_canonical<S>(q)) {
        constexpr int o = opposite<S>(q);
        const T eb = e_dot<S, T, q>(bv, T(0));
        const T even = base + e_pi_e<S, T, q>(r);
        const T godd = T(2) * e_dot<S, T, q>(ru, T(0));
        sink.template put<q>(h[q] + ((ap + eb) + (even - godd)));
        sink.template put<o>(h[o] + ((ap - eb) + (even + godd)));
      }
    });
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
LT_ADJOINT_ENTRIES(kbc, d2q9, lt::KbcAdjoint, D2Q9)
LT_ADJOINT_ENTRIES(kbc, d3q27, lt::KbcAdjoint, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
