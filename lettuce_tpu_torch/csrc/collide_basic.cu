// Collision fragments of the fused collide-and-stream kernel for Hopper
// (sm_90a): the identity ("none"), forced BGK ("bgk_force": Guo and
// Shan-Chen with a uniform acceleration) and TRT ("trt").
//
// Replaces the "none", "bgk_force" and "trt" fragments of
// lettuce_tpu/ops/pallas/stream_collide.py::_make_collide (:520, :592-676,
// :712-732), in the periodic and the masked kernel of stream_collide.cuh,
// for D2Q9, D3Q15, D3Q19 and D3Q27 in float32 and float64; TRT also as
// emit-u instances (K1d), the forward of its adjoint (adjoint_fragments.cu).
//
// What bounds them: device memory, as for BGK (q populations in and out
// per cell, 152 B per D3Q19 float32 update); each adds a few flops per
// population. The algebra that pays on any chip is kept: the forced BGK
// fragment shares its equilibrium and its source between the two members
// of an opposite pair (the (G, H) cache, with the Guo source split into a
// pair-even and a pair-odd part), and TRT computes the relaxed symmetric
// and antisymmetric parts once per pair.

#include "stream_collide.cuh"

namespace lt {

// The identity: every population streams as it is.
template <class S_, class T_>
struct NoCollide {
  using S = S_;
  using T = T_;
  struct Params {
    int unused;
  };

  static Params load(const double*, double) { return Params{0}; }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params&,
                                                 const T (&fv)[S::Q], T,
                                                 const T (&)[S::D], T,
                                                 const Store& store) {
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      store.template put<q>(fv[q]);
    });
  }
};

// BGK with a uniform acceleration a: the equilibrium velocity is shifted to
// u_f = u + k a / rho (k = 1/2 for Guo, tau for Shan-Chen) and, for Guo,
// the source S_q = src w_q ((e_q - u_f)/cs^2 + (e_q.u_f) e_q / cs^4).a is
// added, src = 1 - 1/(2 tau). Per canonical direction e_c of a pair,
//   G = w base + w/2 trho (e_c.u_f)^2/cs^4 - coef u_f.a + cea e_c.u_f/cs^2
//   H = w trho e_c.u_f/cs^2 + cea,   coef = src w / cs^2, cea = coef e_c.a,
// and f_post(+-e_c) = keep f + (G +- H).
// params: [tau_inv, k, has_src, src, a_0, a_1, a_2]
template <class S_, class T_>
struct BgkForce {
  using S = S_;
  using T = T_;
  struct Params {
    T tau_inv, keep, inv_cs2, half_inv_cs2;
    T kacc[S::D];     // k a
    T acc[S::D];      // a
    T coef[S::Q];     // src w_q / cs^2
    T cea[S::Q];      // coef e_q.a, on canonical directions
    int has_src;
  };

  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs;
    const double tau_inv = params[0], k = params[1], src = params[3];
    Params p{};
    p.tau_inv = T(tau_inv);
    p.keep = T(1.0 - tau_inv);
    p.inv_cs2 = T(1.0 / cs2);
    p.half_inv_cs2 = T(0.5 / cs2);
    p.has_src = params[2] != 0.0;
    for (int a = 0; a < S::D; ++a) {
      p.kacc[a] = T(k * params[4 + a]);
      p.acc[a] = T(params[4 + a]);
    }
    for (int q = 0; q < S::Q; ++q) {
      const double coef = src * S::w(q) / cs2;
      double ea = 0.0;
      for (int a = 0; a < S::D; ++a) ea += double(S::e(q, a)) * params[4 + a];
      p.coef[q] = T(coef);
      p.cea[q] = T(coef * ea);
    }
    return p;
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T,
                                                 const Store& store) {
    const T inv_rho = T(1) / rho;
    T uf[S::D], up[S::D];
    T u2f = T(0);
    T ua = T(0);  // u_f . a over the non-zero components of a
#pragma unroll
    for (int a = 0; a < S::D; ++a) {
      uf[a] = u[a] + p.kacc[a] * inv_rho;
      u2f = u2f + uf[a] * uf[a];
      up[a] = uf[a] * p.inv_cs2;
      if (p.acc[a] != T(0)) ua = ua + uf[a] * p.acc[a];
    }
    const T base = p.tau_inv * (rho - rho * (u2f * p.half_inv_cs2));
    const T trho = p.tau_inv * rho;
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      if constexpr (is_rest<S>(q)) {
        T out = p.keep * fv[q] + T(S::w(q)) * base;
        if (p.has_src) out = out - p.coef[q] * ua;
        store.template put<q>(out);
      } else if constexpr (is_canonical<S>(q)) {
        constexpr int o = opposite<S>(q);
        const T wq = T(S::w(q));
        const T eu = eu_canonical<S, T, q>(up, T(0));
        const T teu = trho * eu;
        T H = wq * teu;
        T G = wq * base + T(0.5 * S::w(q)) * (teu * eu);
        if (p.has_src) {
          G = G - p.coef[q] * ua;
          if (p.cea[q] != T(0)) {
            G = G + p.cea[q] * eu;
            H = H + p.cea[q];
          }
        }
        store.template put<q>(p.keep * fv[q] + (G + H));
        store.template put<o>(p.keep * fv[o] + (G - H));
      }
    });
  }
};

// chip_smoke.py phase 36 times each cell count of its masked 16-bit
// instances (the Poiseuille cell)
template <class S, class T>
struct TimedCells<BgkForce<S, T>> : std::true_type {};

// TRT: per opposite pair (a, b), a < b,
//   sp = (((f_a + f_b) - (feq_a + feq_b)) / (2 tau_plus),
//   sm = (((f_a - f_b) - (feq_a - feq_b)) / (2 tau_minus),
//   f_post_a = f_a - sp - sm,  f_post_b = f_b - sp + sm.
// params: [tau_plus, tau_minus]
template <class S_, class T_>
struct Trt {
  using S = S_;
  using T = T_;
  struct Params {
    T cp, cm, inv_cs2, half_inv_cs2;
  };

  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs;
    return Params{T(0.5 / params[0]), T(0.5 / params[1]), T(1.0 / cs2),
                  T(0.5 / cs2)};
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 const Store& store) {
    T up[S::D], feq[S::Q];
#pragma unroll
    for (int a = 0; a < S::D; ++a) up[a] = u[a] * p.inv_cs2;
    feq_pairs<S, T>(rho, rho - rho * (u2 * p.half_inv_cs2), up, feq);
    store.template put<0>(fv[0] - p.cp * ((fv[0] + fv[0]) -
                                          (feq[0] + feq[0])));
    static_for<kPairs<S>>([&](auto K_) {
      constexpr int a = pair_first<S>(decltype(K_)::value);
      constexpr int b = opposite<S>(a);
      const T sp = p.cp * ((fv[a] + fv[b]) - (feq[a] + feq[b]));
      const T sm = p.cm * ((fv[a] - fv[b]) - (feq[a] - feq[b]));
      store.template put<a>(fv[a] - sp - sm);
      store.template put<b>(fv[b] - sp + sm);
    });
  }
};

}  // namespace lt

// half_*.cu include this source for its policies alone
#ifndef LT_POLICIES_ONLY

extern "C" {

LT_COLLIDE_ENTRIES(none, d2q9, lt::NoCollide, D2Q9)
LT_COLLIDE_ENTRIES(none, d3q15, lt::NoCollide, D3Q15)
LT_COLLIDE_ENTRIES(none, d3q19, lt::NoCollide, D3Q19)
LT_COLLIDE_ENTRIES(none, d3q27, lt::NoCollide, D3Q27)
LT_COLLIDE_ENTRIES(bgk_force, d2q9, lt::BgkForce, D2Q9)
LT_COLLIDE_ENTRIES(bgk_force, d3q15, lt::BgkForce, D3Q15)
LT_COLLIDE_ENTRIES(bgk_force, d3q19, lt::BgkForce, D3Q19)
LT_COLLIDE_ENTRIES(bgk_force, d3q27, lt::BgkForce, D3Q27)
LT_COLLIDE_ENTRIES(trt, d2q9, lt::Trt, D2Q9)
LT_COLLIDE_ENTRIES(trt, d3q15, lt::Trt, D3Q15)
LT_COLLIDE_ENTRIES(trt, d3q19, lt::Trt, D3Q19)
LT_COLLIDE_ENTRIES(trt, d3q27, lt::Trt, D3Q27)
LT_COLLIDE_EMIT_U_ENTRIES(trt, d2q9, lt::Trt, D2Q9)
LT_COLLIDE_EMIT_U_ENTRIES(trt, d3q15, lt::Trt, D3Q15)
LT_COLLIDE_EMIT_U_ENTRIES(trt, d3q19, lt::Trt, D3Q19)
LT_COLLIDE_EMIT_U_ENTRIES(trt, d3q27, lt::Trt, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
