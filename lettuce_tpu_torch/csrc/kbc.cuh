// The KBC (entropic, Karlin-Boesch-Chikatamarla) collision policy on D2Q9
// and D3Q27, shared by its forward fragment (collide_kbc.cu, and through it
// the 16-bit and blocked instances) and its adjoint (adjoint_fragments.cu's
// KbcAdjoint), which recomputes the forward from the same pieces.
//
// f_post = f - beta (2 ds + gamma dh): ds is the shear part of f - feq
// (from the second-moment deltas dT, dN, dPi; zero on the D3Q27 corners),
// dh = f - feq - ds the higher-order part, and the stabiliser
//   gamma = 1/beta - (2 - 1/beta) sum(ds dh / feq) / sum(dh dh / feq)
// with gamma = 2 where it is below 1e-15 or NaN (an equilibrium cell,
// 0/0). The kernels are built without --use_fast_math, so the isnan guard
// stays.
//
// The design keeps the TPU fragment's pair algebra: feq(+-e) = w (c_eff
// +- rho e.u/cs^2) per pair, one reciprocal per pair (1/feq(+e) = feq(-e)
// / (feq(+e) feq(-e))), the raw second moments from pair sums, and the
// stabiliser's sum over ds dh / feq grouped by the ds tracer it shares (7
// multiplies on D3Q27, not 19). The reciprocals are IEEE divisions: the
// TPU kernel's approximate reciprocal was a VPU device and is not used
// here.

#pragma once

#include "stream_collide.cuh"

namespace lt {

// ds tracer group of direction q (-1: none) and its sign, in the order the
// stabiliser sums them. D2Q9: T, p, m, xy. D3Q27: T, x, y, z, yz, xz, xy.
template <class S>
struct KbcGroups;

template <>
struct KbcGroups<D2Q9> {
  static constexpr int n = 4;
  __host__ __device__ static constexpr int group(int q) {
    constexpr int t[9] = {0, 1, 2, 1, 2, 3, 3, 3, 3};
    return t[q];
  }
  __host__ __device__ static constexpr int sign(int q) {
    constexpr int t[9] = {1, 1, 1, 1, 1, 1, -1, 1, -1};
    return t[q];
  }
};

template <>
struct KbcGroups<D3Q27> {
  static constexpr int n = 7;
  __host__ __device__ static constexpr int group(int q) {
    constexpr int t[27] = {0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5,
                           5, 6, 6, 6, 6, -1, -1, -1, -1, -1, -1, -1, -1};
    return t[q];
  }
  __host__ __device__ static constexpr int sign(int q) {
    constexpr int t[27] = {1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1,
                           -1, 1, 1, -1, -1, 1, 1, 1, 1, 1, 1, 1, 1};
    return t[q];
  }
};

// params: [tau]
template <class S_, class T_>
struct Kbc {
  using S = S_;
  using T = T_;
  using G = KbcGroups<S>;
  struct Params {
    T beta, inv_beta, two_minus_inv_beta, two_beta;
    T inv_cs2, half_inv_cs2, d_cs2;  // d cs^2: the trace of m2(feq)/rho - u u
  };

  static Params load(const double* params, double cs) {
    const double cs2 = cs * cs;
    const double beta = 1.0 / (2.0 * params[0]);
    const double inv_beta = 1.0 / beta;
    return Params{T(beta),        T(inv_beta),  T(2.0 - inv_beta),
                  T(2.0 * beta),  T(1.0 / cs2), T(0.5 / cs2),
                  T(S::D * cs2)};
  }

  // sum over pairs of e_a e_b (f(+e) + f(-e)), times 1/rho
  template <int A, int B>
  __device__ __forceinline__ static T second_moment(const T (&ps)[kPairs<S>],
                                                    T inv_rho) {
    T acc = T(0);
    static_for<kPairs<S>>([&](auto K_) {
      constexpr int k = decltype(K_)::value;
      constexpr int q = pair_first<S>(k);
      constexpr int c = S::e(q, A) * S::e(q, B);
      if constexpr (c == 1) {
        acc = acc + ps[k];
      } else if constexpr (c == -1) {
        acc = acc - ps[k];
      }
    });
    return acc * inv_rho;
  }

  // c_shift = rho - rho u^2 / (2 cs^2): feq(rest) = w c_shift
  __device__ __forceinline__ static T shift(const Params& p, T rho, T u2) {
    return rho - rho * (u2 * p.half_inv_cs2);
  }

  // feq and 1/feq of the pair of the canonical direction q (o its
  // opposite): feq(+-e) = w (c_eff +- re), c_eff = c_shift + re eu / 2,
  // re = rho e.u/cs^2, up = u / cs^2; one division for the pair
  template <int q>
  __device__ __forceinline__ static void equilibrium_pair(
      const T (&up)[S::D], T rho, T c_shift, T& feq_q, T& feq_o, T& recip_q,
      T& recip_o) {
    static_assert(!is_rest<S>(q) && is_canonical<S>(q),
                  "a pair is keyed on its canonical direction");
    const T eu = eu_canonical<S, T, q>(up, T(0));
    const T re = rho * eu;
    const T c_eff = c_shift + re * (eu * T(0.5));
    const T wq = T(S::w(q));
    feq_q = wq * (c_eff + re);
    feq_o = wq * (c_eff - re);
    const T invpm = T(1) / (feq_q * feq_o);
    recip_q = feq_o * invpm;
    recip_o = feq_q * invpm;
  }

  // the shear tracers ds per group, from the pair sums' raw second moments
  __device__ __forceinline__ static void tracers(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 T (&ds)[G::n]) {
    const T inv_rho = T(1) / rho;
    T ps[kPairs<S>];
    static_for<kPairs<S>>([&](auto K_) {
      constexpr int k = decltype(K_)::value;
      constexpr int q = pair_first<S>(k);
      ps[k] = fv[q] + fv[opposite<S>(q)];
    });
    if constexpr (S::D == 3) {
      const T m200 = second_moment<0, 0>(ps, inv_rho);
      const T m020 = second_moment<1, 1>(ps, inv_rho);
      const T m002 = second_moment<2, 2>(ps, inv_rho);
      const T dT = (m200 + m020 + m002) - (u2 + p.d_cs2);
      const T dNxz = (m200 - m002) - (u[0] * u[0] - u[2] * u[2]);
      const T dNyz = (m020 - m002) - (u[1] * u[1] - u[2] * u[2]);
      const T dPxy = second_moment<0, 1>(ps, inv_rho) - u[0] * u[1];
      const T dPxz = second_moment<0, 2>(ps, inv_rho) - u[0] * u[2];
      const T dPyz = second_moment<1, 2>(ps, inv_rho) - u[1] * u[2];
      const T r6 = rho * T(1. / 6.);
      const T r4 = T(0.25) * rho;
      ds[0] = rho * -dT;
      ds[1] = r6 * (T(2) * dNxz - dNyz + dT);
      ds[2] = r6 * (T(2) * dNyz - dNxz + dT);
      ds[3] = r6 * (-dNxz - dNyz + dT);
      ds[4] = r4 * dPyz;
      ds[5] = r4 * dPxz;
      ds[6] = r4 * dPxy;
    } else {
      const T m20 = second_moment<0, 0>(ps, inv_rho);
      const T m02 = second_moment<1, 1>(ps, inv_rho);
      const T dT = (m20 + m02) - (u2 + p.d_cs2);
      const T dN = (m20 - m02) - (u[0] * u[0] - u[1] * u[1]);
      const T dPxy = second_moment<0, 1>(ps, inv_rho) - u[0] * u[1];
      const T r4 = T(0.25) * rho;
      ds[0] = rho * -dT;
      ds[1] = r4 * (dT + dN);
      ds[2] = r4 * (dT - dN);
      ds[3] = r4 * dPxy;
    }
  }

  // ds_q: the tracer of q's group with q's sign (0 on the corners)
  template <int q>
  __device__ __forceinline__ static T shear(const T (&ds)[G::n]) {
    constexpr int g = G::group(q);
    if constexpr (g < 0) {
      return T(0);
    } else if constexpr (G::sign(q) > 0) {
      return ds[g];
    } else {
      return -ds[g];
    }
  }

  // dh_q = f_q - feq_q - ds_q, added to the stabiliser's sums: sum_h over
  // q, sum_s grouped by tracer (group_acc)
  template <int q>
  __device__ __forceinline__ static T deviation(T f, T feq, T recip,
                                                const T (&ds)[G::n],
                                                T (&group_acc)[G::n],
                                                T& sum_h) {
    constexpr int g = G::group(q);
    T dh;
    if constexpr (g < 0) {
      dh = f - feq;
    } else if constexpr (G::sign(q) > 0) {
      dh = f - feq - ds[g];
    } else {
      dh = f - feq + ds[g];
    }
    const T dof = dh * recip;
    if constexpr (g >= 0) {
      if constexpr (G::sign(q) > 0) {
        group_acc[g] = group_acc[g] + dof;
      } else {
        group_acc[g] = group_acc[g] - dof;
      }
    }
    sum_h = sum_h + dh * dof;
    return dh;
  }

  // the stabiliser gamma, and whether its guard set it to 2
  __device__ __forceinline__ static T stabiliser(const Params& p, T sum_s,
                                                 T sum_h, bool& fired) {
    const T gamma = p.inv_beta - (p.two_minus_inv_beta * sum_s) / sum_h;
    fired = gamma < T(1e-15) || isnan(gamma);
    return fired ? T(2) : gamma;
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 const Store& store) {
    T up[S::D];
#pragma unroll
    for (int a = 0; a < S::D; ++a) up[a] = u[a] * p.inv_cs2;

    const T c_shift = shift(p, rho, u2);
    T feq[S::Q], recip[S::Q];
    feq[0] = T(S::w(0)) * c_shift;
    recip[0] = T(1) / feq[0];
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      if constexpr (!is_rest<S>(q) && is_canonical<S>(q)) {
        constexpr int o = opposite<S>(q);
        equilibrium_pair<q>(up, rho, c_shift, feq[q], feq[o], recip[q],
                            recip[o]);
      }
    });

    T ds[G::n];
    tracers(p, fv, rho, u, u2, ds);

    // dh, and the stabiliser sums
    T dh[S::Q], group_acc[G::n];
#pragma unroll
    for (int g = 0; g < G::n; ++g) group_acc[g] = T(0);
    T sum_h = T(0);
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      dh[q] = deviation<q>(fv[q], feq[q], recip[q], ds, group_acc, sum_h);
    });
    T sum_s = T(0);
#pragma unroll
    for (int g = 0; g < G::n; ++g) sum_s = sum_s + ds[g] * group_acc[g];

    bool fired;
    const T bg = p.beta * stabiliser(p, sum_s, sum_h, fired);
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      constexpr int g = G::group(q);
      const T core = fv[q] - bg * dh[q];
      if constexpr (g < 0) {
        store.template put<q>(core);
      } else if constexpr (G::sign(q) > 0) {
        store.template put<q>(core - p.two_beta * ds[g]);
      } else {
        store.template put<q>(core + p.two_beta * ds[g]);
      }
    });
  }
};

}  // namespace lt
