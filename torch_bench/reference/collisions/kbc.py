"""The entropic multi-relaxation collision of Karlin, Bösch and
Chikatamarla (KBC; Bösch, Chikatamarla & Karlin, PRE 92, 043309, 2015),
on D2Q9 and D3Q27, in plain torch from the paper's equations. It takes no
parameters.

The populations split as f = k + s + h: k carries the conserved moments,
s the shear part and h the higher-order rest. With f_eq the quadratic
equilibrium at f's density and velocity:

* the shear part is the projection of the second moments
  Pi_ab = sum_i f_i e_ia e_ib onto the populations, as lettuce's KBC
  defines it (its trace included): -(Pi_xx + Pi_yy [+ Pi_zz]) on the rest
  population, Pi_aa / 2 on the two populations along axis a,
  e_a e_b Pi_ab / 4 on the four with two non-zero components a and b, and
  nothing on D3Q27's corners; Delta s = s(f) - s(f_eq), which is linear,
  so s(f - f_eq);
* Delta h = f - f_eq - Delta s;
* the shear part relaxes at beta = 1 / (2 tau), the higher-order part at
  the stabiliser gamma = 1/beta - (2 - 1/beta) <Delta s|Delta h> /
  <Delta h|Delta h>, with the entropic scalar product
  <x|y> = sum_i x_i y_i / f_eq_i;
* f' = f - beta (2 Delta s + gamma Delta h).

Departures from the paper, both the program's too: gamma = 2 (BGK at
tau) where <Delta h|Delta h> = 0 (a 0/0), and gamma = 2 where gamma falls
below 1e-15. Near equilibrium, with beta about 0.986, gamma turns
negative once the ratio of the two products passes about 1.03; a
reference without the second guard would differ from the program there
by design, not by fault.
"""

import torch

from torch_bench.reference import lbm


def shear(f: torch.Tensor, st: lbm.Stencil) -> torch.Tensor:
    """The shear part s(f) of populations ``f`` ([q, *grid])."""
    pi = {}
    for a in range(st.d):
        for b in range(a, st.d):
            terms = [v[a] * v[b] * f[i] for i, v in enumerate(st.e)
                     if v[a] * v[b]]
            total = terms[0]
            for t in terms[1:]:
                total = total + t
            pi[a, b] = total
    trace = pi[0, 0]
    for a in range(1, st.d):
        trace = trace + pi[a, a]
    zero = torch.zeros_like(trace)
    parts = []
    for v in st.e:
        axes = [a for a, c in enumerate(v) if c]
        if not axes:
            parts.append(-trace)
        elif len(axes) == 1:
            parts.append(pi[axes[0], axes[0]] / 2)
        elif len(axes) == 2:
            a, b = axes
            parts.append(v[a] * v[b] * pi[a, b] / 4)
        else:
            parts.append(zero)
    return torch.stack(parts)


def collide(f, st, tau, params):
    if st.name not in ("D2Q9", "D3Q27"):
        raise ValueError(f"KBC is defined on D2Q9 and D3Q27, not {st.name}")
    feq = lbm.equilibrium(f.sum(0), lbm.velocity(f, st), st)
    beta = 1.0 / (2 * tau)
    delta_s = shear(f - feq, st)
    delta_h = f - feq - delta_s
    sh = (delta_s * delta_h / feq).sum(0)
    hh = (delta_h * delta_h / feq).sum(0)
    flat = hh == 0
    gamma = 1 / beta - (2 - 1 / beta) * sh / torch.where(
        flat, torch.ones_like(hh), hh)
    two = torch.full_like(gamma, 2.0)
    gamma = torch.where(flat | (gamma < 1e-15), two, gamma)
    return f - beta * (2 * delta_s + gamma * delta_h)
