"""The benchmark's arithmetic over a profiled stretch: busy time as the
union of device intervals, idle gaps and what the host was doing in them,
kernel families and their rooflines, and the window's rate. Pure Python:
the CPU tests check it without a card.
"""

from __future__ import annotations

import re

__all__ = ["union", "busy_seconds", "idle_gaps", "label_gaps",
           "template_name", "family_of", "bytes_per_update",
           "ops_per_update", "roofline_share", "window_mlups",
           "window_spans"]


def union(intervals):
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy_seconds(intervals, lo, hi) -> float:
    """Time within ``[lo, hi]`` in which at least one interval is open:
    overlapping operations count once."""
    return sum(e - s for s, e in union(_clip(intervals, lo, hi)))


def idle_gaps(intervals, lo, hi):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, at = [], lo
    for s, e in union(_clip(intervals, lo, hi)):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def label_gaps(gaps, spans, other="other"):
    """``{label: idle seconds}``: each moment of a gap goes to the
    innermost (shortest) host span ``(label, start, end)`` open then, or to
    ``other`` where none is."""
    totals = {}
    for gs, ge in gaps:
        inside = [sp for sp in spans if min(ge, sp[2]) > max(gs, sp[1])]
        cuts = sorted({gs, ge} | {t for _, s, e in inside for t in (s, e)
                                  if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            open_ = [sp for sp in inside if sp[1] <= a and sp[2] >= b]
            label = (min(open_, key=lambda sp: sp[2] - sp[1])[0]
                     if open_ else other)
            totals[label] = totals.get(label, 0.0) + (b - a)
    return totals


def template_name(name: str) -> str:
    """A kernel's function name without its scope, template arguments and
    parameters: ``void lt::stream_collide_kernel<...>(...)`` ->
    ``stream_collide_kernel``; a name that is no C++ signature (``Memcpy
    DtoH ...``, ``Kernel2``) as it is."""
    if "::" not in name and not name.startswith("void "):
        return name
    text = name.replace("(anonymous namespace)", "anonymous")
    depth, cut = 0, len(text)
    for i, ch in enumerate(text):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            cut = i
            break
    head = text[:cut].rstrip()
    while head.endswith(">"):  # the function's own template arguments
        depth = 0
        for j in range(len(head) - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(head[j], 0)
            if depth == 0:
                head = head[:j].rstrip()
                break
        else:
            break
    words = head.split()
    return words[-1].split("::")[-1] if words else name


def family_of(name: str, families):
    """The first kernel family whose ``match`` pattern finds ``name``."""
    for family in families:
        if re.search(family["match"], name):
            return family
    return None


def _terms(coefficients: dict, sizes: dict) -> float:
    total = 0.0
    for term, coefficient in coefficients.items():
        value = float(coefficient)
        for factor in term.split("*"):
            value *= sizes[factor.strip()]
        total += value
    return total


def bytes_per_update(family, sizes) -> float:
    """Bytes one lattice update of ``family`` moves, inputs read once and
    outputs written once: the family's ``bytes`` terms over ``sizes`` (q
    populations, d dimensions, s bytes a stored value, c bytes a computed
    one, m bytes of a cell's boundary code)."""
    return _terms(family["bytes"], sizes)


def ops_per_update(family, sizes) -> float:
    """Floating-point operations of one lattice update of ``family``."""
    return _terms(family["ops"], sizes)


def roofline_share(launches, families, sizes, updates, peaks):
    """``(share, unknown)`` over the launches the profiler recorded, each
    ``(kernel name, device seconds)``, of the kernels whose names match
    ``peaks["kernel_prefix"]``: the sum of each launch's bound (the larger
    of its bytes over the bandwidth and its operations over the float rate,
    for ``updates`` lattice updates) over the sum of their device time. A
    kernel of no family adds its time with a zero bound and is listed in
    ``unknown``. ``share`` is None when no such launch was recorded."""
    bound = spent = 0.0
    unknown = set()
    for name, seconds in launches:
        if peaks["kernel_prefix"] not in name:
            continue
        spent += seconds
        family = family_of(name, families)
        if family is None:
            unknown.add(template_name(name))
            continue
        bound += max(updates * bytes_per_update(family, sizes)
                     / peaks["hbm_bytes_per_s"],
                     updates * ops_per_update(family, sizes)
                     / peaks["fp32_ops_per_s"])
    if spent <= 0:
        return None, sorted(unknown)
    return bound / spent, sorted(unknown)


def window_mlups(cells: int, steps: int, seconds: float) -> float:
    """Million lattice updates a second: every cell, every step, over the
    whole window."""
    return cells * steps / seconds / 1e6


def window_spans(spans, window, stretch=None) -> list:
    """The indices of the program's spans ``(name, parent, start_ns,
    end_ns)`` that lie inside ``window`` (``(start_ns, end_ns)``) and do not
    overlap ``stretch`` (the profiled stretch, whose profiler cost they
    would carry; None: no stretch)."""
    lo, hi = window
    inside = []
    for i, (_, _, start, end) in enumerate(spans):
        if start < lo or end > hi:
            continue
        if stretch is not None and start < stretch[1] and end > stretch[0]:
            continue
        inside.append(i)
    return inside
