"""The comparison that decides ``correct``: numbers from the program's
outputs against the plain reference's, each held to its limit.

Norm gaps follow one rule: for each leaf (a layer's slice of a stacked
weight, or a whole unstacked one) the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf
and the median of the reference's leaf norms (so a leaf whose norm is
all but zero weighs like a typical one); a number takes the worst leaf,
or the median one.
"""
from __future__ import annotations

import math


def median(values):
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def norm_gaps(prog, ref, keep=None):
    """Each counted leaf's norm gap (see the module docstring), as a list
    of (gap, path, layer)."""
    med = median([x for v in ref.values() for x in v])
    out = []
    for path, rv in ref.items():
        for i, (p, r) in enumerate(zip(prog[path], rv)):
            if keep is not None and not keep[path][i]:
                continue
            gap = abs(p - r) / max(r, med, 1e-30)
            out.append((gap if math.isfinite(gap) else math.inf, path, i))
    return out


def median_norm_gap(prog, ref):
    """The median leaf's norm gap: steady from seed to seed where the
    worst leaf is one of many small ones whose sums cancel."""
    return median([g for g, _, _ in norm_gaps(prog, ref)])


def worst_norm_gap(prog, ref, keep=None, where=None):
    """The worst counted leaf's norm gap (``norm_gaps``); ``where``, a
    list, receives its (gap, path, layer)."""
    gaps = norm_gaps(prog, ref, keep)
    worst = max(gaps, default=(0.0, None, None))
    if where is not None:
        where.append(worst)
    return worst[0]


def worst_rel_diff(diff, ref):
    """diff: {path: [norm of the program's leaf minus the reference's]};
    ref: {path: [norm of the reference's leaf]}. The worst leaf's
    distance over the larger of its reference norm and the median's."""
    med = median([x for v in ref.values() for x in v])
    worst = 0.0
    for path, rv in ref.items():
        for d, r in zip(diff[path], rv):
            gap = d / max(r, med, 1e-30)
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moved_leaves(ref_grad, floor=1e-3):
    """The leaves whose reference gradient is at least ``floor`` of the
    median leaf's: only those are held to their change (a leaf whose
    gradient is nought to rounding moves under Adam by round-off alone)."""
    med = median([x for v in ref_grad.values() for x in v])
    return {k: [x >= floor * med for x in v] for k, v in ref_grad.items()}


def worst_rel_gap(prog, ref):
    """Largest |p - r| / |r| over paired scalars."""
    worst = 0.0
    for p, r in zip(prog, ref):
        gap = abs(p - r) / max(abs(r), 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def judge(numbers, limits):
    """(correct, lines): every number within its limit. A number that is
    missing, not finite or over its limit makes the run not correct."""
    ok, rows = True, {}
    for name, spec in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= spec["limit"]
        ok = ok and good
        rows[name] = {"value": v, "limit": spec["limit"]}
    return ok, rows
