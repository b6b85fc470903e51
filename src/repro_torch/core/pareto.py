"""Approximation-space exploration & Pareto-front extraction (Ch. 6); the
port of ``repro.core.pareto``, same masks bit for bit.

The dissertation's "cooperative approximation" chapter enumerates combinations
of the technique pool, evaluates (error, resources) for each configuration,
and keeps the Pareto-optimal set.  This module is that loop, with the error
side computed bit-exactly (error_analysis) and the resource side from the
paper's own unit-gate model (area_model).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import area_model, axmult, error_analysis


@dataclass
class DesignPoint:
    name: str
    fam: str
    n: int
    k: int
    p: int
    r: int
    mred: float
    nmed: float
    area: float
    energy: float
    on_front: bool = False

    def row(self) -> str:
        star = "*" if self.on_front else " "
        return (
            f"{star} {self.name:<12} mred={self.mred:.6f} area={self.area:8.1f} "
            f"energy={self.energy:9.1f}"
        )


def explore(n: int = 16, num_samples: int = 1 << 16, seed: int = 0) -> list[DesignPoint]:
    """Evaluate the full multiplier-configuration pool at bit-width ``n``.

    Enumerates every family config from ``axmult.family_configs`` plus the
    exact CMB baseline, attaches sampled error metrics (MRED/NMED) and
    unit-gate area/energy, and marks the (mred, energy) Pareto front in
    place.  This is the Ch. 6 *circuit-level* exploration; the network-level
    counterpart over per-layer degree vectors lives in ``repro_torch.tune``
    (which reuses :func:`front_mask` for the same dominance rule)."""
    points: list[DesignPoint] = []
    # exact baseline
    base_area = area_model.area_cmb(n)
    points.append(
        DesignPoint("CMB", "CMB", n, 0, 0, 0, 0.0, 0.0, base_area,
                    area_model.energy_proxy("CMB", n))
    )
    for name, fn, meta in axmult.family_configs(n):
        rep = error_analysis.evaluate_sampled(fn, n, num=num_samples, seed=seed)
        fam, k, p, r = meta["fam"], meta["k"], meta["p"], meta["r"]
        points.append(
            DesignPoint(
                name, fam, n, k, p, r, rep.mred, rep.nmed,
                area_model.area_of(fam, n, k, p, r),
                area_model.energy_proxy(fam, n, k, p, r),
            )
        )
    mark_front(points, x="mred", y="energy")
    return points


def front_mask(xs, ys) -> list[bool]:
    """Generic minimize-both Pareto mask over two parallel sequences.

    ``mask[i]`` is True iff no other point weakly dominates point ``i``
    (``x <= x_i and y <= y_i`` with at least one strict).  Duplicated points
    all stay on the front.  Shared by :func:`mark_front` (multiplier design
    points) and the ``repro_torch.tune`` plan search (per-layer degree vectors) —
    one dominance rule for both exploration stages."""
    n = len(xs)
    assert len(ys) == n
    mask = []
    for i in range(n):
        dominated = any(
            xs[j] <= xs[i] and ys[j] <= ys[i]
            and (xs[j] < xs[i] or ys[j] < ys[i])
            for j in range(n) if j != i)
        mask.append(not dominated)
    return mask


def mark_front(points: list[DesignPoint], x: str = "mred", y: str = "energy") -> None:
    """Mark Pareto-optimal points (minimize both ``x`` and ``y`` attributes)
    in place by setting ``on_front`` — the presentation layer over
    :func:`front_mask`."""
    mask = front_mask([getattr(p, x) for p in points],
                      [getattr(p, y) for p in points])
    for pt, m in zip(points, mask):
        pt.on_front = m


def front(points: list[DesignPoint]) -> list[DesignPoint]:
    """The marked Pareto subset, sorted most-accurate (lowest mred) first —
    run :func:`mark_front` (or :func:`explore`) beforehand."""
    return sorted([p for p in points if p.on_front], key=lambda p: p.mred)


def best_under_error(points: list[DesignPoint], mred_budget: float) -> DesignPoint | None:
    """The paper's design-selection rule: the cheapest (minimum energy)
    configuration whose error stays within ``mred_budget``; None when no
    configuration qualifies."""
    ok = [p for p in points if p.mred <= mred_budget]
    return min(ok, key=lambda p: p.energy) if ok else None
