"""Calibration-driven approximation-plan search (the Ch. 6 exploration loop
aimed at a deployed network instead of a lone multiplier) — the port of
``repro.tune.autotune``, line for line but for the forwards, which run
under ``torch.inference_mode()`` on the model's device.

The uniform global degree the QoS controller used to rescale treats every
layer as equally error-sensitive; the surveys the repo tracks (Leon et al.,
arXiv:2307.11124 / 2307.11128) identify per-layer assignment driven by
error-sensitivity profiling as the technique that dominates it on the
quality-vs-cost front.  This module closes that loop:

  1. :func:`profile_sensitivity` — one calibration batch, one site at a time:
     degrade site ``i`` to ``e`` effective bits while every other site stays
     at 8, and record the output-error metric.  The runtime degree is a
     device int32 vector (models/degrees.py), so every probe runs the same
     kernels: only the vector's values change.
  2. :func:`build_plan` — greedy descent over mixed assignments: repeatedly
     degrade the site with the best modeled-cost-saving per predicted-error
     ratio, *measure* the true error of each visited vector, keep the
     Pareto-optimal visits (``core.pareto.front_mask`` — the same dominance
     rule as the multiplier-space exploration), and emit the front as an
     :class:`~repro_torch.tune.plan.ApproxPlan` degree ladder.

Costs come from the dissertation's own unit-gate model: dropping to ``e``
effective bits is the rounding knob ``r = 8 - e`` of the PR multiplier
(``core.quantization`` maps them 1:1), so a site's per-MAC energy is
``area_model.energy_proxy("ROUND", 8, r=8-e)`` and a vector's cost is the
MAC-weighted sum over sites, normalized to the all-8 assignment.

Everything here is offline tooling: forwards on a calibration batch, no
engine or kernel changes — the emitted plan is what crosses into runtime.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import area_model, pareto
from repro_torch.core.approx import ApproxPolicy
from repro_torch.tune.plan import ApproxPlan, PlanPoint, site_names

DEFAULT_GRID = (8, 7, 6, 5, 4)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def energy_per_mac(ebits: int, n: int = 8) -> float:
    """Unit-gate energy proxy of one MAC at ``ebits`` effective bits: the
    PR multiplier with rounding at ``r = n - ebits`` (the DyFXU mapping of
    core/quantization.py), normalized so ``ebits == n`` costs 1.0."""
    base = area_model.energy_proxy("ROUND", n, p=0, r=0)
    return area_model.energy_proxy("ROUND", n, p=0, r=n - int(ebits)) / base


def site_macs(cfg) -> list:
    """Approximate per-site MAC counts (one forward token) for the matmuls
    the approximation dispatch touches — the weights of the cost sum.
    Order matches ``plan.site_names``: layers in stacking order, head last.

    Configs may carry their own counts (non-LM workloads — e.g. the stream
    pipeline's ``StreamConfig.site_macs``): that override wins outright."""
    if hasattr(cfg, "site_macs"):
        return [float(m) for m in cfg.site_macs()]
    d = cfg.d_model
    pd = cfg.padded(1)

    def attn_macs() -> float:
        qo = 2 * d * pd.n_heads * cfg.head_dim
        kv = 2 * d * cfg.n_kv_heads * cfg.head_dim
        return qo + kv

    def mlp_macs(d_ff: int) -> float:
        return 3 * d * d_ff

    per_layer: list = []
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        H = d_in // s.headdim
        lm = d * (2 * d_in + 2 * s.d_state + H) + d_in * d
        per_layer = [float(lm)] * cfg.n_layers
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_groups, tail = divmod(cfg.n_layers, len(pat))
        rec = 5 * d * d + mlp_macs(cfg.d_ff)
        att = attn_macs() + mlp_macs(cfg.d_ff)
        group = [rec if name == "rec" else att for name in pat]
        per_layer = group * n_groups + [rec] * tail
    else:
        if cfg.moe:
            m = cfg.moe
            ffn = (d * m.n_experts                       # router
                   + m.top_k * 3 * d * m.d_expert
                   + m.n_shared * 3 * d * m.d_shared)
        else:
            ffn = mlp_macs(cfg.d_ff)
        per_layer = [float(attn_macs() + ffn)] * cfg.n_layers
    head = float(d * cfg.vocab)
    if cfg.frontend:
        head += float(cfg.frontend_dim * d)
    return per_layer + [head]


def vector_cost(cfg, degrees: Sequence[int]) -> float:
    """Modeled cost of a per-site degree vector: MAC-weighted unit-gate
    energy, normalized so the uniform all-8 vector costs 1.0."""
    macs = site_macs(cfg)
    assert len(macs) == len(degrees), (len(macs), len(degrees))
    total = sum(m * energy_per_mac(e) for m, e in zip(macs, degrees))
    return total / sum(macs)


# ---------------------------------------------------------------------------
# calibration error
# ---------------------------------------------------------------------------


class _Prober:
    """Forwards for one (model, params, batch): an exact-policy reference
    plus an AXQ forward taking the degree vector as a device int32 operand
    (one set of kernels for the whole profile/search).  Errors are memoized
    per degree vector, so the sensitivity profile and the search never pay
    twice for the same assignment.

    ``metric`` makes the calibration error pluggable (plans must calibrate
    on *application-level* error — PSNR/SSIM for signal/vision streams,
    logit error for LMs): a callable ``metric(ref, out) -> float`` over
    float64 numpy arrays, LOWER = better (Pareto front_mask minimizes both
    axes — wrap quality-style metrics as their negation, e.g.
    ``lambda ref, out: -psnr_db(ref, out)``).  None keeps the normalized-RMS
    deviation.

    Models may supply their exact-arithmetic twin via an ``exact_model()``
    hook (servable workloads); LM Models fall back to the exact-policy
    model on the same device.  Both forwards run under
    ``torch.inference_mode()`` and are read back as float64 numpy, so the
    default nRMS and any plugged ``metric`` are the reference's numpy code;
    the degree vector goes to the device once per probe."""

    def __init__(self, model, params, batch, metric=None):
        self.cfg = model.cfg
        self.device = model.device
        self.batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                      for k, v in batch.items()}
        self.params = params
        self.metric = metric
        self.model = model
        if hasattr(model, "exact_model"):
            exact = model.exact_model()
        else:
            from repro_torch.models.registry import Model

            exact = Model(model.cfg, ApproxPolicy(), device=model.device)
        with torch.inference_mode():
            ref = exact.forward(params, self.batch)[0]
        self.ref = ref.float().cpu().numpy().astype(np.float64)
        self._ref_rms = float(np.sqrt(np.mean(self.ref ** 2))) or 1.0
        self._memo: dict = {}
        #: forwards run (memo misses), for build-time accounting
        self.probes = 0

    def error(self, degrees: Sequence[int]) -> float:
        """Calibration error vs the exact-arithmetic reference: the plugged
        ``metric``, or normalized RMS output deviation (the NMED analogue at
        network scale) by default."""
        key = tuple(int(e) for e in degrees)
        if key in self._memo:
            return self._memo[key]
        deg = torch.tensor(key, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            out = self.model.forward(self.params, self.batch, degree=deg)[0]
        out = out.float().cpu().numpy().astype(np.float64)
        self.probes += 1
        if self.metric is not None:
            err = float(self.metric(self.ref, out))
        else:
            err = float(np.sqrt(np.mean((out - self.ref) ** 2))
                        / self._ref_rms)
        self._memo[key] = err
        return err


def measure_error(model, params, batch, degrees, metric=None) -> float:
    """One-off measurement (tests / benches); for sweeps build a
    :class:`_Prober` once via :func:`build_plan`."""
    return _Prober(model, params, batch, metric=metric).error(degrees)


def profile_sensitivity(model, params, batch,
                        grid: Sequence[int] = DEFAULT_GRID,
                        prober: Optional[_Prober] = None,
                        metric=None) -> dict:
    """Per-site error-sensitivity profile on a calibration batch.

    For each site ``i`` and degree ``e`` in ``grid`` (below 8), measure the
    output error of the vector that is all-8 except ``degrees[i] = e``.
    Returns ``{site_name: {ebits: error}}`` — the auditable record the plan
    carries (re-tuning can detect model drift).  The search itself ranks
    candidates by *measured* errors, not this profile; sharing a prober
    just makes these single-site probes free for it (error memo)."""
    p = prober or _Prober(model, params, batch, metric=metric)
    names = site_names(model.cfg)
    S = len(names)
    out: dict = {}
    for i, name in enumerate(names):
        prof = {}
        for e in grid:
            if e >= 8:
                continue
            vec = [8] * S
            vec[i] = int(e)
            prof[int(e)] = p.error(vec)
        out[name] = prof
    return out


# ---------------------------------------------------------------------------
# plan search
# ---------------------------------------------------------------------------


def build_plan(model, params, batch, *, grid: Sequence[int] = DEFAULT_GRID,
               max_rungs: int = 8, block: Optional[int] = None,
               exhaustive_budget: int = 160,
               seed_meta: Optional[dict] = None,
               prober: Optional[_Prober] = None,
               metric=None) -> ApproxPlan:
    """Search mixed per-site degree assignments and emit the Pareto ladder.

    ``model`` must be built with the plan-execution policy (uniform dynamic
    AXQ — ``ApproxPlan.policy()``); ``batch`` is the calibration batch the
    errors are measured on.  Two strategies, picked by design-space size:

    * **exhaustive** — when ``len(grid) ** n_sites <= exhaustive_budget``,
      every assignment is measured (the Ch. 6 full-space sweep; feasible for
      smoke-scale layer counts).
    * **measured greedy** — otherwise: starting from uniform-8, every
      single-site one-grid-step candidate is *measured* each round and the
      one with the best cost-saving per error-increase ratio is taken.  All
      probed candidates (not just accepted ones) enter the visited set, so
      the front is denser than the walk itself.

    Visited vectors are filtered by ``core.pareto.front_mask`` on (measured
    error, modeled cost) and the front — subsampled to ``max_rungs`` —
    becomes the ladder, most accurate rung first.

    Callers doing further measurements (benchmarks) can pass a shared
    ``prober`` (``_Prober(model, params, batch)``) — its error memo makes
    every vector the search visited free to re-query.
    """
    import itertools

    cfg = model.cfg
    names = site_names(cfg)
    S = len(names)
    grid = sorted({int(e) for e in grid}, reverse=True)
    if grid[0] != 8:
        raise ValueError(f"grid must start at 8 (got {grid})")
    t0 = time.time()
    prober = prober or _Prober(model, params, batch, metric=metric)
    sens = profile_sensitivity(model, params, batch, grid, prober=prober)
    macs = site_macs(cfg)

    visited: list[tuple[list, float, float]] = []
    seen: set = set()

    def record(vec):
        key = tuple(int(e) for e in vec)
        if key in seen:
            return next(v for v in visited if tuple(v[0]) == key)[1:]
        seen.add(key)
        err = prober.error(vec)          # memoized: profile probes are free
        cost = vector_cost(cfg, vec)
        visited.append((list(key), err, cost))
        return err, cost

    exhaustive = len(grid) ** S <= exhaustive_budget
    if exhaustive:
        for vec in itertools.product(grid, repeat=S):
            record(vec)
    else:
        def next_lower(e: int) -> Optional[int]:
            below = [g for g in grid if g < e]
            return below[0] if below else None

        degrees = [8] * S
        cur_err, cur_cost = record(degrees)
        eps = 1e-12
        while True:
            best = None
            for i in range(S):
                nxt = next_lower(degrees[i])
                if nxt is None:
                    continue
                cand = list(degrees)
                cand[i] = nxt
                err, cost = record(cand)
                score = (cur_cost - cost) / max(err - cur_err, eps)
                if best is None or score > best[0]:
                    best = (score, i, nxt, err, cost)
            if best is None:
                break
            _, i, nxt, cur_err, cur_cost = best
            degrees[i] = nxt

    errs = [v[1] for v in visited]
    costs = [v[2] for v in visited]
    mask = pareto.front_mask(errs, costs)
    front = [v for v, m in zip(visited, mask) if m]
    front.sort(key=lambda v: (-v[2], v[1]))     # costliest == most accurate first
    if len(front) > max_rungs:
        idx = np.linspace(0, len(front) - 1, max_rungs).round().astype(int)
        front = [front[i] for i in sorted(set(idx.tolist()))]
    ladder = [
        PlanPoint(name=f"rung_{r}", degrees=tuple(int(x) for x in vec),
                  error=float(err), cost=float(cost))
        for r, (vec, err, cost) in enumerate(front)
    ]
    used = prober.metric
    meta = {
        "calibration": {k: list(np.shape(v)) for k, v in batch.items()},
        "grid": list(grid),
        "metric": (getattr(used, "metric_name", None)
                   or getattr(used, "__name__", "custom")) if used else "nrms",
        "strategy": "exhaustive" if exhaustive else "greedy",
        "visited": len(visited),
        "tune_seconds": round(time.time() - t0, 3),
        **(seed_meta or {}),
    }
    spec = model.policy.default
    return ApproxPlan(arch=cfg.name, sites=names, ladder=ladder,
                      block=int(block if block is not None else spec.block),
                      sensitivity=sens, meta=meta)
