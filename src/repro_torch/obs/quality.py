"""Online quality telemetry: the serving-time twin of the calibration
prober (``tune.autotune._Prober``) — the port of ``repro.obs.quality``.

An :class:`~repro_torch.tune.plan.ApproxPlan`'s per-rung error numbers are
measured once, offline, on a calibration batch.  Deployed behind a QoS
controller the plan serves live traffic at whatever rung load dictates —
and nothing checks that the calibrated error claims still hold on the
*production* distribution.  The quality tap closes that gap: every Nth
engine tick it re-runs the current step inputs through the same kernels
twice — once at the live degree, once at the exact rung (all sites at 8
effective bits) — and records the live-vs-exact error into a histogram
labelled by the active rung.

The tap is a pure observer.  The LM decode step writes each slot's new K/V
row into the cache in place (``models/attention.py::write_token``), so the
LM probe saves exactly the rows the step will write (every layer, every
slot, one position; the int8 cache's scales with them) and puts them back
after its two forwards: the state after :meth:`QualityTap.sample` is
bit-identical to the state before.  The exact rung's degree operand is
built once per degree shape; the one ``float()`` of the result is the only
device sync a sample adds.

Cost model: two extra decode forwards per sample.  ``every=0`` disables the
tap entirely (the default).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dynamic import degree_record
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["QualityTap", "rung_label", "QUALITY_BUCKETS"]

#: relative-error flavored buckets (normalized RMS logit deviation)
QUALITY_BUCKETS = (1e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


def rung_label(degree) -> str:
    """Stable label for a degree: ``"8"`` for the global scalar, ``"8.7.6"``
    for a per-site vector (dots keep it one Prometheus label value).  Pass
    the host record (an int or a tuple): a device tensor here syncs."""
    rec = degree_record(degree)
    if isinstance(rec, tuple):
        return ".".join(str(int(x)) for x in rec)
    return str(int(rec))


#: cache fields of per-slot state, which a decode step rewrites whole
_STATE_FIELDS = ("h", "conv")


def lm_logit_rms_probe(model, tp: int = 1, reduce=None):
    """The LM probe: live-degree and exact-rung decode logits on identical
    inputs, normalized RMS deviation over the active slots.  What both
    forwards write is saved first and restored after: each slot's token
    row of the K/V fields, and the recurrent families' state fields whole.
    On a mesh both are whole logit rows (gathered over ``model``), so every
    rank computes the same value.  ``reduce`` sums the probe's three sums
    (squared deviation, squared exact logits, active slots) over the ranks
    that hold the other slots (a serving data axis): every rank then
    computes the value over all the slots."""
    from repro_torch.models.attention import token_rows
    from repro_torch.models.layers import gather_vocab
    from repro_torch.models.transformer import attn_window

    cfg = model.cfg
    window = attn_window(cfg)

    def probe(params, cache, tokens, active, deg, exact_deg):
        fields = [f for f in cache._fields if f not in ("length",) + _STATE_FIELDS]
        states = [f for f in cache._fields if f in _STATE_FIELDS]
        bidx = rows = None
        if fields:
            rows = token_rows(cache.k.shape[2], cache.length, window)
            bidx = torch.arange(rows.shape[0], device=rows.device)
        saved = [getattr(cache, f)[:, bidx, rows].clone() for f in fields]
        saved_states = [getattr(cache, f).clone() for f in states]
        approx, _ = model.decode_step(params, cache, tokens, tp=tp,
                                      degree=deg, active=active)
        exact, _ = model.decode_step(params, cache, tokens, tp=tp,
                                     degree=exact_deg, active=active)
        approx, exact = gather_vocab(approx), gather_vocab(exact)
        for f, old in zip(fields, saved):
            getattr(cache, f)[:, bidx, rows] = old
        for f, old in zip(states, saved_states):
            getattr(cache, f).copy_(old)
        w = active.to(torch.float32)[:, None, None]
        sq_dev = (((approx - exact) ** 2) * w).sum()
        sq_ref, slots = ((exact ** 2) * w).sum(), w.sum()
        if reduce is not None:
            sq_dev, sq_ref, slots = reduce(torch.stack([sq_dev, sq_ref, slots]))
        n = torch.clamp(slots * approx.shape[-2] * approx.shape[-1], min=1.0)
        dev = torch.sqrt(sq_dev / n)
        ref = torch.sqrt(sq_ref / n)
        return dev / torch.clamp(ref, min=1e-9)

    return probe


class QualityTap:
    """Per-rung quality histogram sampled from live serving traffic.

    Built by the serve workload when ``quality_every > 0``; :meth:`sample`
    is called with the tick's step inputs *before* the fused step runs.

    The error metric is pluggable: by default the tap compares live-vs-exact
    *logits* of an LM ``model`` (normalized RMS deviation, recorded as
    ``repro_quality_logit_rms``); a workload may instead pass its own
    ``probe(params, state, feed, active, degree, exact_degree) -> 0-d
    tensor`` together with a ``metric_name`` (histogram family
    ``repro_quality_{metric_name}``, matching trace-arg key) and ``buckets``
    fitting the metric's range — e.g. the stream workload probes per-frame
    PSNR in dB.  A probe must leave the state as it found it."""

    def __init__(self, model=None, *, tp: int = 1, every: int = 32,
                 registry: Optional[obs_metrics.Registry] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 probe=None, metric_name: str = "logit_rms",
                 buckets=QUALITY_BUCKETS):
        if every <= 0:
            raise ValueError(f"quality tap period must be > 0 (got {every})")
        if model is None and probe is None:
            raise ValueError("QualityTap needs a model or a custom probe")
        self.every = int(every)
        self.samples = 0
        self.metric_name = metric_name
        self.registry = registry if registry is not None else obs_metrics.Registry()
        self.tracer = tracer if tracer is not None else obs_trace.get_tracer()
        self.hist = self.registry.histogram(
            f"repro_quality_{metric_name}",
            f"live-vs-exact {metric_name} by rung",
            labels=("rung",), buckets=tuple(buckets))
        self._probes = self.registry.counter(
            "repro_quality_probes_total", "quality-tap probe forwards run")
        self._probe = probe if probe is not None else lm_logit_rms_probe(model, tp)
        #: the exact rung's degree operand per (shape, device), built once
        self._exact: dict = {}

    def due(self, tick: int) -> bool:
        return tick % self.every == 0

    def _exact_degree(self, degree: torch.Tensor) -> torch.Tensor:
        key = (tuple(degree.shape), degree.device)
        exact = self._exact.get(key)
        if exact is None:
            exact = self._exact[key] = torch.full_like(degree, 8)
        return exact

    def sample(self, tick: int, params, state, feed, active, degree,
               rung=None) -> float:
        """Measure the live-vs-exact quality metric for this tick's inputs
        (``feed`` and ``active`` on the state's device, ``degree`` the device
        operand) and record it under the active rung — ``rung``, the host
        record of ``degree`` (the engine passes it, so labelling never
        syncs).  Returns the value."""
        with torch.no_grad():
            val = self._probe(params, state, feed, active, degree,
                              self._exact_degree(degree))
        err = float(val)                       # the sample's one sync
        label = rung_label(degree if rung is None else rung)
        self.hist.labels(rung=label).observe(err)
        self._probes.inc()
        self.samples += 1
        self.tracer.event("quality_probe", track="engine", tick=tick,
                          rung=label, **{self.metric_name: err})
        return err
