"""Serving QoS accounting: per-request latency breakdown + engine counters.

MLPerf-style definitions:
  queue_time  enqueue -> admission into a slot
  ttft        enqueue -> first generated token (includes queueing + prefill)
  tpot        mean inter-token time after the first token
  e2e         enqueue -> completion

Token accounting is split prefill-vs-decode: prompt tokens are ingested by
the fused prefill call (plus the final prompt token, which rides the decode
step that emits the first output token); generated tokens are decode tokens.

Counters live in a :class:`repro_torch.obs.metrics.Registry`:
:class:`EngineStats` is a thin view over one — the scalar reads
(``stats.prefill_tokens`` etc.) keep working, while the same numbers export
as Prometheus text / JSON through ``stats.registry``.  ``degree_history`` entries
are normalized to ``(tick, degrees_tuple)`` at record time
(``core.dynamic.degree_record(as_tuple=True)``): a global scalar degree
records as a 1-tuple, so consumers never isinstance-branch.  The engine
records host-side degree values, so recording never syncs the device.
"""

from __future__ import annotations

from collections import deque

from repro_torch.core.dynamic import degree_record
from repro_torch.obs import metrics as obs_metrics

#: latency histogram buckets (seconds) shared by the TTFT/TPOT/queue/e2e
#: families
LATENCY_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class EngineStats:
    """Engine-lifetime counters (all ticks / admissions), registry-backed.

    Every counter the engine maintains is a family in ``self.registry``
    (a fresh per-engine :class:`~repro_torch.obs.metrics.Registry` by
    default, so co-resident engines don't sum into each other; pass a
    shared one to co-export with the kernel-dispatch counters).  The scalar
    attributes are read-only properties over the registry.
    """

    def __init__(self, registry: obs_metrics.Registry | None = None, *,
                 unit: str = "tokens", admit_name: str = "prefill",
                 step_name: str = "decode"):
        self.registry = (registry if registry is not None
                         else obs_metrics.Registry())
        # workload vocabulary (servable.py): the LM defaults give the
        # reference's family names (repro_prefill_tokens_total, ...)
        self.unit = unit
        r = self.registry
        self.c_admit_units = r.counter(
            f"repro_{admit_name}_{unit}_total",
            f"payload {unit} ingested via the fused {admit_name} call")
        self.c_admit_calls = r.counter(
            f"repro_{admit_name}_calls_total",
            f"fused {admit_name} invocations")
        self.c_step_units = r.counter(
            f"repro_{step_name}_{unit}_total",
            "active slot-steps executed by the fused step")
        self.c_steps = r.counter(
            f"repro_{step_name}_steps_total",
            "engine ticks that ran the fused step")
        # legacy LM-named aliases (same counter objects; tests/benches read
        # these regardless of workload)
        self.c_prefill_tokens = self.c_admit_units
        self.c_prefill_calls = self.c_admit_calls
        self.c_decode_tokens = self.c_step_units
        self.c_decode_steps = self.c_steps
        self.c_admitted = r.counter(
            "repro_requests_admitted_total", "requests admitted into a slot")
        self.c_completed = r.counter(
            "repro_requests_completed_total", "requests finished (EOS/budget)")
        self.h_ttft = r.histogram(
            "repro_ttft_seconds", "enqueue -> first generated token",
            buckets=LATENCY_BUCKETS)
        self.h_tpot = r.histogram(
            "repro_tpot_seconds", "mean inter-token time after the first",
            buckets=LATENCY_BUCKETS)
        self.h_queue = r.histogram(
            "repro_queue_seconds", "enqueue -> admission into a slot",
            buckets=LATENCY_BUCKETS)
        self.h_e2e = r.histogram(
            "repro_e2e_seconds", "enqueue -> completion",
            buckets=LATENCY_BUCKETS)
        self.c_route_steps = r.counter(
            "repro_kernel_route_steps_total",
            "engine ticks by resolved kernel backend", labels=("site", "backend"))
        self.g_degree = r.gauge(
            "repro_degree_ebits", "live approximation degree by plan site",
            labels=("site",))
        # resilience families (repro_torch.resil); zero-valued unless the
        # engine runs with faults/guards/policy
        self.c_faults = r.counter(
            "repro_faults_injected_total",
            "faults injected by the engine's FaultPlan", labels=("kind",))
        self.c_guard_trips = r.counter(
            "repro_guard_trips_total",
            "runtime guard trips (slot quarantine or quality sentinel)",
            labels=("reason",))
        self.c_retries = r.counter(
            "repro_retries_total", "guard-tripped requests requeued")
        self.c_failed = r.counter(
            "repro_requests_failed_total", "requests failed (retries spent)")
        self.c_shed = r.counter(
            "repro_requests_shed_total",
            "requests shed by backpressure", labels=("reason",))
        self.c_deadline_miss = r.counter(
            "repro_deadline_miss_total",
            "requests terminated past their deadline", labels=("edge",))
        self.c_brownout = r.counter(
            "repro_brownout_total",
            "forced QoS rung degradations under overload")
        self.c_scrubs = r.counter(
            "repro_param_scrubs_total", "golden parameter restores")
        self.c_dropped_ticks = r.counter(
            "repro_dropped_ticks_total", "fused steps skipped by drop faults")
        # admission pipeline families; zero-valued unless the engine runs
        # with an AdmissionConfig
        self.c_warmups = r.counter(
            "repro_admission_warmups_total",
            "warmup passes over the admission + step call shapes")
        self.c_admit_bucket = r.counter(
            "repro_prefill_bucket_total",
            "bucketed prefill flushes by padded length", labels=("bucket",))
        self.c_packed_rows = r.counter(
            "repro_packed_rows_total",
            "prompt rows admitted via multi-row packed prefill calls")
        self.c_chunk_calls = r.counter(
            "repro_prefill_chunk_calls_total",
            "chunked prefill device calls (long-prompt admission)")
        # recent (tick, degrees_tuple) trace — ALWAYS a tuple (a global
        # scalar records as a 1-tuple); bounded so long engines don't leak
        self.degree_history: deque = deque(maxlen=512)

    # ---- legacy scalar reads (tests, benches, summarize) -------------

    @property
    def prefill_tokens(self) -> int:
        return int(self.c_prefill_tokens.value)

    @property
    def prefill_calls(self) -> int:
        return int(self.c_prefill_calls.value)

    @property
    def decode_tokens(self) -> int:
        return int(self.c_decode_tokens.value)

    @property
    def decode_steps(self) -> int:
        return int(self.c_decode_steps.value)

    @property
    def admitted(self) -> int:
        return int(self.c_admitted.value)

    # ---- recording ---------------------------------------------------

    def record_degree(self, tick: int, degree, site_names=None) -> tuple:
        """Append a tuple-normalized degree to the history and refresh the
        ``repro_degree_ebits{site=..}`` gauge family.  ``site_names`` maps
        vector positions to plan site names (``layer_i`` / ``head``); a
        1-entry record without names exports as ``site="global"``."""
        rec = degree_record(degree, as_tuple=True)
        self.degree_history.append((tick, rec))
        if site_names is not None and len(site_names) == len(rec):
            for name, e in zip(site_names, rec):
                self.g_degree.labels(site=name).set(e)
        elif len(rec) == 1:
            self.g_degree.labels(site="global").set(rec[0])
        else:
            for i, e in enumerate(rec):
                self.g_degree.labels(site=f"site_{i}").set(e)
        return rec

    def record_completion(self, req) -> None:
        """Observe one finished request into the latency histograms.
        Reads the LM-named request fields with a fallback to the generic
        ServeCore names, so both workloads (and legacy request shims)
        observe identically."""
        self.c_completed.inc()
        self.h_queue.observe(req.queue_time)
        self.h_e2e.observe(req.e2e)
        if _rget(req, "t_first_token", "t_first_emit") > 0:
            self.h_ttft.observe(req.ttft)
        if len(_rget(req, "out_tokens", "out")) > 1:
            self.h_tpot.observe(req.tpot)


def _rget(req, *names, default=None):
    """Read the first present attribute: LM-era name first (the serve tests
    pin request shims carrying only those), generic ServeCore name second."""
    for name in names:
        val = getattr(req, name, None)
        if val is not None:
            return val
    return default


def _units(req) -> int:
    """Payload size in workload units: the generic Request carries it
    (``payload_units``); legacy request shims fall back to the prompt."""
    u = _rget(req, "payload_units")
    if u is not None:
        return int(u)
    p = _rget(req, "prompt", "payload")
    return int(p.size) if p is not None else 0


def _pct(xs, q: float) -> float:
    """Linearly-interpolated percentile (inclusive / numpy ``linear``
    method) — the nearest-rank rounding it replaces put p95 on an observed
    sample, which over-reported tails at small n."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def summarize(done, stats: EngineStats | None = None,
              wall_s: float | None = None) -> dict:
    """Aggregate finished requests into a flat metrics dict (ms units).
    Key names keep the LM-era vocabulary ("generated_tokens", ...) for
    stability; request fields are read LM-name-first with generic-name
    fallback (``_rget``), so stream-workload requests summarize too."""
    outs = [_rget(r, "out_tokens", "out") for r in done]
    ttft = [r.ttft for r in done
            if _rget(r, "t_first_token", "t_first_emit") > 0]
    tpot = [r.tpot for r, o in zip(done, outs) if len(o) > 1]
    queue = [r.queue_time for r in done]
    e2e = [r.e2e for r in done]
    gen = sum(len(o) for o in outs)
    out = {
        "requests": len(done),
        "generated_tokens": gen,
        "prompt_tokens": sum(_units(r) for r in done),
        "ttft_p50_ms": round(_pct(ttft, 0.50) * 1e3, 2),
        "ttft_p95_ms": round(_pct(ttft, 0.95) * 1e3, 2),
        "ttft_p99_ms": round(_pct(ttft, 0.99) * 1e3, 2),
        "tpot_p50_ms": round(_pct(tpot, 0.50) * 1e3, 2),
        "tpot_p95_ms": round(_pct(tpot, 0.95) * 1e3, 2),
        "queue_p50_ms": round(_pct(queue, 0.50) * 1e3, 2),
        "queue_p95_ms": round(_pct(queue, 0.95) * 1e3, 2),
        "e2e_p50_ms": round(_pct(e2e, 0.50) * 1e3, 2),
        "e2e_p95_ms": round(_pct(e2e, 0.95) * 1e3, 2),
    }
    # which degree served each request's FIRST token: a mid-run rung change
    # is visible here even when every request finishes on the final rung
    first_deg: dict = {}
    for r in done:
        d = _rget(r, "degree_at_first_token", "degree_at_first_emit")
        if d is not None:
            key = ".".join(str(x) for x in d)
            first_deg[key] = first_deg.get(key, 0) + 1
    if first_deg:
        out["degree_at_first_token"] = dict(sorted(first_deg.items()))
    # terminal status partition (resilience policies): only surfaced when
    # some request ended non-ok, so clean summaries are unchanged
    statuses: dict = {}
    for r in done:
        st = getattr(r, "status", "ok")
        statuses[st] = statuses.get(st, 0) + 1
    if set(statuses) - {"ok"}:
        out["request_status"] = dict(sorted(statuses.items()))
    if wall_s is not None and wall_s > 0:
        out["gen_tok_per_s"] = round(gen / wall_s, 1)
    if stats is not None:
        out["engine_prefill_tokens"] = stats.prefill_tokens
        out["engine_prefill_calls"] = stats.prefill_calls
        out["engine_decode_tokens"] = stats.decode_tokens
        out["engine_decode_steps"] = stats.decode_steps
        if stats.degree_history:
            # entries are tuple-normalized at record time: a global ladder
            # records 1-tuples, a plan ladder the rung's per-site tuple
            out["degree_final_ebits"] = list(stats.degree_history[-1][1])
    return out
