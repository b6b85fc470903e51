"""Workload-generic continuous-batching serve core: slot lifecycle + QoS.

Requests enter a FIFO queue; free slots are (re)filled on admission by the
workload's fused ingest call, which rewinds the slot's state region and
writes the payload prefix into it; every engine tick runs ONE fused step
for all slots.  Free slots are masked out of the step — their state never
advances — so a freed slot can be handed to the next request with no stale
state: admission into a reused slot equals a solo run on a fresh engine.

The engine is generic over a :class:`~repro_torch.serve.servable.ServableModel`
(``serve/lm.py`` adapts the language models, ``serve/stream.py`` the DSP
pipeline).  The approximation degree is a device int32 operand — a global
scalar or, under an :class:`~repro_torch.tune.plan.ApproxPlan`, a per-site
vector — and an optional :class:`~repro_torch.core.dynamic.QoSController`
moves it with serving load (heavy load -> cheaper arithmetic, idle ->
exact).  With a plan the controller steps along the plan's calibrated
ladder (whole mixed per-site configurations) instead of one global knob.
One device operand per ladder rung is built at construction, so a rung
move swaps a reference: no rebuild, no host-to-device copy, no sync.

Compiled step (``capture``): on a CUDA device the fused step — and, with
an admission config, each bucket's prefill and the prefill chunk — runs
as a replay of one CUDA graph per call shape (``serve/graphs.py``), the
counterpart of the reference's ``jax.jit`` of each entry point, captured
at construction so no request ever waits on a capture.  A tick stages the
feed and the slot mask through pinned host buffers into the graph's
static inputs, replays, and reads the emissions back into a pinned buffer
— its one device-to-host read.  The graphs read the degree from one
static device buffer; a rung move copies the prebuilt rung operand into
it on the stream (device to device: no recapture, no host copy, no sync).
``capture=None`` captures on a CUDA device and runs eagerly on the CPU,
which has no graphs; ``capture=False`` runs the card eagerly (an explicit
choice, for comparisons); ``capture=True`` on the CPU raises.  A capture
that fails raises: the engine never falls back to eager serving.

With an admission config on the workload (``serve/admission.py``) the
engine runs the admission pipeline: short prompts pack into bucketed
prefill calls, long prompts admit chunk by chunk across ticks, interleaved
with decode (a slot joins the fused step once its prompt is in), every
admission and step call shape runs once at construction (warmup), and a
background emitter detokenizes harvested tokens off the tick.

Observability: every lifecycle edge — enqueue, admission, the per-tick
step, first emission, completion, QoS rung moves (with the per-site degree
vector) — is traced through ``tracer`` (the process-global
:mod:`repro_torch.obs.trace` tracer by default; one predicate per call
site while it is disabled) under the workload's vocabulary; every counter
lives in ``stats.registry`` (pass ``registry=`` to co-export with the
dispatch counters); ``quality_every=N`` samples the live-vs-exact output
error every N ticks into a per-rung histogram (``obs/quality.py``).

Resilience (``repro_torch.resil``): ``faults=`` injects a seeded
:class:`~repro_torch.resil.faults.FaultPlan` (SEU bit flips, NaN/Inf
activations, latency spikes, dropped ticks); ``guards=`` switches the
engine onto the workload's ``guarded_step`` — per-slot ok bits computed in
the step, quarantine through the in-place slot reset, golden-parameter
scrubbing, the quality-tap sentinel; ``policy=`` adds deadlines,
capped-backoff retry, backpressure and brownout-by-approximation (the QoS
ladder degrades before anything sheds).  ``clock=`` injects the engine's
time source (``resil.policy.VirtualClock`` makes deadlines and backoff
deterministic).  Faults imply guards, and guards imply a policy.  Under
capture the guarded step is the one captured at warmup: the fault vector
is a static input staged through pinned memory like the feed, and the ok
bits come back packed into the emissions' one pinned read.  Flips, resets
and scrubs are written in place, into the tensors the graphs read; the
golden copy is a device clone of the parameter tree, and a scrub copies
back only the leaves flipped since the last one.  Every request
terminates exactly once in ``done`` with a status in {ok, failed, shed,
deadline}, and ``resil_log`` records the (tick, event, args) recovery
trace.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dynamic import (QoSController, degree_operand,
                                      degree_record, entry_degree)
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.obs import trace as obs_trace
from repro_torch.resil import GuardConfig, ServePolicy
from repro_torch.resil.faults import tree_leaves
from repro_torch.serve.emitq import AsyncEmitter
from repro_torch.serve.graphs import GraphSet, device_inputs
from repro_torch.serve.metrics import EngineStats
from repro_torch.serve.servable import ServableModel
from repro_torch.tune.plan import site_names


@dataclass
class Request:
    """One unit of serving work.  ``payload`` is what the workload ingests
    (LM prompt ids), ``out`` what its steps emit."""

    rid: int
    payload: object
    budget: int = 32
    payload_units: int = 0
    out: list = field(default_factory=list)
    done: bool = False
    admitted_units: int = 0
    #: workload read head into the payload (chunked admission progress)
    cursor: int = 0
    t_enqueue: float = 0.0
    t_admitted: float = 0.0
    t_first_emit: float = 0.0
    t_done: float = 0.0
    #: degree tuple that served the first emission
    degree_at_first_emit: Optional[tuple] = None
    #: terminal disposition: ok | failed (retries spent) | shed | deadline
    status: str = "ok"
    #: guard-trip requeues so far
    retries: int = 0
    #: e2e / TTFT deadlines (seconds from t_enqueue; None = none)
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    #: earliest admission time (retry backoff gate)
    eligible_at: float = 0.0

    @property
    def queue_time(self) -> float:
        return self.t_admitted - self.t_enqueue

    @property
    def ttft(self) -> float:
        return self.t_first_emit - self.t_enqueue

    @property
    def tpot(self) -> float:
        return (self.t_done - self.t_first_emit) / max(len(self.out) - 1, 1)

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_enqueue


class ServeCore:
    """Continuous-batching engine over a fixed batch of ``slots``.

    ``qos`` drives the runtime degree from load; ``plan`` replaces the
    controller's ladder with the plan's calibrated per-site rungs (and
    supplies the initial degree vector); ``degree`` pins a static initial
    degree (scalar or per-site vector) without a controller; ``prepack``
    applies the workload's quantize-once weight residency at construction.
    ``tracer``, ``registry`` and ``quality_every`` are the observability
    hooks; ``capture`` picks graph replay or eager steps; ``faults``,
    ``guards``, ``policy`` and ``clock`` the resilience layer (module
    docstring).  Host times (TTFT, e2e) are taken after each tick's
    emissions reach the host, which waits for the device."""

    def __init__(self, workload: ServableModel, params, *, slots: int = 8,
                 max_len: int = 512, seed: int = 0,
                 qos: Optional[QoSController] = None, degree=None,
                 prepack: bool = True, plan=None, registry=None,
                 tracer=None, quality_every: int = 0, emitter=None,
                 capture: Optional[bool] = None, faults=None, guards=None,
                 policy=None, clock=None):
        self.workload = workload
        self.device = workload.device
        self.capture = resolve_capture(capture, self.device)
        self.params = workload.prepack(params) if prepack else params
        self.slots = slots
        self.max_len = max_len
        self.qos = qos
        self._clock = clock if clock is not None else time.time
        self.state = workload.init_state(batch=slots, max_len=max_len)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_budget = np.zeros(slots, np.int32)
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.stats = EngineStats(registry, unit=workload.unit,
                                 admit_name=workload.admit_span,
                                 step_name=workload.step_span)
        self._tracer = tracer if tracer is not None else obs_trace.get_tracer()
        self._feed = workload.init_feed(slots)
        self._rid = itertools.count()
        self._ticks = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # approximation plan: validate against the arch, and point the QoS
        # controller's ladder at the plan's calibrated per-site rungs
        cfg = workload.cfg
        self.plan = plan
        if plan is not None:
            plan.validate_for(cfg)
            if qos is not None:
                qos.ladder = plan.qos_ladder()
                qos.degree = min(qos.degree, len(qos.ladder) - 1)
        # device degree operands: one per rung, built once.  The initial
        # degree is the pinned ``degree``, else the controller's current
        # rung, else the plan's most accurate rung.
        self._rungs = None
        if qos is not None and qos.ladder:
            self._rungs = [degree_operand(e, self.device) for e in qos.ladder]
        self._degree = None
        self._degree_host = None
        if degree is not None:
            self._degree = torch.as_tensor(degree, dtype=torch.int32,
                                           device=self.device)
            self._degree_host = degree_record(degree)
        elif self._rungs is not None:
            self._degree = self._rungs[qos.degree]
            self._degree_host = entry_degree(qos.ladder[qos.degree])
        elif plan is not None:
            self._degree = torch.as_tensor(plan.degrees(0), device=self.device)
            self._degree_host = tuple(plan.ladder[0].degrees)
        # plan site names label the repro_degree_ebits{site=..} gauges (and
        # trace events); scalar degrees export as site="global"
        self._site_names = site_names(cfg)
        self._degree_rec: Optional[tuple] = None
        if self._degree is not None:
            # the construction-time degree is served until the first QoS
            # update: record it so the history covers every degree used
            self._degree_rec = self.stats.record_degree(
                -1, self._degree_host, self._site_names)
        # per-rung online quality telemetry (obs/quality.py): compare the
        # live degree's outputs against the exact rung every N ticks
        self._tap = None
        if quality_every > 0:
            if self._degree is None:
                raise ValueError(
                    "quality_every needs a driven degree (pass degree=, "
                    "qos=, or plan=)")
            self._tap = workload.quality_tap(every=quality_every,
                                             registry=self.stats.registry,
                                             tracer=self._tracer)
        # backend last counted per dispatch call site (route counters)
        self._route: dict = {}
        self._init_resil(faults, guards, policy)
        # admission pipeline: None = exact-length admission, one fused
        # prefill per request
        self._admission = getattr(workload, "admission", None)
        self.emitter = None
        if self._admission is not None and emitter is not False:
            self.emitter = emitter if emitter is not None else AsyncEmitter()
        #: the engine's CUDA graphs (None: eager)
        self.graphs: Optional[GraphSet] = None
        # the rung the captured degree buffer holds (None: a pinned degree)
        self._rung_in_buffer = (qos.degree if degree is None and self._rungs is not None
                                else None)
        if self.capture:
            self._init_capture()
        if self._admission is not None and self._admission.warmup:
            self._warmup()
        if self.capture and self._step_key not in self.graphs:
            # no admission warmup: the step is still captured here, so the
            # capture stays out of the first request's TTFT
            self._capture_step()

    def _init_resil(self, faults, guards, policy) -> None:
        """Faults imply guards (injected corruption must be catchable) and
        guards imply a policy (something must own retry semantics); with
        all three absent the engine runs the plain step."""
        if faults is not None and guards is None:
            guards = GuardConfig()
        if guards is not None and policy is None:
            policy = ServePolicy()
        self.faults = faults
        self.guards = guards
        self.policy = policy
        #: (tick, event, sorted-args) recovery trace: the same fault seed and
        #: traffic give the same log
        self.resil_log: list = []
        self._golden = None
        self._sentinel = None
        self._fault_vec = np.zeros(self.slots, np.float32)
        #: parameter leaves flipped since the last scrub (tree_leaves order)
        self._dirty: set = set()
        if guards is not None:
            if guards.limit is not None:
                self.workload.guard_limit = guards.limit
            # the golden copy: a device clone (the live tensors are flipped
            # in place, where the graphs read them)
            self._live_leaves = tree_leaves(self.params)
            self._golden = [t.clone() for t in self._live_leaves]
            if guards.sentinel_threshold is not None:
                if self._tap is None:
                    raise ValueError(
                        "sentinel_threshold needs quality_every > 0 (the "
                        "sentinel watches the quality tap's samples)")
                self._sentinel = guards.sentinel()
        if faults is not None:
            faults.bind(self.state, self.params, self.slots)

    def _init_capture(self) -> None:
        """The graph set, the static degree buffer every graph reads, and
        the step's static inputs (feed, slot mask)."""
        wl = self.workload
        sampling = not getattr(wl, "greedy", True)
        self.graphs = GraphSet(self.device, (self._gen,) if sampling else ())
        if hasattr(wl, "graphs"):
            wl.graphs = self.graphs              # the workload's admission graphs
        if self._degree is not None:
            self._degree = self._degree.clone()
            for r in self._rungs or ():
                if r.shape != self._degree.shape:
                    raise ValueError(
                        f"a QoS rung of shape {tuple(r.shape)} cannot share the "
                        f"captured degree buffer of shape {tuple(self._degree.shape)}")
        self._step_inputs = {
            "feed": torch.from_numpy(self._feed).to(self.device),
            "active": torch.zeros(self.slots, dtype=torch.bool, device=self.device)}
        if self.guards is not None:
            self._step_inputs["fault"] = torch.zeros(self.slots, dtype=torch.float32,
                                                     device=self.device)
        self._step_key = ("step", (tuple(self._feed.shape),
                                   None if self._degree is None
                                   else tuple(self._degree.shape)))
        self._read_event = torch.cuda.Event()
        self._out_pin = None

    def _scratch_step(self, feed, active, fault=None) -> None:
        """The fused step on a scratch copy of the state with a throwaway
        generator, so the live state and the engine's sampling stream stay
        as they were."""
        scratch = type(self.state)(*(t.clone() for t in self.state))
        args = (self.params, scratch, feed, active,
                torch.Generator(device=self.device).manual_seed(0), self._degree)
        if self.guards is not None:
            self.workload.guarded_step(*args, fault)
        else:
            self.workload.step(*args)
        del scratch

    def _run_step(self, feed, active, fault=None):
        """One step on the live state (advanced in place; the eager engine
        also takes the returned tuple): the emissions, with the ok bits
        packed in as a last column under guards (:func:`pack_ok`)."""
        if self.guards is None:
            nxt, state = self.workload.step(self.params, self.state, feed, active,
                                            self._gen, self._degree)
        else:
            nxt, state, ok = self.workload.guarded_step(
                self.params, self.state, feed, active, self._gen, self._degree, fault)
            self._emit_shape = tuple(nxt.shape)
            self._emit_dtype = torch.empty(0, dtype=nxt.dtype).numpy().dtype
            nxt = pack_ok(nxt, ok)
        if not self.capture:
            self.state = state
        return nxt

    def _capture_step(self) -> None:
        """Capture the fused step (guarded under guards) against the live
        state — a capture executes nothing, so the state stays bit-identical
        — warmed up on a scratch copy."""
        c = self.graphs.capture(self._step_key, self._run_step, self._step_inputs,
                                warm_fn=self._scratch_step)
        self._out_pin = self.graphs._pinned(c.out)

    def _warmup(self) -> None:
        """Run every admission call shape and the fused step once before
        the first request — under capture, capture each one's graph.  The
        admission calls use dummy rows that write nothing; the step runs on
        a scratch copy of the state with every slot free (and is then
        captured against the live state)."""
        wl = self.workload
        a = self._admission
        with self._tracer.span("admission_warmup", track="engine",
                               buckets=list(a.buckets), pack=a.pack,
                               chunk=a.chunk_tokens):
            wl.warmup_admission(self.params, self.state, self._feed, self._degree)
            if self.capture:
                if self._step_key not in self.graphs:
                    self._capture_step()
            else:
                self._scratch_step(
                    torch.from_numpy(self._feed).to(self.device),
                    torch.zeros(self.slots, dtype=torch.bool, device=self.device),
                    torch.zeros(self.slots, dtype=torch.float32, device=self.device))
        self.stats.c_warmups.inc()

    # ------------------------------------------------------------------

    def submit(self, payload, budget: Optional[int] = None, *,
               deadline_ms: Optional[float] = None,
               ttft_deadline_ms: Optional[float] = None) -> Request:
        """Enqueue one request (FIFO); returns the live Request.
        ``deadline_ms`` / ``ttft_deadline_ms`` override the policy defaults
        per request (ignored without a policy: nothing would enforce them)."""
        wl = self.workload
        payload = wl.validate(payload)
        if budget is None:
            budget = wl.default_budget(payload)
        p = self.policy
        if p is not None:
            if deadline_ms is None:
                deadline_ms = p.deadline_ms
            if ttft_deadline_ms is None:
                ttft_deadline_ms = p.ttft_deadline_ms
        req = (wl.request_cls or Request)(
            rid=next(self._rid), payload=payload, budget=int(budget),
            payload_units=wl.payload_units(payload), t_enqueue=self._clock(),
            deadline_s=None if deadline_ms is None else deadline_ms / 1e3,
            ttft_deadline_s=(None if ttft_deadline_ms is None
                             else ttft_deadline_ms / 1e3))
        self.queue.append(req)
        self._tracer.event(
            "enqueue", track="engine", rid=req.rid,
            queue_depth=len(self.queue),
            **{wl.payload_arg: req.payload_units, wl.budget_arg: int(budget)})
        return req

    def _admit(self, slot: int, req: Request):
        req.t_admitted = self._clock()
        wl = self.workload
        with self._tracer.span(wl.admit_span, track="engine", rid=req.rid,
                               slot=slot,
                               **{wl.payload_arg: req.payload_units}):
            self.state, ingested = wl.admit(self.params, self.state,
                                            self._feed, slot, req,
                                            self._degree)
        req.admitted_units = int(ingested)
        if req.admitted_units > 0:
            self.stats.c_admit_units.inc(req.admitted_units)
            self.stats.c_admit_calls.inc()
            if wl.admit_site:
                self._count_route(wl.admit_site)
        self.slot_req[slot] = req
        self.slot_budget[slot] = req.budget
        self.stats.c_admitted.inc()

    # ---- admission pipeline (serve/admission.py) ------------------------

    def _chunk_call(self, slot: int, req: Request) -> None:
        """One chunked-prefill call advancing ``req``'s admission."""
        wl = self.workload
        with self._tracer.span(wl.admit_span, track="engine", rid=req.rid,
                               slot=slot, chunk=True, cursor=req.cursor):
            self.state, n = wl.admit_chunk(self.params, self.state,
                                           self._feed, slot, req,
                                           self._degree)
        req.admitted_units += int(n)
        if n > 0:
            self.stats.c_admit_units.inc(int(n))
        self.stats.c_admit_calls.inc()
        self.stats.c_chunk_calls.inc()
        if wl.admit_site:
            self._count_route(wl.admit_site)

    def _flush_batch(self, pairs: list) -> None:
        """Admit up to ``pack`` requests in one bucketed prefill call."""
        if not pairs:
            return
        wl = self.workload
        with self._tracer.span(wl.admit_span, track="engine",
                               rid=pairs[0][1].rid, slot=pairs[0][0],
                               packed=len(pairs)):
            self.state, ingested = wl.admit_batch(self.params, self.state,
                                                  self._feed, pairs,
                                                  self._degree)
        total = 0
        for (_, req), n in zip(pairs, ingested):
            req.admitted_units = int(n)
            total += int(n)
        if total > 0:
            self.stats.c_admit_units.inc(total)
        self.stats.c_admit_calls.inc()
        if len(pairs) > 1:
            self.stats.c_packed_rows.inc(len(pairs))
        bucket = getattr(wl, "last_admit_bucket", None)
        if bucket is not None:
            self.stats.c_admit_bucket.labels(bucket=str(bucket)).inc()
        if wl.admit_site:
            self._count_route(wl.admit_site)

    def _admit_pipeline(self, now: float) -> None:
        """Bucketed/packed/chunked admission: first advance mid-admission
        chunked slots (a bounded number of calls per tick, so long-prompt
        ingestion interleaves with decode instead of stalling short-request
        TTFT), then fill free slots — chunked requests take their slot
        alone, short ones pack into one bucketed prefill call."""
        wl = self.workload
        a = self._admission
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None or wl.admit_complete(req):
                continue
            for _ in range(a.chunk_calls_per_tick):
                self._chunk_call(s, req)
                if wl.admit_complete(req):
                    break
        batch: list = []
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            if self.policy is None:
                req = self.queue.popleft() if self.queue else None
            else:
                req = self._next_admittable(now)
            if req is None:
                break
            req.t_admitted = now
            self.slot_req[s] = req
            self.slot_budget[s] = req.budget
            self.stats.c_admitted.inc()
            if wl.wants_chunked(req):
                self._chunk_call(s, req)
            else:
                batch.append((s, req))
                if len(batch) >= a.pack:
                    self._flush_batch(batch)
                    batch = []
        self._flush_batch(batch)

    def _update_degree(self, n_active: int):
        """Feed the QoS controller a load-headroom signal: overload moves
        the degree down the ladder (cheaper arithmetic), idle capacity back
        to exact — by swapping prebuilt device operands.  Plan ladders step
        whole per-site degree vectors; the global ladder one ebits scalar."""
        occupancy = (n_active + len(self.queue)) / self.slots
        headroom = max(0.0, 1.0 - occupancy)
        entry = self.qos.update(self._ticks, headroom)
        if not self.capture:
            self._degree = self._rungs[self.qos.degree]
        elif self.qos.degree != self._rung_in_buffer:
            # the graphs read one static buffer: copy the rung in, on the
            # stream before the next replay
            self._degree.copy_(self._rungs[self.qos.degree])
            self._rung_in_buffer = self.qos.degree
        self._degree_host = entry_degree(entry)
        rec = self.stats.record_degree(self._ticks, self._degree_host,
                                       self._site_names)
        if rec != self._degree_rec:
            # QoS rung transition: the event carries the full per-site
            # degree vector, so the trace shows which arithmetic served
            # every span that follows
            self._tracer.event("qos_rung", track="engine", tick=self._ticks,
                               rung=self.qos.degree, degrees=list(rec),
                               headroom=round(headroom, 4))
            self._degree_rec = rec

    def _count_route(self, site: str) -> None:
        """Per-call kernel-route counter: the backend this call site took
        (``dispatch.last_route``, written by the router on every call), so
        ``sum(route counters) == call count``; a ``kernel_route`` event
        marks each site's first backend and every change of it."""
        backend = kdispatch.last_route.get(site)
        if backend is None:
            backend = kdispatch.resolved_backend(self.device)
        if self._route.get(site) != backend:
            self._route[site] = backend
            self._tracer.event("kernel_route", track="engine", site=site,
                               backend=backend)
        self.stats.c_route_steps.labels(site=site, backend=backend).inc()

    # ---- resilience machinery (repro_torch.resil) -----------------------

    def _resil_event(self, name: str, **args) -> None:
        """Record one recovery-trace entry and the matching trace event.
        The entry is a plain (tick, name, sorted-args) tuple, so two runs
        compare with ``==``."""
        self.resil_log.append((self._ticks, name, tuple(sorted(args.items()))))
        self._tracer.event(name, track="resil", tick=self._ticks, **args)

    def _finish(self, req: Request, status: str, now: float,
                slot: Optional[int] = None) -> None:
        """Terminate one request non-ok (failed/shed/deadline): exactly one
        ``done`` entry per submitted request, whatever its fate."""
        req.status = status
        req.done = True
        req.t_done = now
        self.done.append(req)
        if slot is not None:
            self.slot_req[slot] = None

    def _scrub(self, reason: str) -> None:
        """Copy the golden parameters back, in place, into the leaves
        flipped since the last scrub (memory scrubbing).  Free when nothing
        was flipped."""
        if self._golden is None or not self._dirty:
            return
        for i in sorted(self._dirty):
            self._live_leaves[i].copy_(self._golden[i])
        self._dirty.clear()
        self.stats.c_scrubs.inc()
        self._resil_event("param_scrub", reason=reason)

    def params_golden(self) -> bool:
        """Whether every parameter leaf is byte-equal to its golden copy
        (reads the card: for checks, never on the serving path)."""
        if self._golden is None:
            return True
        return all(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                   for a, b in zip(self._live_leaves, self._golden))

    def _quarantine(self, slot: int, now: float) -> None:
        """Per-slot guard trip: reset the slot in place, scrub, and requeue
        the request (rewound to a fresh admission, behind capped backoff) or
        fail it per policy."""
        req = self.slot_req[slot]
        self.stats.c_guard_trips.labels(reason="slot").inc()
        self._resil_event("guard_tripped", reason="slot", rid=req.rid, slot=slot)
        self.state = self.workload.reset_slot(self.state, slot)
        self.slot_req[slot] = None
        if self.guards.scrub_on_trip:
            self._scrub("guard_trip")
        req.retries += 1
        if req.retries > self.policy.max_retries:
            self._finish(req, "failed", now)
            self.stats.c_failed.inc()
            self._resil_event("request_failed", rid=req.rid, retries=req.retries)
            return
        # full rewind: the retry is indistinguishable from a fresh admission
        req.out.clear()
        req.cursor = 0
        req.admitted_units = 0
        req.t_first_emit = 0.0
        req.degree_at_first_emit = None
        backoff = self.policy.backoff_s(req.retries)
        req.eligible_at = now + backoff
        self.queue.appendleft(req)
        self.stats.c_retries.inc()
        self._resil_event("retry", rid=req.rid, retries=req.retries,
                          backoff_ms=round(backoff * 1e3, 3))

    def _next_admittable(self, now: float) -> Optional[Request]:
        """Oldest queued request whose retry backoff has elapsed."""
        for req in self.queue:
            if req.eligible_at <= now:
                self.queue.remove(req)
                return req
        return None

    def _enforce_queue_policy(self, now: float) -> None:
        """Deadline-cull the queue, apply queue-age shedding, and resolve
        queue-length overload: brownout first (force the QoS controller one
        rung down its ladder), shed — newest first — only once the ladder
        is exhausted."""
        p = self.policy
        keep: deque = deque()
        for req in self.queue:
            age = now - req.t_enqueue
            if req.deadline_s is not None and age > req.deadline_s:
                self._finish(req, "deadline", now)
                self.stats.c_deadline_miss.labels(edge="queue").inc()
                self._resil_event("deadline_miss", edge="queue", rid=req.rid)
                continue
            if req.ttft_deadline_s is not None and req.t_first_emit == 0.0:
                # TTFT runs from enqueue: past the deadline a queued request
                # can no longer emit in time, and one whose remaining budget
                # cannot cover its admission calls is doomed
                if age > req.ttft_deadline_s:
                    self._finish(req, "deadline", now)
                    self.stats.c_deadline_miss.labels(edge="queue_ttft").inc()
                    self._resil_event("deadline_miss", edge="queue_ttft", rid=req.rid)
                    continue
                if p.admit_eta_ms is not None:
                    eta = self.workload.admit_calls(req) * p.admit_eta_ms / 1e3
                    if age + eta > req.ttft_deadline_s:
                        self._finish(req, "shed", now)
                        self.stats.c_shed.labels(reason="doomed").inc()
                        self._resil_event("shed", reason="doomed", rid=req.rid)
                        continue
            if (p.max_queue_age_ms is not None
                    and age * 1e3 > p.max_queue_age_ms):
                self._finish(req, "shed", now)
                self.stats.c_shed.labels(reason="stale").inc()
                self._resil_event("shed", reason="stale", rid=req.rid)
                continue
            keep.append(req)
        self.queue = keep
        if p.max_queue is None or len(self.queue) <= p.max_queue:
            return
        qos = self.qos
        if (p.brownout and qos is not None and qos.ladder
                and qos.degree < len(qos.ladder) - 1):
            # graceful degradation: one rung per tick, with the controller's
            # own cooldown armed so it cannot climb straight back
            qos.degree += 1
            qos._cooldown = qos.cooldown_steps
            self.stats.c_brownout.inc()
            self._resil_event("brownout_rung", rung=qos.degree, queued=len(self.queue))
            return
        while len(self.queue) > p.max_queue:
            victim = self.queue.pop()
            self._finish(victim, "shed", now)
            self.stats.c_shed.labels(reason="overload").inc()
            self._resil_event("shed", reason="overload", rid=victim.rid)

    def _enforce_active_deadlines(self, now: float) -> None:
        """Terminate in-slot requests past their e2e or TTFT deadline (the
        freed slot region is rewound by the next admission's reset)."""
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None:
                continue
            age = now - req.t_enqueue
            if req.deadline_s is not None and age > req.deadline_s:
                edge = "active"
            elif (req.ttft_deadline_s is not None and req.t_first_emit == 0.0
                    and age > req.ttft_deadline_s):
                edge = "ttft"
            else:
                continue
            self._finish(req, "deadline", now, slot=s)
            self.stats.c_deadline_miss.labels(edge=edge).inc()
            self._resil_event("deadline_miss", edge=edge, rid=req.rid, slot=s)

    def _stall(self, seconds: float) -> None:
        """Latency spike: advance an injectable clock, sleep a real one."""
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(seconds)
        else:
            time.sleep(seconds)

    def _flip_state(self, ev) -> None:
        """A ``seu_state`` fault: its bit flipped in place in the live
        state."""
        self.state = self.faults.apply_state(self.state, ev)

    def _apply_faults(self) -> bool:
        """Apply this tick's scheduled faults; True = the step is dropped.
        State and parameter flips land in place in the live tensors (the
        golden clone is apart); activation faults arm the fault vector."""
        drop = False
        for ev in self.faults.events_at(self._ticks):
            self.faults.record(ev)
            self.stats.c_faults.labels(kind=ev.kind).inc()
            self._resil_event("fault_injected", **ev.args())
            if ev.kind == "seu_state":
                self._flip_state(ev)
            elif ev.kind == "seu_param":
                self.params = self.faults.apply_params(self.params, ev)
                self._dirty.add(ev.leaf)
            elif ev.kind == "nan":
                self._fault_vec[ev.slot] = ev.value
            elif ev.kind == "spike":
                self._stall(ev.value)
            elif ev.kind == "drop":
                drop = True
        return drop

    # ------------------------------------------------------------------

    def tick(self) -> int:
        """One engine iteration: the policy's deadline and queue checks,
        admission into free slots, the periodic scrub, the QoS degree, this
        tick's faults, the quality tap (and sentinel), then ONE fused step
        over all slots and the harvest (quarantining any slot whose ok bit
        is False).  Returns the number of active slots."""
        wl = self.workload
        now = self._clock()
        if self.policy is not None:
            self._enforce_queue_policy(now)
            self._enforce_active_deadlines(now)
        if self._admission is None:
            for s in range(self.slots):
                if self.slot_req[s] is None and self.queue:
                    if self.policy is None:
                        self._admit(s, self.queue.popleft())
                    else:
                        req = self._next_admittable(now)
                        if req is None:
                            break
                        self._admit(s, req)
        else:
            self._admit_pipeline(now)
        if self.guards is not None and self.guards.scrub_every > 0 \
                and self._ticks and self._ticks % self.guards.scrub_every == 0:
            self._scrub("periodic")
        busy = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not busy:
            return 0
        # a slot mid-way through chunked admission holds a request but has
        # no decodable state yet: it stays out of the fused step's mask
        active = [s for s in busy if wl.admit_complete(self.slot_req[s])]
        if not active:
            # admission-only tick: chunk calls progressed, nothing decodes
            self._ticks += 1
            return len(busy)
        if self.qos is not None:
            self._update_degree(len(active))
        # scheduled faults land before the step: flips are what the step
        # reads, the armed fault vector poisons its activations
        drop = self.faults is not None and self._apply_faults()
        mask = np.zeros(self.slots, bool)
        mask[active] = True
        if self._tap is not None and self._tap.due(self._ticks):
            # probe BEFORE the step, on the inputs the step is about to
            # consume; the tap leaves the state as it found it
            val = self._tap.sample(self._ticks, self.params, self.state,
                                   torch.from_numpy(self._feed).to(self.device),
                                   torch.from_numpy(mask).to(self.device), self._degree,
                                   rung=self._degree_rec)
            if self._sentinel is not None and self._sentinel.observe(val):
                self.stats.c_guard_trips.labels(reason="quality").inc()
                self._resil_event("guard_tripped", reason="quality",
                                  sample=round(float(val), 6))
                if self.guards.scrub_on_trip:
                    self._scrub("sentinel")
        if drop:
            # dropped tick: no step (no replay), no state advance, no
            # emission, no budget charge; an armed fault evaporates
            self._fault_vec[:] = 0.0
            self._ticks += 1
            self.stats.c_dropped_ticks.inc()
            return len(active)
        with self._tracer.span(f"{wl.step_span}_tick", track="engine",
                               tick=self._ticks, active=len(active),
                               queued=len(self.queue)):
            host = {"feed": self._feed, "active": mask}
            if self.guards is not None:
                host["fault"] = self._fault_vec
            if self.capture:
                out = self._replay_step(host)
            else:
                dev = device_inputs(host, self.device)
                out = self._run_step(**dev).cpu().numpy()   # the tick's one read
            if self.guards is not None:
                self._fault_vec[:] = 0.0
                nxt, ok = unpack_ok(out, self._emit_shape, self._emit_dtype)
            else:
                nxt, ok = out, None
        self._ticks += 1
        self.stats.c_steps.inc()
        self.stats.c_step_units.inc(len(active))
        for site in wl.step_sites:
            self._count_route(site)
        self._tracer.counter("slots", track="engine", active=len(active),
                             queued=len(self.queue))
        now = self._clock()
        for s in active:
            req = self.slot_req[s]
            if ok is not None and not ok[s]:
                # corrupted emission: never banked — quarantine the slot
                self._quarantine(s, now)
                continue
            emitted, finished, info = wl.harvest(req, self._feed, s, nxt[s])
            if emitted:
                if req.t_first_emit == 0.0:
                    req.t_first_emit = now
                    req.degree_at_first_emit = self._degree_rec
                    self._tracer.event(wl.first_event, track="engine",
                                       rid=req.rid, slot=s,
                                       ttft_ms=round(req.ttft * 1e3, 3))
                if self.emitter is not None:
                    # detokenize/deliver off-thread: the tick does not wait
                    # on host-side emit work
                    self.emitter.push(req, req.out[-1])
                self.slot_budget[s] -= 1
            if finished or self.slot_budget[s] <= 0:
                req.done = True
                req.t_done = now
                self.done.append(req)
                self.slot_req[s] = None
                self.stats.record_completion(req)
                self._tracer.event("request_done", track="engine",
                                   rid=req.rid, slot=s,
                                   e2e_ms=round(req.e2e * 1e3, 3),
                                   **wl.done_args(req, info))
        return len(active)

    def _replay_step(self, host: dict) -> np.ndarray:
        """Stage the step's inputs, replay its graph and read its output
        into pinned memory: the tick's one device-to-host read (a copy out,
        so the next tick's read cannot overwrite it)."""
        out = self.graphs.run(self._step_key, host)
        self._out_pin.copy_(out, non_blocking=True)
        self._read_event.record()
        self._read_event.synchronize()
        return self._out_pin.numpy().copy()

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        """Tick until the queue and every slot are empty (or ``max_ticks``);
        returns all finished requests in completion order."""
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.tick()
            ticks += 1
        if self.emitter is not None:
            self.emitter.flush()
        return self.done


def pack_ok(emission: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The guarded step's emissions and ok bits as one (slots, E + 1)
    tensor — int64 for integer emissions, float64 for float ones (both
    exact) — so the tick reads them back in one copy."""
    wide = torch.float64 if emission.is_floating_point() else torch.int64
    rows = emission.reshape(emission.shape[0], -1).to(wide)
    return torch.cat([rows, ok.reshape(-1, 1).to(wide)], dim=1)


def unpack_ok(packed: np.ndarray, shape: tuple, dtype) -> tuple:
    """Inverse of :func:`pack_ok` on the host: (emissions of ``shape`` and
    ``dtype``, ok bools)."""
    return (packed[:, :-1].astype(dtype).reshape(shape), packed[:, -1] != 0)


def resolve_capture(capture: Optional[bool], device) -> bool:
    """The engine's ``capture`` switch: None -> graphs on a CUDA device,
    eager on the CPU; True on a device without CUDA graphs raises."""
    dev = torch.device(device)
    if capture is None:
        return dev.type == "cuda"
    if capture and dev.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device (CUDA graphs); the "
                         f"workload runs on {dev}")
    return bool(capture)
