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
error every N ticks into a per-rung histogram (``obs/quality.py``).  The
reference's fault injection, guards and serving policy are not ported
yet.
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
from repro_torch.serve.emitq import AsyncEmitter
from repro_torch.serve.graphs import GraphSet
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
    hooks; ``capture`` picks graph replay or eager steps (module
    docstring).  Host times (TTFT, e2e) are taken after each tick's
    emissions reach the host, which waits for the device."""

    def __init__(self, workload: ServableModel, params, *, slots: int = 8,
                 max_len: int = 512, seed: int = 0,
                 qos: Optional[QoSController] = None, degree=None,
                 prepack: bool = True, plan=None, registry=None,
                 tracer=None, quality_every: int = 0, emitter=None,
                 capture: Optional[bool] = None):
        self.workload = workload
        self.device = workload.device
        self.capture = resolve_capture(capture, self.device)
        self.params = workload.prepack(params) if prepack else params
        self.slots = slots
        self.max_len = max_len
        self.qos = qos
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
        self._step_key = ("step", (tuple(self._feed.shape),
                                   None if self._degree is None
                                   else tuple(self._degree.shape)))
        self._read_event = torch.cuda.Event()
        self._out_pin = None

    def _scratch_step(self, feed, active) -> None:
        """The fused step on a scratch copy of the state with a throwaway
        generator, so the live state and the engine's sampling stream stay
        as they were."""
        scratch = type(self.state)(*(t.clone() for t in self.state))
        self.workload.step(self.params, scratch, feed, active,
                           torch.Generator(device=self.device).manual_seed(0),
                           self._degree)
        del scratch

    def _capture_step(self) -> None:
        """Capture the fused step against the live state (a capture executes
        nothing, so the state stays bit-identical), warmed up on a scratch
        copy."""
        wl = self.workload

        def step(feed, active):
            nxt, _ = wl.step(self.params, self.state, feed, active, self._gen,
                             self._degree)
            return nxt

        c = self.graphs.capture(self._step_key, step, self._step_inputs,
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
                    torch.zeros(self.slots, dtype=torch.bool, device=self.device))
        self.stats.c_warmups.inc()

    # ------------------------------------------------------------------

    def submit(self, payload, budget: Optional[int] = None) -> Request:
        """Enqueue one request (FIFO); returns the live Request."""
        wl = self.workload
        payload = wl.validate(payload)
        if budget is None:
            budget = wl.default_budget(payload)
        req = (wl.request_cls or Request)(
            rid=next(self._rid), payload=payload, budget=int(budget),
            payload_units=wl.payload_units(payload), t_enqueue=time.time())
        self.queue.append(req)
        self._tracer.event(
            "enqueue", track="engine", rid=req.rid,
            queue_depth=len(self.queue),
            **{wl.payload_arg: req.payload_units, wl.budget_arg: int(budget)})
        return req

    def _admit(self, slot: int, req: Request):
        req.t_admitted = time.time()
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

    def _admit_pipeline(self) -> None:
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
        now = time.time()
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            if not self.queue:
                break
            req = self.queue.popleft()
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

    # ------------------------------------------------------------------

    def tick(self) -> int:
        """One engine iteration: admit queued requests into free slots,
        update the QoS degree, run ONE fused step over all slots, and
        harvest emissions.  Returns the number of active slots."""
        wl = self.workload
        if self._admission is None:
            for s in range(self.slots):
                if self.slot_req[s] is None and self.queue:
                    self._admit(s, self.queue.popleft())
        else:
            self._admit_pipeline()
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
        mask = np.zeros(self.slots, bool)
        mask[active] = True
        if self._tap is not None and self._tap.due(self._ticks):
            # probe BEFORE the step, on the inputs the step is about to
            # consume; the tap leaves the state as it found it
            self._tap.sample(self._ticks, self.params, self.state,
                             torch.from_numpy(self._feed).to(self.device),
                             torch.from_numpy(mask).to(self.device), self._degree,
                             rung=self._degree_rec)
        with self._tracer.span(f"{wl.step_span}_tick", track="engine",
                               tick=self._ticks, active=len(active),
                               queued=len(self.queue)):
            if self.capture:
                nxt = self._replay_step(mask)
            else:
                nxt, self.state = wl.step(
                    self.params, self.state, torch.from_numpy(self._feed).to(self.device),
                    torch.from_numpy(mask).to(self.device), self._gen, self._degree)
                nxt = nxt.cpu().numpy()      # the tick's one device->host read
        self._ticks += 1
        self.stats.c_steps.inc()
        self.stats.c_step_units.inc(len(active))
        for site in wl.step_sites:
            self._count_route(site)
        self._tracer.counter("slots", track="engine", active=len(active),
                             queued=len(self.queue))
        now = time.time()
        for s in active:
            req = self.slot_req[s]
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

    def _replay_step(self, mask: np.ndarray) -> np.ndarray:
        """Stage the feed and the slot mask, replay the step's graph and read
        its emissions into pinned memory: the tick's one device-to-host
        read (a copy out, so the next tick's read cannot overwrite them)."""
        g = self.graphs
        out = g.run(self._step_key, {"feed": self._feed, "active": mask})
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
