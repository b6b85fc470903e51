"""ServableModel: the workload protocol the serve engine is generic over.

The engine (``serve/engine.py::ServeCore``) owns the scheduling — FIFO
queue, fixed slot batch, free-slot masking, the QoS degree ladder, metrics
— and knows nothing about what flows through the slots.  Everything
workload-specific (what a unit of work is, how a payload is ingested into a
slot, what one fused step computes, when a request finishes, the words the
trace events speak, the quality tap) lives behind this protocol;
``serve/lm.py`` implements it for language models, ``serve/stream.py`` for
the DSP pipeline.

State contract: ``init_state`` returns a NamedTuple on the cache layout of
``models/cache_ops.py`` (``length`` (batch,) at axis 0, other fields batch
at axis 1), so the generic slot reset / mask helpers apply.

Degree contract: ``admit``/``step`` receive the engine's device degree
operand (None | scalar | per-site vector) and pass it down as a tensor —
never ``int()`` it: a host read would sync the device every tick.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels import dispatch as kdispatch
from repro_torch.resil import guards


class ServableModel:
    """Base/protocol for engine workloads."""

    # ---- vocabulary: how the engine narrates this workload ------------
    #: what one emitted unit is called (metric family names, summaries)
    unit: str = "items"
    #: trace-span name for slot admission/ingest (and its metric families)
    admit_span: str = "admit"
    #: enqueue/admit trace arg naming the payload size
    payload_arg: str = "payload_items"
    #: enqueue trace arg naming the emission budget
    budget_arg: str = "budget"
    #: trace-event name for a request's first emission
    first_event: str = "first_emit"
    #: step vocabulary stem: the engine's tick span is "{step_span}_tick"
    #: and the step counter families are "repro_{step_span}_*"
    step_span: str = "step"
    #: dispatch call-site counted per admission ingest (None = uncounted)
    admit_site: Optional[str] = "admit"
    #: dispatch call-sites counted per fused step
    step_sites: tuple = ()
    #: Request subclass the engine constructs on submit
    request_cls = None
    #: the arch config (degree site names); exposes ``name``, ``n_layers``
    cfg = None
    #: the device the workload's state lives on
    device = None
    #: magnitude bound of a clean emission (``resil.guards.slot_ok``);
    #: None = finiteness only
    guard_limit: Optional[float] = None

    def prepack(self, params):
        """Quantize-once residency hook; identity by default."""
        return params

    def init_state(self, *, batch: int, max_len: int):
        raise NotImplementedError

    def init_feed(self, slots: int):
        """Host-side (slots, ...) array handed to each fused step."""
        raise NotImplementedError

    def reset_slot(self, state, slot):
        raise NotImplementedError

    def validate(self, payload):
        """Canonicalize a submitted payload, or raise ValueError at submit."""
        raise NotImplementedError

    def payload_units(self, payload) -> int:
        raise NotImplementedError

    def default_budget(self, payload) -> int:
        raise NotImplementedError

    def admit(self, params, state, feed, slot: int, req, degree):
        """Ingest ``req.payload`` into ``slot``; returns (state, ingested)."""
        raise NotImplementedError

    # ---- bucketed / packed / chunked admission (serve/admission.py) ----

    def admit_batch(self, params, state, feed, pairs, degree):
        """Admit several requests in one device call: ``pairs`` is a list of
        ``(slot, req)``.  Returns ``(state, ingested_list)``.  Default:
        sequential :meth:`admit` calls (no packing win, same semantics)."""
        ingested = []
        for slot, req in pairs:
            state, n = self.admit(params, state, feed, slot, req, degree)
            ingested.append(n)
        return state, ingested

    def admit_chunk(self, params, state, feed, slot: int, req, degree):
        """Advance one chunk of ``req``'s admission into ``slot`` (progress
        carried in ``req.cursor``).  Returns ``(state, ingested)``."""
        raise NotImplementedError(f"{type(self).__name__} cannot chunk")

    def admit_complete(self, req) -> bool:
        """Whether ``req``'s payload is fully ingested — a slot only joins
        the fused step's batch once this holds."""
        return True

    def wants_chunked(self, req) -> bool:
        """Whether this request should admit via :meth:`admit_chunk`."""
        return False

    def admit_calls(self, req) -> int:
        """Device calls needed to admit ``req``."""
        return 1

    def warmup_admission(self, params, state, feed, degree) -> None:
        """Run every admission call shape (bucket ladder, chunk size) once
        with dummy rows, so no request meets a new shape after startup.
        Must leave ``state``/``feed`` as they were.  Default: nothing."""

    def step(self, params, state, feed, active, generator, degree):
        """ONE fused step over all slots: (emission (slots,), new_state);
        free slots are masked so their state never advances."""
        raise NotImplementedError

    def guarded_step(self, params, state, feed, active, generator, degree, fault):
        """Fault-aware twin of :meth:`step` (``repro_torch.resil``): the same
        contract plus a per-slot ``fault`` operand — a (slots,) float32
        tensor, 0.0 = clean, NaN/Inf = corrupt that slot's activations via
        ``dispatch.inject_fault`` — and a third output, the per-slot ``ok``
        bools of ``resil.guards.slot_ok`` against :attr:`guard_limit`.  The
        engine never banks an emission whose ok bit is False; it quarantines
        the slot.  This default injects into and guards the emission;
        workloads may place both inside the pipeline (the LM adapter guards
        the logits before sampling).  No host read: it is captured."""
        emission, new_state = self.step(params, state, feed, active, generator,
                                        degree)
        emission = kdispatch.inject_fault(emission, fault)
        return emission, new_state, guards.slot_ok(emission, limit=self.guard_limit)

    def harvest(self, req, feed, slot: int, emission):
        """Bank one slot's emission; returns (emitted, finished, info)."""
        raise NotImplementedError

    def done_args(self, req, info: dict) -> dict:
        """Trace args for the request_done event (workload vocabulary)."""
        return {self.unit: len(req.out), **info}

    # ---- quality / calibration hooks ---------------------------------

    def quality_tap(self, *, every: int, registry, tracer):
        """Build the live-vs-exact quality sampler (obs/quality.py) for
        ``quality_every=N``; workloads without one raise."""
        raise NotImplementedError(
            f"{type(self).__name__} has no quality tap")

    def exact_model(self):
        """An exact-arithmetic twin for calibration references
        (tune.autotune probes); self if ``degree=None`` already means exact."""
        return self
