"""LM workload adapter: token decode on the generic serve core.

Sampling (greedy / top-k / temperature), EOS stopping, prompt admission,
KV-cache init/reset and the logit-RMS quality tap live in :class:`LMAdapter`; :class:`ServeEngine` is the
LM engine surface (``submit(prompt, max_new_tokens)``, ``cache``,
``eos_id``) over :class:`~repro_torch.serve.engine.ServeCore`.

Admission is exact-length (one fused prefill per request) unless an
:class:`~repro_torch.serve.admission.AdmissionConfig` is given (and the
model is no MoE, whose admission stays exact-length): then short
prompts pack into bucketed prefill calls padded to a fixed ladder of
lengths, and long ones (bf16/f32 cache) admit in chunks across ticks.
``trace_counts`` counts the distinct call shapes each entry point has seen
(``prefill``, ``prefill_batch``, ``prefill_chunk``, ``step``) — what a
compiled reference would compile once each — so tests can pin admission to
the bucket ladder.

Under a capturing engine (``ServeCore(capture=...)``, the default on a
CUDA device) each bucket's prefill, the prefill chunk and the step are
replays of one CUDA graph per call shape (``serve/graphs.py``), captured
at warmup (or at a shape's first use without warmup): their tokens, slots,
lengths, offset and chunk length are staged through pinned host buffers
into the graph's static inputs, and the write plans run on the device.
Exact-length admission (:meth:`LMAdapter.admit`) stays eager: its call
shape is the prompt's length, unbounded, and the reference too compiles
one program per new length at first use — a shape seen once gains nothing
from a capture.

  eos_id semantics: ``-1`` (the default) disables EOS stopping.  When set,
  sampling ``eos_id`` finishes the request; the EOS token itself is neither
  emitted into ``out_tokens`` nor charged against ``max_new_tokens``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models.cache_ops import cache_mask_update, cache_reset_slot
from repro_torch.models.layers import gather_vocab
from repro_torch.models.registry import Model
from repro_torch.models.transformer import attn_window
from repro_torch.resil import guards
from repro_torch.serve import engine as _engine
from repro_torch.serve.admission import AdmissionConfig, bucket_for
from repro_torch.serve.graphs import device_inputs
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.servable import ServableModel


class Request(_engine.Request):
    """Generic request with the LM field names as read-only views."""

    @property
    def prompt(self) -> np.ndarray:
        return self.payload

    @property
    def max_new_tokens(self) -> int:
        return self.budget

    @property
    def out_tokens(self) -> list:
        return self.out

    @property
    def prefill_tokens(self) -> int:
        return self.admitted_units

    @property
    def t_first_token(self) -> float:
        return self.t_first_emit

    @property
    def degree_at_first_token(self) -> Optional[tuple]:
        return self.degree_at_first_emit


class LMAdapter(ServableModel):
    """ServableModel over a :class:`~repro_torch.models.registry.Model`:
    token units, fused-prefill (or bucketed/packed/chunked) admission,
    sample-and-feed-back decode."""

    unit = "tokens"
    admit_span = "prefill"
    step_span = "decode"
    payload_arg = "prompt_tokens"
    budget_arg = "max_new_tokens"
    first_event = "first_token"
    admit_site = "prefill"
    step_sites = ("decode",)
    request_cls = Request
    #: clean logits sit well under this; a high-exponent SEU or a NaN/Inf
    #: injection blows past it (resil.guards)
    guard_limit = 1e4

    def __init__(self, model: Model, *, tp: int = 1, eos_id: int = -1,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, max_len: int = 512,
                 admission: Optional[AdmissionConfig] = None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.tp = tp
        self.eos_id = eos_id
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        cfg = self.cfg
        # the prompt bound: the SSM ingests unbounded prompts into its fixed
        # state; a window cache (the hybrid's local window, a sliding-window
        # arch's) ring-wraps only while window <= max_len; dense attention is
        # bounded by the cache capacity
        window = attn_window(cfg)
        if cfg.family == "ssm" or (window is not None and window <= max_len):
            self._max_prompt = None
        else:
            self._max_prompt = max_len
        #: distinct call shapes seen per entry point
        self.trace_counts = {"prefill": 0, "prefill_batch": 0,
                             "prefill_chunk": 0, "step": 0}
        self._shapes: dict = {name: set() for name in self.trace_counts}
        self.admission = admission.resolved(max_len) if admission else None
        if self.admission is not None and self.cfg.moe:
            # MoE capacity routing couples the rows of one call (the
            # per-expert capacity counts them all), so a bucketed or packed
            # prefill would not equal sequential admission: MoE keeps the
            # exact-length path, as the reference does
            self.admission = None
        # chunked prefill serves the bf16/f32 cache only (REPRO_KV_INT8 picks
        # the int8 cache at init_state)
        self._chunk_ok = (self.admission is not None
                          and self.admission.chunk_tokens > 0
                          and model.supports_chunked_prefill()
                          and os.environ.get("REPRO_KV_INT8", "0") != "1")
        #: bucket length of the last bucketed prefill call
        self.last_admit_bucket: Optional[int] = None
        #: the capturing engine's :class:`~repro_torch.serve.graphs.GraphSet`
        #: (None: every call runs eagerly)
        self.graphs = None

    def _note(self, name: str, shape) -> None:
        if shape not in self._shapes[name]:
            self._shapes[name].add(shape)
            self.trace_counts[name] += 1

    def prepack(self, params):
        return self.model.prepack(params)

    def init_state(self, *, batch: int, max_len: int):
        return self.model.init_cache(tp=self.tp, batch=batch, max_len=max_len)

    def init_feed(self, slots: int):
        return np.zeros((slots, 1), np.int64)

    def reset_slot(self, state, slot):
        return self.model.reset_slot(state, slot)

    def validate(self, prompt):
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if self._max_prompt is not None and prompt.size > self._max_prompt:
            raise ValueError(
                f"prompt length {prompt.size} exceeds cache capacity "
                f"{self._max_prompt} (max_len)")
        return prompt

    def payload_units(self, prompt) -> int:
        return int(prompt.size)

    def default_budget(self, prompt) -> int:
        return 32

    def admit(self, params, cache, feed, slot, req, degree):
        """Ingest the prompt prefix with one fused prefill call; the final
        prompt token rides the next fused decode step (it produces the
        first generated token).  Always eager, also under a capturing
        engine: the call shape is the prompt's length (module docstring)."""
        prompt = req.payload
        if prompt.size > 1:
            toks = torch.from_numpy(prompt[:-1]).to(self.device)
            self._note("prefill", tuple(toks.shape))
            _, cache = self.model.prefill(params, cache, toks, slot, tp=self.tp,
                                          degree=degree)
            ingested = int(prompt.size) - 1
        else:
            cache = self.model.reset_slot(cache, slot)
            ingested = 0
        feed[slot, 0] = int(prompt[-1])
        req.cursor = ingested
        return cache, ingested

    # ---- bucketed / packed / chunked admission ------------------------

    def _call(self, key, fn, host: dict, dummy: dict, run: bool = True) -> None:
        """One call of the capture-ready ``fn`` (keyword device inputs) at
        call shape ``key``: eagerly on ``host`` copied to the device, or —
        under a capturing engine — as a replay of ``key``'s graph with
        ``host`` staged into its static inputs, the graph captured first
        (on the ``dummy`` inputs, which write nothing) if ``key`` is new.
        ``run=False`` only captures (warmup)."""
        g = self.graphs
        if g is None:
            if run:
                fn(**device_inputs(host, self.device))
            return
        if key not in g:
            g.capture(key, fn, device_inputs(dummy, self.device))
        if run:
            g.run(key, host)

    def _batch_inputs(self, pack: int, Pb: int, B: int) -> dict:
        """A bucketed call's inputs, every row a dummy (slot B, length 0)."""
        return {"tokens": np.zeros((pack, Pb), np.int64),
                "slots": np.full((pack,), B, np.int64),
                "lengths": np.zeros((pack,), np.int64)}

    def _chunk_inputs(self, C: int, slot: int) -> dict:
        """A chunk call's inputs into ``slot`` at offset 0, no real token
        (for the dummy slot B, a call that writes nothing)."""
        return {"tokens": np.zeros((C,), np.int64), "slot": np.asarray(slot, np.int64),
                "offset": np.asarray(0, np.int64), "clen": np.asarray(0, np.int64)}

    def _prefill_batch(self, params, cache, host: dict, degree, run: bool = True):
        """One bucketed prefill call on ``host`` (:meth:`_batch_inputs`)."""
        pack, Pb = host["tokens"].shape

        def fn(tokens, slots, lengths):
            self._note("prefill_batch", tuple(tokens.shape))
            self.model.prefill_batch(params, cache, tokens, slots, lengths,
                                     tp=self.tp, degree=degree)

        self._call(("prefill_batch", (pack, Pb)), fn, host,
                   self._batch_inputs(pack, Pb, cache.length.shape[0]), run)

    def _prefill_chunk(self, params, cache, host: dict, degree, run: bool = True):
        """One chunk call on ``host`` (:meth:`_chunk_inputs`); a prompt's
        first chunk (offset 0) rewinds its slot inside the call."""
        C = host["tokens"].shape[0]
        B = cache.length.shape[0]

        def fn(tokens, slot, offset, clen):
            self._note("prefill_chunk", tuple(tokens.shape))
            live = (slot >= 0) & (slot < B)
            cache_reset_slot(cache, torch.clamp(slot, 0, B - 1), mask=live & (offset == 0))
            self.model.prefill_chunk(params, cache, tokens, slot, offset, clen,
                                     tp=self.tp, degree=degree)

        self._call(("prefill_chunk", (C,)), fn, host, self._chunk_inputs(C, B), run)

    def admit_batch(self, params, cache, feed, pairs, degree):
        """Pack up to ``admission.pack`` prompt prefixes into ONE bucketed
        prefill call.  Calls are padded to exactly ``pack`` rows with
        dummies (slot = B, which writes nothing), so each bucket has one
        call shape.  Prefixes longer than the largest bucket take the
        exact-length path."""
        a = self.admission
        if a is None:
            return super().admit_batch(params, cache, feed, pairs, degree)
        B = feed.shape[0]
        ingested = {}
        bucketed = []
        self.last_admit_bucket = None        # set only by a bucketed call
        for slot, req in pairs:
            n = req.payload_units - 1
            if n > a.buckets[-1]:
                cache, ingested[id(req)] = self.admit(params, cache, feed,
                                                      slot, req, degree)
            else:
                bucketed.append((slot, req))
        for i in range(0, len(bucketed), a.pack):
            group = bucketed[i:i + a.pack]
            lens = [r.payload_units - 1 for _, r in group]
            Pb = bucket_for(max(lens + [1]), a.buckets)
            host = self._batch_inputs(a.pack, Pb, B)
            for row, ((slot, req), n) in enumerate(zip(group, lens)):
                host["tokens"][row, :n] = req.payload[:-1]
                host["slots"][row] = slot
                host["lengths"][row] = n
                feed[slot, 0] = int(req.payload[-1])
                req.cursor = n
                ingested[id(req)] = n
            self._prefill_batch(params, cache, host, degree)
            self.last_admit_bucket = Pb
        return cache, [ingested[id(r)] for _, r in pairs]

    def admit_chunk(self, params, cache, feed, slot, req, degree):
        """Advance one ``chunk_tokens`` chunk of ``req``'s prompt prefix;
        ``req.cursor`` carries progress.  The final prompt token rides the
        decode feed once the prefix lands."""
        C = self.admission.chunk_tokens
        prompt = req.payload
        target = prompt.size - 1
        take = min(C, target - req.cursor)
        host = self._chunk_inputs(C, slot)
        host["tokens"][:take] = prompt[req.cursor:req.cursor + take]
        host["offset"][...] = req.cursor
        host["clen"][...] = take
        self._prefill_chunk(params, cache, host, degree)
        req.cursor += take
        if req.cursor >= target:
            feed[slot, 0] = int(prompt[-1])
        return cache, take

    def admit_complete(self, req) -> bool:
        if self.admission is None:
            return True
        return req.cursor >= max(req.payload_units - 1, 0)

    def wants_chunked(self, req) -> bool:
        return (self._chunk_ok
                and req.payload_units - 1 > self.admission.chunk_tokens)

    def admit_calls(self, req) -> int:
        n = req.payload_units - 1
        if self.admission is not None and self.wants_chunked(req):
            return -(-n // self.admission.chunk_tokens)
        return 1

    def warmup_admission(self, params, cache, feed, degree) -> None:
        """Run one call per bucket shape (and the chunk shape) with all-dummy
        rows: slot = B writes nothing, so the live cache is untouched.  Under
        a capturing engine each shape's graph is captured instead (its
        eager warm-up runs the dummy call once)."""
        a = self.admission
        if a is None:
            return
        B = feed.shape[0]
        run = self.graphs is None
        for Pb in a.buckets:
            self._prefill_batch(params, cache, self._batch_inputs(a.pack, Pb, B),
                                degree, run)
        if self._chunk_ok:
            self._prefill_chunk(params, cache, self._chunk_inputs(a.chunk_tokens, B),
                                degree, run)

    def _logits(self, params, cache, feed, active, degree):
        """The fused decode: one token a slot, the cache advanced in place
        (free slots' lengths frozen); returns the last position's (slots,
        vocab) logits — whole rows, gathered over the ``model`` group on a
        mesh — and the cache."""
        self._note("step", (tuple(feed.shape),
                            None if degree is None else tuple(getattr(degree, "shape", ()))))
        logits, new_cache = self.model.decode_step(params, cache, feed,
                                                   tp=self.tp, degree=degree,
                                                   active=active)
        cache = cache_mask_update(cache, new_cache, active, into=cache)
        return gather_vocab(logits)[:, 0, :self.cfg.vocab], cache

    def _sample(self, logits, generator):
        return sample_tokens(logits, generator, greedy=self.greedy,
                             temperature=self.temperature, top_k=self.top_k)

    def step(self, params, cache, feed, active, generator, degree):
        """The fused decode step, the next tokens sampled on the device.
        Reads nothing on the host: a capturing engine replays it from a
        CUDA graph."""
        logits, cache = self._logits(params, cache, feed, active, degree)
        return self._sample(logits, generator), cache

    def guarded_step(self, params, cache, feed, active, generator, degree, fault):
        """:meth:`step` with the fault injected into, and the guard run on,
        the logits before sampling — where corruption is still observable
        (sampling collapses a poisoned distribution to a plausible token).
        Sampling stays defined on a quarantined slot: its non-finite logits
        are zeroed (the token is discarded).  Returns (tokens, cache, ok)."""
        logits, cache = self._logits(params, cache, feed, active, degree)
        lv = kdispatch.inject_fault(logits, fault)
        ok = guards.slot_ok(lv, limit=self.guard_limit)
        safe = torch.where(torch.isfinite(lv), lv, torch.zeros_like(lv))
        return self._sample(safe, generator), cache, ok

    def harvest(self, req, feed, slot, emission):
        tok = int(emission)
        if self.eos_id >= 0 and tok == self.eos_id:
            return False, True, {"eos": True}
        req.out.append(tok)
        feed[slot, 0] = tok
        return True, False, {"eos": False}

    def done_args(self, req, info) -> dict:
        return {"eos": bool(info.get("eos", False)), "tokens": len(req.out)}

    # ---- quality ------------------------------------------------------

    def quality_tap(self, *, every, registry, tracer):
        """The logit-RMS tap: live-degree vs exact-rung decode logits on the
        tick's inputs, the cache rows it writes restored (obs/quality.py)."""
        from repro_torch.obs.quality import QualityTap

        return QualityTap(self.model, tp=self.tp, every=every,
                          registry=registry, tracer=tracer)


class ServeEngine(_engine.ServeCore):
    """The LM serving engine: ``ServeCore`` with an :class:`LMAdapter`.
    Runs on the model's device (``build_model(..., device=...)``), from
    CUDA graphs there unless ``capture=False`` (``ServeCore``)."""

    def __init__(self, model: Model, params, *, slots: int = 8,
                 max_len: int = 512, eos_id: int = -1, tp: int = 1,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, qos=None, degree=None,
                 prepack: bool = True, plan=None, registry=None,
                 tracer=None, quality_every: int = 0,
                 admission: Optional[AdmissionConfig] = None, emitter=None,
                 capture: Optional[bool] = None, **resil_kw):
        workload = LMAdapter(model, tp=tp, eos_id=eos_id, greedy=greedy,
                             temperature=temperature, top_k=top_k,
                             max_len=max_len, admission=admission)
        super().__init__(workload, params, slots=slots, max_len=max_len,
                         seed=seed, qos=qos, degree=degree, prepack=prepack,
                         plan=plan, registry=registry, tracer=tracer,
                         quality_every=quality_every, emitter=emitter,
                         capture=capture, **resil_kw)
        self.model = model
        self.eos_id = eos_id
        self.tp = tp

    @property
    def cache(self):
        return self.state

    @cache.setter
    def cache(self, value):
        self.state = value

    def submit(self, prompt, max_new_tokens: int = 32, **kw) -> Request:
        """Enqueue one request (FIFO).  Returns the live Request — tokens
        appear in ``request.out_tokens`` as ticks generate them.  ``kw``:
        ``deadline_ms`` / ``ttft_deadline_ms`` (``ServeCore.submit``)."""
        return super().submit(prompt, max_new_tokens, **kw)
