"""LM workload adapter: token decode on the generic serve core.

Sampling (greedy / top-k / temperature), EOS stopping, prompt admission,
KV-cache init/reset and the logit-RMS quality tap live in :class:`LMAdapter`; :class:`ServeEngine` is the
LM engine surface (``submit(prompt, max_new_tokens)``, ``cache``,
``eos_id``) over :class:`~repro_torch.serve.engine.ServeCore`.

Admission is exact-length (one fused prefill per request) unless an
:class:`~repro_torch.serve.admission.AdmissionConfig` is given: then short
prompts pack into bucketed prefill calls padded to a fixed ladder of
lengths, and long ones (bf16/f32 cache) admit in chunks across ticks.
``trace_counts`` counts the distinct call shapes each entry point has seen
(``prefill``, ``prefill_batch``, ``prefill_chunk``, ``step``) — what a
compiled reference would compile once each — so tests can pin admission to
the bucket ladder.

  eos_id semantics: ``-1`` (the default) disables EOS stopping.  When set,
  sampling ``eos_id`` finishes the request; the EOS token itself is neither
  emitted into ``out_tokens`` nor charged against ``max_new_tokens``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.models.cache_ops import cache_mask_update
from repro_torch.models.registry import Model
from repro_torch.serve import engine as _engine
from repro_torch.serve.admission import AdmissionConfig, bucket_for
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
        window = self.cfg.swa_window
        # dense attention is bounded by the cache capacity; a window cache
        # ring-wraps only while window <= max_len
        self._max_prompt = None if (window is not None and window <= max_len) \
            else max_len
        #: distinct call shapes seen per entry point
        self.trace_counts = {"prefill": 0, "prefill_batch": 0,
                             "prefill_chunk": 0, "step": 0}
        self._shapes: dict = {name: set() for name in self.trace_counts}
        self.admission = admission.resolved(max_len) if admission else None
        # chunked prefill serves the bf16/f32 cache only (REPRO_KV_INT8 picks
        # the int8 cache at init_state)
        self._chunk_ok = (self.admission is not None
                          and self.admission.chunk_tokens > 0
                          and model.supports_chunked_prefill()
                          and os.environ.get("REPRO_KV_INT8", "0") != "1")
        #: bucket length of the last bucketed prefill call
        self.last_admit_bucket: Optional[int] = None

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
        first generated token)."""
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

    def _prefill_batch(self, params, cache, toks: np.ndarray, slots, lengths,
                       degree):
        t = torch.from_numpy(toks).to(self.device)
        self._note("prefill_batch", tuple(t.shape))
        return self.model.prefill_batch(params, cache, t, slots, lengths,
                                        tp=self.tp, degree=degree)

    def _prefill_chunk(self, params, cache, toks: np.ndarray, slot: int,
                       offset: int, clen: int, degree):
        t = torch.from_numpy(toks).to(self.device)
        self._note("prefill_chunk", tuple(t.shape))
        return self.model.prefill_chunk(params, cache, t, slot, offset, clen,
                                        tp=self.tp, degree=degree)

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
            toks = np.zeros((a.pack, Pb), np.int64)
            slots = np.full((a.pack,), B, np.int64)
            lengths = np.zeros((a.pack,), np.int64)
            for row, ((slot, req), n) in enumerate(zip(group, lens)):
                toks[row, :n] = req.payload[:-1]
                slots[row] = slot
                lengths[row] = n
                feed[slot, 0] = int(req.payload[-1])
                req.cursor = n
                ingested[id(req)] = n
            cache = self._prefill_batch(params, cache, toks, slots, lengths,
                                        degree)
            self.last_admit_bucket = Pb
        return cache, [ingested[id(r)] for _, r in pairs]

    def admit_chunk(self, params, cache, feed, slot, req, degree):
        """Advance one ``chunk_tokens`` chunk of ``req``'s prompt prefix;
        ``req.cursor`` carries progress.  The final prompt token rides the
        decode feed once the prefix lands."""
        C = self.admission.chunk_tokens
        prompt = req.payload
        target = prompt.size - 1
        if req.cursor == 0:
            cache = self.model.reset_slot(cache, slot)
        take = min(C, target - req.cursor)
        toks = np.zeros((C,), np.int64)
        toks[:take] = prompt[req.cursor:req.cursor + take]
        cache = self._prefill_chunk(params, cache, toks, slot, req.cursor, take,
                                    degree)
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
        rows: slot = B writes nothing, so the live cache is untouched."""
        a = self.admission
        if a is None:
            return
        B = feed.shape[0]
        for Pb in a.buckets:
            self._prefill_batch(params, cache, np.zeros((a.pack, Pb), np.int64),
                                np.full((a.pack,), B, np.int64),
                                np.zeros((a.pack,), np.int64), degree)
        if self._chunk_ok:
            self._prefill_chunk(params, cache,
                                np.zeros((a.chunk_tokens,), np.int64), B, 0, 0,
                                degree)

    def step(self, params, cache, feed, active, generator, degree):
        self._note("step", (tuple(feed.shape),
                            None if degree is None else tuple(getattr(degree, "shape", ()))))
        logits, new_cache = self.model.decode_step(params, cache, feed,
                                                   tp=self.tp, degree=degree,
                                                   active=active)
        # free slots are masked out: length frozen
        new_cache = cache_mask_update(cache, new_cache, active)
        nxt = sample_tokens(logits[:, 0, :self.cfg.vocab], generator,
                            greedy=self.greedy, temperature=self.temperature,
                            top_k=self.top_k)
        return nxt, new_cache

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
    Runs on the model's device (``build_model(..., device=...)``)."""

    def __init__(self, model: Model, params, *, slots: int = 8,
                 max_len: int = 512, eos_id: int = -1, tp: int = 1,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, qos=None, degree=None,
                 prepack: bool = True, plan=None, registry=None,
                 tracer=None, quality_every: int = 0,
                 admission: Optional[AdmissionConfig] = None, emitter=None):
        workload = LMAdapter(model, tp=tp, eos_id=eos_id, greedy=greedy,
                             temperature=temperature, top_k=top_k,
                             max_len=max_len, admission=admission)
        super().__init__(workload, params, slots=slots, max_len=max_len,
                         seed=seed, qos=qos, degree=degree, prepack=prepack,
                         plan=plan, registry=registry, tracer=tracer,
                         quality_every=quality_every, emitter=emitter)
        self.model = model
        self.eos_id = eos_id
        self.tp = tp

    @property
    def cache(self):
        return self.state

    @cache.setter
    def cache(self, value):
        self.state = value

    def submit(self, prompt, max_new_tokens: int = 32) -> Request:
        """Enqueue one request (FIFO).  Returns the live Request — tokens
        appear in ``request.out_tokens`` as ticks generate them."""
        return super().submit(prompt, max_new_tokens)
