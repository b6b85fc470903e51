"""LM workload adapter: token decode on the generic serve core.

Sampling (greedy / top-k / temperature), EOS stopping, the prompt-prefix
fused prefill and KV-cache init/reset live in :class:`LMAdapter`;
:class:`ServeEngine` is the LM engine surface (``submit(prompt,
max_new_tokens)``, ``cache``, ``eos_id``) over
:class:`~repro_torch.serve.engine.ServeCore`.  Admission is exact-length:
one fused prefill per request.

  eos_id semantics: ``-1`` (the default) disables EOS stopping.  When set,
  sampling ``eos_id`` finishes the request; the EOS token itself is neither
  emitted into ``out_tokens`` nor charged against ``max_new_tokens``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.cache_ops import cache_mask_update
from repro_torch.models.registry import Model
from repro_torch.serve import engine as _engine
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
    token units, fused-prefill admission, sample-and-feed-back decode."""

    unit = "tokens"
    admit_span = "prefill"
    step_span = "decode"
    request_cls = Request

    def __init__(self, model: Model, *, tp: int = 1, eos_id: int = -1,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, max_len: int = 512):
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
            _, cache = self.model.prefill(params, cache, toks, slot, tp=self.tp,
                                          degree=degree)
            ingested = int(prompt.size) - 1
        else:
            cache = self.model.reset_slot(cache, slot)
            ingested = 0
        feed[slot, 0] = int(prompt[-1])
        return cache, ingested

    def step(self, params, cache, feed, active, generator, degree):
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


class ServeEngine(_engine.ServeCore):
    """The LM serving engine: ``ServeCore`` with an :class:`LMAdapter`.
    Runs on the model's device (``build_model(..., device=...)``)."""

    def __init__(self, model: Model, params, *, slots: int = 8,
                 max_len: int = 512, eos_id: int = -1, tp: int = 1,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, qos=None, degree=None,
                 prepack: bool = True):
        workload = LMAdapter(model, tp=tp, eos_id=eos_id, greedy=greedy,
                             temperature=temperature, top_k=top_k,
                             max_len=max_len)
        super().__init__(workload, params, slots=slots, max_len=max_len,
                         seed=seed, qos=qos, degree=degree, prepack=prepack)
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
