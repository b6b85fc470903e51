"""One CUDA graph per call shape: the port's counterpart of the reference's
``jax.jit`` of each serving entry point (``serve/engine.py`` jits the
fused step, ``serve/lm.py`` the bucketed prefill and the prefill chunk).

A :class:`GraphSet` belongs to one engine.  :meth:`GraphSet.capture` runs a
callable eagerly once on a side stream (the warm-up: libraries load, lazy
device constants and launch plans are made outside any capture), then
captures it against static input buffers; :meth:`GraphSet.run` stages host
arrays into those buffers through pinned memory (non-blocking copies on
the stream) and replays the graph.  Every graph of a set allocates from one
memory pool: only one replays at a time, so their intermediates can share
it.  A capture that fails raises with the call shape in the message; there
is no eager fallback.

Launch bookkeeping: the kernel wrappers count their launches in Python
(``kernels/_build.py``), which a replay never runs.  At capture the set
records the rise of ``launches``, ``flash_schedules`` and
``plain_cuda_calls`` over the capture, puts the counters back (a capture
executes nothing), and adds that rise on every replay, so the counts read
as if each replay had launched its kernels from Python.  Each graph also
keeps its capture time and how far its capture grew the shared pool.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import _build


def _counters() -> tuple:
    return (_build.launches, _build.flash_schedules, _build.plain_cuda_calls)


def _snapshot() -> list:
    return [dict(d) for d in _counters()]


@dataclass
class Captured:
    """One captured call shape: its graph, static inputs (device) with
    their pinned host staging and the event of the last copy out of it, the
    callable's output (static), the counter
    rise of one replay, the capture's seconds and how far it grew the
    pool (bytes)."""

    graph: object
    inputs: dict
    staging: dict
    event: object
    out: object
    delta: list
    capture_s: float
    pool_bytes: int
    replays: int = 0


class GraphSet:
    """The CUDA graphs of one engine, keyed by call shape, in one pool.

    ``generators`` are registered with every graph (a sampling step draws
    from the engine's generator; each replay advances its offset)."""

    def __init__(self, device, generators=()):
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.graphs: dict = {}
        self._pool = None
        self._stream = None

    # ---- the device side (a test replaces these with stubs) -------------

    def _new_pool(self):
        return torch.cuda.graph_pool_handle()

    def _side_stream(self):
        return torch.cuda.Stream(self.device)

    def _pinned(self, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _event(self):
        return torch.cuda.Event()

    def pool_bytes(self) -> int:
        """Device bytes the caching allocator holds in this set's pool (its
        segments, free blocks included)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _warm(self, fn: Callable, inputs: dict) -> None:
        """Run ``fn`` eagerly once on the side stream (the standard warm-up
        before a capture)."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            fn(**inputs)
        cur.wait_stream(self._stream)

    def _capture(self, fn: Callable, inputs: dict):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = fn(**inputs)
        return graph, out

    # ---- capture and replay --------------------------------------------

    def __contains__(self, key) -> bool:
        return key in self.graphs

    def capture(self, key, fn: Callable, inputs: dict, warm_fn: Optional[Callable] = None):
        """Warm ``warm_fn`` (default ``fn``) up eagerly, then capture ``fn``
        on the static ``inputs`` (device tensors, keyword arguments of
        ``fn``, holding values the warm-up may run on).  Returns the
        :class:`Captured`."""
        if key in self.graphs:
            raise ValueError(f"call shape {key!r} is already captured")
        if self._pool is None:
            self._pool = self._new_pool()
            self._stream = self._side_stream()
        try:
            self._warm(warm_fn or fn, inputs)
            before = _snapshot()
            pool = self.pool_bytes()
            t = time.perf_counter()
            graph, out = self._capture(fn, inputs)
            capture_s = time.perf_counter() - t
            pool_bytes = self.pool_bytes() - pool
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of call shape {key!r} failed: "
                               f"{type(e).__name__}: {e}") from e
        delta = []
        for d, b in zip(_counters(), before):
            delta.append({k: d[k] - b[k] for k in d if d[k] != b[k]})
            d.update(b)                    # the capture launched nothing
        staging = {k: self._pinned(v) for k, v in inputs.items()}
        c = Captured(graph, inputs, staging, self._event(), out, delta, capture_s,
                     pool_bytes)
        self.graphs[key] = c
        return c

    def stage(self, key, host: dict) -> Captured:
        """Copy host arrays into the static inputs of ``key`` through its
        pinned buffers, non-blocking, ordered on the current stream.  The
        host waits only for this key's previous copy out of those buffers."""
        c = self.graphs[key]
        c.event.synchronize()
        for name, arr in host.items():
            pin = c.staging[name]
            pin.numpy()[...] = arr
            c.inputs[name].copy_(pin, non_blocking=True)
        c.event.record()
        return c

    def replay(self, key):
        """Replay ``key``'s graph; the launch counters rise as its capture
        recorded.  Returns the static output."""
        c = self.graphs[key]
        c.graph.replay()
        c.replays += 1
        for d, inc in zip(_counters(), c.delta):
            for k, n in inc.items():
                d[k] += n
        return c.out

    def run(self, key, host: dict):
        """:meth:`stage` then :meth:`replay`."""
        self.stage(key, host)
        return self.replay(key)

    # ---- reporting -----------------------------------------------------

    def summary(self) -> dict:
        """Per call shape: capture seconds, the pool's growth, replays and
        the launches of one replay; the total capture seconds and the
        pool's bytes now."""
        shapes = {repr(k): {"capture_s": c.capture_s, "pool_bytes": c.pool_bytes,
                            "replays": c.replays, "launches": dict(c.delta[0])}
                  for k, c in self.graphs.items()}
        return {"graphs": len(self.graphs),
                "capture_s": sum(c.capture_s for c in self.graphs.values()),
                "pool_bytes": self.pool_bytes(), "shapes": shapes}


def device_inputs(host: dict, device) -> dict:
    """Device tensors of host arrays (the eager path's pageable copies)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
