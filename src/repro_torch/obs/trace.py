"""Process-global structured tracing with Chrome ``trace_event`` export (the
port of ``repro.obs.trace``: the same events, names and file format).

The runtime-adjustable approximation scheme is only trustworthy if the
system can *show* which degree served which request and what it cost
(DESIGN.md §11).  This tracer is the zero-dependency substrate: bounded
ring buffers of span / instant / counter events, nestable via context
manager, exportable as Chrome ``trace_event`` JSON — the file loads
directly in ``chrome://tracing`` / Perfetto.

Contract:

  * **disabled is free** — the global tracer starts disabled; ``span()``
    returns a shared no-op context manager and ``event()`` returns
    immediately, so instrumented hot paths (the serve tick, the train
    step) pay one predicate per call site.
  * **bounded** — events land in a ``deque(maxlen=capacity)``; overflow
    evicts the oldest and increments ``dropped`` (long-lived engines never
    leak).
  * **tracks** — every event carries a ``track`` (engine / train / a
    request id); tracks become Chrome thread lanes with ``thread_name``
    metadata so the viewer groups the timeline sensibly.

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("prefill", rid=3, tokens=17):
        ...
    trace.event("qos_rung", degrees=[8, 7, 6])
    trace.get_tracer().write("trace.json")      # open in chrome://tracing
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["Tracer", "get_tracer", "set_tracer", "enable", "disable",
           "span", "event", "counter"]


class _NullSpan:
    """Shared no-op context manager handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a Chrome complete event ('X') on exit."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._emit({
            "name": self._name, "ph": "X", "ts": self._tracer._us(self._t0),
            "dur": round((t1 - self._t0) * 1e6, 3),
            "pid": self._tracer.pid, "tid": self._tracer._tid(self._track),
            "cat": "repro", "args": self._args,
        })
        return False


class Tracer:
    """Bounded ring buffer of Chrome ``trace_event`` dicts.

    ``enabled`` gates every recording call; flip it with
    :meth:`enable` / :meth:`disable` (also settable at construction).  The
    buffer holds at most ``capacity`` events — old events are evicted and
    counted in :attr:`dropped`.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        self.dropped = 0
        self._events: deque = deque(maxlen=self.capacity)
        self._tracks: dict = {}          # track name -> tid int
        self._meta: list = []            # thread_name metadata events
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # ---- control -----------------------------------------------------

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # ---- recording ---------------------------------------------------

    def _us(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 3)

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                # checked again under the lock: a track first seen by two
                # threads at once gets one tid and one metadata event
                tid = self._tracks.get(track)
                if tid is None:
                    tid = self._tracks[track] = len(self._tracks) + 1
                    self._meta.append({
                        "name": "thread_name", "ph": "M", "pid": self.pid,
                        "tid": tid, "args": {"name": track},
                    })
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, track: str = "main", **args):
        """Context manager timing a nested region; a no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, track, args)

    def event(self, name: str, track: str = "main", **args) -> None:
        """Instant event ('i') — a point-in-time marker with payload."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "i", "s": "t",
                    "ts": self._us(time.perf_counter()), "pid": self.pid,
                    "tid": self._tid(track), "cat": "repro", "args": args})

    def counter(self, name: str, track: str = "main", **values) -> None:
        """Counter event ('C') — plotted as a stacked series in the viewer."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C",
                    "ts": self._us(time.perf_counter()), "pid": self.pid,
                    "tid": self._tid(track), "args": values})

    # ---- export ------------------------------------------------------

    @property
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The ``chrome://tracing`` / Perfetto JSON object."""
        return {"traceEvents": self._meta + self.events,
                "displayTimeUnit": "ms",
                "otherData": {"tracer": "repro_torch.obs", "dropped": self.dropped}}

    def write(self, path) -> str:
        """Serialize to ``path``; returns the path written."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return str(path)


# ---------------------------------------------------------------------------
# process-global tracer (the one the engine / trainer / dispatch instrument)
# ---------------------------------------------------------------------------

_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Swap the process-global tracer (tests); None installs a fresh
    disabled one.  Returns the installed tracer."""
    global _GLOBAL
    _GLOBAL = tracer if tracer is not None else Tracer()
    return _GLOBAL


def enable(capacity: Optional[int] = None) -> Tracer:
    """Enable the global tracer (optionally resizing its ring buffer)."""
    global _GLOBAL
    if capacity is not None and capacity != _GLOBAL.capacity:
        _GLOBAL = Tracer(capacity=capacity)
    return _GLOBAL.enable()


def disable() -> Tracer:
    return _GLOBAL.disable()


def span(name: str, track: str = "main", **args):
    return _GLOBAL.span(name, track=track, **args)


def event(name: str, track: str = "main", **args) -> None:
    _GLOBAL.event(name, track=track, **args)


def counter(name: str, track: str = "main", **values) -> None:
    _GLOBAL.counter(name, track=track, **values)
