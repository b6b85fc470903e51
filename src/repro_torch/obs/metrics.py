"""Typed metric registry with a Prometheus text-format exporter (the port of
``repro.obs.metrics``: the same families give the same text).

One registry is the single source for every counter the stack maintains:
the serve engine's token/step counters and latency histograms
(``serve/metrics.py::EngineStats`` is a thin view over one of these),
per-backend kernel-route counters (``kernels/dispatch.py``), the
``repro_degree_ebits{site=..}`` gauge family and the online quality
telemetry (``obs/quality.py``).

Zero dependencies: the exporter emits the Prometheus text exposition
format (``# HELP`` / ``# TYPE`` + samples; histograms as cumulative
``_bucket{le=..}`` + ``_sum`` + ``_count``) and :func:`parse_text` parses
it back — the round-trip is under test, so ``--metrics-out`` artifacts
are guaranteed scrapeable.

  reg = Registry()
  c = reg.counter("repro_decode_steps_total", "engine ticks")
  c.inc()
  h = reg.histogram("repro_ttft_seconds", "enqueue->first token")
  h.observe(0.031)
  routes = reg.counter("repro_kernel_route_steps_total", "ticks by backend",
                       labels=("site", "backend"))
  routes.labels(site="decode", backend="cuda").inc()
  text = reg.to_prometheus()          # scrape / --metrics-out artifact
  snap = reg.snapshot()               # JSON-able dict
"""

from __future__ import annotations

import math
import re
import threading
from typing import Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "set_registry", "parse_text", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram bucket upper bounds (seconds-flavored, latency-friendly)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting: integers stay integral."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotone float counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0 (got {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable instantaneous value."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) that also keeps
    exact count/sum; ``observe`` is O(#buckets)."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self._counts = [0] * len(bs)      # per-bucket (non-cumulative)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list:
        """[(le, cumulative_count)] + implicit +Inf == count."""
        out, acc = [], 0
        for b, c in zip(self.buckets, self._counts):
            acc += c
            out.append((b, acc))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family; labelless families hold a single child
    (``.inc`` / ``.set`` / ``.observe`` proxy straight through), labelled
    families intern children per label-value tuple via :meth:`labels`."""

    def __init__(self, name: str, help_: str, kind: str,
                 labelnames: Sequence[str] = (), **kwargs):
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._children: dict = {}
        if not self.labelnames:
            self._children[()] = _KINDS[kind](**kwargs)

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children.setdefault(key, _KINDS[self.kind](**self._kwargs))
        return child

    @property
    def children(self) -> dict:
        return dict(self._children)

    # labelless convenience proxies
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled; use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0):
        self._solo().inc(n)

    def set(self, v: float):
        self._solo().set(v)

    def observe(self, v: float):
        self._solo().observe(v)

    @property
    def value(self) -> float:
        return self._solo().value

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum


class Registry:
    """Metric family registry.  Registration is idempotent: re-declaring a
    family with the same (kind, labelnames) returns the existing one, so
    module-level call sites (kernel dispatch) and object call sites (the
    engine) can share families without import-order coupling."""

    def __init__(self):
        self._families: dict = {}
        self._lock = threading.Lock()

    def _register(self, name: str, help_: str, kind: str,
                  labels: Sequence[str], **kwargs) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}")
                return fam
            fam = Family(name, help_, kind, labels, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._register(name, help_, "counter", labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._register(name, help_, "gauge", labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._register(name, help_, "histogram", labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    @property
    def families(self) -> dict:
        return dict(self._families)

    # ---- export ------------------------------------------------------

    @staticmethod
    def _labelstr(names: tuple, values: tuple, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in zip(names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (round-trips :func:`parse_text`)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                child = fam.children[key]
                if fam.kind == "histogram":
                    for le, acc in child.cumulative():
                        ls = self._labelstr(fam.labelnames, key,
                                            f'le="{_fmt(le)}"')
                        lines.append(f"{name}_bucket{ls} {acc}")
                    ls = self._labelstr(fam.labelnames, key, 'le="+Inf"')
                    lines.append(f"{name}_bucket{ls} {child.count}")
                    ls = self._labelstr(fam.labelnames, key)
                    lines.append(f"{name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{ls} {child.count}")
                else:
                    ls = self._labelstr(fam.labelnames, key)
                    lines.append(f"{name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able nested dict of every family/child (``--metrics-out``
        twin artifact; also the programmatic read API)."""
        out: dict = {}
        for name, fam in sorted(self._families.items()):
            children = {}
            for key, child in sorted(fam.children.items()):
                lk = ",".join(f"{k}={v}" for k, v in zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    children[lk] = {"count": child.count, "sum": child.sum,
                                    "buckets": {_fmt(le): acc for le, acc
                                                in child.cumulative()}}
                else:
                    children[lk] = child.value
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": children}
        return out

    def write(self, path) -> str:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return str(path)


# ---------------------------------------------------------------------------
# text-format parser (round-trip tests; tools that read --metrics-out)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_text(text: str) -> dict:
    """Parse Prometheus exposition text into
    ``{(name, ((label, value), ...)): float}`` — histogram series appear
    under their ``_bucket`` / ``_sum`` / ``_count`` sample names, exactly
    as a scraper sees them."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        labels = tuple(sorted(_LABEL_PAIR_RE.findall(m.group("labels") or "")))
        raw = m.group("value")
        val = math.inf if raw == "+Inf" else float(raw)
        out[(m.group("name"), labels)] = val
    return out


# ---------------------------------------------------------------------------
# process-global registry (kernel dispatch counters; launch exporters)
# ---------------------------------------------------------------------------

_GLOBAL = Registry()


def get_registry() -> Registry:
    return _GLOBAL


def set_registry(registry: Optional[Registry]) -> Registry:
    """Swap the process-global registry (tests); None installs a fresh one."""
    global _GLOBAL
    _GLOBAL = registry if registry is not None else Registry()
    return _GLOBAL
