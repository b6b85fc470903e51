"""Deterministic, seeded fault injection for the serve engine.

Fault model: the dissertation's deployment target is space-grade FPGAs,
where radiation-induced single-event upsets (SEUs) flip bits in
configuration and user memory; the standard mitigations are memory
scrubbing and architectural masking.  The software-visible end of that
spectrum, against the serving stack:

  * ``seu_state``  — flip one bit inside one slot's region of one decode
    state field (KV cache, stream tail) via
    :func:`repro_torch.models.cache_ops.cache_bit_flip`;
  * ``seu_param``  — flip one bit of one weight leaf (persistent until the
    engine scrubs it from its golden copy);
  * ``nan``        — corrupt one slot's activations with NaN/Inf inside the
    fused step, through the ``fault`` operand consumed by
    ``dispatch.inject_fault``;
  * ``spike``      — a latency spike in the engine loop (the engine stalls
    its clock);
  * ``drop``       — a dropped tick: the fused step is skipped outright (no
    state advance, no emissions, no budget charged);
  * ``replica_loss`` — a whole serving replica dies (fleet level: a
    :class:`~repro_torch.dist.fleet.FleetSupervisor` binds its plan with
    ``bind_fleet`` and consumes the draws; a single engine records the
    kind and ignores it).

Flips land in place, in the tensors the engine's CUDA graphs read by
address, so the next replay computes on the corrupted bits.

Determinism contract: :meth:`FaultPlan.events_at` derives every draw from
``np.random.default_rng((seed, tick))`` — stateless per tick, so the same
seed yields the same injected-fault sequence however many ticks run, in
whatever order engines are built.  The draws are the reference's, in its
order, and parameter leaves are numbered in the reference's flatten order
(:func:`tree_leaves`), so one seed hits the same leaf, element and bit in
both packages.  SEU bit choice is biased to the high-order magnitude bit
(``seu_bit=-2``: the top exponent bit of a float, bit 30 of an int32);
``seu_bit="uniform"`` draws uniformly, sign bits included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.models import cache_ops
from repro_torch.tree import tree_leaves

#: spec-string aliases accepted by :meth:`FaultSpec.parse`
_ALIASES = {
    "seu": "seu_state", "seu_state": "seu_state", "state": "seu_state",
    "seu_param": "seu_param", "param": "seu_param",
    "nan": "nan", "inf": "nan",
    "spike": "spike", "latency": "spike",
    "drop": "drop", "drop_tick": "drop",
    "replica": "replica_loss", "replica_loss": "replica_loss",
}


@dataclass(frozen=True)
class FaultSpec:
    """Per-tick fault probabilities (independent Bernoulli draws per kind).

    ``spike_ms`` is the stall a latency spike adds; ``inf_ratio`` the share
    of activation faults injected as Inf instead of NaN; ``seu_bit`` the
    bit targeted by SEU flips (negative = from the top: -2 is the high
    magnitude bit; "uniform" draws uniformly)."""

    seu_state: float = 0.0
    seu_param: float = 0.0
    nan: float = 0.0
    spike: float = 0.0
    drop: float = 0.0
    #: whole-replica loss (fleet level; a single engine ignores the kind)
    replica_loss: float = 0.0
    spike_ms: float = 5.0
    inf_ratio: float = 0.5
    seu_bit: object = -2

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse a ``--faults`` flag string: ``"seu=0.05,nan=0.1,drop=0.01"``
        (aliases: seu/state -> seu_state, param -> seu_param, inf -> nan,
        latency -> spike, replica -> replica_loss).  ``spike_ms``,
        ``inf_ratio`` and ``seu_bit`` may ride along by their field names."""
        kw = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            key, _, val = part.partition("=")
            if not val:
                raise ValueError(f"bad --faults entry {part!r} (want k=v)")
            key = key.strip()
            if key in _ALIASES:
                kw[_ALIASES[key]] = float(val)
            elif key in ("spike_ms", "inf_ratio"):
                kw[key] = float(val)
            elif key == "seu_bit":
                kw[key] = val if val == "uniform" else int(val)
            else:
                raise ValueError(f"unknown fault kind {key!r} "
                                 f"(know: {sorted(set(_ALIASES))})")
        return cls(**kw)


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault.  ``kind`` is a FaultSpec rate name; the target
    fields that apply depend on the kind (slot/target/index/bit for state
    SEUs, leaf/target/index/bit for param SEUs, slot/value for activation
    faults, value = stall seconds for spikes)."""

    tick: int
    kind: str
    slot: Optional[int] = None
    target: Optional[str] = None   # state field name | param leaf path
    leaf: Optional[int] = None     # param leaf index (tree_leaves order)
    index: Optional[int] = None    # flat element offset within the region
    bit: Optional[int] = None
    value: Optional[float] = None  # NaN/Inf payload or spike seconds

    def args(self) -> dict:
        """Trace-event / recovery-log args (deterministic, JSON-safe)."""
        out = {"kind": self.kind}
        for k in ("slot", "target", "leaf", "index", "bit"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.value is not None:
            out["value"] = repr(float(self.value))
        return out


class FaultPlan:
    """Seeded fault schedule over engine ticks.

    Stochastic mode: a :class:`FaultSpec` and a seed; each tick's events
    come from a stateless per-tick RNG.  Scripted mode: explicit
    ``events`` for exact scenarios.  The engine calls :meth:`bind` once
    (the state fields' per-slot sizes and the parameter leaves' sizes, so
    draws can pick targets) and :meth:`events_at` per tick; every event
    applied lands in ``injected``."""

    def __init__(self, spec: Optional[FaultSpec] = None, *, seed: int = 0,
                 events: Optional[list] = None):
        if spec is None and events is None:
            raise ValueError("FaultPlan needs a FaultSpec or scripted events")
        self.spec = spec
        self.seed = int(seed)
        self._scripted = list(events) if events is not None else None
        self.injected: list[FaultEvent] = []
        self._fields: list[tuple[str, int, int]] = []   # (name, numel/slot, bits)
        self._leaves: list[tuple[str, int, int]] = []   # (path, numel, bits)
        self._slots = 0
        self._replicas = 0

    # -- binding ---------------------------------------------------------
    def bind(self, state, params, slots: int) -> "FaultPlan":
        """Capture the fault surface: the per-slot region size of every
        state field (``length`` excluded — the slot cursor is a control
        fault, not a memory fault) and every parameter leaf.  Reads only
        shapes and element sizes: nothing is copied off the card."""
        self._slots = int(slots)
        self._fields = []
        for name in state._fields:
            if name == "length":
                continue
            o = getattr(state, name)
            numel = int(np.prod(tuple(o.shape)) // o.shape[1])   # batch at axis 1
            self._fields.append((name, numel, 8 * o.element_size()))
        self._leaves = []
        for i, leaf in enumerate(tree_leaves(params)):
            numel = int(np.prod(tuple(leaf.shape)))
            if numel:
                self._leaves.append((str(i), numel, 8 * leaf.element_size()))
        return self

    def bind_fleet(self, replicas: int) -> "FaultPlan":
        """``replica_loss`` draws pick a victim in ``[0, replicas)``."""
        self._replicas = int(replicas)
        return self

    # -- schedule --------------------------------------------------------
    def _bit(self, rng, bits: int) -> int:
        sb = self.spec.seu_bit
        if sb == "uniform":
            return int(rng.integers(bits))
        return bits + sb if sb < 0 else min(sb, bits - 1)

    def events_at(self, tick: int) -> list[FaultEvent]:
        """The faults scheduled for ``tick`` (deterministic).  Draw order is
        fixed per kind, so the sequence depends only on (seed, tick, bound
        shapes)."""
        if self._scripted is not None:
            return [ev for ev in self._scripted if ev.tick == tick]
        sp = self.spec
        rng = np.random.default_rng((self.seed, tick))
        out: list[FaultEvent] = []
        if rng.random() < sp.seu_state and self._fields:
            name, numel, bits = self._fields[int(rng.integers(len(self._fields)))]
            out.append(FaultEvent(
                tick, "seu_state", slot=int(rng.integers(self._slots)),
                target=name, index=int(rng.integers(numel)),
                bit=self._bit(rng, bits)))
        if rng.random() < sp.seu_param and self._leaves:
            li = int(rng.integers(len(self._leaves)))
            path, numel, bits = self._leaves[li]
            out.append(FaultEvent(
                tick, "seu_param", leaf=li, target=path,
                index=int(rng.integers(numel)), bit=self._bit(rng, bits)))
        if rng.random() < sp.nan:
            val = np.inf if rng.random() < sp.inf_ratio else np.nan
            out.append(FaultEvent(tick, "nan",
                                  slot=int(rng.integers(self._slots)),
                                  value=float(val)))
        if rng.random() < sp.spike:
            out.append(FaultEvent(tick, "spike", value=sp.spike_ms / 1e3))
        if rng.random() < sp.drop:
            out.append(FaultEvent(tick, "drop"))
        # replica_loss draws only when its rate is nonzero, so plans without
        # the kind keep their RNG sequences
        if sp.replica_loss and rng.random() < sp.replica_loss \
                and self._replicas:
            out.append(FaultEvent(
                tick, "replica_loss", target="replica",
                slot=int(rng.integers(self._replicas))))
        return out

    # -- application (in place: the graphs read these tensors) ----------
    def apply_state(self, state, ev: FaultEvent):
        """Flip the state bit ``ev`` names, in place; returns the state."""
        return cache_ops.cache_bit_flip(state, ev.target, ev.slot,
                                        ev.index, ev.bit)

    def apply_params(self, params, ev: FaultEvent):
        """Flip the parameter bit ``ev`` names, in place; returns the tree.
        The engine's golden clone is a separate copy, and the engine marks
        the leaf for its next scrub."""
        cache_ops.bit_flip(tree_leaves(params)[ev.leaf], ev.index, ev.bit)
        return params

    def record(self, ev: FaultEvent) -> FaultEvent:
        self.injected.append(ev)
        return ev
