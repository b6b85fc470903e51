"""Runtime approximation control — the DyFXU/DyFPU analogue at system level
(Ch. 5 §5.2.3 "Dynamic Configuration of the Approximation Degree").

The deployed computation never changes with the degree: the degree is a
device int32 operand that the kernels read from device memory, and this
host-side controller moves it to track a quality budget.

Control law (simple, monotone, hysteresis-banded):
  * quality signal q_t (here: serving-load headroom);
  * if EMA(q) < low_water  -> increase approximation (cheaper, lossier);
  * if EMA(q) > high_water -> decrease approximation (costlier, safer);
  * degree clamped to the configured ladder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def degree_operand(entry: dict, device="cpu") -> torch.Tensor:
    """Turn one QoS ladder entry into the device degree operand the models
    consume: ``{"degrees": [...]}`` (a per-site rung) becomes an int32
    vector, ``{"ebits": n}`` the global int32 scalar.  This copies host
    values to ``device``; the serve engine builds one operand per rung at
    construction, so a rung move on the hot path is a pointer swap."""
    if "degrees" in entry:
        vals = [int(e) for e in entry["degrees"]]
    else:
        vals = int(entry.get("ebits", 8))
    return torch.tensor(vals, dtype=torch.int32, device=device)


def degree_record(degree, *, as_tuple: bool = False):
    """Loggable/hashable form of a degree: a plain int for the global
    scalar, a tuple of ints for a per-site vector (``as_tuple=True`` makes
    the scalar a 1-tuple too).  Pass host values (ints, lists, ladder
    entries' numbers) on the hot path: a device tensor here syncs."""
    if isinstance(degree, torch.Tensor):
        degree = degree.detach().cpu().numpy()
    arr = np.asarray(degree)
    if arr.ndim or as_tuple:
        return tuple(int(x) for x in arr.reshape(-1))
    return int(arr)


def entry_degree(entry: dict):
    """Host-side value of a ladder entry (int or tuple) — the record form
    of :func:`degree_operand` without touching the device."""
    if "degrees" in entry:
        return tuple(int(e) for e in entry["degrees"])
    return int(entry.get("ebits", 8))


@dataclass
class QoSController:
    """Moves an integer degree along a ladder to track an error budget.

    degree semantics: index into ``ladder``; entry 0 = most accurate.
    Ladder entries are opaque to the controller — global degree kwargs
    (``{'ebits': 8} .. {'ebits': 5}``) or per-site rungs
    (``{'degrees': [...]}``); the consumer turns the chosen entry into the
    device degree operand.
    """

    ladder: list[dict]
    low_water: float
    high_water: float
    ema_alpha: float = 0.1
    cooldown_steps: int = 10
    degree: int = 0
    _ema: float | None = field(default=None, repr=False)
    _cooldown: int = field(default=0, repr=False)
    history: list[tuple[int, float, int]] = field(default_factory=list, repr=False)

    def update(self, step: int, quality_signal: float) -> dict:
        """Feed one quality observation; returns the (possibly new) degree
        kwargs to apply at the next step."""
        self._ema = (
            quality_signal
            if self._ema is None
            else (1 - self.ema_alpha) * self._ema + self.ema_alpha * quality_signal
        )
        if self._cooldown > 0:
            self._cooldown -= 1
        elif self._ema < self.low_water and self.degree < len(self.ladder) - 1:
            self.degree += 1          # quality headroom -> approximate harder
            self._cooldown = self.cooldown_steps
        elif self._ema > self.high_water and self.degree > 0:
            self.degree -= 1          # quality violated -> back off
            self._cooldown = self.cooldown_steps
        self.history.append((step, float(self._ema), self.degree))
        return self.ladder[self.degree]

    @property
    def ema(self) -> float:
        return self._ema if self._ema is not None else 0.0
