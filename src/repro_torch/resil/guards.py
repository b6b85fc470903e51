"""Runtime guards for the serve engine's fused step.

Two detection layers:

  * **Per-slot output guards** — every guarded step returns a per-slot
    ``ok`` bool beside its emission: :func:`slot_ok` checks that the slot's
    output activation is finite everywhere and (when the workload declares
    a ``guard_limit``) within its magnitude bound — LM logits within
    ``|x| <= limit``, stream frames within the Q-format range the clean
    integer pipeline never leaves.  The check runs inside the step (a
    reduction on the device, captured with it), so a corrupted emission is
    never banked: the engine quarantines the slot — resets it in place
    through the ``cache_ops`` reset — and requeues or fails the request per
    policy.
  * **Quality-anomaly sentinel** — :class:`QualitySentinel` watches the
    live-vs-exact samples of the engine's quality tap (``obs/quality.py``)
    and trips when ``window`` consecutive samples cross the threshold
    (logit RMS above, or PSNR dB below, per ``mode``).

On any trip the engine scrubs: it copies its golden parameter clone back,
in place, into the leaves flipped since the last scrub (CUDA graphs read
the live tensors by address, so the repair must land in them) — the
software analogue of configuration-memory scrubbing.  ``scrub_every`` adds
blind periodic scrubbing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def _rows_all(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(b.shape[0], -1).all(dim=1)


def slot_ok(x: torch.Tensor, *, limit: Optional[float] = None) -> torch.Tensor:
    """Per-slot sanity reduction over a (slots, ...) batch: True where the
    slot's values are all finite and, when ``limit`` is given, all within
    ``|x| <= limit`` (compared in f32; NaN fails it).  No host read."""
    if x.is_floating_point():
        ok = _rows_all(torch.isfinite(x))
    else:
        ok = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    if limit is not None:
        ok = ok & _rows_all(x.to(torch.float32).abs() <= limit)
    return ok


@dataclass
class GuardConfig:
    """Engine guard knobs.  Passing a GuardConfig (or any fault plan) to
    ``ServeCore`` switches it onto the workload's ``guarded_step`` — same
    arithmetic, plus the fault operand and the per-slot ok bits."""

    #: override the workload's ``guard_limit`` magnitude bound (None keeps
    #: the workload default: 1e4 for LM logits, 2 << q for stream frames)
    limit: Optional[float] = None
    #: restore the golden parameters whenever any guard trips
    scrub_on_trip: bool = True
    #: blind periodic scrub every N ticks (0 = off)
    scrub_every: int = 0
    #: quality-tap anomaly threshold (None = sentinel off; needs
    #: ``quality_every > 0`` on the engine)
    sentinel_threshold: Optional[float] = None
    #: "max": trip when sample > threshold (LM logit RMS);
    #: "min": trip when sample < threshold (stream PSNR)
    sentinel_mode: str = "max"
    #: consecutive bad samples required to trip
    sentinel_window: int = 1

    def sentinel(self) -> Optional["QualitySentinel"]:
        if self.sentinel_threshold is None:
            return None
        return QualitySentinel(self.sentinel_threshold,
                               mode=self.sentinel_mode,
                               window=self.sentinel_window)


class QualitySentinel:
    """Threshold watcher over the quality tap's live-vs-exact samples."""

    def __init__(self, threshold: float, *, mode: str = "max",
                 window: int = 1):
        if mode not in ("max", "min"):
            raise ValueError(f"sentinel mode {mode!r} (want max|min)")
        self.threshold = float(threshold)
        self.mode = mode
        self.window = max(1, int(window))
        self._bad = 0
        self.trips = 0

    def observe(self, value: float) -> bool:
        """Feed one sample; True when the trip condition fires (resets the
        consecutive-bad counter so one anomaly reports once)."""
        bad = (value > self.threshold if self.mode == "max"
               else value < self.threshold)
        self._bad = self._bad + 1 if bad else 0
        if self._bad >= self.window:
            self._bad = 0
            self.trips += 1
            return True
        return False
