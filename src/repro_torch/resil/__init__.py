"""repro_torch.resil — fault injection, runtime guards, graceful degradation
(the port of ``repro.resil``).

The dissertation hardens DSP kernels for space-grade (radiation-exposed)
FPGAs and proposes runtime-adjustable approximation as a low-overhead
quality-management loop.  This package is that story at system level: a
serving stack that expects faults —

  * :mod:`repro_torch.resil.faults` — deterministic, seeded SEU-style fault
    injection (bit flips into params / per-slot cache state, NaN/Inf into
    activations, latency spikes, dropped ticks);
  * :mod:`repro_torch.resil.guards` — per-slot output guards computed inside
    the (captured) step, golden-param scrubbing, and a quality-tap anomaly
    sentinel;
  * :mod:`repro_torch.resil.policy` — per-request deadlines, capped-backoff
    retry, queue backpressure, and brownout-by-approximation: under
    overload the QoS controller is forced down its calibrated ladder
    before any request is shed.

All three wire through ``serve/engine.py::ServeCore`` for both workloads.
"""

from repro_torch.resil.faults import FaultEvent, FaultPlan, FaultSpec
from repro_torch.resil.guards import GuardConfig, QualitySentinel, slot_ok
from repro_torch.resil.policy import ServePolicy, VirtualClock, retry

__all__ = [
    "FaultEvent", "FaultPlan", "FaultSpec",
    "GuardConfig", "QualitySentinel", "slot_ok",
    "ServePolicy", "VirtualClock", "retry",
]
