"""repro_torch.obs — observability of the port's serving stack (the port of
``repro.obs``; the reference's bench-record regression gate is not ported).

  * :mod:`repro_torch.obs.trace` — process-global span/instant tracer with
    bounded ring buffers and Chrome ``trace_event`` export
    (``chrome://tracing`` / Perfetto).
  * :mod:`repro_torch.obs.metrics` — typed counter/gauge/histogram registry
    with a Prometheus text exporter and a JSON snapshot.
  * :mod:`repro_torch.obs.quality` — online per-rung live-vs-exact error
    telemetry (the serving-time twin of the calibration prober).
"""

from repro_torch.obs.metrics import Registry, get_registry, parse_text
from repro_torch.obs.quality import QualityTap
from repro_torch.obs.trace import Tracer, get_tracer

__all__ = ["Registry", "get_registry", "parse_text", "QualityTap",
           "Tracer", "get_tracer", "trace", "metrics"]

from repro_torch.obs import metrics, trace  # noqa: E402  (re-export modules)
