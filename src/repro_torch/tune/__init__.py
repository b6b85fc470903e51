"""repro_torch.tune — calibration-driven per-layer approximation plans (the
port of ``repro.tune``).

Offline half: :func:`build_plan` / :func:`profile_sensitivity` explore mixed
per-layer degree assignments on a calibration batch and emit a serializable
:class:`ApproxPlan` (plan.py; the reference's JSON format).  Runtime half:
the plan's degree ladder is executed by the models' per-layer degree vectors
(models/degrees.py) and stepped by the serve QoS controller
(serve/engine.py ``plan=``).
"""

from repro_torch.tune.autotune import (build_plan, energy_per_mac, measure_error,
                                       profile_sensitivity, site_macs, vector_cost)
from repro_torch.tune.plan import ApproxPlan, PlanPoint, site_names, uniform_plan

__all__ = [
    "ApproxPlan", "PlanPoint", "build_plan", "energy_per_mac",
    "measure_error", "profile_sensitivity", "site_macs", "site_names",
    "uniform_plan", "vector_cost",
]
