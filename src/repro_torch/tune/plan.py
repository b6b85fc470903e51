"""ApproxPlan: a serialized per-layer approximation assignment + degree ladder
(the port of ``repro.tune.plan``: the same JSON file format, so a plan
written by either package loads in the other).

The dissertation's methodology is two-staged: an *offline* exploration of the
approximation space (Ch. 6 — here `repro_torch.tune.autotune`, driven by a
calibration batch) and a *runtime* configuration register that moves the
approximation degree without re-synthesis (Ch. 5 §5.2.3 — here the device
per-layer degree vector of models/degrees.py).  The `ApproxPlan` is the
artifact that connects them: a checkpoint-adjacent JSON file holding

  * the **sites** — one per layer plus the shared head site, in the model's
    stacking order (hybrid: group-major, tail last);
  * the **static configuration** — execution mode (AXQ) and quantization
    block, from which :meth:`ApproxPlan.policy` rebuilds the ApproxPolicy the
    model must run under for the plan's degrees to mean anything;
  * the measured per-site **sensitivity** profile (calibration metadata kept
    for auditability — re-tuning can tell whether the model drifted);
  * the **ladder** — an ordered sequence of Pareto points, most accurate
    first.  Each :class:`PlanPoint` is a full per-site degree vector with its
    measured calibration error and modeled cost, so the serve QoS controller
    steps between *whole mixed configurations* instead of rescaling one
    global knob.

Round-tripping is bit-stable: `ApproxPlan.load(p.save(path))` compares equal
field-for-field (degrees are plain ints, floats go through `repr`-exact JSON).
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec, uniform

PLAN_VERSION = 1


@dataclass(frozen=True)
class PlanPoint:
    """One rung of the degree ladder: a full per-site assignment.

    ``degrees``: tuple of ints, one per plan site (layers then head), each an
    AXQ effective-bits degree in 1..8.  ``error`` is the calibration metric
    measured with this exact vector (autotune.measure_error); ``cost`` is the
    unit-gate energy proxy of the whole network under this vector, normalized
    so the all-8 assignment costs 1.0.
    """

    name: str
    degrees: tuple
    error: float
    cost: float

    def degree_array(self) -> np.ndarray:
        return np.asarray(self.degrees, np.int32)


@dataclass
class ApproxPlan:
    """Serializable per-layer approximation plan (see module docstring)."""

    arch: str
    sites: list
    ladder: list                      # list[PlanPoint], most accurate first
    mode: str = "axq"
    block: int = 256
    sensitivity: dict = field(default_factory=dict)   # site -> {ebits: error}
    meta: dict = field(default_factory=dict)
    version: int = PLAN_VERSION

    # ---- runtime -----------------------------------------------------

    def num_sites(self) -> int:
        return len(self.sites)

    def degrees(self, rung: int = 0) -> np.ndarray:
        """The per-site degree vector of ladder rung ``rung`` (0 = most
        accurate), ready to pass as the model's runtime ``degree``."""
        return self.ladder[rung].degree_array()

    def policy(self, dynamic: bool = True) -> ApproxPolicy:
        """The ApproxPolicy the model must be built with to execute this
        plan: a uniform spec in the plan's mode/block whose *degree* is the
        runtime knob (``dynamic=True`` so the device vector wins over the
        spec's static ebits)."""
        if self.mode != ApproxMode.AXQ.value:
            raise ValueError(
                f"only AXQ plans execute at runtime (got mode {self.mode!r}); "
                "emulation modes are exploration-stage only")
        return uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=8,
                                  block=self.block, dynamic=dynamic))

    def qos_ladder(self) -> list:
        """Ladder entries for :class:`repro_torch.core.dynamic.QoSController`:
        each rung contributes ``{"degrees": [...]}``, which the serve engine
        turns into one device operand per rung in place of the global
        ``{"ebits": n}``."""
        return [{"degrees": list(pt.degrees)} for pt in self.ladder]

    # ---- (de)serialization -------------------------------------------

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ladder"] = [
            {**asdict(pt), "degrees": list(pt.degrees)} for pt in self.ladder
        ]
        # JSON object keys are strings: canonicalize the per-site ebits keys
        # so save -> load -> to_dict round-trips field-for-field
        d["sensitivity"] = {
            site: {str(e): v for e, v in prof.items()}
            for site, prof in self.sensitivity.items()
        }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ApproxPlan":
        if d.get("version", 1) > PLAN_VERSION:
            raise ValueError(f"plan version {d['version']} is newer than "
                             f"this reader ({PLAN_VERSION})")
        ladder = [
            PlanPoint(name=p["name"], degrees=tuple(int(x) for x in p["degrees"]),
                      error=float(p["error"]), cost=float(p["cost"]))
            for p in d["ladder"]
        ]
        sens = {
            site: {int(e): float(v) for e, v in prof.items()}
            for site, prof in d.get("sensitivity", {}).items()
        }
        return cls(arch=d["arch"], sites=list(d["sites"]), ladder=ladder,
                   mode=d.get("mode", "axq"), block=int(d.get("block", 256)),
                   sensitivity=sens,
                   meta=d.get("meta", {}), version=d.get("version", 1))

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "ApproxPlan":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))

    def validate_for(self, cfg) -> None:
        """Loud mismatch check before running a plan against a model."""
        if self.arch != cfg.name:
            raise ValueError(
                f"plan was tuned for arch {self.arch!r}, not {cfg.name!r} — "
                "its calibrated errors/costs do not transfer; re-tune")
        want = cfg.n_layers + 1
        if len(self.sites) != want:
            raise ValueError(
                f"plan has {len(self.sites)} sites but arch {cfg.name!r} "
                f"needs {want} (n_layers + head)")
        if not self.ladder:
            raise ValueError("plan has an empty ladder")
        for pt in self.ladder:
            if len(pt.degrees) != want:
                raise ValueError(f"ladder point {pt.name!r} has "
                                 f"{len(pt.degrees)} degrees, needs {want}")


def site_names(cfg) -> list:
    """Canonical plan site names: ``layer_i`` in stacking order, then
    ``head`` (unembedding + frontend projections).  Non-LM configs may
    carry their own names (``StreamConfig.site_names`` -> fir/conv2d/gain);
    the count contract (n_layers + 1) is unchanged."""
    if hasattr(cfg, "site_names"):
        return list(cfg.site_names())
    return [f"layer_{i}" for i in range(cfg.n_layers)] + ["head"]


def uniform_plan(cfg, ebits_ladder=(8, 7, 6, 5), block: int = 256) -> ApproxPlan:
    """A degenerate plan whose every rung is a uniform assignment — the
    pre-plan global-knob behavior expressed in plan form (baselines, tests)."""
    sites = site_names(cfg)
    ladder = [
        PlanPoint(name=f"uniform_e{e}", degrees=tuple([int(e)] * len(sites)),
                  error=0.0, cost=0.0)
        for e in ebits_ladder
    ]
    return ApproxPlan(arch=cfg.name, sites=sites, ladder=ladder, block=block,
                      meta={"kind": "uniform"})
