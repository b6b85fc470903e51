"""A fleet of sharded replicas (``repro_torch.dist.fleet`` over
``fleet_meshes``) on the CPU: tinyllama-1.1b-smoke in f32, four gloo
ranks spawned through ``meshctx.spawn_ranks``, 3 replicas x tp=2 — replicas
0 and 1 on disjoint slices (ranks 0-1, 2-3), replica 2 on ranks 0-1 as
``fleet_meshes`` falls back — with the supervisor's host logic on every
rank and each replica's tokens broadcast to the ranks outside it.

Held to the reference's ``FleetSupervisor`` on ``fleet_meshes(3, tp=2)``
over 8 host devices (a JAX subprocess: the device flag must precede the
JAX import; its replicas are disjoint there), on the reference's scenario
(tests/test_sharded_serve.py: replica 1 lost at tick 2, a scripted plan)
and a seeded ``replica_loss`` plan, each on a VirtualClock: the recovery
trace (``resil_log``), every request's status and tokens, the last
rescale plan (``data=2, model=2`` after the scripted loss) and the
replicas' liveness, equal; every request ends once; ok tokens equal a
clean one-process engine's; two runs of one seed give one trace; every
rank's view equal.  Then ``launch.serve --replicas 2 --tp 2 --ring`` with
seeded replica losses through gloo, and its report lines."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

import _torch_dp as H
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.dist import meshctx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b-smoke"
PROMPTS = [[1 + i, 2 + i, 3 + i] for i in range(8)]
NEW = 6
SEEDED = (0.3, 3)

_REFERENCE = r"""
import dataclasses, json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config
from repro.dist.fleet import FleetSupervisor, fleet_meshes
from repro.models import build_model
from repro.resil import FaultEvent, FaultPlan, FaultSpec, ServePolicy, VirtualClock
from repro.serve.sharded import ShardedServeEngine

cfg = dataclasses.replace(get_config("%(arch)s"), dtype="float32")
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0), tp=2)
out = {}
for name in ("scripted", "seeded"):
    plan = (FaultPlan(events=[FaultEvent(tick=2, kind="replica_loss", slot=1,
                                         target="replica")])
            if name == "scripted" else
            FaultPlan(FaultSpec(replica_loss=%(rate)r), seed=%(seed)r))
    clock = VirtualClock()
    policy = ServePolicy(deadline_ms=None, ttft_deadline_ms=None, max_queue=None,
                         max_queue_age_ms=None, backoff_ms=0.0)

    def build(mesh, rid):
        return ShardedServeEngine(model, params, mesh=mesh, slots=2, max_len=32,
                                  clock=clock, policy=policy)

    sup = FleetSupervisor(build, 3, tp=2, clock=clock, faults=plan, policy=policy)
    reqs = [sup.submit(p, %(new)r) for p in %(prompts)r]
    done = sup.run_until_drained(max_ticks=400)
    out[name] = {"resil_log": sup.resil_log,
                 "done": sorted((r.rid, r.status, [int(t) for t in r.out]) for r in done),
                 "rescale": {"data": sup.rescales[-1].data, "model": sup.rescales[-1].model,
                             "idle": sup.rescales[-1].idle_devices},
                 "alive": [r.alive for r in sup.replicas],
                 "devices": [[d.id for d in r.mesh.devices.flat] for r in sup.replicas]}
print("FLEET_REF " + json.dumps(out))
"""


def _reference():
    code = _REFERENCE % {"arch": ARCH, "rate": SEEDED[0], "seed": SEEDED[1], "new": NEW,
                         "prompts": PROMPTS}
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                 "HOME": os.environ.get("HOME", "/tmp"),
                                 "JAX_PLATFORMS": "cpu"})


def _json(x):
    return json.loads(json.dumps(x))


def test_sharded_fleet_matches_reference(tmp_path):
    ref_proc = _reference()
    cfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    tree = jax.tree.map(np.asarray, jbuild_model(cfg).init(jax.random.PRNGKey(0), tp=2))
    got = meshctx.spawn_ranks(H.fleet_rank, 4, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=(ARCH, tree, 2, PROMPTS, NEW, SEEDED))
    out, err = ref_proc.communicate(timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("FLEET_REF ")]
    assert line, err[-3000:]
    ref = json.loads(line[0][len("FLEET_REF "):])
    r0 = got[0]
    # the slices: replicas 0 and 1 disjoint, replica 2 on the first ranks
    assert r0["scripted"]["ranks"] == [(0, 1), (2, 3), (0, 1)]
    assert [g["scripted"]["members"] for g in got] == [[True, False, True]] * 2 + \
        [[False, True, False]] * 2
    assert ref["scripted"]["devices"] == [[0, 1], [2, 3], [4, 5]]
    for name in ("scripted", "seeded"):
        mine, theirs = r0[name], ref[name]
        assert all(g[name]["resil_log"] == mine["resil_log"] for g in got)
        assert all(g[name]["done"] == mine["done"] for g in got)
        assert mine["rids"] == list(range(len(PROMPTS))) == sorted(mine["submitted"])
        assert _json(mine["resil_log"]) == theirs["resil_log"], name
        assert _json(mine["done"]) == theirs["done"], name
        assert mine["alive"] == theirs["alive"]
        plan = mine["rescale"]
        assert {"data": plan["data"], "model": plan["model"],
                "idle": plan["idle_devices"]} == theirs["rescale"]
        for rid, status, toks in mine["done"]:
            assert status == "ok" and toks == r0["clean"][rid], (name, rid)
    names = [n for _, n, _ in r0["scripted"]["resil_log"]]
    assert "replica_lost" in names and "rescale" in names
    assert not r0["scripted"]["alive"][1]
    assert (r0["scripted"]["rescale"]["data"], r0["scripted"]["rescale"]["model"]) == (2, 2)
    assert r0["seeded"]["resil_log"] == r0["seeded_again"]["resil_log"]
    assert r0["seeded"]["done"] == r0["seeded_again"]["done"]
    assert any(n == "replica_lost" for _, n, _ in r0["seeded"]["resil_log"])


def test_launch_serve_replicas_tp2_ring_on_gloo(capfd):
    """``launch.serve --replicas 2 --tp 2 --ring`` under seeded replica
    losses: four gloo ranks, every request ends once and ok, the ranks'
    streams equal; rank 0 prints the reference's fleet lines (the
    survivor plan of one (1, 2) replica: data=1, model=2)."""
    from repro_torch.launch import serve as launch_serve

    s, sup = launch_serve.run(["--device", "cpu", "--dist-backend", "gloo", "--replicas", "2",
                               "--tp", "2", "--ring", "--requests", "8", "--new-tokens", "4",
                               "--slots", "2", "--faults", "replica_loss=0.3",
                               "--fault-seed", "3", "--metrics"])
    assert sup is None and s["statuses"] == {"ok": 8} and s["streams_equal"]
    assert s["replicas"] == 2 and s["tp"] == 2 and s["rescales"] >= 1
    assert s["members"] == [0]
    assert s["collective_calls_per_tick"]["collective-permute"] > 0
    out = capfd.readouterr().out
    assert out.count("[launch.serve] fleet: 8 reqs on 2 replica(s) x tp=2") == 1
    assert "last rescale: data=1 model=2 idle=0" in out
    assert "fleet events:" in out and "replica 1: dead@tick" in out
