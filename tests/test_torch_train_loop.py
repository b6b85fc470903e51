"""The port's fault-tolerant trainer and ``launch.train`` on the CPU, the
cases of tests/test_trainer.py and tests/test_train.py: preemption (a
blocking checkpoint, then restart and resume), the straggler watchdog, the
QoS ladder on the loss improvement, the tracer's spans and events and the
``repro_train_*`` / ``repro_degree_ebits`` metrics (held to the reference
trainer's Prometheus text on the same run, where values do not depend on
the clock), overfitting one batch under EXACT, and compressed gradients
still converging."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.configs import get_config as jget_config
from repro.core.dynamic import QoSController as JQoS
from repro.data.pipeline import make_pipeline as jmake_pipeline
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.core.dynamic import QoSController
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model, concrete_batch
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.train import step as tstep
from repro_torch.train.trainer import StragglerWatchdog, Trainer, TrainerConfig

torch.set_num_threads(2)

ARCH = "tinyllama-1.1b-smoke"


def _mk(tmp, total=20, ckpt_every=50, qos=None, qos_every=20, registry=None, tracer=None,
        schedule=None):
    cfg = tget_config(ARCH)
    m = build_model(cfg, device="cpu")
    pipe = make_pipeline(cfg, seq_len=16, global_batch=2)
    return Trainer(m, tstep.StepConfig(remat="none", total_steps=schedule or total, warmup=2),
                   TrainerConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(tmp),
                                 log_every=1000, qos=qos, qos_every=qos_every),
                   pipe, registry=registry, tracer=tracer)


class _PreemptingPipeline:
    """Raises the trainer's preemption flag at a given step (stands in for
    SIGTERM from the scheduler)."""

    def __init__(self, inner, box, at_step):
        self.inner, self.box, self.at = inner, box, at_step

    def batch_at(self, step):
        if step >= self.at:
            self.box[0]._preempted = True
        return self.inner.batch_at(step)


def test_preemption_checkpoints_and_resumes(tmp_path):
    """Preempted at step 3: a blocking checkpoint at the next step, exit;
    a fresh trainer restores it (the state bit for bit) and resumes to the
    end, its losses equal to an uninterrupted run's at 1e-5 (all three on
    one learning-rate schedule)."""
    t = _mk(tmp_path / "a", total=50, ckpt_every=100)
    t.pipeline = _PreemptingPipeline(t.pipeline, [t], at_step=3)
    out = t.run()
    assert out["preempted"] and out["final_step"] <= 5
    assert t.ckpt.latest_valid_step() == out["final_step"]
    t2 = _mk(tmp_path / "a", total=8, ckpt_every=100, schedule=50)
    state, start = t2.init_or_restore()
    saved, _ = t2.ckpt.restore(out["final_step"], state)
    for a, b in zip(TT.leaves(state), TT.leaves(saved)):
        np.testing.assert_array_equal(a, b)
    out2 = t2.run()
    assert out2["history"][0]["step"] == out["final_step"] and out2["final_step"] == 8
    ref = _mk(tmp_path / "b", total=8, ckpt_every=100, schedule=50).run()
    losses = [h["loss"] for h in out["history"] + out2["history"]]
    np.testing.assert_allclose(losses, [h["loss"] for h in ref["history"]], rtol=1e-5)


def test_straggler_watchdog_flags_outliers():
    w = StragglerWatchdog(factor=2.0)
    for i in range(20):
        assert not w.observe(i, 0.1)
    assert w.observe(20, 0.5)
    assert w.flagged and w.flagged[0][0] == 20


def test_straggler_event_and_counter(tmp_path, monkeypatch):
    """A step slower than twice the median after 10 steps is flagged: the
    history, the straggler event and the counter.  The trainer's clock is a
    fake one that each step advances by 0.1 s and step 11 by 0.5 s (5x), so
    no load on the host can make another step slow."""
    import types

    from repro_torch.train import trainer as ttrainer

    clock = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(ttrainer, "time", types.SimpleNamespace(time=lambda: clock.t))
    tracer = ttrace.Tracer(enabled=True)
    t = _mk(tmp_path, total=12, ckpt_every=100, tracer=tracer)
    inner = t._step_fn

    def slow_at_11(state, batch, degree):
        clock.t += 0.5 if len(t.history) == 11 else 0.1
        return inner(state, batch, degree)

    t._step_fn = slow_at_11
    out = t.run()
    assert [h["time_s"] for h in t.history] == pytest.approx([0.1] * 11 + [0.5])
    assert [s for s, _, _ in out["stragglers"]] == [11]
    assert t.history[11]["straggler"]
    assert [e["args"]["step"] for e in tracer.events if e["name"] == "straggler"] == [11]
    assert t.registry.get("repro_train_straggler_steps_total").value == 1


def _ladder():
    return [{"ebits": 8}, {"ebits": 7}, {"ebits": 6}]


def test_qos_trainer_matches_reference_trace_and_metrics(tmp_path):
    """axq8 under a QoS ladder 8 -> 7 -> 6 that moves every check: the
    port's trainer (restored from the reference's initial state) against
    the reference's on the same pipeline (Pallas route): the same
    losses (1e-5), degree history, qos_rung events and span names per
    step, and the same Prometheus text of the clock-free families."""
    arch = ARCH
    jm, tm = TT.models(arch, "axq8")
    jcfg = dataclasses.replace(jget_config(arch), dtype="float32")
    scj, sct = TT.step_cfgs(remat="none", total_steps=20, warmup=2)
    kw = dict(low_water=10.0, high_water=20.0, cooldown_steps=0)   # step down each check
    jr, tr = jmetrics.Registry(), tmetrics.Registry()
    jt, tt = jtrace.Tracer(enabled=True), ttrace.Tracer(enabled=True)
    with TT.jax_backend("pallas"):
        jout = JTrainer(jm, scj, JTrainerConfig(total_steps=8, ckpt_every=4,
                                                ckpt_dir=str(tmp_path / "j"), log_every=100,
                                                qos=JQoS(ladder=_ladder(), **kw), qos_every=2),
                        jmake_pipeline(jcfg, seq_len=16, global_batch=2),
                        registry=jr, tracer=jt).run()
    # the port's trainer starts from the reference's initial state (step 0)
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.train import step as jstep

    JCheckpointer(tmp_path / "t").save(0, jstep.init_state(jm, jax.random.PRNGKey(0)))
    tq = QoSController(ladder=_ladder(), **kw)
    trainer = Trainer(tm, sct, TrainerConfig(total_steps=8, ckpt_every=4,
                                             ckpt_dir=str(tmp_path / "t"), log_every=100,
                                             qos=tq, qos_every=2),
                      make_pipeline(tm.cfg, seq_len=16, global_batch=2), registry=tr, tracer=tt)
    tout = trainer.run()
    assert tout["final_step"] == jout["final_step"] == 8
    assert len(tq.history) > 0
    np.testing.assert_allclose([h["loss"] for h in tout["history"]],
                               [h["loss"] for h in jout["history"]], rtol=1e-5)
    assert [h["degree"] for h in tout["history"]] == [h["degree"] for h in jout["history"]]
    assert len({h["degree"] for h in tout["history"]}) > 1

    def names(tracer):
        return [(e["name"], e.get("args", {}).get("step"),
                 e.get("args", {}).get("degrees")) for e in tracer.events
                if e["name"] in ("data_batch", "train_step", "checkpoint", "qos_rung")]

    assert names(tt) == names(jt)
    keep = ("repro_train_steps_total", "repro_train_checkpoints_total", "repro_degree_ebits",
            "repro_train_step_seconds_count", "repro_train_straggler_steps_total")
    parse_t = {k: v for k, v in tmetrics.parse_text(tr.to_prometheus()).items()
               if k[0].startswith(keep)}
    parse_j = {k: v for k, v in jmetrics.parse_text(jr.to_prometheus()).items()
               if k[0].startswith(keep)}
    # (down to degree 5 the losses part by 5e-4 after six steps: AXQ's int8
    # codes amplify last-ulp differences, ROADMAP §C)
    assert parse_t == parse_j and parse_t
    np.testing.assert_allclose(tr.get("repro_train_loss").value,
                               jr.get("repro_train_loss").value, rtol=1e-5)


def test_overfit_tiny_batch():
    """40 EXACT steps on one batch drop the loss by more than 1.0."""
    cfg = tget_config(ARCH)
    m = build_model(cfg, device="cpu")
    state = tstep.init_state(m, seed=0)
    scfg = tstep.StepConfig(remat="none", total_steps=60, warmup=5)
    batch = concrete_batch(cfg, seq=16, batch=2)
    losses = []
    for _ in range(40):
        state, met = tstep.train_step(m, scfg, state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_compressed_grads_training_converges():
    cfg = tget_config(ARCH)
    m = build_model(cfg, device="cpu")
    state = tstep.init_state(m, seed=0)
    scfg = tstep.StepConfig(remat="none", total_steps=40, warmup=2, compress_grads=True)
    batch = concrete_batch(cfg, seq=16, batch=2)
    losses = []
    for _ in range(30):
        state, met = tstep.train_step(m, scfg, state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.8, (losses[0], losses[-1])


def test_launch_train_cpu_end_to_end(tmp_path, capsys):
    """``launch.train --device cpu`` with --qos, --compress-grads,
    --trace-out and --metrics-out: the run, its checkpoints, the trace's
    spans and the metrics file; a second run resumes from the last
    checkpoint; --mesh with a batch that does not split over its data ranks
    raises before any rank starts."""
    ttrace.get_tracer().clear()
    tr_path, m_path = tmp_path / "trace.json", tmp_path / "metrics.prom"
    argv = ["--arch", ARCH, "--steps", "12", "--seq", "16", "--batch", "2", "--approx",
            "axq8", "--qos", "--compress-grads", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"), "--trace-out", str(tr_path),
            "--metrics-out", str(m_path)]
    try:
        out = tlaunch.main(argv)
    finally:
        ttrace.disable()
    assert out["final_step"] == 12 and not out["preempted"]
    ev = json.loads(tr_path.read_text())["traceEvents"]
    steps = [e["args"]["step"] for e in ev if e.get("name") == "train_step"]
    assert steps == list(range(12))
    assert any(e.get("name") == "checkpoint" for e in ev)
    prom = tmetrics.parse_text(m_path.read_text())
    assert prom[("repro_train_steps_total", ())] >= 12
    assert prom[("repro_train_checkpoints_total", ())] >= 2
    assert any(k[0] == "repro_degree_ebits" for k in prom)
    assert "done at step 12" in capsys.readouterr().out
    out2 = tlaunch.main(argv[:3] + ["14"] + argv[4:])
    assert out2["history"][0]["step"] == 12 and out2["final_step"] == 14
    with pytest.raises(SystemExit, match="does not split over 2 data ranks"):
        tlaunch.main(["--mesh", "2x1", "--batch", "3", "--arch", "mamba2-370m-smoke",
                      "--device", "cpu"])
    tlaunch.kdispatch.set_backend(None)


def test_launch_train_mesh_cpu(tmp_path, capfd):
    """``launch.train --mesh 1x2 --device cpu``: two spawned gloo ranks
    train the smoke to the end and checkpoint (rank 0 writes the gathered
    state); rank 0 prints the summary with the mesh's transport."""
    argv = ["--arch", ARCH, "--steps", "4", "--seq", "16", "--batch", "2", "--mesh", "1x2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    out = tlaunch.main(argv)
    assert out["final_step"] == 4 and not out["preempted"]
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["collective_bytes_per_step"]["all-reduce"] > 0
    assert (tmp_path / "ck" / "step_0000000004" / "manifest.json").exists()
    assert "mesh 1x2 (gloo)" in capfd.readouterr().out
