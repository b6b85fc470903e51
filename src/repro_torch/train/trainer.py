"""Trainer loop: checkpoint/restart, preemption handling, straggler watchdog
and runtime approximation (QoS) control (the port of
``repro.train.trainer``).

  * checkpoint saves hold whole arrays under their tree paths, so a restart
    restores onto any layout (a checkpoint the reference wrote included);
  * SIGTERM/SIGINT -> a blocking checkpoint, then a clean exit (preemption);
  * the step-time watchdog flags stragglers;
  * the QoS controller moves the DyFXU degree — a device int32 scalar, or a
    per-site vector when the ladder holds ApproxPlan rungs — on the loss
    improvement; a move builds the next rung's operand from host values and
    never reads the device.

The reference jits its step; here the step runs eagerly (the kernels under
autograd, ``train/step.py``).  Capturing it in a CUDA graph is left for
later.

On a mesh (``mesh=``, or the active one; one process a rank) every rank
builds the global parameters from the seed and keeps its shards
(``dist.sharding.shard_train_state``), takes its data coordinate's rows of
each batch, checkpoints through the mesh checkpointer (gathered, rank 0
writes, a barrier), and MAX-reduces the preemption flag over the world once
a step, so every rank checkpoints at the same step and exits.  The loss the
QoS controller reads is the global one, so every rank moves the degree at
the same step; the degree stays a device operand.  Rank 0 alone prints.
"""

from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.dynamic import QoSController, degree_operand, entry_degree
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.models.registry import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.tree import tree_map
from repro_torch.train import step as step_mod


def _as_tuple(rec) -> tuple:
    return rec if isinstance(rec, tuple) else (rec,)


@dataclass
class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the trailing median."""

    factor: float = 2.0
    window: int = 50
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 10 and dt > self.factor * med
        if slow:
            self.flagged.append((step, dt, med))
        return slow


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    async_ckpt: bool = True
    # QoS-driven dynamic approximation (None = static degree)
    qos: Optional[QoSController] = None
    qos_every: int = 20
    # static degree used when qos is None: an ApproxPlan rung's per-site
    # degree list, or None for the global default (ebits 8)
    static_degrees: Optional[list] = None


class Trainer:
    """``registry`` / ``tracer``: step and checkpoint spans and QoS ladder
    events go to the process-global tracer by default (free when disabled);
    counters and gauges land in a fresh per-trainer registry unless a shared
    one is passed (``launch.train --metrics-out`` exports it).  After
    :meth:`run`, ``state`` is the last state (this rank's on a mesh)."""

    def __init__(self, model: Model, scfg: step_mod.StepConfig,
                 tcfg: TrainerConfig, pipeline: SyntheticPipeline,
                 tp: int = 1, registry=None, tracer=None, mesh=None):
        self.model = model
        self.scfg = scfg
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.tp = tp
        mesh = mesh if mesh is not None else meshctx.get_mesh()
        self.mesh = mesh if math.prod(mesh.shape) > 1 else None
        if self.mesh is not None and self.mesh.size("model") != tp:
            raise ValueError(f"tp={tp} on a mesh whose model axis is "
                             f"{self.mesh.size('model')}")
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep, mesh=self.mesh)
        self.watchdog = StragglerWatchdog()
        self._preempted = False
        self._step_fn = lambda state, batch, degree: step_mod.train_step(
            model, scfg, state, batch, tp=tp, degree=degree)
        self.history: list[dict] = []
        self.registry = (registry if registry is not None
                         else obs_metrics.Registry())
        self._tracer = tracer if tracer is not None else obs_trace.get_tracer()
        r = self.registry
        self._c_steps = r.counter("repro_train_steps_total",
                                  "optimizer steps executed")
        self._c_ckpts = r.counter("repro_train_checkpoints_total",
                                  "checkpoints written")
        self._c_stragglers = r.counter("repro_train_straggler_steps_total",
                                       "steps flagged by the watchdog")
        self._g_loss = r.gauge("repro_train_loss", "last step's loss")
        self._g_degree = r.gauge(
            "repro_degree_ebits", "live approximation degree by plan site",
            labels=("site",))
        self._h_step = r.histogram("repro_train_step_seconds",
                                   "wall time per optimizer step")

    # ------------------------------------------------------------------

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _record_degree(self, entry: dict) -> tuple:
        """Refresh the ``repro_degree_ebits{site=..}`` gauge family from a
        ladder entry's host values (a scalar -> ``site="global"``)."""
        from repro_torch.tune.plan import site_names

        rec = _as_tuple(entry_degree(entry))
        names = site_names(self.model.cfg)
        if len(rec) == len(names):
            for name, e in zip(names, rec):
                self._g_degree.labels(site=name).set(e)
        else:
            self._g_degree.labels(site="global").set(rec[0])
        return rec

    def _print(self, msg: str) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            print(msg)

    def _batch(self, step: int) -> dict:
        dev = self.model.device
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                     torch.int64 if v.dtype.kind == "i" else None)
                 for k, v in self.pipeline.batch_at(step).items()}
        if self.mesh is not None:
            batch = sharding.shard_batch(batch, self.mesh)
        return {k: v.to(dev) for k, v in batch.items()}

    def init_or_restore(self, seed: int = 0) -> tuple[step_mod.TrainState, int]:
        state = step_mod.init_state(self.model, seed, tp=self.tp, mesh=self.mesh)
        got = None
        try:
            got = self.ckpt.restore_latest(state)
        except Exception:
            got = None
        if got is None:
            return state, 0
        step, tree, extra = got
        dev = self.model.device
        tree = tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
        self._print(f"[trainer] restored checkpoint at step {step}")
        return step_mod.TrainState(*tree), step

    def _preempted_anywhere(self) -> bool:
        """Whether to stop now: this rank's preemption flag, on a mesh
        MAX-reduced over the world, so every rank takes the same decision
        at the same step (a signal that lands during the reduction counts
        at the next step)."""
        if self.mesh is None:
            return self._preempted
        import torch.distributed as dist

        dev = self.mesh.device if self.mesh.backend == "nccl" else "cpu"
        flag = torch.tensor([1.0 if self._preempted else 0.0], device=dev)
        stop = bool(collectives.all_reduce(flag, dist.group.WORLD, op="max").item() > 0)
        self._preempted = self._preempted or stop
        return stop

    def run(self, seed: int = 0) -> dict:
        self._install_signal_handlers()
        state, start = self.init_or_restore(seed)
        dev = self.model.device
        if self.tcfg.qos:
            entry = self.tcfg.qos.ladder[self.tcfg.qos.degree]
        elif self.tcfg.static_degrees is not None:
            entry = {"degrees": self.tcfg.static_degrees}
        else:
            entry = {"ebits": 8}
        degree = degree_operand(entry, dev)
        self._record_degree(entry)
        t_last_loss = None
        step, stop = start, False
        while step < self.tcfg.total_steps:
            with self._tracer.span("data_batch", track="train", step=step):
                batch = self._batch(step)
            t0 = time.time()
            with self._tracer.span("train_step", track="train", step=step):
                state, metrics = self._step_fn(state, batch, degree)
                loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = self.watchdog.observe(step, dt)
            self._c_steps.inc()
            self._g_loss.set(loss)
            self._h_step.observe(dt)
            if slow:
                self._c_stragglers.inc()
                self._tracer.event("straggler", track="train", step=step,
                                   dt_s=round(dt, 4))
            rec = {"step": step, "loss": loss, "time_s": dt,
                   "grad_norm": float(metrics["grad_norm"]),
                   "degree": entry_degree(entry), "straggler": slow}
            self.history.append(rec)
            if step % self.tcfg.log_every == 0:
                self._print(f"[trainer] step {step} loss {loss:.4f} "
                            f"({dt*1e3:.0f} ms){' STRAGGLER' if slow else ''}")
            # QoS: quality signal = loss improvement rate (negative delta)
            if self.tcfg.qos and step % self.tcfg.qos_every == 0 and step > start:
                signal_q = (t_last_loss - loss) if t_last_loss is not None else 0.0
                kw = self.tcfg.qos.update(step, signal_q)
                old = _as_tuple(entry_degree(entry))
                entry = kw
                degree = degree_operand(entry, dev)
                new = self._record_degree(entry)
                if new != old:
                    # a ladder move: the event carries the whole degree vector,
                    # as the serve engine's qos_rung transitions do
                    self._tracer.event("qos_rung", track="train", step=step,
                                       rung=self.tcfg.qos.degree,
                                       degrees=list(new))
                t_last_loss = loss
            elif t_last_loss is None:
                t_last_loss = loss
            step += 1
            stop = self._preempted_anywhere()
            if stop or step % self.tcfg.ckpt_every == 0:
                with self._tracer.span("checkpoint", track="train", step=step):
                    self.ckpt.save(
                        step, state,
                        extra={"data_step": step, "degree": entry_degree(entry)},
                        blocking=stop or not self.tcfg.async_ckpt)
                self._c_ckpts.inc()
                if stop:
                    self._print(f"[trainer] preempted: checkpointed at {step}, exiting")
                    break
        self.ckpt.wait()
        self.state = state
        if not stop and (step % self.tcfg.ckpt_every):
            self.ckpt.save(step, state,
                           extra={"data_step": step, "degree": entry_degree(entry)},
                           blocking=True)
            self._c_ckpts.inc()
        return {"final_step": step, "history": self.history,
                "preempted": stop,
                "stragglers": self.watchdog.flagged}
