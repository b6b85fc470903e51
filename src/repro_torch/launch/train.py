"""Training entry point: the fault-tolerant trainer on one device or a mesh
(the port of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 1000 \\
      [--mesh DxM] [--dist-backend nccl|gloo] \\
      [--approx axq8|exact] [--qos] [--plan PLAN.json] [--compress-grads] \\
      [--kernels auto|cuda|torch] [--trace-out T.json] [--metrics-out M.prom]

It runs on the card unless ``--device cpu`` is given (the smoke archs, e.g.
``--arch tinyllama-1.1b-smoke``, fit the CPU).  ``--mesh DxM`` trains on
D x M ranks, one process a rank (the batch split over ``data``, the
weights over ``model``; every family): spawned here, or this process's
rank under ``torchrun``, as
``launch.serve --tp`` starts its ranks.  Ranks that share
a card need ``--dist-backend gloo``.  Rank 0 prints the summary; a SIGTERM
to the launcher reaches every rank, which checkpoint at one step and exit.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.approx import policy_from_flag
from repro_torch.core.dynamic import QoSController
from repro_torch.data.pipeline import make_pipeline
from repro_torch.dist import collectives, meshctx
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train import step as step_mod
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model ranks (one process a rank)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend of a mesh (default: nccl with a card "
                         "a rank, gloo on the CPU; ranks sharing a card need gloo)")
    ap.add_argument("--approx", default="exact")
    ap.add_argument("--plan", default=None,
                    help="ApproxPlan JSON (repro_torch.tune): train under the "
                         "plan's policy with its per-layer degree ladder as "
                         "the QoS ladder (implies the plan's mode/block)")
    ap.add_argument("--qos", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--kernels", default=None, choices=("auto", "cuda", "torch"),
                    help="kernel backend (default: REPRO_TORCH_KERNELS or auto = "
                         "the kernels for CUDA tensors)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (the card by default)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run "
                         "(data/step/checkpoint spans, straggler and "
                         "QoS-rung events)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write Prometheus text-format metrics (step/loss/"
                         "checkpoint counters, step-time histogram, degree "
                         "gauges) at exit")
    return ap


#: seconds a rank may wait in a collective, and the bound on a run of
#: spawned ranks
DIST_TIMEOUT_S = 3600.0


def _join_mesh(args):
    """This rank's ``(data, model)`` mesh of ``--mesh``, installed, on its
    device."""
    d, m = mesh_dims(args)
    mesh = meshctx.set_mesh(meshctx.make_mesh((d, m), ("data", "model"),
                                              device=args.device,
                                              backend=args.dist_backend))
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def _train_rank(rank: int, world: int, argd: dict) -> dict:
    """One rank of ``--mesh DxM``: its mesh, then the trainer; returns its
    result (the history, final step, preemption)."""
    args = argparse.Namespace(**argd)
    return train(args, _join_mesh(args))[0]


def mesh_dims(args) -> tuple:
    """(data, model) ranks of ``--mesh``; a batch that does not split over
    the data ranks raises ``SystemExit`` before any rank starts."""
    d, m = (int(x) for x in args.mesh.split("x")[:2])
    if d * m > 1 and args.batch % d:
        raise SystemExit(f"--mesh {args.mesh}: --batch {args.batch} does not split "
                         f"over {d} data ranks")
    return d, m


def train_mesh(args, world: int):
    """``--mesh DxM``: D x M ranks spawned here, or this process's rank
    under ``torchrun``.  Returns (rank 0's result, this process's trainer
    or None)."""
    args.dist_backend = meshctx.resolve_backend(args.device, world, args.dist_backend)
    if meshctx.under_torchrun():
        rank, n = meshctx.init_from_env(device=args.device, backend=args.dist_backend,
                                        timeout_s=DIST_TIMEOUT_S)
        if n != world:
            raise SystemExit(f"--mesh {args.mesh} under torchrun with {n} ranks")
        return train(args, _join_mesh(args))
    threads = 1 if torch.device(args.device).type == "cpu" else 0
    results = meshctx.spawn_ranks(_train_rank, world, timeout_s=DIST_TIMEOUT_S,
                                  backend=args.dist_backend, device=args.device,
                                  args=(vars(args),), threads=threads)
    return results[0], None


def run(argv=None):
    """Parse ``argv`` and train; returns (the trainer's result, trainer) —
    on a mesh of spawned ranks (rank 0's result, None)."""
    args = build_parser().parse_args(argv)
    d, m = mesh_dims(args)
    if d * m > 1:
        return train_mesh(args, d * m)
    return train(args, None)


def train(args, mesh):
    """The trainer of ``args`` on this process's device (``mesh``: this
    rank's, or None for one device)."""
    kdispatch.set_backend(args.kernels)
    rank = 0 if mesh is None else mesh.rank
    if args.trace_out and rank == 0:
        obs_trace.enable()
    m = 1 if mesh is None else mesh.size("model")
    device = args.device if mesh is None else mesh.device

    cfg = get_config(args.arch)
    plan = None
    if args.plan is not None:
        from repro_torch.tune import ApproxPlan

        plan = ApproxPlan.load(args.plan)
        plan.validate_for(cfg)
        policy = plan.policy(dynamic=True)
    else:
        try:
            policy = policy_from_flag(args.approx, dynamic=args.qos)
        except ValueError as e:
            raise SystemExit(str(e))
    model = build_model(cfg, policy, device=device)
    pipe = make_pipeline(cfg, seq_len=args.seq, global_batch=args.batch)
    # as in serve: --qos steps the ladder (the plan's rungs with --plan); a
    # plan without --qos trains its most accurate rung as a fixed degree
    ladder = (plan.qos_ladder() if plan is not None
              else [{"ebits": 8}, {"ebits": 7}, {"ebits": 6}, {"ebits": 5}])
    qos = QoSController(ladder=ladder, low_water=-0.005,
                        high_water=0.05) if args.qos else None
    static_degrees = (list(plan.degrees(0))
                      if (plan is not None and qos is None) else None)
    trainer = Trainer(
        model,
        step_mod.StepConfig(remat="none", total_steps=args.steps,
                            warmup=max(args.steps // 20, 5),
                            compress_grads=args.compress_grads),
        TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 4, 10),
                      ckpt_dir=args.ckpt_dir, qos=qos,
                      static_degrees=static_degrees),
        pipe, tp=m,
        registry=obs_metrics.get_registry() if args.metrics_out else None,
        mesh=mesh)
    collectives.counter.reset()
    out = trainer.run()
    if rank:
        return out, trainer
    where = "" if mesh is None else f"mesh {args.mesh} ({mesh.transport}) "
    print(f"[launch.train] done at step {out['final_step']}; "
          f"preempted={out['preempted']}; stragglers={len(out['stragglers'])} "
          f"[{where}device={model.device} kernels={kdispatch.resolved_backend(model.device)}]")
    if mesh is not None:
        coll = collectives.counter.snapshot()
        steps = max(len(out["history"]), 1)
        out["collective_bytes_per_step"] = {k: v / steps for k, v in coll["bytes"].items()}
        out["collective_host_ms_per_step"] = coll["host_ms"] / steps
        print(f"[launch.train] rank 0 collectives a step: bytes "
              f"{out['collective_bytes_per_step']}, host {coll['host_ms'] / steps:.1f} ms")
    if args.trace_out:
        obs_trace.get_tracer().write(args.trace_out)
        print(f"[launch.train] wrote Chrome trace -> {args.trace_out}")
    if args.metrics_out:
        obs_metrics.get_registry().write(args.metrics_out)
        print(f"[launch.train] wrote Prometheus metrics -> {args.metrics_out}")
    return out, trainer


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
