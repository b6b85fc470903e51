"""Training entry point: the fault-tolerant trainer on one device (the port
of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 1000 \\
      [--approx axq8|exact] [--qos] [--plan PLAN.json] [--compress-grads] \\
      [--kernels auto|cuda|torch] [--trace-out T.json] [--metrics-out M.prom]

It runs on the card unless ``--device cpu`` is given (the smoke archs, e.g.
``--arch tinyllama-1.1b-smoke``, fit the CPU); ``--mesh`` other than 1x1
raises: the mesh is not ported yet.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core.approx import policy_from_flag
from repro_torch.core.dynamic import QoSController
from repro_torch.data.pipeline import make_pipeline
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
                    help="data x model devices; only 1x1 (one device) is ported")
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


def run(argv=None):
    """Parse ``argv`` and train; returns (the trainer's result, trainer)."""
    args = build_parser().parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x")[:2])
    if (d, m) != (1, 1):
        raise SystemExit(f"--mesh {args.mesh}: the port trains on one device (1x1); "
                         "the mesh is not ported yet")
    kdispatch.set_backend(args.kernels)
    if args.trace_out:
        obs_trace.enable()

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
    model = build_model(cfg, policy, device=args.device)
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
        registry=obs_metrics.get_registry() if args.metrics_out else None)
    out = trainer.run()
    print(f"[launch.train] done at step {out['final_step']}; "
          f"preempted={out['preempted']}; stragglers={len(out['stragglers'])} "
          f"[device={model.device} kernels={kdispatch.resolved_backend(model.device)}]")
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
