"""Serving entrypoint: the continuous-batching engine on the card.

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --qos --metrics
  # int8 KV cache, bucketed prefill packed four prompts to a call:
  REPRO_KV_INT8=1 python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --approx axq8 --qos --prefill-buckets auto --pack 4 --metrics
  # the sliding-window arch (window 4096: the cache is a ring, prompts may
  # be longer than it, and their prefill runs the band schedule):
  python -m repro_torch.launch.serve --arch h2o-danube-1.8b --approx axq8 --qos --metrics
  # head_dim 128 with QKV bias (the bias rides the AXQ GEMM's epilogue):
  python -m repro_torch.launch.serve --arch qwen2.5-3b --approx axq8 --qos --metrics
  # the MoE family at full width (granite: 40 experts, top-8; exact-length
  # admission only, on either cache)
  python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --approx axq8 --qos --metrics
  # the recurrent families: Mamba-2 SSD (a fixed state a slot, prompts of
  # any length) and the RG-LRU hybrid (a local-attention ring of 2048 at
  # head_dim 256), bucketed or not (chunked admission is not offered):
  python -m repro_torch.launch.serve --arch mamba2-370m --approx axq8 --qos --metrics
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --approx axq8 --qos \
      --prefill-buckets auto --pack 4 --metrics
  # the plain PyTorch versions on the host, at smoke size:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b-smoke --device cpu
  # the streaming DSP workload (FIR -> blur -> gain on the PR multiplier):
  python -m repro_torch.launch.serve --workload stream --qos --metrics
  # a per-layer approximation plan (repro_torch.tune), the QoS controller
  # stepping its calibrated ladder, with a Chrome trace, Prometheus metrics
  # and the live-vs-exact quality tap every 8 ticks:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --plan plan.json --qos \
      --trace-out trace.json --metrics-out metrics.prom --quality-every 8
  # a seeded fault storm against guards, quarantine, scrubbing, deadlines,
  # retries, queue shedding and brownout down the QoS ladder:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --qos \
      --faults seu_state=0.02,seu_param=0.01,nan=0.05,spike=0.02,drop=0.02 \
      --fault-seed 7 --deadline-ms 2000 --retries 4 --shed 8 --brownout --metrics
  # the VLM's backbone (internvl2-1b; text-only prompts, as the reference
  # serves it):
  python -m repro_torch.launch.serve --arch internvl2-1b --approx axq8 --qos --metrics
  # a fleet of 3 replica engines on the one card, surviving seeded replica
  # losses (queue migration, in-flight rewind, survivor replanning):
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --replicas 3 \
      --faults replica_loss=0.02 --metrics
  # tensor parallelism: 2 ranks (here both on the one card, so gloo must be
  # asked for), each with its shards of the weights and its heads of the
  # cache; --ring moves the EXACT row-parallel reductions as int8:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --qos \
      --tp 2 --dist-backend gloo --metrics
  # the recurrent families at tp=2 (each rank its SSM heads / RG-LRU
  # channels and its kv head of recurrentgemma's MQA):
  python -m repro_torch.launch.serve --arch mamba2-370m --approx axq8 --qos \
      --tp 2 --dist-backend gloo --prefill-buckets auto --pack 4 --metrics

Weights are random-init from ``--seed``.  ``--qos`` walks the AXQ degree
ladder ebits 8 -> 5 with load, at a fixed set of kernels (the stream
workload: the per-site ladder [e] * 3 for e = 8 -> 5; its weights are the
deterministic ``serve.stream.default_params`` and its clips ``make_clip``
from seeds 0 .. requests - 1).
``REPRO_KV_INT8=1`` serves from the int8 KV cache (there is no flag for it,
as in the reference launcher).  ``--plan`` (either workload) serves under
the plan's policy with its most accurate rung, or with ``--qos`` steps its
ladder; ``--approx`` is then ignored.  ``--faults`` (either workload)
injects a seeded fault storm and turns on the runtime guards;
``--deadline-ms``, ``--retries``, ``--shed`` and ``--brownout`` set the
serving policy (``repro_torch.resil``).  A single engine ignores
``replica_loss``.

``--replicas N`` (N > 1) serves either workload through a
:class:`repro_torch.dist.fleet.FleetSupervisor` over N replica engines on
the one device (with ``--tp M``, on ranks: below): least-loaded routing
(``--route-by slots|backlog``), a fleet-level ``replica_loss`` plan drawn
from ``--faults`` (the engine kinds become one plan a replica, seeded
``--fault-seed + rid``), queue migration and in-flight rewind when a
replica dies, and the survivor plan with its modeled latency
(``--rescale-ms``).  LM replicas share one packed
weight set (each has its own cache and graphs; a storm with ``seu_param``
gives each replica its own copy, since flips land in place).  An
encoder-only arch (hubert-xlarge) has no decode step and raises, as in the
reference.

``--tp M`` (or ``--mesh 1xM``; ``--tp`` wins) serves the LM workload with
tensor parallelism over M ranks (``repro_torch.serve.sharded``), and
``--mesh DxM`` one engine over D x M ranks whose slots split over the D
data coordinates (``--slots`` must divide by D): the launcher spawns its
ranks itself (``dist.meshctx.spawn_ranks``) unless it runs under
``torchrun`` (``RANK`` / ``WORLD_SIZE`` set), every rank builds the same
seeded weights, keeps its shards and its slots' part of the cache and
runs the same host logic over every request, and rank 0 prints the
report.  Rank r runs on ``cuda:(r % cards)``; ranks that share a card
need ``--dist-backend gloo`` (NCCL refuses two ranks on one GPU; without
the flag the launcher raises).  ``--ring`` routes the EXACT row-parallel
reductions through the int8 ring.  The sharded step runs eagerly.

``--replicas N --tp M [--ring]`` serves a fleet of N sharded replicas on
N x M ranks (``dist.fleet.fleet_meshes``: replica r on ranks r M .. r M +
M - 1; under ``torchrun`` with fewer ranks the replicas that do not fit
share the first M, as the reference's share devices); every rank runs the
supervisor, rank 0 prints the reference's fleet report.  The stream
workload and the audio encoder under ``--tp`` raise, as do the MoE family
on a data axis (the reference cannot serve it: ROADMAP §C), a data axis
with ``--replicas`` (a replica is a (1, M) mesh) and capture of the
sharded step (ROADMAP §A).

  # one engine's 8 slots over 2 data coordinates of 2 model ranks each,
  # the four ranks on the one card:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --qos \
      --mesh 2x2 --slots 8 --dist-backend gloo --metrics
  # 2 replicas x tp=2 on four ranks, surviving seeded replica losses:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --replicas 2 \
      --tp 2 --ring --dist-backend gloo --faults replica_loss=0.05 --fault-seed 3 --metrics
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.approx import policy_from_flag
from repro_torch.core.dynamic import QoSController
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine
from repro_torch.serve.metrics import summarize


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lm", choices=("lm", "stream"),
                    help="lm: token decode; stream: frame clips through the "
                         "approximate FIR/conv pipeline")
    ap.add_argument("--frames", type=int, default=8,
                    help="frames per clip (stream workload)")
    ap.add_argument("--arch", default="tinyllama-1.1b-smoke")
    ap.add_argument("--mesh", default="1x1",
                    help="device mesh DxM: M tensor-parallel ranks (--tp) for each of "
                         "D data coordinates, which split the slots")
    # -- the replica fleet (repro_torch.dist.fleet) -----------------------
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve through a FleetSupervisor over N replica engines "
                         "(N > 1): all on the one device, or with --tp M on N x M ranks")
    ap.add_argument("--tp", type=int, default=0, metavar="M",
                    help="tensor-parallel ranks (default: the model axis of --mesh); "
                         "above 1 the launcher spawns M ranks")
    ap.add_argument("--ring", action="store_true",
                    help="route the EXACT row-parallel reductions of tensor-"
                         "parallel serving through the int8 ring all-reduce")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend of the ranks (default: nccl when "
                         "every rank has its own card, gloo on the CPU; ranks that "
                         "share a card need gloo)")
    ap.add_argument("--rescale-ms", type=float, default=5.0,
                    help="modeled survivor re-shard latency charged per rescale "
                         "(repro_rescale_seconds histogram)")
    ap.add_argument("--route-by", default="slots", choices=("slots", "backlog"),
                    help="fleet routing load: slots counts requests (queued + in "
                         "a slot); backlog counts admission work in payload units")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512,
                    help="KV-cache capacity per slot (prompt bound)")
    ap.add_argument("--approx", default="exact",
                    help="projection arithmetic: exact | axqN (block-int8 "
                         "GEMMs at N effective bits, e.g. axq8/axq6); "
                         "ignored when --plan is given (the plan carries "
                         "its own policy)")
    ap.add_argument("--plan", default=None,
                    help="path to an ApproxPlan JSON (repro_torch.tune): "
                         "serve with per-layer degrees; with --qos the "
                         "controller steps the plan's calibrated ladder")
    ap.add_argument("--qos", action="store_true",
                    help="drive the runtime approximation degree from load "
                         "(ladder ebits 8->5, or the plan's rungs; no rebuild)")
    ap.add_argument("--kernels", default=None, choices=("auto", "cuda", "torch"),
                    help="kernel backend (default: REPRO_TORCH_KERNELS or "
                         "auto = the CUDA kernels for tensors on the card)")
    ap.add_argument("--no-prepack", action="store_true",
                    help="keep float weights (per-call weight quantization)")
    ap.add_argument("--prefill-buckets", default=None, metavar="LIST",
                    help="bucketed prefill: comma list of ascending prompt-"
                         "prefix lengths (e.g. 16,32,64,128), or 'auto' for "
                         "the power-of-two ladder up to max_len; every bucket "
                         "shape runs once at startup")
    ap.add_argument("--pack", type=int, default=1, metavar="N",
                    help="pack up to N short prompts into one bucketed "
                         "prefill call (each row writes its own slot)")
    ap.add_argument("--chunk-tokens", type=int, default=0, metavar="C",
                    help="chunked prefill: split prompts longer than C into "
                         "C-token chunks admitted across ticks, interleaved "
                         "with decode (0 = off; bf16/f32 cache only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 enables categorical sampling")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k most likely tokens")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts and sampling seed")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop-token id; -1 disables EOS stopping")
    ap.add_argument("--metrics", action="store_true",
                    help="print the latency summary and token accounting")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run "
                         "(enqueue/prefill/decode/QoS-rung spans; open in "
                         "chrome://tracing or Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write Prometheus text-format metrics (engine "
                         "counters, latency histograms, kernel routes, "
                         "degree gauges) at exit")
    ap.add_argument("--quality-every", type=int, default=0, metavar="N",
                    help="sample the live-vs-exact output error every N "
                         "ticks into a per-rung histogram (0 = off; needs "
                         "--qos/--plan)")
    # -- resilience (repro_torch.resil) -----------------------------------
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request e2e deadline; a request past it "
                         "terminates with status=deadline (queued or "
                         "in-slot), never silently")
    ap.add_argument("--retries", type=int, default=None, metavar="N",
                    help="guard-trip requeues before a request fails "
                         "(default 2; capped-exponential backoff)")
    ap.add_argument("--shed", type=int, default=None, metavar="Q",
                    help="queue-length backpressure cap: overflow sheds "
                         "newest-first (or browns out first, see --brownout)")
    ap.add_argument("--brownout", action="store_true",
                    help="under overload force the QoS controller down the "
                         "approximation ladder BEFORE shedding (needs --qos)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="inject a seeded fault storm: comma list of "
                         "kind=rate — seu_state, seu_param, nan, spike, drop "
                         "(e.g. 'seu_state=0.02,nan=0.05'); enables runtime "
                         "guards + quarantine; with --replicas, "
                         "replica_loss=RATE kills whole replicas (drawn fleet-"
                         "level; the engine kinds keep per-replica storms)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault schedule seed: the same seed reproduces the "
                         "injected-fault sequence and recovery trace")
    return ap


def policy_from_args(args):
    """ServePolicy from the CLI flags, or None when no policy flag is set."""
    if (args.deadline_ms is None and args.retries is None
            and args.shed is None and not args.brownout):
        return None
    from repro_torch.resil import ServePolicy

    if args.brownout and not args.qos:
        raise SystemExit("--brownout degrades the QoS ladder under "
                         "overload: it needs --qos (or --plan with "
                         "--qos) to have a ladder to walk")
    return ServePolicy(
        deadline_ms=args.deadline_ms,
        max_retries=args.retries if args.retries is not None else 2,
        max_queue=args.shed,
        brownout=args.brownout)


def resil_kwargs(args) -> dict:
    """The engine's resilience keywords from the CLI flags (both
    workloads); empty when no resilience flag is set (the plain step)."""
    kw: dict = {}
    if args.faults:
        from repro_torch.resil import FaultPlan, FaultSpec, GuardConfig

        kw["faults"] = FaultPlan(FaultSpec.parse(args.faults), seed=args.fault_seed)
        kw["guards"] = GuardConfig()
    policy = policy_from_args(args)
    if policy is not None:
        kw["policy"] = policy
    return kw


def print_resil(eng) -> None:
    """Resilience summary line (only when something happened)."""
    s = eng.stats

    def fam_total(fam) -> int:
        return sum(int(c.value) for c in fam.children.values())

    counts = {
        "faults_injected": fam_total(s.c_faults),
        "guard_trips": fam_total(s.c_guard_trips),
        "retries": int(s.c_retries.value),
        "shed": fam_total(s.c_shed),
        "deadline_miss": fam_total(s.c_deadline_miss),
        "brownout_rungs": int(s.c_brownout.value),
        "param_scrubs": int(s.c_scrubs.value),
    }
    if any(counts.values()):
        line = " ".join(f"{k}={v}" for k, v in counts.items() if v)
        print(f"[launch.serve]   resil: {line}")


def admission_from_args(args):
    """AdmissionConfig from the CLI flags, or None when no admission flag
    is set (the engine then admits each prompt at its exact length).
    ``--prefill-buckets auto`` derives the power-of-two ladder from the
    engine's max_len."""
    if not (args.prefill_buckets or args.pack > 1 or args.chunk_tokens):
        return None
    buckets: tuple = ()
    if args.prefill_buckets and args.prefill_buckets != "auto":
        buckets = tuple(int(b) for b in args.prefill_buckets.split(","))
    return AdmissionConfig(buckets=buckets, pack=max(args.pack, 1),
                           chunk_tokens=args.chunk_tokens)


def write_obs(args) -> None:
    """Exit-time observability dumps (both workloads)."""
    if args.trace_out:
        obs_trace.get_tracer().write(args.trace_out)
        print(f"[launch.serve] wrote Chrome trace -> {args.trace_out}")
    if args.metrics_out:
        obs_metrics.get_registry().write(args.metrics_out)
        print(f"[launch.serve] wrote Prometheus metrics -> {args.metrics_out}")


def load_plan(args):
    """The ``--plan`` file, or None (ServeCore validates it against the
    arch before serving)."""
    if args.plan is None:
        return None
    from repro_torch.tune import ApproxPlan

    return ApproxPlan.load(args.plan)


def serve_stream(args):
    """--workload stream: frame clips through the DSP/vision pipeline.
    Returns (summary, engine)."""
    from repro_torch.serve.stream import (StreamAdapter, StreamServeEngine,
                                          make_clip)

    adapter = StreamAdapter(device=args.device)
    cfg = adapter.cfg
    plan = load_plan(args)
    qos = QoSController(
        ladder=[{"degrees": [e] * (cfg.n_layers + 1)} for e in (8, 7, 6, 5)],
        low_water=0.25, high_water=0.75, cooldown_steps=8,
    ) if args.qos else None
    registry = obs_metrics.get_registry() if args.metrics_out else None
    eng = StreamServeEngine(adapter, slots=args.slots, seed=args.seed, qos=qos,
                            plan=plan, registry=registry,
                            quality_every=args.quality_every, **resil_kwargs(args))
    t0 = time.time()
    for i in range(args.requests):
        eng.submit(make_clip(args.frames, cfg.frame, q=cfg.q, seed=i))
    done = eng.run_until_drained()
    dt = time.time() - t0
    frames = sum(len(r.out) for r in done)
    print(f"[launch.serve] stream: {len(done)} clips, {frames} frames, "
          f"{dt:.2f}s ({frames / max(dt, 1e-9):.1f} frames/s) "
          f"[device={adapter.device} "
          f"kernels={kdispatch.resolved_backend(adapter.device)}]")
    s = summarize(done, eng.stats, wall_s=dt)
    if args.metrics:
        for k, v in s.items():
            print(f"[launch.serve]   {k:24s} {v}")
        if qos is not None:
            print(f"[launch.serve]   degree ladder visits: "
                  f"{[e for _, e in list(eng.stats.degree_history)[-8:]]} (last 8)")
        print_resil(eng)
    write_obs(args)
    return s, eng


def lm_model(args, device=None, tp: int = 1, prepack: bool = True):
    """(cfg, plan, model, params) of ``--workload lm``: the arch under the
    plan's or ``--approx``'s policy on ``device`` (default ``--device``),
    seeded weights padded for ``tp``, prepacked unless ``--no-prepack`` or
    ``prepack=False``.  An encoder-only arch raises before any weight is
    made: it has no decode step."""
    cfg = get_config(args.arch)
    if cfg.encoder_only:
        raise ValueError("encoder-only arch has no decode step")
    plan = load_plan(args)
    if plan is not None:
        plan.validate_for(cfg)
        # the plan pins mode/block; its degrees are the runtime knob
        policy = plan.policy(dynamic=True)
    else:
        try:
            policy = policy_from_flag(args.approx, dynamic=args.qos)
        except ValueError as e:
            raise SystemExit(str(e))
    model = build_model(cfg, policy, device=args.device if device is None else device)
    params = model.init(seed=args.seed, tp=tp)
    if prepack and not args.no_prepack:
        # rebind: the f32 copies of packed weights are dropped here
        params = model.prepack(params)
    return cfg, plan, model, params


def lm_qos(args):
    """A fresh QoS controller (stateful: one an engine), or None."""
    return QoSController(
        ladder=[{"ebits": e} for e in (8, 7, 6, 5)],
        low_water=0.25, high_water=0.75, cooldown_steps=8,
    ) if args.qos else None


def lm_prompts(args, cfg) -> list:
    """The launcher's prompts: 2-9 tokens uniform over the vocab, seeded."""
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, cfg.vocab, int(rng.integers(2, 10)))
            for _ in range(args.requests)]


def lm_engine_kwargs(args) -> dict:
    return dict(max_len=args.max_len, eos_id=args.eos_id, greedy=args.temperature <= 0,
                temperature=max(args.temperature, 1e-6), top_k=args.top_k,
                seed=args.seed, prepack=False, quality_every=args.quality_every,
                admission=admission_from_args(args))


def serve_lm(args):
    """--workload lm: token decode.  Returns (summary, engine)."""
    cfg, plan, model, params = lm_model(args)
    qos = lm_qos(args)
    registry = obs_metrics.get_registry() if args.metrics_out else None
    eng = ServeEngine(model, params, slots=args.slots, qos=qos, plan=plan,
                      registry=registry, **lm_engine_kwargs(args), **resil_kwargs(args))
    t0 = time.time()
    for p in lm_prompts(args, cfg):
        eng.submit(p, args.new_tokens)
    done = eng.run_until_drained()
    dt = time.time() - t0
    s = summarize(done, eng.stats, wall_s=dt)
    print(f"[launch.serve] {s['requests']} reqs, {s['generated_tokens']} "
          f"generated tokens, {dt:.2f}s ({s.get('gen_tok_per_s', 0.0):.1f} gen "
          f"tok/s) [device={model.device} "
          f"kernels={kdispatch.resolved_backend(model.device)} "
          f"cache={type(eng.cache).__name__}]")
    if args.metrics:
        for k, v in s.items():
            print(f"[launch.serve]   {k:24s} {v}")
        if qos is not None:
            print(f"[launch.serve]   degree ladder visits: "
                  f"{[e for _, e in list(eng.stats.degree_history)[-8:]]} (last 8)")
        a = eng.workload.admission
        if a is not None:
            st = eng.stats
            print(f"[launch.serve]   admission: buckets {list(a.buckets)} pack "
                  f"{a.pack} chunk {a.chunk_tokens}; packed rows "
                  f"{int(st.c_packed_rows.value)}, chunk calls "
                  f"{int(st.c_chunk_calls.value)}; call shapes "
                  f"{eng.workload.trace_counts}")
        print_resil(eng)
    write_obs(args)
    return s, eng


def fleet_fault_plans(args, replicas: int):
    """Split ``--faults`` for a fleet: ``replica_loss`` is drawn by one
    fleet-level plan (the supervisor binds it to the replica count); the
    engine kinds become one plan a replica, seeded ``--fault-seed + rid``
    so the replicas see distinct storms, with ``replica_loss`` zeroed (an
    engine ignores the kind, so leaving it there would drop the rate).
    Returns (fleet plan or None, [engine plan or None] a replica)."""
    if not args.faults:
        return None, [None] * replicas
    import dataclasses

    from repro_torch.resil import FaultPlan, FaultSpec

    spec = FaultSpec.parse(args.faults)
    fleet_plan = (FaultPlan(FaultSpec(replica_loss=spec.replica_loss), seed=args.fault_seed)
                  if spec.replica_loss else None)
    espec = dataclasses.replace(spec, replica_loss=0.0)
    if not any((espec.seu_state, espec.seu_param, espec.nan, espec.spike, espec.drop)):
        return fleet_plan, [None] * replicas
    return fleet_plan, [FaultPlan(espec, seed=args.fault_seed + rid)
                        for rid in range(replicas)]


def serve_fleet(args):
    """--replicas N: N replica engines of either workload under one
    FleetSupervisor on the one device.  Returns (summary, supervisor)."""
    from repro_torch.dist.fleet import FleetSupervisor
    from repro_torch.resil import GuardConfig

    fleet_plan, engine_plans = fleet_fault_plans(args, args.replicas)
    policy = policy_from_args(args)
    registry = obs_metrics.get_registry() if args.metrics_out else None

    def engine_kwargs(rid: int) -> dict:
        kw: dict = {"slots": args.slots, "registry": registry}
        if engine_plans[rid] is not None:
            kw["faults"] = engine_plans[rid]
            kw["guards"] = GuardConfig()
        if policy is not None:
            kw["policy"] = policy
        return kw

    if args.workload == "stream":
        from repro_torch.serve.stream import StreamAdapter, StreamServeEngine, make_clip

        adapter = StreamAdapter(device=args.device)
        scfg = adapter.cfg
        ladder = [{"degrees": [e] * (scfg.n_layers + 1)} for e in (8, 7, 6, 5)]
        plan = load_plan(args)

        def build(mesh, rid):
            # QoS controllers are stateful: one a replica, never shared
            qos = QoSController(ladder=ladder, low_water=0.25, high_water=0.75,
                                cooldown_steps=8) if args.qos else None
            return StreamServeEngine(adapter, seed=args.seed, qos=qos, plan=plan,
                                     quality_every=args.quality_every,
                                     **engine_kwargs(rid))

        payloads = [make_clip(args.frames, scfg.frame, q=scfg.q, seed=i)
                    for i in range(args.requests)]
        budget, unit, device = None, "frames", adapter.device
    else:
        cfg, plan, model, params = lm_model(args)
        # one packed weight set for every replica; a parameter storm flips
        # in place, so it gets a copy a replica
        own = args.faults is not None and any(
            p is not None and p.spec.seu_param for p in engine_plans)

        def build(mesh, rid):
            p = params
            if own:
                from repro_torch.tree import tree_map

                p = tree_map(torch.clone, params)
            return ServeEngine(model, p, qos=lm_qos(args), plan=plan,
                               **lm_engine_kwargs(args), **engine_kwargs(rid))

        payloads = lm_prompts(args, cfg)
        budget, unit, device = args.new_tokens, "tokens", model.device

    sup = FleetSupervisor(build, args.replicas, faults=fleet_plan, policy=policy,
                          registry=registry, rescale_ms=args.rescale_ms,
                          route_by=args.route_by, device=device)
    t0 = time.time()
    for p in payloads:
        sup.submit(p, budget)
    done = sup.run_until_drained()
    dt = time.time() - t0
    counts = sup.status_counts()
    _fleet_report(sup, done, dt, f"{args.replicas} replica(s)", unit, device)
    s = summarize(done, None, wall_s=dt)
    s.update(replicas=args.replicas, live=len(sup.live), statuses=counts,
             rescales=len(sup.rescales))
    if args.metrics:
        _fleet_metrics(s, sup)
    write_obs(args)
    return s, sup


def _fleet_report(sup, done, dt: float, what: str, unit: str, device) -> None:
    """The fleet's report line and its last rescale (the reference's)."""
    units = sum(len(r.out) for r in done)
    status = " ".join(f"{k}={v}" for k, v in sorted(sup.status_counts().items()))
    print(f"[launch.serve] fleet: {len(done)} reqs on {what}, "
          f"{len(sup.live)} up at exit, {units} {unit}, {dt:.2f}s [{status}] "
          f"[device={device} kernels={kdispatch.resolved_backend(device)}]")
    if sup.rescales:
        last = sup.rescales[-1]
        print(f"[launch.serve]   last rescale: data={last.data} model={last.model} "
              f"idle={last.idle_devices} ({len(sup.rescales)} rescale(s))")


def _fleet_metrics(s: dict, sup) -> None:
    """``--metrics``: the summary, the fleet's events and each replica."""
    for k, v in s.items():
        print(f"[launch.serve]   {k:24s} {v}")
    events: dict = {}
    for _, name, _ in sup.resil_log:
        events[name] = events.get(name, 0) + 1
    if events:
        line = " ".join(f"{k}={v}" for k, v in sorted(events.items()))
        print(f"[launch.serve]   fleet events: {line}")
    for r in sup.replicas:
        state = "up" if r.alive else f"dead@tick{r.died_at}"
        print(f"[launch.serve]   replica {r.rid}: {state}, "
              f"{len(r.engine.done)} reqs finished")


def mesh_dims(args) -> tuple:
    """(data, model) ranks of ``--mesh`` / ``--tp``.  The stream workload
    under ``--tp``, a data axis with ``--replicas`` (a fleet replica is a
    ``(1, M)`` mesh) and ``--ring`` on a fleet of 1-wide replicas raise
    (never a silent one-device run)."""
    d, m = (int(x) for x in args.mesh.split("x")[:2])
    if args.tp:
        m = args.tp
    if m > 1 and args.workload != "lm":
        raise SystemExit(f"--tp {m}: tensor parallelism serves the lm workload")
    if d > 1 and args.workload != "lm":
        raise SystemExit(f"--mesh {args.mesh}: a serving data axis serves the lm workload")
    if d > 1 and args.slots % d:
        raise SystemExit(f"--mesh {args.mesh}: --slots {args.slots} does not divide over the "
                         f"{d} data coordinates")
    if args.replicas > 1 and d > 1:
        raise SystemExit(f"--mesh {args.mesh} with --replicas: a fleet replica is a (1, M) "
                         "mesh; give its model axis with --tp M")
    if args.replicas > 1 and args.ring and m == 1:
        raise SystemExit("--ring with --replicas needs --tp above 1: a 1-wide model axis "
                         "has no reduction to ring")
    return d, m


#: seconds a rank may wait in a collective, and the bound on a run of
#: spawned ranks (their start, weights, packs and serving)
DIST_TIMEOUT_S = 900.0


def _serve_rank(rank: int, world: int, args):
    """One rank of ``--mesh DxM`` / ``--tp M``: the sharded engine over this
    rank's shards of the seeded weights and its slots' part of the cache,
    serving the launcher's requests.  Returns (summary, engine); rank 0
    prints the report."""
    from repro_torch.dist import collectives, meshctx
    from repro_torch.serve.sharded import ShardedServeEngine

    d, m = mesh_dims(args)
    if d * m != world:
        raise SystemExit(f"--mesh {d}x{m} needs {d * m} ranks, the world has {world}")
    mesh = meshctx.set_mesh(meshctx.make_mesh((d, m), ("data", "model"),
                                              device=args.device,
                                              backend=args.dist_backend))
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    kdispatch.set_backend(args.kernels)
    if args.trace_out and rank == 0:
        obs_trace.enable()
    cfg, plan, model, params = lm_model(args, device=mesh.device, tp=m, prepack=False)
    qos = lm_qos(args)
    registry = obs_metrics.get_registry() if args.metrics_out else None
    kw = lm_engine_kwargs(args)
    kw["prepack"] = not args.no_prepack
    eng = ShardedServeEngine(model, params, mesh=mesh, ring=args.ring, slots=args.slots,
                             qos=qos, plan=plan, registry=registry, **kw,
                             **resil_kwargs(args))
    del params                       # the global float tree: each rank keeps its shards
    collectives.counter.reset()
    t0 = time.time()
    for p in lm_prompts(args, cfg):
        eng.submit(p, args.new_tokens)
    done = eng.run_until_drained()   # raises unless the ranks' streams are equal
    dt = time.time() - t0
    s = summarize(done, eng.stats, wall_s=dt)
    coll = collectives.counter.snapshot()
    ticks = max(int(eng.stats.c_steps.value), 1)
    s.update(tp=m, data=d, transport=mesh.transport, streams_equal=True,
             statuses={k: sum(r.status == k for r in done) for k in {r.status for r in done}},
             **_collectives_per_tick(coll, ticks))
    if rank == 0:
        shape = f"mesh {d}x{m}" if d > 1 else f"tp={m}"
        print(f"[launch.serve] {shape} ({mesh.transport}{', ring' if eng.ring else ''}): "
              f"{s['requests']} reqs, {s['generated_tokens']} generated tokens, {dt:.2f}s "
              f"({s.get('gen_tok_per_s', 0.0):.1f} gen tok/s), streams equal on every rank "
              f"[device={mesh.device} kernels={kdispatch.resolved_backend(mesh.device)} "
              f"cache={type(eng.cache).__name__}]")
        if args.metrics:
            for k, v in s.items():
                print(f"[launch.serve]   {k:24s} {v}")
            print_resil(eng)
        write_obs(args)
    return s, eng


def _collectives_per_tick(coll: dict, ticks: int) -> dict:
    return dict(collective_bytes_per_tick={k: v / ticks for k, v in coll["bytes"].items()},
                collective_calls_per_tick={k: v / ticks for k, v in coll["calls"].items()},
                collective_host_ms_per_tick=coll["host_ms"] / ticks,
                collective_wait_ms_per_tick=coll["wait_ms"] / ticks)


def _rank_entry(rank: int, world: int, kind: str, argd: dict) -> dict:
    """A spawned rank: ``_RANKS[kind]`` on the launcher's arguments; its
    summary goes back to the launcher."""
    return _RANKS[kind](rank, world, argparse.Namespace(**argd))[0]


def _spawn_or_join(args, world: int, kind: str):
    """Run ``_RANKS[kind]`` on ``world`` ranks: spawned here, or this
    process's rank under ``torchrun`` (whose world one engine's mesh must
    fill; a fleet takes the world it is given).  Returns (rank 0's
    summary, None) when spawned, else this rank's (summary, engine or
    supervisor)."""
    from repro_torch.dist import meshctx

    args.dist_backend = meshctx.resolve_backend(args.device, world, args.dist_backend)
    if meshctx.under_torchrun():
        rank, got = meshctx.init_from_env(device=args.device, backend=args.dist_backend,
                                          timeout_s=DIST_TIMEOUT_S)
        if kind == "serve" and got != world:
            raise SystemExit(f"{world} ranks asked for under torchrun with {got}")
        return _RANKS[kind](rank, got, args)
    threads = 1 if torch.device(args.device).type == "cpu" else 0
    results = meshctx.spawn_ranks(_rank_entry, world, timeout_s=DIST_TIMEOUT_S,
                                  backend=args.dist_backend, device=args.device,
                                  args=(kind, vars(args)), threads=threads)
    return results[0], None


def serve_tp(args, d: int, m: int):
    """``--mesh DxM`` / ``--tp M``: D x M ranks of one sharded engine.
    Returns (rank 0's summary, this process's engine or None)."""
    from repro_torch.models.transformer import check_tp_supported

    check_tp_supported(get_config(args.arch), m)
    return _spawn_or_join(args, d * m, "serve")


def _fleet_rank(rank: int, world: int, args):
    """One rank of ``--replicas N --tp M``: the FleetSupervisor over every
    replica (SPMD: this rank computes the replicas whose ranks hold it and
    shadows the others).  Returns (summary, supervisor); rank 0 prints the
    reference's fleet report."""
    from repro_torch.dist import collectives, meshctx
    from repro_torch.dist.fleet import FleetSupervisor
    from repro_torch.resil import GuardConfig
    from repro_torch.serve.sharded import ShardedServeEngine

    _, m = mesh_dims(args)
    dev = meshctx.rank_device(rank, args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kdispatch.set_backend(args.kernels)
    if args.trace_out and rank == 0:
        obs_trace.enable()
    cfg, plan, model, params = lm_model(args, device=dev, tp=m, prepack=False)
    fleet_plan, engine_plans = fleet_fault_plans(args, args.replicas)
    policy = policy_from_args(args)
    registry = obs_metrics.get_registry() if args.metrics_out else None
    kw = lm_engine_kwargs(args)
    kw["prepack"] = not args.no_prepack

    def build(mesh, rid):
        ekw: dict = {}
        if engine_plans[rid] is not None:
            ekw.update(faults=engine_plans[rid], guards=GuardConfig())
        if policy is not None:
            ekw["policy"] = policy
        return ShardedServeEngine(model, params, mesh=mesh, ring=args.ring, slots=args.slots,
                                  qos=lm_qos(args), plan=plan, registry=registry, **kw, **ekw)

    sup = FleetSupervisor(build, args.replicas, tp=m, faults=fleet_plan, policy=policy,
                          registry=registry, rescale_ms=args.rescale_ms,
                          route_by=args.route_by, device=args.device,
                          backend=args.dist_backend)
    del params                       # the global float tree: each member keeps its shards
    collectives.counter.reset()
    t0 = time.time()
    for p in lm_prompts(args, cfg):
        sup.submit(p, args.new_tokens)
    done = sup.run_until_drained()   # raises unless the ranks' streams are equal
    dt = time.time() - t0
    s = summarize(done, None, wall_s=dt)
    ticks = max(sup._ticks, 1)
    s.update(replicas=args.replicas, tp=m, live=len(sup.live), statuses=sup.status_counts(),
             rescales=len(sup.rescales), streams_equal=True,
             members=[r.rid for r in sup.replicas if r.mesh.member],
             **_collectives_per_tick(collectives.counter.snapshot(), ticks))
    if rank == 0:
        _fleet_report(sup, done, dt, f"{args.replicas} replica(s) x tp={m}", "tokens", dev)
        if args.metrics:
            _fleet_metrics(s, sup)
        write_obs(args)
    return s, sup


def serve_fleet_tp(args, m: int):
    """``--replicas N --tp M``: N x M ranks (spawned here, or this
    process's under ``torchrun``, whose world may be smaller: replicas then
    share ranks, as ``fleet_meshes`` falls back).  Returns (rank 0's
    summary, this process's supervisor or None)."""
    from repro_torch.models.transformer import check_tp_supported

    check_tp_supported(get_config(args.arch), m)
    return _spawn_or_join(args, args.replicas * m, "fleet")


#: the rank functions the launcher spawns, by kind
_RANKS = {"serve": _serve_rank, "fleet": _fleet_rank}


def run(argv=None):
    """Parse ``argv`` and serve; returns (summary dict, engine), so a caller
    can inspect the engine after the run — with ``--replicas`` above 1,
    (summary, the FleetSupervisor); on several ranks (``--tp``, ``--mesh``,
    ``--replicas N --tp M``), (rank 0's summary, None) when the ranks were
    spawned.  ``--trace-out`` enables the
    process-global tracer; ``--metrics-out`` exports the process-global
    registry, which the engine and the kernel dispatch share."""
    args = build_parser().parse_args(argv)
    d, m = mesh_dims(args)
    if args.replicas > 1 and m > 1:
        return serve_fleet_tp(args, m)
    if d * m > 1:
        return serve_tp(args, d, m)
    kdispatch.set_backend(args.kernels)
    if args.trace_out:
        obs_trace.enable()
    if args.replicas > 1:
        return serve_fleet(args)
    if args.workload == "stream":
        return serve_stream(args)
    return serve_lm(args)


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
