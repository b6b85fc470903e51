"""Serving entrypoint: the continuous-batching engine on the card.

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --approx axq8 --qos --metrics
  # int8 KV cache, bucketed prefill packed four prompts to a call:
  REPRO_KV_INT8=1 python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --approx axq8 --qos --prefill-buckets auto --pack 4 --metrics
  # the plain PyTorch versions on the host, at smoke size:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b-smoke --device cpu
  # the streaming DSP workload (FIR -> blur -> gain on the PR multiplier):
  python -m repro_torch.launch.serve --workload stream --qos --metrics

Weights are random-init from ``--seed``.  ``--qos`` walks the AXQ degree
ladder ebits 8 -> 5 with load, at a fixed set of kernels (the stream
workload: the per-site ladder [e] * 3 for e = 8 -> 5; its weights are the
deterministic ``serve.stream.default_params`` and its clips ``make_clip``
from seeds 0 .. requests - 1).
``REPRO_KV_INT8=1`` serves from the int8 KV cache (there is no flag for it,
as in the reference launcher).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.approx import policy_from_flag
from repro_torch.core.dynamic import QoSController
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import build_model
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
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512,
                    help="KV-cache capacity per slot (prompt bound)")
    ap.add_argument("--approx", default="exact",
                    help="projection arithmetic: exact | axqN (block-int8 "
                         "GEMMs at N effective bits, e.g. axq8/axq6)")
    ap.add_argument("--qos", action="store_true",
                    help="drive the runtime approximation degree from load "
                         "(ladder ebits 8->5, no rebuild)")
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
    return ap


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


def serve_stream(args) -> dict:
    """--workload stream: frame clips through the DSP/vision pipeline."""
    from repro_torch.serve.stream import (StreamAdapter, StreamServeEngine,
                                          make_clip)

    adapter = StreamAdapter(device=args.device)
    cfg = adapter.cfg
    qos = QoSController(
        ladder=[{"degrees": [e] * (cfg.n_layers + 1)} for e in (8, 7, 6, 5)],
        low_water=0.25, high_water=0.75, cooldown_steps=8,
    ) if args.qos else None
    eng = StreamServeEngine(adapter, slots=args.slots, seed=args.seed, qos=qos)
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
    return s


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    kdispatch.set_backend(args.kernels)
    if args.workload == "stream":
        return serve_stream(args)
    cfg = get_config(args.arch)
    try:
        policy = policy_from_flag(args.approx, dynamic=args.qos)
    except ValueError as e:
        raise SystemExit(str(e))
    model = build_model(cfg, policy, device=args.device)
    params = model.init(seed=args.seed)
    if not args.no_prepack:
        # rebind: the f32 copies of packed weights are dropped here
        params = model.prepack(params)
    qos = QoSController(
        ladder=[{"ebits": e} for e in (8, 7, 6, 5)],
        low_water=0.25, high_water=0.75, cooldown_steps=8,
    ) if args.qos else None
    eng = ServeEngine(model, params, slots=args.slots, max_len=args.max_len,
                      eos_id=args.eos_id, greedy=args.temperature <= 0,
                      temperature=max(args.temperature, 1e-6),
                      top_k=args.top_k, seed=args.seed, qos=qos, prepack=False,
                      admission=admission_from_args(args))
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(2, 10))),
                   args.new_tokens)
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
    return s


if __name__ == "__main__":
    main()
