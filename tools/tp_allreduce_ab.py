"""Time tensor-parallel serving with two ways of all-reducing a CUDA tensor
over gloo, in one call.

The workload is chip_smoke.py's phase 3s: tinyllama-1.1b at full width and
depth, tp=2 as two ranks on one card joined by a gloo group, axq8 with the
QoS ladder 8 -> 5, 16 prompts of 64-512 tokens, 32 new tokens each.  The
two transports of the exact all-reduce (wo's and down's partials, the
embedding's):

  direct  ``collectives.all_reduce`` as the port has it: the CUDA tensor
          goes to gloo, which copies it to the host and back itself;
  staged  the same sum with the copies made here: ``x.to("cpu")``, gloo's
          all-reduce on the host tensor, the result copied back.

Both wait for the card before the collective (the wait counted apart, as
``collectives.counter.wait_ms``).  The runs go direct, staged, staged,
direct, each a fresh pair of rank processes; each prints its decode tick,
tokens/s, TTFT and the collectives' host and wait milliseconds a tick, and
every run must end with every request ok and the ranks' streams equal.
Needs the card and ``nvcc``:

    python tools/tp_allreduce_ab.py [--record PATH]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ORDER = ("direct", "staged", "staged", "direct")


def staged_all_reduce(x, group):
    """``collectives.all_reduce`` with the host copies made explicitly."""
    import torch.distributed as dist

    from repro_torch.dist import collectives

    if group is None:
        return x
    t0 = collectives._start(x, group)
    collectives.counter.add("all-reduce", x.numel() * x.element_size())
    h = x.detach().to("cpu", copy=True)
    dist.all_reduce(h, group=group)
    out = h.to(x.device)
    collectives.counter.host_ms += (time.perf_counter() - t0) * 1e3
    return out


def rank_main(rank: int, world: int, job: dict, mode: str) -> dict:
    """One rank of one run: chip_smoke's 3s serve job under ``mode``."""
    import chip_smoke
    from repro_torch.dist import collectives

    if mode == "staged":
        collectives.all_reduce = staged_all_reduce
    return chip_smoke._tp_rank(rank, world, [job])[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", type=Path, default=None, help="write the runs as JSON here")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.dist import meshctx
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("no card: nothing timed")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    t = time.time()
    _build.build_all()                  # the ranks load this build
    print(f"built in {time.time() - t:.1f} s", flush=True)

    cfg = get_config("tinyllama-1.1b")
    ctx = {"prompt_range": (64, 512), "requests": 16}
    prompts = chip_smoke.tp_prompts(ctx, cfg)
    job = {"kind": "serve", "arch": cfg.name, "approx": "axq8", "block": 256, "ring": False,
           "qos": True, "max_len": 1024, "prompts": prompts, "new_tokens": 32,
           "on_card": True, "slots": 8}
    runs = []
    for mode in ORDER:
        t = time.time()
        ranks = meshctx.spawn_ranks(rank_main, chip_smoke.TP, timeout_s=600.0, backend="gloo",
                                    device="cuda", args=(job, mode), threads=0)
        wall = time.time() - t
        r0 = ranks[0]
        assert all(r["statuses"] == ["ok"] for r in ranks), f"{mode}: a request not ok"
        assert all(r["streams"] == r0["streams"] for r in ranks), f"{mode}: streams differ"
        coll, n = r0["collectives"], max(r0["steps"], 1)
        row = {"mode": mode, "wall_s": wall, "decode_tick_ms": r0["decode_tick_ms_mean"],
               "gen_tok_per_s": r0["gen_tok_per_s"], "ttft_p50_ms": r0["ttft_p50_ms"],
               "collective_host_ms_per_tick": coll["host_ms"] / n,
               "collective_wait_ms_per_tick": coll["wait_ms"] / n,
               "calls_per_tick": {k: v / n for k, v in coll["calls"].items()},
               "launches": r0["launches"]}
        runs.append(row)
        print(json.dumps(row), flush=True)
    for mode in ("direct", "staged"):
        ticks = [r["decode_tick_ms"] for r in runs if r["mode"] == mode]
        host = [r["collective_host_ms_per_tick"] for r in runs if r["mode"] == mode]
        print(f"{mode}: decode tick {ticks} ms, collectives {host} ms a tick", flush=True)
    if args.record:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
