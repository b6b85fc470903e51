"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
traced on the meta device (the port of ``repro.launch.dryrun``).

For each cell this proves the distribution config is coherent on the
production mesh (16x16 single-pod, 2x16x16 multi-pod) and records what
one rank would hold and do there, with no card and no process group:
rank 0's shards are built on the meta device
(``launch.mesh.make_production_mesh(device="meta")``: every mesh axis a
``meshctx.MetaGroup``) and its step runs under
``dist.hlo_analysis.analyze_step``:

  train    ``init_state(tp=)`` cut by ``sharding.shard_train_state``, then
           ``train_step`` (``StepConfig(remat="full")`` unless overridden);
  prefill  the forward (``remat="dots"``) on the rank's parameters, with no
           gradient recorded;
  decode   ``serve_step`` on the rank's parameters (float; bf16 with
           ``REPRO_SERVE_BF16=1``) and the rank's ``init_cache`` shard.

Each gets the rank's rows of the cell's batch (``registry.input_specs``;
a global batch smaller than the data axes, ``long_500k``'s one row, is
held by the first data rank alone).

Differences from the reference's record: there is no HLO, so no
``xla_cost`` and no ``hlo_lines``; ``trace_s`` (the meta run's seconds)
replaces ``lower_s`` / ``compile_s``; ``memory`` is the eager report of
``analyze_step`` (``argument_bytes``, ``output_bytes``, ``peak_bytes``),
not XLA's ``memory_analysis`` (no ``temp_bytes``, ``alias_bytes`` or
``code_bytes``); ``hlo_analysis`` holds the counted dots and collectives
(with their calls), and an empty ``while_trip_counts``.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod]     # subprocess per cell
  python -m repro_torch.launch.dryrun --list
Results land in experiments/dryrun_torch/<mesh>[__<tag>]/<arch>__<shape>.json,
apart from the reference's experiments/dryrun/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "experiments" / "dryrun_torch"

ARCHS = [
    "qwen2-moe-a2.7b",
    "granite-moe-3b-a800m",
    "mistral-nemo-12b",
    "h2o-danube-1.8b",
    "qwen2.5-3b",
    "tinyllama-1.1b",
    "recurrentgemma-2b",
    "internvl2-1b",
    "hubert-xlarge",
    "mamba2-370m",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def rank_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global meta batch: dim 0 split over the data
    axes (``sharding.shard_batch``), or, when the global batch is smaller
    than the data axes, one row on the first data rank."""
    import torch

    from repro_torch.dist import meshctx, sharding

    dp = 1
    for a in meshctx.batch_axes(mesh):
        dp *= mesh.size(a)
    rows = next(iter(batch.values())).shape[0]
    if rows % dp == 0:
        return sharding.shard_batch(batch, mesh)
    if rows > dp:
        raise ValueError(f"a global batch of {rows} rows does not split over {dp} data ranks")
    return {k: torch.empty((1,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             step_overrides: dict | None = None) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist import meshctx, sharding
    from repro_torch.dist.hlo_analysis import analyze_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model, input_specs
    from repro_torch.train import step as step_mod
    from repro_torch.tree import tree_map

    cfg = get_config(arch)
    reason = cfg.skip_reason(shape_name)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "status": "skip" if reason else "pending", "skip_reason": reason,
    }
    if reason:
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta", rank=0)
    tp = mesh.size("model")
    shp = SHAPES[shape_name]
    scfg = step_mod.StepConfig(**({"remat": "full"} | (step_overrides or {})))
    with meshctx.use_mesh(mesh):
        model = build_model(cfg, device="meta")
        batch = rank_rows(input_specs(cfg, shape_name), mesh)
        if shp.kind == "train":
            state = sharding.shard_train_state(step_mod.init_state(model, tp=tp), mesh)
            rep = analyze_step(step_mod.train_step, model, scfg, state, batch, tp=tp)
        elif shp.kind == "prefill":
            params = sharding.shard_params(model.init(tp=tp), mesh=mesh)

            def fwd(params, batch):
                with torch.no_grad():
                    logits, aux = model.forward(params, batch, tp=tp, remat="dots")
                return logits

            rep = analyze_step(fwd, params, batch)
        else:
            params = sharding.shard_params(model.init(tp=tp), mesh=mesh)
            if os.environ.get("REPRO_SERVE_BF16", "0") == "1":
                params = tree_map(lambda t: t.to(torch.bfloat16)
                                  if t.dtype == torch.float32 else t, params)
            # under the mesh the cache is the rank's: its heads, its rows
            cache = model.init_cache(tp, batch["tokens"].shape[0], shp.seq_len)
            rep = analyze_step(step_mod.serve_step, model, params, cache, batch["tokens"],
                               tp=tp)
    n_total, n_active = cfg.param_count()
    rec.update(
        status="ok",
        chips=len(mesh.ranks),
        tp=tp,
        seq=shp.seq_len,
        global_batch=shp.global_batch,
        kind=shp.kind,
        trace_s=round(rep.trace_s, 2),
        memory=rep.memory.as_dict(),
        hlo_analysis=rep.as_dict(),
        params_total=n_total,
        params_active=n_active,
    )
    return rec


def cell_out_path(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> Path:
    d = OUT_DIR / (mesh_name(multi_pod) + (f"__{tag}" if tag else ""))
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{arch}__{shape_name}.json"


def list_lines() -> list:
    """The reference's ``--list`` table: each arch's runnable shapes and
    its skips with their reasons."""
    from repro_torch.configs import get_config

    lines = []
    for a in ARCHS:
        cfg = get_config(a)
        cells = [s for s, v in cfg.valid_shapes().items() if v]
        skips = [f"{s}({cfg.skip_reason(s)})"
                 for s, v in cfg.valid_shapes().items() if v is None]
        lines.append(f"{a:<24} run: {', '.join(cells)}"
                     + (f"  SKIP: {'; '.join(skips)}" if skips else ""))
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every cell as a subprocess (both meshes unless "
                         "--multi-pod/--single-pod given)")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--step-overrides", default="",
                    help='JSON StepConfig overrides, e.g. {"remat":"full"}')
    ap.add_argument("--tag", default="",
                    help="experiment tag (results in <mesh>__<tag>/)")
    args = ap.parse_args(argv)

    if args.list:
        print("\n".join(list_lines()))
        return

    if args.all:
        if args.multi_pod:
            meshes = [True]
        elif args.single_pod:
            meshes = [False]
        else:
            meshes = [False, True]
        failures = []
        for mp in meshes:
            for a in ARCHS:
                for s in SHAPE_NAMES:
                    out = cell_out_path(a, s, mp, args.tag)
                    if out.exists() and not args.force:
                        print(f"[skip-cached] {out.name}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", a, "--shape", s]
                    if mp:
                        cmd.append("--multi-pod")
                    if args.step_overrides:
                        cmd += ["--step-overrides", args.step_overrides]
                    if args.tag:
                        cmd += ["--tag", args.tag]
                    print(f"[run] {a} x {s} mesh={'2x16x16' if mp else '16x16'}",
                          flush=True)
                    r = subprocess.run(cmd, cwd=str(ROOT))
                    if r.returncode != 0:
                        failures.append((a, s, mp))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("all cells done")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --list)")
    overrides = json.loads(args.step_overrides) if args.step_overrides else None
    t0 = time.time()
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, overrides)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name(args.multi_pod),
               "status": "error", "error": traceback.format_exc()}
    out = cell_out_path(args.arch, args.shape, args.multi_pod, args.tag)
    out.write_text(json.dumps(rec, indent=2))
    if rec["status"] == "ok":
        h = rec["hlo_analysis"]
        print(f"OK {args.arch} x {args.shape}: trace {rec['trace_s']}s "
              f"({time.time() - t0:.1f}s in all), "
              f"argument/device {rec['memory']['argument_bytes'] / 2**30:.2f} GiB, "
              f"peak/device {rec['memory']['peak_bytes'] / 2**30:.2f} GiB, "
              f"dot_flops/device {h['dot_flops']:.3e}, "
              f"coll {h['collectives']['total_bytes'] / 2**30:.3f} GiB")
        print("memory:", rec["memory"])
    elif rec["status"] == "skip":
        print(f"SKIP {args.arch} x {args.shape}: {rec['skip_reason']}")
    else:
        print(rec.get("error", "error"), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
