"""The reference's int8-ring gradient against its exact step, on the CPU.

Runs the JAX package's ``train_step`` (``src/repro/train/step.py``) once
with ``REPRO_RING_TP`` off and once on (``ops.ring_tp``: the row-parallel
partials through ``_ring_tp_matmul`` and each column projection's dx
through ``_ring_dx_matmul``'s int8 ring), from one state on one batch, on a
host mesh of ``1 x tp`` devices, EXACT in f32.  It prints the relative
Frobenius distance of the ring step's ``mu`` (one Adam step from zero:
0.1 x the clipped gradient) from the exact step's over all leaves as one
vector, the worst leaf's, and the two losses, as ``chip_smoke.py`` phase
5i reads the port's ring on the card.  The reading is the reference's
envelope for that bound.

    python tools/ring_grad_ref.py [--arch tinyllama-1.1b] [--layers 2]
        [--batch 2] [--seq 1024] [--tp 2] [--seed 0]

Full width at 2 layers and 2 x 1024 tokens needs about 14 GB of host
memory and about a minute of CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={args.tp}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))

    import dataclasses
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.dist import meshctx
    from repro.kernels import ops
    from repro.models import build_model
    from repro.train import step as step_mod

    mesh = meshctx.make_mesh((1, args.tp), ("data", "model"))
    meshctx.set_mesh(mesh)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    model = build_model(cfg)
    state = step_mod.init_state(model, jax.random.PRNGKey(args.seed), tp=args.tp)
    scfg = step_mod.StepConfig(remat="none")
    tokens = np.random.default_rng(args.seed).integers(0, cfg.vocab,
                                                       (args.batch, args.seq))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    batch["labels"] = batch["tokens"]

    def step(ring: bool):
        with ops.ring_tp(ring):
            fn = jax.jit(partial(step_mod.train_step, model, scfg, tp=args.tp))
            new, metrics = fn(state, batch)
        return (jax.tree.map(np.asarray, new.opt.mu), float(metrics["loss"]),
                float(metrics["grad_norm"]))

    mu_x, loss_x, gn_x = step(False)
    mu_r, loss_r, gn_r = step(True)
    num = den = 0.0
    worst = (0.0, "")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(mu_x)[0],
                            jax.tree.leaves(mu_r)):
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        d, n = float(np.sum((b64 - a64) ** 2)), float(np.sum(a64 ** 2))
        num, den = num + d, den + n
        worst = max(worst, ((d / max(n, 1e-30)) ** 0.5, jax.tree_util.keystr(path)))
    print(json.dumps({"arch": args.arch, "layers": args.layers,
                      "batch": [args.batch, args.seq], "mesh": [1, args.tp],
                      "ring_grad_rel": (num / max(den, 1e-30)) ** 0.5,
                      "worst_leaf_rel": worst[0], "worst_leaf": worst[1],
                      "loss_exact": loss_x, "loss_ring": loss_r,
                      "grad_norm_exact": gn_x, "grad_norm_ring": gn_r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
