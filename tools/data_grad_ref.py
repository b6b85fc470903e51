"""A data-parallel mesh step's gradient against one rank's, on the CPU.

On a ``(2, 1)`` mesh each data rank differentiates its rows' share of the
loss (their log-likelihood sum over the global token count,
``models/transformer.py::lm_loss``) and ``train.step`` sums the two
shares (for two ranks one f32 addition, the same in either order).  This
tool computes those shares in one process on the port's one-rank model —
each row of the batch differentiated alone and halved (the rows hold equal
token counts, so a rank's share is exactly half its row's mean-loss
gradient) — adds them, and holds the sum against the one-rank gradient of
the whole batch, leaf by leaf, as ``chip_smoke.py`` phase 5i reads ``mu``
(one Adam step from zero: 0.1 x the clipped gradient, so the same
relative reading).  For the worst leaves it prints the entry, the two
shares there, their sum, the one-rank value and the leaf's largest entry,
and beside each leaf's reading the one-rank gradient against itself with
the batch's rows in the other order: the same sums in another order, so
the size of a rounding.  A mesh reading of that size is a rounding of the
sum; one far above it would mark a fault.  A card rounds each product of a
one-row and a two-row batch differently (its kernels follow the shapes),
where this host's do not: ``--perturb EPS`` adds the one-rank gradient with
every f32 matrix product perturbed by EPS relative (seeded normal noise,
about one f32 ulp at 1e-7) against the unperturbed one, leaf by leaf: how
far one rounding of the products moves each leaf.

    python tools/data_grad_ref.py [--arch mamba2-370m] [--layers 2]
        [--batch 2] [--seq 1024] [--seed 5] [--top 5] [--perturb 1e-7]

The defaults are phase 5i's cut (2 layers at full width, 2 x 1024 tokens
from seed 5, EXACT f32).  mamba2-370m takes about 10 GB of host memory
and a few minutes of CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--perturb", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxPolicy
    from repro_torch.models import build_model
    from repro_torch.train import step as S
    from repro_torch.tree import named_leaves

    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers, dtype="float32")
    model = build_model(cfg, ApproxPolicy(), device="cpu")
    params = S.init_state(model, seed=0, tp=1).params
    B, T = args.batch, args.seq
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, T + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}

    def grads(rows):
        part = {k: v[rows] for k, v in batch.items()}
        _, g = S.value_and_grad(model, params, part, remat="none")
        return [t.detach() for _, t in named_leaves(g)]

    names = [n for n, _ in named_leaves(params)]
    one = grads(slice(0, B))
    swapped = grads(list(range(B - 1, -1, -1)))
    perturbed = None
    if args.perturb:
        matmul, mm_op = torch.matmul, torch.Tensor.__matmul__
        noise = torch.Generator().manual_seed(0)

        def rounded(f):
            def g(a, b, *rest, **kw):
                y = f(a, b, *rest, **kw)
                if y.dtype != torch.float32:
                    return y
                return y * (1 + args.perturb * torch.randn(y.shape, generator=noise))
            return g

        torch.matmul, torch.Tensor.__matmul__ = rounded(matmul), rounded(mm_op)
        try:
            perturbed = grads(slice(0, B))
        finally:
            torch.matmul, torch.Tensor.__matmul__ = matmul, mm_op
    # each data rank's share: its rows' gradient scaled by its token share
    shares = [[t * (1.0 / B) for t in grads(slice(b, b + 1))] for b in range(B)]
    mesh = [sum(parts[1:], parts[0]) for parts in zip(*shares)]
    rows = []
    for i, name in enumerate(names):
        d = (mesh[i] - one[i]).abs()
        big = float(one[i].abs().max())
        if big == 0.0:
            continue
        j = int(d.reshape(-1).argmax())
        at = lambda t: float(t.reshape(-1)[j])
        rows.append({"leaf": name, "shape": list(one[i].shape), "rel": float(d.max()) / big,
                     "rel_rows_swapped": float((swapped[i] - one[i]).abs().max()) / big,
                     "rel_perturbed": (None if perturbed is None else
                                       float((perturbed[i] - one[i]).abs().max()) / big),
                     "entry": [int(k) for k in np.unravel_index(j, tuple(one[i].shape))],
                     "shares": [at(s[i]) for s in shares], "mesh": at(mesh[i]),
                     "one_rank": at(one[i]), "leaf_max": big,
                     "shares_abs_max": max(float(s[i].abs().max()) for s in shares)})
    rows.sort(key=lambda r: -r["rel"])
    if perturbed is not None:
        by = sorted(rows, key=lambda r: -r["rel_perturbed"])[:args.top]
        print("most moved by perturbed products: " + ", ".join(
            f"{r['leaf']} {r['rel_perturbed']:.3g}" for r in by))
    for r in rows[:args.top]:
        print(f"{r['leaf']} {tuple(r['shape'])}: max |mesh - one rank| / max |one rank| "
              f"{r['rel']:.3g} (rows swapped: {r['rel_rows_swapped']:.3g}, products "
              f"perturbed: {r['rel_perturbed']}) at "
              f"{tuple(r['entry'])}: shares {r['shares']} sum {r['mesh']!r} "
              f"one rank {r['one_rank']!r}; leaf's largest entry {r['leaf_max']:.4g}, "
              f"shares' largest {r['shares_abs_max']:.4g}")
    print("DATA_GRAD " + json.dumps({"arch": args.arch, "layers": args.layers,
                                     "batch": [B, T], "worst": rows[:args.top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
