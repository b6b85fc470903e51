"""Per-layer approximation degrees — the runtime half of an ApproxPlan.

The runtime ``degree`` of every model entry point accepts:

  * ``None``        — static policy degrees only;
  * a scalar        — one global DyFXU degree for every site (a Python int
                      or a 0-d int32 tensor);
  * an ``(n_layers + 1,)`` int32 vector — one degree per site: entry ``i``
    drives layer ``i``'s projections, entry ``n_layers`` the head site
    (unembedding).

Device degrees are sliced by view, so each layer's kernels read their
degree from device memory and moving any entry never rebuilds or syncs.
"""

from __future__ import annotations

import torch


def num_sites(cfg) -> int:
    return cfg.n_layers + 1


def split_degree(degree, n_layers: int, device=None):
    """Normalize a runtime ``degree`` into (per-layer sequence, head scalar).

    A scalar broadcasts to every layer; an ``(n_layers + 1,)`` vector splits
    into its layer part and head entry; lists become int32 tensors on
    ``device``.  Anything else raises — a mis-sized plan must not run."""
    if degree is None:
        return None, None
    if isinstance(degree, (list, tuple)):
        degree = torch.tensor([int(e) for e in degree], dtype=torch.int32,
                              device=device)
    if not isinstance(degree, torch.Tensor):
        d = int(degree)
        return [d] * n_layers, d
    if degree.ndim == 0:
        return degree.expand(n_layers), degree
    if degree.ndim != 1 or degree.shape[0] != n_layers + 1:
        raise ValueError(
            f"per-layer degree must have shape ({n_layers + 1},) — one entry "
            f"per layer plus the head site — got shape {tuple(degree.shape)}")
    return degree[:-1], degree[-1]
