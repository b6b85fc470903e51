"""Deterministic, resumable, shardable synthetic-token data pipeline (the
port of ``repro.data.pipeline``: numpy only, so every batch is bit-identical
to the reference's at every step; the trainer moves it to the device).

Design constraints for 1000+-node training (DESIGN.md §3):
  * deterministic as a function of (seed, step) — any host can regenerate any
    batch, so restarts and elastic re-sharding never need data coordination;
  * the cursor is a single integer (global step) stored in the checkpoint;
  * per-host sharding: a host materializes only its slice of the global batch
    (here single-process: the full batch).

The synthetic stream is a mixture of (a) a Markov-chain "language" with
long-range copy dependencies (so loss curves are non-trivial and approximate-
arithmetic ablations are measurable) and (b) optional file-backed token
shards (data/file_source.py style .npy) when real corpora are available.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "markov"      # markov | uniform | file
    file_path: Optional[str] = None
    # markov params
    order_mix: float = 0.7    # P(follow chain) vs uniform
    copy_prob: float = 0.15   # P(copy from 64 tokens back)


class SyntheticPipeline:
    """step -> batch dict; stateless besides the step cursor."""

    def __init__(self, cfg: DataConfig, arch: Optional[ArchConfig] = None):
        self.cfg = cfg
        self.arch = arch
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # sparse-ish Markov transition: each token has 32 likely successors
        self._succ = rng.integers(0, v, size=(min(v, 4096), 32), dtype=np.int32)
        self._file = None
        if cfg.kind == "file" and cfg.file_path:
            # host-side I/O rides the shared resilience retry helper: a
            # transient NFS/FUSE hiccup at trainer start is retried with
            # capped backoff instead of killing the run
            from repro_torch.resil import retry

            self._file = retry(
                lambda: np.load(cfg.file_path, mmap_mode="r"))

    def _markov_tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        follow = rng.random((b, s)) < self.cfg.order_mix
        copy = rng.random((b, s)) < self.cfg.copy_prob
        succ_pick = rng.integers(0, 32, size=(b, s))
        uniform = rng.integers(0, v, size=(b, s), dtype=np.int32)
        m = self._succ.shape[0]
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1] % m, succ_pick[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, uniform[:, t])
            if t >= 64:
                toks[:, t] = np.where(copy[:, t], toks[:, t - 64], toks[:, t])
        return toks

    def batch_at(self, step: int, host_slice: slice | None = None) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        b, s = c.global_batch, c.seq_len
        if self._file is not None:
            n = self._file.shape[0]
            starts = rng.integers(0, n - s - 1, size=b)
            toks = np.stack([self._file[st:st + s + 1] for st in starts]) \
                .astype(np.int32)
        elif c.kind == "uniform":
            toks = rng.integers(0, c.vocab, size=(b, s + 1), dtype=np.int32)
        else:
            toks = self._markov_tokens(rng, b, s + 1)
        if host_slice is not None:
            toks = toks[host_slice]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.arch is not None and self.arch.frontend == "audio":
            feats = rng.standard_normal(
                (toks.shape[0], s, self.arch.frontend_dim)).astype(np.float32)
            # HuBERT-style masked prediction: mask 8% spans, loss on masked
            mask = rng.random((toks.shape[0], s)) < 0.08
            labels = np.where(mask, batch["tokens"] % self.arch.vocab, -1)
            return {"frame_feats": feats, "labels": labels.astype(np.int32)}
        if self.arch is not None and self.arch.frontend == "vision":
            s_img = self.arch.frontend_tokens
            pe = rng.standard_normal(
                (toks.shape[0], s_img, self.arch.frontend_dim)).astype(np.float32)
            return {
                "patch_embeds": pe,
                "tokens": batch["tokens"][:, : s - s_img],
                "labels": batch["labels"][:, : s - s_img],
            }
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(arch: ArchConfig, seq_len: int, global_batch: int,
                  seed: int = 1234, kind: str = "markov") -> SyntheticPipeline:
    return SyntheticPipeline(
        DataConfig(vocab=arch.vocab, seq_len=seq_len, global_batch=global_batch,
                   seed=seed, kind=kind),
        arch,
    )
