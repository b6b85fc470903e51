#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with the card (H100)
    python3 chip_smoke.py --rehearse   # the same phases on the CPU with the
                                       # plain versions, at smoke size

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernel build
     (nvcc for sm_90a from kernels/csrc, with the -Xptxas -v lines);
  2. each hand-written kernel against its plain PyTorch version on the same
     seeded inputs at the serving paths' full-width shapes (tinyllama-1.1b
     for the LM kernels; the stream tick's planes and the Ch. 7 bench
     layouts for the PR product), with the stated tolerance, timed with
     CUDA events beside its bound and, where one PyTorch call computes the
     same function, that call;
  3. the serving paths, each with the launch counts set to 0 just before
     it and read just after: tinyllama-1.1b (random weights from a seeded
     CUDA generator) under axq8 with the QoS ladder 8 -> 5, prepacked,
     served by the continuous-batching engine —
       3   exact-length admission, bf16 KV cache;
       3b  the int8 KV cache with bucketed, packed admission (warmup runs
           every bucket shape first; no new call shape after it);
       3c  the bf16 cache with bucketed, packed and chunked admission,
           long prompts among short ones;
     and the streaming DSP workload at its StreamConfig() widths —
       3d  a backlog of clips (FIR -> 3x3 blur -> gain on the PR
           multiplier) on 64 slots with the per-site QoS ladder 8 -> 5,
           every frame bit-identical to a second run of the same traffic
           through the plain versions on the card;
     every request must finish and every kernel of the path must have
     launched exactly as the layer (or stage) count predicts, while no
     plain version ran on the card;
  4. the same model cut to 2 layers (one prefill and 4 greedy decode
     steps), on the bf16 and on the int8 cache: every kernel call checked
     against its plain version on the model's own inputs, the logits of a
     kernel run against a plain run within the model's measured noise
     floor, and prompts padded to one bucket against their exact-length
     prefill;
  5. one {"kernels": [...]} line and, last, the result line.

With ``--record PATH`` every number also goes to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: published H100 SXM peaks (dense): HBM bytes/s, int8 ops/s, bf16 flops/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12

#: bytes each timed loop cycles through, to keep repeated inputs out of the
#: 50 MB L2 cache (the serving path meets its weights and caches cold)
ROTATE_BYTES = 256 << 20

SOURCES = {
    "axqmm": ("src/repro_torch/kernels/csrc/axqmm.cu", "src/repro/kernels/axqmm.py:89"),
    "axqmm_gated": ("src/repro_torch/kernels/csrc/axqmm.cu", "src/repro/kernels/axqmm.py:117"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:78"),
    "flash_decode_quant": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:109"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:117"),
    "pr_multiply": ("src/repro_torch/kernels/csrc/axmult_elem.cu",
                    "src/repro/kernels/axmult_elem.py:28"),
}

#: the row keys that name a phase-2 shape
SHAPE_KEYS = ("M", "N", "K", "B", "T", "BH", "S", "ebits", "shape")


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``ops`` on the card."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """CUDA-event timing of ``fn(i)`` over ``iters`` calls after warm-up;
    on the CPU (rehearsal) nothing is timed."""

    def __init__(self, torch, on_card: bool):
        self.torch = torch
        self.on_card = on_card

    def __call__(self, fn, iters: int = 30, warmup: int = 3):
        if not self.on_card:
            fn(0)
            return None
        torch = self.torch
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def graph(self, fn, n: int, reps: int = 5):
        """Device time of one ``fn(i)`` call: ``n`` calls captured in one
        CUDA graph and replayed, so the host's per-call work (the wrapper's
        checks, the ctypes call) is not in the time — for kernels shorter
        than their launch."""
        if not self.on_card:
            fn(0)
            return None
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(3):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(n):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * n)


def copies(make, nbytes: int, on_card: bool) -> list:
    n = max(1, min(1024, math.ceil(ROTATE_BYTES / max(nbytes, 1)))) if on_card else 1
    return [make() for _ in range(n)]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_axqmm(ctx, M, N, K, residual, degree):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

    gen = torch.Generator(device=dev).manual_seed(1000 + M + N + K)
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    bk = resolve_block(K, 256)
    pw = prepack_weight(w, bk)
    res = torch.randn(M, N, generator=gen, device=dev) if residual else None
    y = A.axqmm_packed(x, pw, degree, residual=res)
    yp = A.axqmm_packed_plain(x, pw, degree, residual=res)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-5, atol=1e-4))
    nb = K // bk
    wbytes = N * K + N * nb * 4
    pws = copies(lambda: PackedQWeight(pw.qw.clone(), pw.scales.clone()), wbytes,
                 ctx["on_card"])
    qx, sx = A.quantize_for_axqmm(x, bk)
    row = {"M": M, "N": N, "K": K, "residual": residual, "max_abs_err": err,
           "tol": "rtol 1e-5, atol 1e-4", "ok": ok}
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: A.axqmm_quantized(qx, sx, pws[i % len(pws)],
                                                      degree, residual=res))
        row["wrapper_ms"] = timer(lambda i: A.axqmm_packed(x, pws[i % len(pws)],
                                                           degree, residual=res))
        row["plain_ms"] = timer(lambda i: A.axqmm_packed_plain(
            x, pws[i % len(pws)], degree, residual=res), iters=5, warmup=1)
        # cuBLASLt's int8 GEMM wants M > 16: a decode-sized x is zero-padded
        qxl = qx if M > 16 else torch.cat([qx, qx.new_zeros(32 - M, K)])
        row["library_ms"] = timer(lambda i: torch._int_mm(qxl, pws[i % len(pws)].qw.t()))
        row["library_call"] = (f"torch._int_mm on ({qxl.shape[0]}, K) x (K, N) int8 "
                               "(no block scales or degrade)")
    nbytes = M * K + M * nb * 4 + wbytes + M * N * 4 * (2 if residual else 1)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * N * K, INT8_OPS)
    return row


def check_gated(ctx, M, N, K, degree):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

    gen = torch.Generator(device=dev).manual_seed(2000 + M + N + K)
    x = torch.randn(M, K, generator=gen, device=dev)
    bk = resolve_block(K, 256)
    pu = prepack_weight(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K), bk)
    pg = prepack_weight(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K), bk)
    y = A.axqmm_gated_packed(x, pu, pg, degree)
    yp = A.axqmm_gated_plain(x, pu, pg, degree)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-5, atol=1e-4))
    nb = K // bk
    wbytes = 2 * (N * K + N * nb * 4)
    pairs = copies(lambda: (PackedQWeight(pu.qw.clone(), pu.scales.clone()),
                            PackedQWeight(pg.qw.clone(), pg.scales.clone())),
                   wbytes, ctx["on_card"])
    qx, sx = A.quantize_for_axqmm(x, bk)
    row = {"M": M, "N": N, "K": K, "max_abs_err": err, "tol": "rtol 1e-5, atol 1e-4",
           "ok": ok}
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: A.axqmm_gated_quantized(
            qx, sx, *pairs[i % len(pairs)], degree))
        row["wrapper_ms"] = timer(lambda i: A.axqmm_gated_packed(
            x, *pairs[i % len(pairs)], degree))
        row["plain_ms"] = timer(lambda i: A.axqmm_gated_plain(
            x, *pairs[i % len(pairs)], degree), iters=5, warmup=1)
        row["library_ms"] = None
    nbytes = M * K + M * nb * 4 + wbytes + M * N * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * M * N * K, INT8_OPS)
    return row


def check_decode(ctx, B, KVr, G, D, T, nvalid, active):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as FD

    gen = torch.Generator(device=dev).manual_seed(3000 + T)
    qg = torch.randn(B, KVr, G, D, generator=gen, device=dev)
    k = torch.randn(B, T, KVr, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, KVr, D, generator=gen, device=dev).to(torch.bfloat16)
    nv = torch.tensor(nvalid, dtype=torch.int32, device=dev)
    act = torch.tensor(active, dtype=torch.int32, device=dev)
    y = FD.flash_decode(qg, k, v, nv, act)
    yp = FD.flash_decode_plain(qg, k, v, nv, act)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-4, atol=1e-4))
    free_zero = bool((y[[i for i, a in enumerate(active) if not a]] == 0).all())
    require(free_zero, "flash_decode: a free slot's output is not exactly zero")
    kv_bytes = 2 * k.numel() * 2
    caches = copies(lambda: (k.clone(), v.clone()), kv_bytes, ctx["on_card"])
    row = {"B": B, "KVr": KVr, "G": G, "D": D, "T": T, "nvalid": nvalid,
           "active": active, "max_abs_err": err, "tol": "rtol 1e-4, atol 1e-4",
           "ok": ok}
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: FD.flash_decode(qg, *caches[i % len(caches)], nv, act))
        row["plain_ms"] = timer(lambda i: FD.flash_decode_plain(
            qg, *caches[i % len(caches)], nv, act), iters=10)
        q4 = qg.reshape(B, KVr * G, 1, D).to(torch.bfloat16)
        mask = (torch.arange(T, device=dev)[None, :] < nv[:, None])[:, None, None, :]
        row["library_ms"] = timer(lambda i: F.scaled_dot_product_attention(
            q4, caches[i % len(caches)][0].transpose(1, 2),
            caches[i % len(caches)][1].transpose(1, 2), attn_mask=mask,
            enable_gqa=True))
        row["library_call"] = "F.scaled_dot_product_attention(enable_gqa, length mask)"
    live = sum(n for n, a in zip(nvalid, active) if a)
    nbytes = live * KVr * D * 2 * 2 + 2 * B * KVr * G * D * 4 + 2 * B * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * live * KVr * G * D, BF16_FLOPS)
    return row


def check_decode_quant(ctx, B, KVr, G, D, T, nvalid, active, ebits):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.attention import _q8

    gen = torch.Generator(device=dev).manual_seed(5000 + T + ebits)
    qg = torch.randn(B, KVr, G, D, generator=gen, device=dev)
    k, ks = _q8(torch.randn(B, T, KVr, D, generator=gen, device=dev))
    v, vs = _q8(torch.randn(B, T, KVr, D, generator=gen, device=dev))
    nv = torch.tensor(nvalid, dtype=torch.int32, device=dev)
    act = torch.tensor(active, dtype=torch.int32, device=dev)
    # the degree as the serving path passes it: one element of a device vector
    e = torch.tensor([8, ebits], dtype=torch.int32, device=dev)[1]
    y = FD.flash_decode_quant(qg, k, ks, v, vs, nv, act, e)
    yp = FD.flash_decode_quant_plain(qg, k, ks, v, vs, nv, act, e)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=0, atol=1e-5))
    free_zero = bool((y[[i for i, a in enumerate(active) if not a]] == 0).all())
    require(free_zero, "flash_decode_quant: a free slot's output is not exactly zero")
    cache_bytes = 2 * (k.numel() + ks.numel() * 4)
    caches = copies(lambda: (k.clone(), ks.clone(), v.clone(), vs.clone()), cache_bytes,
                    ctx["on_card"])
    row = {"B": B, "KVr": KVr, "G": G, "D": D, "T": T, "ebits": ebits, "nvalid": nvalid,
           "active": active, "max_abs_err": err, "tol": "atol 1e-5", "ok": ok}
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: FD.flash_decode_quant(
            qg, *caches[i % len(caches)], nv, act, e))
        row["plain_ms"] = timer(lambda i: FD.flash_decode_quant_plain(
            qg, *caches[i % len(caches)], nv, act, e), iters=10)
        row["library_ms"] = None
        row["library_call"] = ("none: no single PyTorch call computes the degrade, "
                               "the dequantization and the attention")
    live = sum(n for n, a in zip(nvalid, active) if a)
    nbytes = (live * KVr * (D + 4) * 2 + 2 * B * KVr * G * D * 4 + 2 * B * 4 + 4)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * live * KVr * G * D, INT8_OPS)
    return row


def check_prefill(ctx, BH, S, D, H, KVr):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dt = ctx["dtype"]
    gen = torch.Generator(device=dev).manual_seed(4000 + S)
    q = torch.randn(BH, S, D, generator=gen, device=dev).to(dt)
    k = torch.randn(BH, S, D, generator=gen, device=dev).to(dt)
    v = torch.randn(BH, S, D, generator=gen, device=dev).to(dt)
    y, steps = FA.flash_attention(q, k, v, causal=True, return_steps=True)
    yd, steps_d = FA.flash_attention(q, k, v, causal=True, skip_grid=False,
                                     return_steps=True)
    yp, steps_p = FA.flash_attention_plain(q, k, v, causal=True)
    ctx["sync"]()
    steps, steps_d = int(steps), int(steps_d)
    planned = FA.planned_grid_steps(BH, S)
    planned_d = FA.planned_grid_steps(BH, S, skip_grid=False)
    require(steps == planned == steps_p,
            f"flash_attention steps {steps} (plain {steps_p}) != planned {planned}")
    require(steps_d == planned_d, f"dense steps {steps_d} != planned {planned_d}")
    require(bool(torch.equal(y, yd)), "tri and dense schedules are not bit-identical")
    err = float((y.float() - yp.float()).abs().max())
    ok = bool(torch.allclose(y.float(), yp.float(), rtol=0, atol=1 / 64))
    # the grouped (model-layout) entry vs the (BH, S, D) entry on repeated K/V
    B = BH // H
    q4 = q.reshape(B, H, S, D).transpose(1, 2).contiguous()
    kg = k.reshape(B, H, S, D)[:, ::H // KVr].transpose(1, 2).contiguous()
    vg = v.reshape(B, H, S, D)[:, ::H // KVr].transpose(1, 2).contiguous()
    rep = lambda t: t.repeat_interleave(H // KVr, dim=2).transpose(1, 2).reshape(BH, S, D)
    yg = FA.flash_attention_grouped(q4, kg, vg, causal=True)
    yf = FA.flash_attention(q, rep(kg), rep(vg), causal=True)
    require(bool(torch.equal(yg.transpose(1, 2).reshape(BH, S, D), yf)),
            "grouped and flat flash_attention entries disagree")
    row = {"BH": BH, "S": S, "D": D, "dtype": str(dt), "steps": steps,
           "planned_steps": planned, "dense_steps": steps_d,
           "max_abs_err": err, "tol": "atol 1/64 (one bf16 ulp at |o| < 4)", "ok": ok}
    per = 4 * BH * S * D * q.element_size()
    qkv = copies(lambda: (q.clone(), k.clone(), v.clone()), per, ctx["on_card"])
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: FA.flash_attention(*qkv[i % len(qkv)], causal=True))
        row["plain_ms"] = timer(lambda i: FA.flash_attention_plain(
            *qkv[i % len(qkv)], causal=True), iters=10)
        row["library_ms"] = timer(lambda i: F.scaled_dot_product_attention(
            *(t[None] for t in qkv[i % len(qkv)]), is_causal=True))
        row["library_call"] = "F.scaled_dot_product_attention(is_causal=True)"
    row["bound_ms"], row["bound_by"] = bound(per, 4.0 * BH * D * S * (S + 1) / 2,
                                             BF16_FLOPS)
    return row


#: the PR product's knobs in phase 2: the (p, r) of these degrees (read from
#: a device vector element, as the stream engine passes them) and raw (p, r)
#: pairs as benchmarks/bench_dsp.py sweeps them
PR_DEGREES = (8, 7, 6, 5, 4, 0)
PR_RAW = ((1, 4), (2, 8), (3, 8))


def check_pr_multiply(ctx, shape, what):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import numpy as np

    from repro_torch.kernels import axmult_elem as PR
    from repro_torch.kernels import dsp

    numel = math.prod(shape)
    rng = np.random.default_rng(6000 + len(shape) + numel % 997)
    a, b = (torch.from_numpy(rng.integers(-2**15, 2**15, shape, dtype=np.int32)).to(dev)
            for _ in range(2))
    degrees = torch.tensor(PR_DEGREES, dtype=torch.int32, device=dev)
    knobs = [dsp.degree_to_pr(degrees[i]) for i in range(len(PR_DEGREES))] + list(PR_RAW)
    err = 0
    for pr in knobs:
        y = PR.pr_multiply(a, b, pr)
        yp = PR.pr_multiply_plain(a, b, pr)
        ctx["sync"]()
        err = max(err, int((y.to(torch.int64) - yp.to(torch.int64)).abs().max()))
    row = {"shape": list(shape), "what": what, "numel": numel,
           "knobs": [f"degree {e}" for e in PR_DEGREES] + [f"(p, r) = {k}" for k in PR_RAW],
           "max_abs_err": err, "tol": "exact (0)", "ok": err == 0}
    # timed at degree 5's (1, 6): ``ms`` the kernel alone (CUDA-graph replay
    # of launches on rotating inputs), ``wrapper_ms`` the eager wrapper call
    pr5 = knobs[PR_DEGREES.index(5)]
    ops = copies(lambda: (a.clone(), b.clone()), 8 * numel, ctx["on_card"])
    if ctx["on_card"]:
        row["ms"] = timer.graph(lambda i: PR.pr_multiply(*ops[i % len(ops)], pr5),
                                max(len(ops), 20))
        row["wrapper_ms"] = timer(lambda i: PR.pr_multiply(*ops[i % len(ops)], pr5))
        row["plain_ms"] = timer(lambda i: PR.pr_multiply_plain(*ops[i % len(ops)], pr5),
                                iters=10)
        row["library_ms"] = None
        row["library_call"] = "none: no PyTorch call computes a PR product"
    # two int32 reads and one int32 write per element
    row["bound_ms"], row["bound_by"] = bound(12 * numel, 0, INT8_OPS)
    return row


def phase_kernels(ctx, cfg):
    """Phase 2: every kernel against its plain version."""
    torch = ctx["torch"]
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_decode_quant": [],
            "flash_attention": [], "pr_multiply": []}
    for M in (slots, prompt):
        for N, K, res in ((qd, d, False), (kvd, d, False), (d, qd, True),
                          (d, dff, True)):
            rows["axqmm"].append(check_axqmm(ctx, M, N, K, res, deg))
    rows["axqmm"].append(check_axqmm(ctx, slots, V, d, False, deg))
    for M in (slots, prompt):
        rows["axqmm_gated"].append(check_gated(ctx, M, dff, d, deg))
    G, D, T = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, ctx["max_len"]
    nvalid = [T, (7 * T) // 10, T // 2 + 1, T // 16, 1, (3 * T) // 10, (9 * T) // 10, T // 8]
    active = [1, 1, 1, 1, 1, 0, 1, 1]
    rows["flash_decode"].append(check_decode(ctx, slots, cfg.n_kv_heads, G, D, T,
                                             nvalid[:slots], active[:slots]))
    for e in (8, 5):
        rows["flash_decode_quant"].append(check_decode_quant(
            ctx, slots, cfg.n_kv_heads, G, D, T, nvalid[:slots], active[:slots], e))
    Tr = T - 3 * T // 128                      # ragged: 1000 at T = 1024
    rows["flash_decode_quant"].append(check_decode_quant(
        ctx, slots, cfg.n_kv_heads, G, D, Tr, [min(n, Tr) for n in nvalid[:slots]],
        active[:slots], 6))
    rows["flash_attention"].append(check_prefill(ctx, cfg.n_heads, prompt, D,
                                                 cfg.n_heads, cfg.n_kv_heads))
    # bucketed prefill shapes: four packed rows at half the cache, one at all of it
    for BH, S in ((4 * cfg.n_heads, T // 2), (cfg.n_heads, T)):
        rows["flash_attention"].append(check_prefill(ctx, BH, S, D, cfg.n_heads,
                                                     cfg.n_kv_heads))
    for shape, what in ctx["pr_shapes"]:
        rows["pr_multiply"].append(check_pr_multiply(ctx, shape, what))
    for name, rs in rows.items():
        for r in rs:
            shape = {k: r[k] for k in r if k in SHAPE_KEYS}
            say(f"{name} {shape}: max_err={r['max_abs_err']:.3g} ({r['tol']}) "
                f"kernel_ms={r.get('ms')} plain_ms={r.get('plain_ms')} "
                f"library_ms={r.get('library_ms')} bound_ms={r['bound_ms']:.4g} "
                f"({r['bound_by']})")
            require(r["ok"], f"{name} {shape} disagrees with its plain version: "
                             f"max_abs_err {r['max_abs_err']}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def packed_bytes(params) -> int:
    """Bytes of every packed weight (int8 values + f32 scales): what one
    decode step must read from device memory at the least."""
    from repro_torch.kernels.qstore import PackedQWeight

    if isinstance(params, PackedQWeight):
        return params.qw.numel() + params.scales.numel() * 4
    if isinstance(params, dict):
        return sum(packed_bytes(v) for v in params.values())
    return 0


def serving_model(ctx, cfg):
    """The serving paths' model: axq8 with a dynamic degree, random weights
    from a seeded generator on the device, prepacked."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model

    model = build_model(cfg, policy_from_flag("axq8", dynamic=True), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.prepack(model.init(generator=gen))   # rebind: the f32 copies go
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    return model, params


def make_engine(ctx, model, params, *, max_len, quant=False, admission=None):
    """A QoS-driven engine (ladder ebits 8 -> 5) over the shared weights;
    ``quant`` picks the int8 KV cache (as REPRO_KV_INT8=1 does)."""
    import os

    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.lm import ServeEngine

    qos = QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)],
                        low_water=0.25, high_water=0.75, cooldown_steps=8)
    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if quant else "0"
    try:
        eng = ServeEngine(model, params, slots=ctx["slots"], max_len=max_len, qos=qos,
                          prepack=False, seed=0, admission=admission)
    finally:
        if prev is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = prev
    return eng


def drive(ctx, eng, prompts, new_tokens):
    """Serve ``prompts`` to completion with every launch count set to 0 just
    before and read just after.  Returns the requests and what was seen."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build

    ctx["sync"]()
    _build.reset_counts()
    if ctx["on_card"]:
        torch.cuda.reset_peak_memory_stats()
    st = eng.stats
    t0 = time.time()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    decode_ticks, interleaved, ticks = [], 0, 0
    max_ticks = 8 * len(prompts) * new_tokens
    while eng.queue or any(r is not None for r in eng.slot_req):
        require(ticks < max_ticks, f"the engine did not drain within {max_ticks} ticks")
        before = (st.admitted, int(st.c_chunk_calls.value), st.decode_steps)
        t = time.time()
        eng.tick()                           # a decode tick ends in a device->host read
        dt = time.time() - t
        ticks += 1
        admitted, chunks, steps = (st.admitted != before[0],
                                   int(st.c_chunk_calls.value) != before[1],
                                   st.decode_steps != before[2])
        if steps and not admitted and not chunks:
            decode_ticks.append(dt)
        interleaved += steps and chunks
    ctx["sync"]()
    wall = time.time() - t0
    require(all(r.done for r in reqs), f"{sum(not r.done for r in reqs)} requests unfinished")
    require(all(len(r.out_tokens) == new_tokens for r in reqs),
            "a request finished without all its tokens")
    seen = {"wall_s": wall, "ticks": ticks, "decode_ticks": decode_ticks,
            "interleaved_ticks": interleaved, "launches": dict(_build.launches),
            "plain": dict(_build.plain_cuda_calls),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if ctx["on_card"] else None)}
    return reqs, seen


def check_launches(ctx, label, seen, expect):
    """Every kernel launched exactly as predicted (and those of the path at
    least once), no plain version on the card."""
    launches, plain = seen["launches"], seen["plain"]
    say(f"{label} launches {launches} (expected {expect}); plain versions on the "
        f"card {plain}")
    if not ctx["on_card"]:
        return
    for name in launches:
        require(launches[name] == expect[name],
                f"{label}: kernel {name}: {launches[name]} launches, expected {expect[name]}")
        require(plain[name] == 0, f"{label}: the plain version of {name} ran on the card")
    for name, n in expect.items():
        require(n == 0 or launches[name] > 0, f"{label}: kernel {name} never launched")


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache)


def serve_summary(ctx, label, eng, reqs, seen, tick_bound_ms):
    from repro_torch.serve.metrics import summarize

    s = summarize(reqs, eng.stats, wall_s=seen["wall_s"])
    rungs = sorted({e for _, e in eng.stats.degree_history})
    dts = seen["decode_ticks"]
    out = {
        "requests": len(reqs), "wall_s": seen["wall_s"],
        "generated_tokens": s["generated_tokens"],
        "gen_tok_per_s": s["generated_tokens"] / seen["wall_s"],
        "ticks": seen["ticks"], "decode_steps": eng.stats.decode_steps,
        "prefill_calls": eng.stats.prefill_calls,
        "decode_tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
        "decode_ticks_timed": len(dts), "decode_tick_bound_ms": tick_bound_ms,
        "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p95_ms": s["ttft_p95_ms"],
        "tpot_p50_ms": s["tpot_p50_ms"], "degree_rungs_visited": rungs,
        "degree_at_first_token": s.get("degree_at_first_token"),
        "launches": seen["launches"], "max_memory_allocated": seen["max_memory_allocated"],
        "cache": type(eng.cache).__name__, "cache_bytes": cache_bytes(eng.cache),
    }
    say(f"{label}: {len(reqs)} requests, {out['generated_tokens']} tokens in "
        f"{seen['wall_s']:.3f} s ({out['gen_tok_per_s']:.1f} tok/s); decode tick "
        f"{out['decode_tick_ms_mean']:.3f} ms over {len(dts)} ticks vs bound "
        f"{tick_bound_ms:.4f} ms; TTFT p50 {s['ttft_p50_ms']} ms p95 {s['ttft_p95_ms']} ms; "
        f"max_memory_allocated {out['max_memory_allocated']}; {out['cache']} "
        f"{out['cache_bytes']} bytes; rungs {rungs}")
    return out


def phase_serve(ctx, cfg, model, params):
    """Phase 3: exact-length admission on the bf16 cache."""
    import numpy as np

    wbytes = packed_bytes(params)
    rng = np.random.default_rng(0)
    lo, hi = ctx["prompt_range"]
    warm = make_engine(ctx, model, params, max_len=ctx["max_len"])   # library loads, allocator
    warm.submit(rng.integers(0, cfg.vocab, lo), 2)
    warm.run_until_drained()
    del warm
    eng = make_engine(ctx, model, params, max_len=ctx["max_len"])
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
               for _ in range(ctx["requests"])]
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"phase 3: the QoS degree never moved: {rungs}")
    steps, prefills, L = eng.stats.decode_steps, eng.stats.prefill_calls, cfg.n_layers
    check_launches(ctx, "phase 3", seen, {
        "axqmm": (5 * L + 1) * (steps + prefills), "axqmm_gated": L * (steps + prefills),
        "flash_decode": L * steps, "flash_decode_quant": 0, "flash_attention": L * prefills,
        "pr_multiply": 0})
    out = serve_summary(ctx, "phase 3 (exact admission, bf16 cache)", eng, reqs, seen,
                        wbytes / HBM_BPS * 1e3)
    out.update(arch=cfg.name, new_tokens=ctx["new_tokens"], prompt_range=[lo, hi],
               slots=ctx["slots"], max_len=ctx["max_len"], packed_weight_bytes=wbytes)
    return out, prompts


def phase_serve_int8(ctx, cfg, model, params, prompts):
    """Phase 3b: the int8 KV cache with bucketed, packed admission (this
    slice's main path), on phase 3's traffic."""
    from repro_torch.models.transformer import init_lm_cache
    from repro_torch.serve.admission import AdmissionConfig

    t = time.time()
    eng = make_engine(ctx, model, params, max_len=ctx["max_len"], quant=True,
                      admission=AdmissionConfig(pack=4))
    ctx["sync"]()
    warmup_s = time.time() - t
    wl = eng.workload
    shapes = dict(wl.trace_counts)
    require(shapes["prefill_batch"] == len(wl.admission.buckets) and shapes["step"] == 1,
            f"phase 3b: warmup ran {shapes}, expected {len(wl.admission.buckets)} bucket "
            "shapes and one step shape")
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    require(wl.trace_counts == shapes,
            f"phase 3b: a request met a new call shape: {wl.trace_counts} vs {shapes}")
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"phase 3b: the QoS degree never moved: {rungs}")
    steps, calls, L = eng.stats.decode_steps, eng.stats.prefill_calls, cfg.n_layers
    check_launches(ctx, "phase 3b", seen, {
        "axqmm": (5 * L + 1) * steps + 5 * L * calls, "axqmm_gated": L * (steps + calls),
        "flash_decode": 0, "flash_decode_quant": L * steps, "flash_attention": L * calls,
        "pr_multiply": 0})
    out = serve_summary(ctx, "phase 3b (int8 cache, buckets, pack 4)", eng, reqs, seen,
                        packed_bytes(params) / HBM_BPS * 1e3)
    bf16 = init_lm_cache(cfg, 1, ctx["slots"], ctx["max_len"], device="meta")
    out.update(bf16_cache_bytes=cache_bytes(bf16), warmup_s=warmup_s,
               buckets=list(wl.admission.buckets), pack=wl.admission.pack,
               call_shapes=shapes, packed_rows=int(eng.stats.c_packed_rows.value),
               bucket_flushes={k[0]: int(c.value) for k, c in
                               eng.stats.c_admit_bucket.children.items()})
    say(f"phase 3b: warmup {warmup_s:.2f} s over {shapes}; int8 cache "
        f"{out['cache_bytes']} bytes vs {out['bf16_cache_bytes']} for bf16; "
        f"{calls} bucketed calls {out['bucket_flushes']}, {out['packed_rows']} packed rows")
    return out


def phase_serve_chunked(ctx, cfg, model, params):
    """Phase 3c: the bf16 cache with bucketed, packed and chunked admission:
    long prompts among short ones."""
    import numpy as np

    from repro_torch.serve.admission import AdmissionConfig

    rng = np.random.default_rng(3)
    (llo, lhi), (slo, shi) = ctx["long_range"], ctx["short_range"]
    n_long, n_short = ctx["n_long"], ctx["n_short"]
    long_at = set(rng.choice(n_long + n_short, n_long, replace=False).tolist())
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(llo, lhi + 1)) if i in long_at
                            else int(rng.integers(slo, shi + 1)))
               for i in range(n_long + n_short)]
    eng = make_engine(ctx, model, params, max_len=ctx["max_len_chunked"],
                      admission=AdmissionConfig(pack=4, chunk_tokens=ctx["chunk_tokens"]))
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    st, L = eng.stats, cfg.n_layers
    steps, chunks = st.decode_steps, int(st.c_chunk_calls.value)
    flushes = sum(int(c.value) for c in st.c_admit_bucket.children.values())
    require(chunks >= n_long, f"phase 3c: {chunks} chunk calls for {n_long} long prompts")
    require(seen["interleaved_ticks"] > 0, "phase 3c: no chunk call shared a tick with decode")
    check_launches(ctx, "phase 3c", seen, {
        "axqmm": (5 * L + 1) * steps + 5 * L * (flushes + chunks),
        "axqmm_gated": L * (steps + flushes + chunks), "flash_decode": L * steps,
        "flash_decode_quant": 0, "flash_attention": L * flushes, "pr_multiply": 0})
    out = serve_summary(ctx, "phase 3c (bf16 cache, buckets, pack 4, chunks)", eng, reqs,
                        seen, packed_bytes(params) / HBM_BPS * 1e3)
    short = [r.ttft * 1e3 for i, r in enumerate(reqs) if i not in long_at]
    long_ = [r.ttft * 1e3 for i, r in enumerate(reqs) if i in long_at]
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None
    out.update(chunk_tokens=ctx["chunk_tokens"], chunk_calls=chunks, bucket_flushes=flushes,
               interleaved_ticks=seen["interleaved_ticks"], long_prompts=n_long,
               short_prompts=n_short, prompt_lens=[int(p.size) for p in prompts],
               short_ttft_p50_ms=pct(short, 50), short_ttft_p95_ms=pct(short, 95),
               long_ttft_p50_ms=pct(long_, 50), max_len=ctx["max_len_chunked"])
    say(f"phase 3c: {chunks} chunk calls, {flushes} bucketed calls, "
        f"{seen['interleaved_ticks']} ticks with both a chunk call and a decode step; "
        f"short-request TTFT p50 {out['short_ttft_p50_ms']} ms p95 "
        f"{out['short_ttft_p95_ms']} ms; long-request TTFT p50 {out['long_ttft_p50_ms']} ms")
    return out


def _stream_engine(ctx, cfg):
    """A stream engine on the card with the per-site QoS ladder [e] * 3,
    e = 8 -> 5 (as ``launch.serve --workload stream --qos`` builds it)."""
    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.stream import StreamAdapter, StreamServeEngine

    qos = QoSController(ladder=[{"degrees": [e] * (cfg.n_layers + 1)} for e in (8, 7, 6, 5)],
                        low_water=0.25, high_water=0.75, cooldown_steps=8)
    return StreamServeEngine(StreamAdapter(cfg, device=ctx["dev"]), slots=ctx["stream_slots"],
                             qos=qos)


def _serve_clips(ctx, cfg, clips, backend):
    """Serve ``clips`` (all submitted at t = 0) on a fresh engine through
    ``backend``, with every launch count set to 0 just before and read just
    after.  Returns the engine, the requests and what was seen."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build

    with _backend(backend):
        warm = _stream_engine(ctx, cfg)               # allocator, first launches
        warm.submit(clips[0][:2])
        warm.run_until_drained()
        del warm
        eng = _stream_engine(ctx, cfg)
        ctx["sync"]()
        _build.reset_counts()
        base = 0
        if ctx["on_card"]:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        st = eng.stats
        t0 = time.time()
        reqs = [eng.submit(c) for c in clips]
        step_ticks, ticks = [], 0
        max_ticks = 4 * sum(len(c) for c in clips)
        while eng.queue or any(r is not None for r in eng.slot_req):
            require(ticks < max_ticks, f"the stream engine did not drain within {max_ticks} ticks")
            before = (st.admitted, st.decode_steps)
            t = time.time()
            eng.tick()                           # a step tick ends in a device->host read
            dt = time.time() - t
            ticks += 1
            if st.decode_steps != before[1] and st.admitted == before[0]:
                step_ticks.append(dt)
        ctx["sync"]()
        wall = time.time() - t0
    seen = {"wall_s": wall, "ticks": ticks, "step_ticks": step_ticks,
            "launches": dict(_build.launches), "plain": dict(_build.plain_cuda_calls),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if ctx["on_card"] else None),
            "memory_allocated_before": base if ctx["on_card"] else None}
    return eng, reqs, seen


def _profile_ticks(ctx, cfg, clips, n):
    """Device time inside ``n`` steady stream ticks (every slot busy), from
    a ``torch.profiler`` trace: the kernels' summed device time per tick
    against the tick's host wall time, and the largest kernels by name."""
    torch = ctx["torch"]
    from torch.profiler import ProfilerActivity, profile

    eng = _stream_engine(ctx, cfg)
    for c in clips[:ctx["stream_slots"]]:
        eng.submit(c)
    for _ in range(2):                        # admission tick + one more
        eng.tick()
    ctx["sync"]()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx["on_card"] else [])
    with profile(activities=acts) as prof:
        t = time.time()
        for _ in range(n):
            eng.tick()
        ctx["sync"]()
        wall = time.time() - t
    # the device-side events only: an operator's own entry repeats its
    # kernels' device time
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_us = sum(r[2] for r in rows)
    top = sorted(rows, key=lambda r: -r[2])[:6]
    return {"ticks": n, "tick_wall_ms": 1e3 * wall / n, "device_us_per_tick": dev_us / n,
            "device_busy_share": dev_us * 1e-6 / wall if wall > 0 else None,
            "top_kernels": [{"name": k, "calls": c, "device_us": t} for k, c, t in top]}


def phase_stream(ctx):
    """Phase 3d: the streaming DSP workload at the repo's StreamConfig()
    widths (256-sample frames, 8 FIR taps, 16x16 tiles, Q12): a backlog of
    clips on ``stream_slots`` slots with the QoS ladder 8 -> 5 over the three
    sites.  One ``pr_multiply`` launch per stage, three per tick; the frames
    and the degree history must equal a second run of the same traffic
    through the plain versions on the card.  Then the whole-clip forward's
    PSNR against the exact pipeline at uniform degrees 8..4."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.error_analysis import psnr_db
    from repro_torch.kernels import _build
    from repro_torch.serve.metrics import summarize
    from repro_torch.serve.stream import StreamAdapter, StreamConfig, make_clip

    cfg = StreamConfig()
    slots, n_clips, n_frames = ctx["stream_slots"], ctx["stream_clips"], ctx["stream_frames"]
    clips = [make_clip(n_frames, cfg.frame, q=cfg.q, seed=i) for i in range(n_clips)]
    kernels = "cuda" if ctx["on_card"] else "auto"
    eng, reqs, seen = _serve_clips(ctx, cfg, clips, kernels)
    require(all(r.done and len(r.out) == n_frames for r in reqs),
            f"phase 3d: a clip did not return all {n_frames} frames")
    steps = eng.stats.decode_steps
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect["pr_multiply"] = 3 * steps
    check_launches(ctx, "phase 3d", seen, expect)
    hist = [(t, tuple(d)) for t, d in eng.stats.degree_history]
    rungs = sorted({d for _, d in hist})
    require(len(rungs) > 1, f"phase 3d: the QoS degree never moved: {rungs}")
    peng, preqs, pseen = _serve_clips(ctx, cfg, clips, "torch")
    require([(t, tuple(d)) for t, d in peng.stats.degree_history] == hist,
            "phase 3d: the plain run's degree history differs from the kernel run's")
    same = all(len(r.out) == len(q.out) and all(np.array_equal(x, y) for x, y in
                                                 zip(r.out, q.out))
               for r, q in zip(reqs, preqs))
    require(same, "phase 3d: the kernel run's frames differ from the plain run's")

    s = summarize(reqs, eng.stats, wall_s=seen["wall_s"])
    frames = sum(len(r.out) for r in reqs)
    dts = seen["step_ticks"]
    tick_bound = 18 * slots * cfg.frame * 12 / HBM_BPS * 1e3
    out = {"config": dataclasses.asdict(cfg), "slots": slots, "clips": n_clips,
           "frames_per_clip": n_frames, "frames": frames, "wall_s": seen["wall_s"],
           "frames_per_s": frames / seen["wall_s"], "ticks": seen["ticks"],
           "step_ticks": steps, "tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
           "ticks_timed": len(dts), "tick_bound_ms": tick_bound,
           "ttff_p50_ms": s["ttft_p50_ms"], "ttff_p95_ms": s["ttft_p95_ms"],
           "e2e_p50_ms": s["e2e_p50_ms"], "e2e_p95_ms": s["e2e_p95_ms"],
           "degree_rungs_visited": [list(r) for r in rungs],
           "degree_at_first_frame": s.get("degree_at_first_token"),
           "launches": seen["launches"], "max_memory_allocated": seen["max_memory_allocated"],
           "memory_allocated_before": seen["memory_allocated_before"],
           "plain_run": {"wall_s": pseen["wall_s"], "frames_per_s": frames / pseen["wall_s"],
                         "tick_ms_mean": 1e3 * sum(pseen["step_ticks"])
                         / max(len(pseen["step_ticks"]), 1)},
           "frames_bit_identical_to_plain": same}
    say(f"phase 3d (stream, {slots} slots, {n_clips} clips x {n_frames} frames): "
        f"{frames} frames in {seen['wall_s']:.3f} s ({out['frames_per_s']:.1f} frames/s; "
        f"plain versions {out['plain_run']['frames_per_s']:.1f}); tick "
        f"{out['tick_ms_mean']:.4f} ms over {len(dts)} ticks vs bound {tick_bound:.4g} ms; "
        f"TTFF p50 {s['ttft_p50_ms']} ms p95 {s['ttft_p95_ms']} ms; e2e p50 "
        f"{s['e2e_p50_ms']} ms p95 {s['e2e_p95_ms']} ms; rungs {rungs}; "
        f"max_memory_allocated {out['max_memory_allocated']} (before the run "
        f"{out['memory_allocated_before']}); frames bit-identical to "
        f"the plain run: {same}")

    # whole-clip forward against the exact pipeline (outside the counted run)
    ad = StreamAdapter(cfg, device=dev)
    params = ad.init_params()
    batch = {"frames": np.stack([make_clip(ctx["psnr_frames"], cfg.frame, q=cfg.q, seed=i)
                                 for i in range(ctx["psnr_clips"])])}
    with _backend(kernels):
        exact, _ = ad.forward(params, batch, None)
    psnr = {}
    for e in (8, 7, 6, 5, 4):
        deg = torch.tensor([e] * (cfg.n_layers + 1), dtype=torch.int32, device=dev)
        with _backend(kernels):
            yk, _ = ad.forward(params, batch, deg)
        with _backend("torch"):
            yp, _ = ad.forward(params, batch, deg)
        require(bool(torch.equal(yk, yp)),
                f"phase 3d: forward at degree {e}: kernel and plain differ")
        require(bool(torch.isfinite(yk).all()) and tuple(yk.shape) == tuple(exact.shape),
                f"phase 3d: forward at degree {e}: non-finite or misshapen output")
        psnr[e] = psnr_db(exact.cpu().numpy(), yk.cpu().numpy())
    require(bool(torch.equal(exact, ad.forward(params, batch, torch.full(
        (3,), 8, dtype=torch.int32, device=dev))[0])), "phase 3d: degree 8 is not exact")
    out["forward_psnr_db"] = psnr
    with _backend(kernels):
        out["profile"] = prof = _profile_ticks(ctx, cfg, clips,
                                               min(16, n_frames - 2))
    say(f"phase 3d: profiled {prof['ticks']} steady ticks: {prof['tick_wall_ms']:.4f} ms "
        f"wall per tick, {prof['device_us_per_tick']:.2f} us of device kernel time per "
        f"tick (busy share {prof['device_busy_share']}); largest: "
        + "; ".join(f"{r['name'][:60]} x{r['calls']} {r['device_us']:.1f} us"
                    for r in prof["top_kernels"]))
    say(f"phase 3d: forward PSNR vs the exact pipeline ({ctx['psnr_clips']} clips x "
        f"{ctx['psnr_frames']} frames), kernel == plain bit for bit: "
        + ", ".join(f"degree {e}: {v:.3f} dB" for e, v in psnr.items()))
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel-vs-plain on the whole model
# ---------------------------------------------------------------------------


#: phase 4 runs: (dtype, runtime degree, int8 KV cache)
MODEL_RUNS = (("float32", [8, 6, 7], False), ("bfloat16", 8, False),
              ("float32", [8, 6, 7], True), ("bfloat16", 8, True))

#: relative perturbation of the plain run's projection outputs that measures
#: the model's own noise floor (phase 4)
NOISE_EPS = 1e-6


def _call_tols(dtype):
    """(rtol, atol) of each kernel against its plain version on the model's
    own inputs: the GEMMs at the qmm oracle tolerance (observed
    bit-identical); attention to f32 summation order, or one bf16 ulp at
    |o| < 4 for bf16 outputs; the int8-cache decode at 1e-5 abs, the
    reference's kernel-vs-jnp tolerance."""
    attn = (1e-4, 1e-4) if dtype == "float32" else (0.0, 1 / 64)
    return {"axqmm": (1e-5, 1e-4), "axqmm_gated": (1e-5, 1e-4),
            "flash_decode": (1e-4, 1e-4), "flash_decode_quant": (0.0, 1e-5),
            "flash_attention": attn}


@contextlib.contextmanager
def _patched(pairs):
    """Temporarily replace module attributes: pairs of (module, name, fn)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, fn in pairs:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _checked_kernels(ctx, dtype, report):
    """Each kernel wrapper, wrapped to also run its plain version on the
    same inputs and record the worst difference and any call outside the
    tolerance into ``report`` {name: [calls, max_err, bad_calls]}."""
    torch = ctx["torch"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD

    tols = _call_tols(dtype)

    def checked(name, kernel, plain):
        def call(*a, **kw):
            y = kernel(*a, **kw)
            yp = plain(*a, **kw)
            rtol, atol = tols[name]
            row = report.setdefault(name, [0, 0.0, 0])
            row[0] += 1
            row[1] = max(row[1], float((y.float() - yp.float()).abs().max()))
            row[2] += not bool(torch.allclose(y.float(), yp.float(), rtol=rtol, atol=atol))
            return y
        return call

    return _patched([
        (A, "axqmm_packed", checked("axqmm", A.axqmm_packed, A.axqmm_packed_plain)),
        (A, "axqmm_gated_packed", checked("axqmm_gated", A.axqmm_gated_packed,
                                          A.axqmm_gated_plain)),
        (FD, "flash_decode", checked("flash_decode", FD.flash_decode,
                                     FD.flash_decode_plain)),
        (FD, "flash_decode_quant", checked("flash_decode_quant", FD.flash_decode_quant,
                                           FD.flash_decode_quant_plain)),
        (dispatch, "flash_attention_grouped",
         checked("flash_attention", dispatch.flash_attention_grouped,
                 FA.flash_attention_grouped_plain)),
    ])


def _perturbed_projections(ctx, eps):
    """The plain AXQ projections with their f32 outputs perturbed by
    ``eps`` relative (seeded noise) before the cast to the working dtype,
    so the perturbation survives a bf16 rounding where it crosses one."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.kernels import axqmm as A

    plain = A.axqmm_packed_plain
    gen = torch.Generator(device=dev).manual_seed(7)

    def call(*a, **kw):
        y = plain(*a, **kw)
        return y * (1 + eps * torch.randn(y.shape, generator=gen, device=dev))

    return _patched([(A, "axqmm_packed_plain", call)])


@contextlib.contextmanager
def _backend(name):
    from repro_torch.kernels import dispatch

    dispatch.set_backend(name)
    try:
        yield
    finally:
        dispatch.set_backend(None)


def _model_logits(ctx, model, params, prompt, deg, backend, feed, quant):
    """One prefill and 4 decode steps of slot 1 (slot 0 free); returns the
    5 logit rows and the greedy tokens fed."""
    torch, dev = ctx["torch"], ctx["dev"]
    with _backend(backend):
        B, slot = 2, 1
        cache = model.init_cache(1, B, prompt.shape[0] + 8, quant=quant)
        lg, cache = model.prefill(params, cache, prompt, slot, degree=deg)
        logits = [lg[0]]
        toks = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        active = torch.tensor([False, True], device=dev)
        fed = []
        for t in range(4):
            fed.append(int(logits[-1].argmax()) if feed is None else feed[t])
            toks[slot, 0] = fed[-1]
            lg, cache = model.decode_step(params, cache, toks, degree=deg,
                                          active=active)
            logits.append(lg[slot, 0])
        return torch.stack(logits).float(), fed


def _padded_vs_exact(ctx, model, params, deg, backend, quant, vocab):
    """Prompts of ``ctx["padded_lens"]`` prefilled one by one at their exact
    lengths, and packed into one bucketed call padded to the next power of
    two: the largest difference of each cache field, and of the logits of
    one decode step from each cache."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    lens = ctx["padded_lens"]
    Pb = 1 << (max(lens) - 1).bit_length()
    rng = np.random.default_rng(2)
    rows = [torch.as_tensor(rng.integers(0, vocab, n), device=dev) for n in lens]
    toks = torch.zeros((len(lens), Pb), dtype=torch.int64, device=dev)
    for i, r in enumerate(rows):
        toks[i, :r.numel()] = r
    nxt = torch.as_tensor(rng.integers(0, vocab, (len(lens), 1)), device=dev)
    with _backend(backend):
        exact = model.init_cache(1, len(lens), Pb, quant=quant)
        for i, r in enumerate(rows):
            model.prefill(params, exact, r, i, degree=deg)
        padded = model.prefill_batch(params, model.init_cache(1, len(lens), Pb, quant=quant),
                                     toks, list(range(len(lens))), list(lens), degree=deg)
        fields = {f: float((getattr(exact, f).float() - getattr(padded, f).float())
                           .abs().max()) for f in exact._fields}
        le, _ = model.decode_step(params, exact, nxt, degree=deg)
        lp, _ = model.decode_step(params, padded, nxt, degree=deg)
    ctx["sync"]()
    return {"lens": list(lens), "bucket": Pb, "cache_max_abs_diff": fields,
            "bit_identical": all(v == 0 for v in fields.values()),
            "logits_max_abs_diff": float((le - lp).abs().max())}


def phase_model(ctx, cfg):
    """Phase 4: kernel vs plain on the model cut to 2 layers, on the bf16
    and on the int8 cache.

    (a) Every kernel call of a kernel run is checked against its plain
    version on the same (the model's own) inputs, at the stated tolerance.
    (b) The logits of the kernel run and of a plain run are compared.  AXQ
    makes the model chaotic in its inputs: a difference in the last f32 bit
    can move an int8 activation code, whose step then moves every later
    code.  So (b) is held to the model's own noise floor, measured in this
    run as the change of the plain logits when the plain projections' f32
    outputs are perturbed by NOISE_EPS relative: the kernel run may differ
    from the plain run by at most 4x that floor.
    (c) Bucketed prefill against exact-length prefill through the kernels:
    the attention tile width follows the padded length, so the online
    softmax may sum in another order; the difference is reported, and the
    next decode step's logits are held to the same 4x floor."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model

    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, ctx["prefill_m"]), device=dev)
    out = []
    for dtype, degree, quant in MODEL_RUNS:
        label = f"2-layer {dtype} at degree {degree}, {'int8' if quant else 'bf16'} cache"
        cut = dataclasses.replace(cfg, n_layers=2, dtype=dtype)
        model = build_model(cut, policy_from_flag("axq8", dynamic=True), device=dev)
        params = model.prepack(model.init(seed=1))
        deg = torch.tensor(degree, dtype=torch.int32, device=dev)
        # the rehearsal drives the same sequence with `auto`, which routes
        # the CPU tensors to the plain versions (no kernel call to check)
        kernels = "cuda" if ctx["on_card"] else "auto"
        calls: dict = {}
        with _checked_kernels(ctx, dtype, calls):
            lk, fed = _model_logits(ctx, model, params, prompt, deg, kernels, None, quant)
        # both plain runs decode the kernel run's greedy tokens
        lp, _ = _model_logits(ctx, model, params, prompt, deg, "torch", fed, quant)
        with _perturbed_projections(ctx, NOISE_EPS):
            ln, _ = _model_logits(ctx, model, params, prompt, deg, "torch", fed, quant)
        ctx["sync"]()
        diff = float((lk - lp).abs().max())
        floor = float((ln - lp).abs().max())
        tol = 4 * max(floor, 1e-3)
        pve = _padded_vs_exact(ctx, model, params, deg, kernels, quant, cfg.vocab)
        say(f"{label}: kernel calls vs plain on the model's inputs "
            f"{{name: [calls, max_err, outside tolerance]}} {calls}")
        say(f"{label}: logits kernels vs plain max |diff| {diff:.4g}; the plain model's "
            f"own change under a {NOISE_EPS:g} relative perturbation of its projections "
            f"{floor:.4g}; tolerance {tol:.4g}")
        say(f"{label}: padded (bucket {pve['bucket']}) vs exact prefill of lengths "
            f"{pve['lens']}: bit-identical {pve['bit_identical']}, cache max |diff| "
            f"{pve['cache_max_abs_diff']}, next-step logits max |diff| "
            f"{pve['logits_max_abs_diff']:.4g}")
        decode = "flash_decode_quant" if quant else "flash_decode"
        for name in ("axqmm", "axqmm_gated", decode, "flash_attention"):
            n, err, bad = calls.get(name, (0, 0.0, 0))
            require(n > 0 or not ctx["on_card"], f"{label}: {name} never ran")
            require(bad == 0, f"{label}: {bad} of {n} {name} calls outside "
                              f"tolerance of the plain version (max err {err})")
        require(diff <= tol, f"{label}: kernel-vs-plain logits differ by {diff} "
                             f"(noise floor {floor})")
        require(pve["logits_max_abs_diff"] <= tol,
                f"{label}: padded-vs-exact prefill moves the next logits by "
                f"{pve['logits_max_abs_diff']} (noise floor {floor})")
        out.append({"dtype": dtype, "degree": degree, "int8_cache": quant,
                    "kernel_calls": calls, "max_abs_logit_diff": diff,
                    "noise_floor": floor, "noise_eps": NOISE_EPS, "tolerance": tol,
                    "max_abs_logit": float(lp.abs().max()), "padded_vs_exact": pve})
    return out


# ---------------------------------------------------------------------------


def write_record(path, record) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU with the plain versions at "
                         "smoke size (prints no result line)")
    ap.add_argument("--record", type=Path, default=None, metavar="PATH",
                    help="also write every number to this JSON file")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks; prints "
                         "no result line)")
    args = ap.parse_args(argv)
    if not (HERE / "src" / "repro_torch").is_dir():
        say("FAIL: src/repro_torch not found next to this script (run it from "
            "a checkout of the repository)")
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch

    on_card = not args.rehearse
    if on_card and not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false: no card, no result")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        say(f"nvidia-smi: {'; '.join(smi)}")
        say(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind} "
            f"x{count}, capability {torch.cuda.get_device_capability(0)}")
        t = time.time()
        _build.build_all()
        say(f"built {sorted(_build.SOURCES)} in {time.time() - t:.1f} s")
        for name, lines in _build.ptxas_log.items():
            for ln in lines:
                say(f"ptxas[{name}] {ln.strip()}")
        ctx = {"torch": torch, "dev": torch.device("cuda", 0), "on_card": True,
               "sync": torch.cuda.synchronize, "dtype": torch.bfloat16,
               "slots": 8, "prefill_m": 255, "max_len": 1024, "requests": 16,
               "new_tokens": 32, "prompt_range": (64, 512),
               "chunk_tokens": 256, "max_len_chunked": 1056, "n_long": 4,
               "long_range": (700, 1000), "n_short": 12, "short_range": (64, 200),
               "padded_lens": (20, 60, 255, 500),
               "stream_slots": 64, "stream_clips": 256, "stream_frames": 32,
               "psnr_clips": 4, "psnr_frames": 8,
               "pr_shapes": (((8, 64, 256), "stream tick: FIR planes, 64 slots"),
                             ((9, 64, 256), "stream tick: 3x3 blur planes"),
                             ((1, 64, 256), "stream tick: 1x1 gain plane"),
                             ((32, 4064), "Ch. 7: 32-tap FIR over 4096 samples"),
                             ((25, 1, 128, 128), "Ch. 7: 5x5 blur on 128x128"),
                             ((1_000_003,), "ragged"),
                             ((1 << 24,), "flat 2^24"))}
        cfg = get_config("tinyllama-1.1b")
    else:
        torch.set_num_threads(4)
        smi, kind, count = ["cpu rehearsal"], "cpu", 0
        ctx = {"torch": torch, "dev": torch.device("cpu"), "on_card": False,
               "sync": lambda: None, "dtype": torch.float32,
               "slots": 4, "prefill_m": 37, "max_len": 64, "requests": 6,
               "new_tokens": 4, "prompt_range": (8, 40),
               "chunk_tokens": 16, "max_len_chunked": 64, "n_long": 2,
               "long_range": (40, 56), "n_short": 4, "short_range": (8, 20),
               "padded_lens": (3, 9, 20, 37),
               "stream_slots": 4, "stream_clips": 6, "stream_frames": 4,
               "psnr_clips": 2, "psnr_frames": 3,
               "pr_shapes": (((8, 4, 256), "stream tick: FIR planes, 4 slots"),
                             ((9, 4, 256), "stream tick: 3x3 blur planes"),
                             ((1, 4, 256), "stream tick: 1x1 gain plane"),
                             ((32, 4064), "Ch. 7: 32-tap FIR over 4096 samples"),
                             ((1003,), "ragged"))}
        cfg = get_config("tinyllama-1.1b-smoke")
    ctx["timer"] = Timer(torch, on_card)

    record = {"card": smi, "kind": kind, "count": count}
    record["kernels"] = phase_kernels(ctx, cfg)
    if args.kernels_only:
        write_record(args.record, record)
        say("kernel checks done (--kernels-only): no result line")
        return 0
    model, params = serving_model(ctx, cfg)
    record["main_path"], prompts = phase_serve(ctx, cfg, model, params)
    record["int8_cache_path"] = phase_serve_int8(ctx, cfg, model, params, prompts)
    record["chunked_path"] = phase_serve_chunked(ctx, cfg, model, params)
    del model, params
    if on_card:
        torch.cuda.empty_cache()
    record["stream_path"] = phase_stream(ctx)
    record["model_2layer"] = phase_model(ctx, cfg)

    paths = {"3": record["main_path"], "3b": record["int8_cache_path"],
             "3c": record["chunked_path"], "3d": record["stream_path"]}
    summary = []
    for name, rows in record["kernels"].items():
        src, replaces = SOURCES[name]
        # the summary row: the unembedding GEMM (the largest decode GEMM)
        # for axqmm, the decode-shaped row for the others
        lead = rows[-1] if name == "axqmm" else rows[0]
        by_path = {k: v["launches"][name] for k, v in paths.items()}
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": lead.get("ms"), "plain_ms": lead.get("plain_ms"),
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead.get("library_ms"),
            "shape": {k: lead[k] for k in lead if k in SHAPE_KEYS},
        })
    record["summary"] = summary
    write_record(args.record, record)
    if not on_card:
        say("rehearsal done on the CPU (plain versions, smoke size): no device result")
        return 0
    print(smi[0])
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        rc = 1
    sys.exit(rc)
