#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with the card (H100)
    python3 chip_smoke.py --rehearse   # the same phases on the CPU with the
                                       # plain versions, at smoke size

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernel build
     (nvcc for sm_90a from kernels/csrc, with the -Xptxas -v lines);
  2. each hand-written kernel against its plain PyTorch version on the same
     seeded inputs at the main path's full-width tinyllama-1.1b shapes,
     with the stated tolerance, timed with CUDA events beside its bound
     and, where one PyTorch call computes the same product, that call;
  3. the main path: tinyllama-1.1b (random weights from a seeded CUDA
     generator) under axq8 with the QoS ladder 8 -> 5, prepacked, served by
     the continuous-batching engine; every request must finish, the QoS
     degree must move, and every kernel of the path must have launched
     while no plain version ran on the card;
  4. the same model cut to 2 layers (one prefill and 4 greedy decode
     steps): every kernel call checked against its plain version on the
     model's own inputs, and the logits of a kernel run against a plain run
     within the model's measured noise floor;
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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:117"),
}


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


def phase_kernels(ctx, cfg):
    """Phase 2: every kernel against its plain version."""
    torch = ctx["torch"]
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_attention": []}
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
    rows["flash_attention"].append(check_prefill(ctx, cfg.n_heads, prompt, D,
                                                 cfg.n_heads, cfg.n_kv_heads))
    for name, rs in rows.items():
        for r in rs:
            shape = {k: r[k] for k in r if k in ("M", "N", "K", "B", "T", "BH", "S")}
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


def phase_serve(ctx, cfg):
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.approx import policy_from_flag
    from repro_torch.core.dynamic import QoSController
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.serve.lm import ServeEngine
    from repro_torch.serve.metrics import summarize

    model = build_model(cfg, policy_from_flag("axq8", dynamic=True), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(generator=gen)
    params = model.prepack(params)          # rebind: the f32 copies go
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    wbytes = packed_bytes(params)
    tick_bound_ms = wbytes / HBM_BPS * 1e3

    def engine():
        qos = QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)],
                            low_water=0.25, high_water=0.75, cooldown_steps=8)
        return ServeEngine(model, params, slots=ctx["slots"], max_len=ctx["max_len"],
                           qos=qos, prepack=False, seed=0), qos

    rng = np.random.default_rng(0)
    lo, hi = ctx["prompt_range"]
    warm, _ = engine()                      # library loads and allocator warm-up
    warm.submit(rng.integers(0, cfg.vocab, lo), 2)
    warm.run_until_drained()
    del warm

    eng, qos = engine()
    n_req, new_tokens = ctx["requests"], ctx["new_tokens"]
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
               for _ in range(n_req)]
    ctx["sync"]()
    _build.reset_counts()
    if ctx["on_card"]:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    decode_ticks = []
    max_ticks = 4 * n_req * new_tokens
    while eng.queue or any(r is not None for r in eng.slot_req):
        require(eng.stats.decode_steps < max_ticks,
                f"the engine did not drain within {max_ticks} ticks")
        admitted = eng.stats.admitted
        t = time.time()
        eng.tick()                           # ends in a device->host read
        if eng.stats.admitted == admitted:
            decode_ticks.append(time.time() - t)
    ctx["sync"]()
    wall = time.time() - t0
    launches = dict(_build.launches)
    plain = dict(_build.plain_cuda_calls)
    s = summarize(eng.done, eng.stats, wall_s=wall)

    require(len(eng.done) == n_req, f"{len(eng.done)} of {n_req} requests finished")
    require(all(len(r.out_tokens) == new_tokens for r in reqs),
            "a request finished without all its tokens")
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"the QoS degree never moved: {rungs}")
    steps, prefills = eng.stats.decode_steps, eng.stats.prefill_calls
    L = cfg.n_layers
    expect = {"axqmm": (5 * L + 1) * (steps + prefills), "axqmm_gated": L * (steps + prefills),
              "flash_decode": L * steps, "flash_attention": L * prefills}
    say(f"main path launches {launches} (expected {expect}); plain versions on "
        f"the card {plain}")
    for name in launches if ctx["on_card"] else ():
        require(launches[name] > 0, f"kernel {name} never launched on the main path")
        require(launches[name] == expect[name],
                f"kernel {name}: {launches[name]} launches, expected {expect[name]}")
        require(plain[name] == 0, f"the plain version of {name} ran on the card")
    gen_tok = s["generated_tokens"]
    out = {
        "arch": cfg.name, "requests": n_req, "new_tokens": new_tokens,
        "prompt_range": [lo, hi], "slots": ctx["slots"], "max_len": ctx["max_len"],
        "wall_s": wall, "generated_tokens": gen_tok, "gen_tok_per_s": gen_tok / wall,
        "decode_steps": steps, "prefill_calls": prefills,
        "decode_tick_ms_mean": 1e3 * sum(decode_ticks) / max(len(decode_ticks), 1),
        "decode_ticks_timed": len(decode_ticks),
        "decode_tick_bound_ms": tick_bound_ms, "packed_weight_bytes": wbytes,
        "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p95_ms": s["ttft_p95_ms"],
        "tpot_p50_ms": s["tpot_p50_ms"], "degree_rungs_visited": rungs,
        "degree_at_first_token": s.get("degree_at_first_token"),
        "launches": launches,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if ctx["on_card"] else None),
    }
    say(f"main path: {n_req} requests, {gen_tok} tokens in {wall:.3f} s "
        f"({out['gen_tok_per_s']:.1f} tok/s); decode tick {out['decode_tick_ms_mean']:.3f} ms "
        f"vs bound {tick_bound_ms:.4f} ms ({wbytes / 1e9:.3f} GB of packed weights); "
        f"TTFT p50 {s['ttft_p50_ms']} ms p95 {s['ttft_p95_ms']} ms; "
        f"max_memory_allocated {out['max_memory_allocated']}; rungs {rungs}")
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel-vs-plain on the whole model
# ---------------------------------------------------------------------------


#: phase 4 runs: (dtype, runtime degree)
MODEL_RUNS = (("float32", [8, 6, 7]), ("bfloat16", 8))

#: relative perturbation of the plain run's projection outputs that measures
#: the model's own noise floor (phase 4)
NOISE_EPS = 1e-6


def _call_tols(dtype):
    """(rtol, atol) of each kernel against its plain version on the model's
    own inputs: the GEMMs at the qmm oracle tolerance (observed
    bit-identical); attention to f32 summation order, or one bf16 ulp at
    |o| < 4 for bf16 outputs."""
    attn = (1e-4, 1e-4) if dtype == "float32" else (0.0, 1 / 64)
    return {"axqmm": (1e-5, 1e-4), "axqmm_gated": (1e-5, 1e-4),
            "flash_decode": (1e-4, 1e-4), "flash_attention": attn}


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


def _model_logits(ctx, model, params, prompt, deg, backend, feed):
    """One prefill and 4 decode steps of slot 1 (slot 0 free); returns the
    5 logit rows and the greedy tokens fed."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.kernels import dispatch

    dispatch.set_backend(backend)
    try:
        B, slot = 2, 1
        cache = model.init_cache(1, B, prompt.shape[0] + 8)
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
    finally:
        dispatch.set_backend(None)


def phase_model(ctx, cfg):
    """Phase 4: kernel vs plain on the model cut to 2 layers.

    (a) Every kernel call of a kernel run is checked against its plain
    version on the same (the model's own) inputs, at the stated tolerance.
    (b) The logits of the kernel run and of a plain run are compared.  AXQ
    makes the model chaotic in its inputs: a difference in the last f32 bit
    can move an int8 activation code, whose step then moves every later
    code.  So (b) is held to the model's own noise floor, measured in this
    run as the change of the plain logits when the plain projections' f32
    outputs are perturbed by NOISE_EPS relative: the kernel run may differ
    from the plain run by at most 4x that floor."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model

    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, ctx["prefill_m"]), device=dev)
    out = []
    for dtype, degree in MODEL_RUNS:
        cut = dataclasses.replace(cfg, n_layers=2, dtype=dtype)
        model = build_model(cut, policy_from_flag("axq8", dynamic=True), device=dev)
        params = model.prepack(model.init(seed=1))
        deg = torch.tensor(degree, dtype=torch.int32, device=dev)
        # the rehearsal drives the same sequence with `auto`, which routes
        # the CPU tensors to the plain versions (no kernel call to check)
        kernels = "cuda" if ctx["on_card"] else "auto"
        calls: dict = {}
        with _checked_kernels(ctx, dtype, calls):
            lk, fed = _model_logits(ctx, model, params, prompt, deg, kernels, None)
        # both plain runs decode the kernel run's greedy tokens
        lp, _ = _model_logits(ctx, model, params, prompt, deg, "torch", fed)
        with _perturbed_projections(ctx, NOISE_EPS):
            ln, _ = _model_logits(ctx, model, params, prompt, deg, "torch", fed)
        ctx["sync"]()
        diff = float((lk - lp).abs().max())
        floor = float((ln - lp).abs().max())
        tol = 4 * max(floor, 1e-3)
        say(f"2-layer {dtype} at degree {degree}: kernel calls vs plain on the "
            f"model's inputs {{name: [calls, max_err, outside tolerance]}} {calls}")
        say(f"2-layer {dtype} at degree {degree}: logits kernels vs plain max |diff| "
            f"{diff:.4g}; the plain model's own change under a {NOISE_EPS:g} "
            f"relative perturbation of its projections {floor:.4g}; tolerance "
            f"{tol:.4g}")
        for name in ("axqmm", "axqmm_gated", "flash_decode", "flash_attention"):
            n, err, bad = calls.get(name, (0, 0.0, 0))
            require(n > 0 or not ctx["on_card"], f"2-layer {dtype}: {name} never ran")
            require(bad == 0, f"2-layer {dtype}: {bad} of {n} {name} calls outside "
                              f"tolerance of the plain version (max err {err})")
        require(diff <= tol, f"2-layer {dtype} kernel-vs-plain logits differ by {diff} "
                             f"(noise floor {floor})")
        out.append({"dtype": dtype, "degree": degree, "kernel_calls": calls,
                    "max_abs_logit_diff": diff, "noise_floor": floor,
                    "noise_eps": NOISE_EPS, "tolerance": tol,
                    "max_abs_logit": float(lp.abs().max())})
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
               "new_tokens": 32, "prompt_range": (64, 512)}
        cfg = get_config("tinyllama-1.1b")
    else:
        torch.set_num_threads(4)
        smi, kind, count = ["cpu rehearsal"], "cpu", 0
        ctx = {"torch": torch, "dev": torch.device("cpu"), "on_card": False,
               "sync": lambda: None, "dtype": torch.float32,
               "slots": 4, "prefill_m": 37, "max_len": 64, "requests": 6,
               "new_tokens": 4, "prompt_range": (8, 40)}
        cfg = get_config("tinyllama-1.1b-smoke")
    ctx["timer"] = Timer(torch, on_card)

    record = {"card": smi, "kind": kind, "count": count}
    record["kernels"] = phase_kernels(ctx, cfg)
    if args.kernels_only:
        write_record(args.record, record)
        say("kernel checks done (--kernels-only): no result line")
        return 0
    record["main_path"] = phase_serve(ctx, cfg)
    record["model_2layer"] = phase_model(ctx, cfg)

    summary = []
    for name, rows in record["kernels"].items():
        src, replaces = SOURCES[name]
        # the summary row: the unembedding GEMM (the largest decode GEMM)
        # for axqmm, the decode-shaped row for the others
        lead = rows[-1] if name == "axqmm" else rows[0]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": record["main_path"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": lead.get("ms"), "plain_ms": lead.get("plain_ms"),
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead.get("library_ms"),
            "shape": {k: lead[k] for k in lead if k in ("M", "N", "K", "B", "T", "BH", "S")},
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
