"""Build the decode kernels at four split widths and time them on the card.

The variants set ``Split<D>::W`` (cache rows a split) to 64, 128, 256 or
512 at every head dim in ``src/repro_torch/kernels/csrc/flash_decode.cu``.
For each variant it prints the D = 64, 80 and 128 instantiations'
registers and spill bytes from ``ptxas -v``; then, for each row below, the
device time of one call of ``flash_decode`` (bf16 cache) and
``flash_decode_quant`` (int8 cache, ebits 5) by CUDA-graph replay over
caches rotated through >= 256 MiB, its achieved GB/s and its largest error
against the plain version, beside SDPA's device time for the bf16 row.

Rows, 8 slots each:

* ``chip_smoke.py`` phase 2's decode shapes: tinyllama-1.1b, the full ring
  of h2o-danube-1.8b, qwen2.5-3b and mistral-nemo-12b;
* the serving paths' traffic, the slot lengths of a steady decode tick:
  path 3 (tinyllama, its first 8 prompts at decode step 16) and the ticks
  that phase 3e (danube, ring of 4096) and 3g (qwen) trace (their first 8
  prompts, 6 tokens in).

Last, the host work of one eager ``flash_decode`` call at qwen's shape,
part by part (the wrapper's checks, its two allocations, the C launch),
beside one eager SDPA call: the mean host time of 400 calls each.  Needs
the card and ``nvcc``:

    python tools/tune_decode_split.py

Builds go to ``build/tune/`` of the checkout.
"""
from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: the width line of ``struct Split`` in the source
SPLIT = re.compile(r"static constexpr int W = [^;]*;")
WIDTHS = (64, 128, 256, 512)
#: name, KVr, G, D, T, lengths of the 8 slots (None: phase 2's mix, "ring":
#: every slot at T, one freed)
SHAPES = (
    ("tinyllama", 4, 8, 64, 1024, None),
    ("danube ring", 8, 4, 80, 4096, "ring"),
    ("qwen", 2, 8, 128, 4096, None),
    ("mistral-nemo", 8, 4, 128, 4096, None),
    ("path 3 tick", 4, 8, 64, 1024, [472, 438, 329, 494, 282, 427, 489, 271]),
    ("3e tick", 8, 4, 80, 4096, [456, 109, 4086, 357, 226, 4096, 4096, 385]),
    ("3g tick", 2, 8, 128, 4096, [3662, 414, 307, 79, 76, 3161, 349, 112]),
)


def build(_build, out: Path) -> dict:
    """Compile every variant (all nvcc processes at once); print the
    resources and return {W: loaded library}."""
    src = (_build.CSRC / "flash_decode.cu").read_text()
    assert len(SPLIT.findall(src)) == 1, "the source's split width moved"
    built = _build.build_variants("flash_decode", {
        f"w{w}": SPLIT.sub(f"static constexpr int W = {w};", src) for w in WIDTHS}, out)
    for w in WIDTHS:
        for r in _build.kernel_resources(built[f"w{w}"][1]):
            inst = _build.decode_instance(r["function"])
            if inst and inst[2] >= 64:
                print(f"W={w} {inst[0]}_kernel<{inst[1]}, D={inst[2]}, GQ={inst[3]}>: "
                      f"{r['registers']} registers, spill {r['spill_stores']}/"
                      f"{r['spill_loads']} B", flush=True)
    return {w: built[f"w{w}"][0] for w in WIDTHS}


def host_us(torch, fn, n: int = 400) -> float:
    """Mean host time in us of ``fn()`` over ``n`` calls (the queue is
    drained first and holds them all)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / n


def host_parts(torch, F, FD, _build, dev) -> None:
    """Print the host work of one eager flash_decode call at qwen's shape
    (bf16 cache), part by part, and of one eager SDPA call."""
    import math

    B, KVr, G, D, T = 8, 2, 8, 128, 4096
    qg = torch.randn(B, KVr, G, D, device=dev)
    k = torch.randn(B, T, KVr, D, device=dev).bfloat16()
    v = torch.randn(B, T, KVr, D, device=dev).bfloat16()
    nv = torch.full((B,), T, dtype=torch.int32, device=dev)
    act = torch.ones(B, dtype=torch.int32, device=dev)
    part = FD._split_scratch(B, KVr, G, D, T, dev)
    out = torch.empty((B, KVr, G, D), dtype=torch.float32, device=dev)
    launch = _build.entry("flash_decode_launch")
    args = (qg.data_ptr(), k.data_ptr(), v.data_ptr(), nv.data_ptr(), act.data_ptr(),
            out.data_ptr(), part.data_ptr(), B, T, KVr, G, D, 1, 1.0 / math.sqrt(D),
            _build.stream_of(qg))

    def checks():
        _build.expect(k, "k", k.dtype, dev, (B, T, KVr, D), align=FD.KV_ALIGN)
        _build.expect(v, "v", k.dtype, dev, (B, T, KVr, D), align=FD.KV_ALIGN)
        _build.expect(nv, "nvalid", torch.int32, dev, (B,))
        _build.expect(act, "active", torch.int32, dev, (B,))

    q4 = qg.reshape(B, KVr * G, 1, D).bfloat16()
    mask = (torch.arange(T, device=dev)[None, :] < nv[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    parts = {
        "flash_decode call": lambda: FD.flash_decode(qg, k, v, nv, act),
        "require_sm90": lambda: _build.require_sm90(qg),
        "q cast + contiguous": lambda: qg.to(torch.float32).contiguous(),
        "4 operand checks": checks,
        "scratch allocation": lambda: FD._split_scratch(B, KVr, G, D, T, dev),
        "out allocation": lambda: torch.empty((B, KVr, G, D), dtype=torch.float32, device=dev),
        "stream_of": lambda: _build.stream_of(qg),
        "C launch (2 kernels)": lambda: launch(*args),
        "SDPA call": lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                            enable_gqa=True),
    }
    print("host us a call (qwen, bf16): " + "; ".join(
        f"{name} {host_us(torch, fn):.2f}" for name, fn in parts.items()), flush=True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import ROTATE_BYTES, Timer, decode_lengths
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.attention import _q8

    if not torch.cuda.is_available():
        print("no card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    dev = torch.device("cuda", 0)
    host_parts(torch, F, FD, _build, dev)      # the source's own widths
    libs = build(_build, ROOT / "build" / "tune")
    timer = Timer(torch, True)
    B = 8
    for name, KVr, G, D, T, kind in SHAPES:
        if kind == "ring":
            nvalid, active = [T] * B, [1] * B
            active[B // 2 + 1] = 0
        elif kind is None:
            nvalid, active = decode_lengths(T, B)
        else:
            nvalid, active = kind, [1] * B
        gen = torch.Generator(device=dev).manual_seed(T + D)
        qg = torch.randn(B, KVr, G, D, generator=gen, device=dev)
        k = torch.randn(B, T, KVr, D, generator=gen, device=dev)
        v = torch.randn(B, T, KVr, D, generator=gen, device=dev)
        nv = torch.tensor(nvalid, dtype=torch.int32, device=dev)
        act = torch.tensor(active, dtype=torch.int32, device=dev)
        e = torch.tensor([8, 5], dtype=torch.int32, device=dev)[1]
        n = max(1, min(32, ROTATE_BYTES // (2 * k.numel() * 2)))
        bf = [(k.bfloat16(), v.bfloat16()) for _ in range(n)]
        i8 = [(*_q8(k), *_q8(v)) for _ in range(n)]
        live = sum(t for t, a in zip(nvalid, active) if a)
        nbytes = {"bf16": live * KVr * D * 4, "int8": live * KVr * (D + 4) * 2}
        calls = {
            "bf16": (lambda i: FD.flash_decode(qg, *bf[i % n], nv, act),
                     FD.flash_decode_plain(qg, *bf[0], nv, act), 1e-4),
            "int8": (lambda i: FD.flash_decode_quant(qg, i8[i % n][0], i8[i % n][1],
                                                     i8[i % n][2], i8[i % n][3], nv, act, e),
                     FD.flash_decode_quant_plain(qg, *i8[0][:2], *i8[0][2:], nv, act, e), 1e-5),
        }
        q4 = qg.reshape(B, KVr * G, 1, D).bfloat16()
        mask = (torch.arange(T, device=dev)[None, :] < nv[:, None])[:, None, None, :]
        sdpa = timer.graph(lambda i: F.scaled_dot_product_attention(
            q4, bf[i % n][0].transpose(1, 2), bf[i % n][1].transpose(1, 2), attn_mask=mask,
            enable_gqa=True), n)
        for cache, (call, ref, tol) in calls.items():
            line = f"{name} KVr={KVr} G={G} D={D} T={T} lengths={nvalid} {cache}"
            if cache == "bf16":
                line += f" | SDPA {sdpa:.5f} ms"
            for w, lib in libs.items():
                _build.use("flash_decode", lib)
                y = call(0)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                ms = timer.graph(call, n)
                line += (f" | W={w} {ms:.5f} ms {nbytes[cache] / ms / 1e6:.1f} GB/s "
                         f"err={err:.3g}{'' if err <= tol else ' OVER'}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
