"""Build four variants of the bf16 flash_attention body at head_dim 128 and
time them on the card.

The variants cross the kv chunk width of ``TcTile<128>`` (64 or 32 rows)
with the blocks per SM of ``__launch_bounds__`` (1 or 2), from the source in
``src/repro_torch/kernels/csrc/flash_attention.cu``.  For each variant it
prints the D = 128 instantiations' registers and spill bytes from ``ptxas
-v``, then for ``tri`` at S = 4096, 1024 and 255 and ``band`` at S = 8192
(window 4096), qwen2.5-3b's heads (16 query, 2 kv, one sequence), the time
of one call (CUDA events, inputs rotated through >= 256 MiB), its TFLOP/s,
whether its output equals the first variant's bit for bit, and its largest
error against the plain version (S <= 4096).  Needs the card and ``nvcc``:

    python tools/tune_flash_tile.py

Builds go to ``build/tune/`` of the checkout.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TILE = """struct TcTile<128> {
  static constexpr int kCh = 32;
};"""
BOUNDS = "__launch_bounds__(MAXWARPS * 32, 2)"
VARIANTS = {"ch64_b2": (64, 2), "ch32_b2": (32, 2), "ch64_b1": (64, 1), "ch32_b1": (32, 1)}
H, KVr, D = 16, 2, 128


def variant_source(src: str, ch: int, blocks: int) -> str:
    assert src.count(TILE) == 1 and src.count(BOUNDS) == 1, "the source's tile moved"
    tile = TILE.replace("kCh = 32", f"kCh = {ch}")
    return src.replace(TILE, tile).replace(BOUNDS, f"__launch_bounds__(MAXWARPS * 32, {blocks})")


def build(_build, out: Path) -> dict:
    """Compile every variant (all nvcc processes at once); print the D = 128
    resources and return {name: loaded library}."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    built = _build.build_variants("flash_attention", {
        name: variant_source(src, ch, blocks) for name, (ch, blocks) in VARIANTS.items()}, out)
    for name, (_, lines) in built.items():
        for r in _build.kernel_resources(lines):
            inst = _build.flash_instance(r["function"])
            if inst and inst[2] == D:
                print(f"{name} {inst[0]} {inst[1]} D={D}: {r['registers']} registers, spill "
                      f"{r['spill_stores']}/{r['spill_loads']} B", flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("no card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    libs = build(_build, ROOT / "build" / "tune")
    dev = torch.device("cuda", 0)

    def timeit(fn, iters=20, warm=3):
        for i in range(warm):
            fn(i)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for i in range(iters):
            fn(i)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    for sched, S in (("tri", 4096), ("tri", 1024), ("tri", 255), ("band", 8192)):
        gen = torch.Generator(device=dev).manual_seed(S)
        q, k, v = (torch.randn(1, S, n, D, generator=gen, device=dev).bfloat16()
                   for n in (H, KVr, KVr))
        ncopy = max(1, min(32, (256 << 20) // (2 * S * (H + KVr) * D * 2)))
        qkv = [(q.clone(), k.clone(), v.clone()) for _ in range(ncopy)]
        window = 4096 if sched == "band" else None
        pairs = H * sum(min(r + 1, window or S) for r in range(S))
        ref = (FA.flash_attention_grouped_plain(q, k, v, causal=True, window=window)
               if S <= 4096 else None)
        first = None
        line = f"{sched} S={S} D={D}"
        for name, lib in libs.items():
            _build.use("flash_attention", lib)

            def call(i):
                return FA.flash_attention_grouped(*qkv[i % ncopy], causal=True, window=window)

            y = call(0)
            torch.cuda.synchronize()
            same = "" if first is None else f" same={torch.equal(y, first)}"
            first = y if first is None else first
            err = "" if ref is None else f" err={float((y.float() - ref.float()).abs().max()):.4g}"
            ms = timeit(call)
            line += f" | {name} {ms:.4f} ms {4 * D * pairs / ms / 1e9:.1f} TFLOP/s{same}{err}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
