"""Time the axqmm / axqmm_gated kernels on the card, beside an older build
of them and torch._int_mm, and sweep their launch plans.

For every GEMM of one decode step (M = 8) and of one 255-token prefill
call of tinyllama-1.1b, h2o-danube-1.8b and qwen2.5-3b, and for qwen's
gated and down projections of a 4096-token prefill call, it prints the
device time of one call by CUDA-graph replay over weights rotated through
>= 256 MiB (cold L2, as serving meets them): the kernels of this checkout
at the plan the wrapper picks (``kernels/axqmm.py::plan``), the older
build given by ``--baseline`` (a directory holding an ``axqmm.cu`` whose
entry points take no scratch or plan arguments, and the ``common.cuh`` it
includes), and
torch._int_mm (x padded to 32 rows at decode; for the gated rows, one
call on each of the two weights), with the bound (bytes at 3.35 TB/s or
int8 operations at 1,979 TOP/s), the achieved TOP/s and the plan's blocks
an SM.  Every kernel output is checked bit for bit against the plain
version at the first call.  With ``--sweep`` it also times the other
plans of each shape (tile configuration x splits of K) at the first
degree given; with ``--kernels`` the device time of each kernel of one
call (the decode or tile kernel, the combine of a split, the pre-pass)
from a ``torch.profiler`` trace of 20 calls.  The degree is a
device int32 (``--ebits``, default 6 as in chip_smoke.py's phase 2; 8
takes the kernels' no-degrade path).  Needs the card and ``nvcc``:

    python tools/tune_axqmm.py [--baseline DIR] [--sweep] [--kernels] [--ebits 6 8] [--out PATH]

The baseline builds into ``build/tune/`` of the checkout.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MODELS = ("tinyllama-1.1b", "h2o-danube-1.8b", "qwen2.5-3b")


def shapes():
    """(model, projection, M, N, K, gated, residual) of every timed row."""
    from repro_torch.configs import get_config

    out = []
    for name in MODELS:
        c = get_config(name)
        d, qd, kvd = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        proj = [("wq", qd, d, False, False), ("wk", kvd, d, False, False),
                ("wo", d, qd, False, True), ("down", d, c.d_ff, False, True),
                ("gate+up", c.d_ff, d, True, False)]
        for M in (8, 255):
            out += [(name, p, M, N, K, g, r) for p, N, K, g, r in proj]
        out.append((name, "unembed", 8, c.vocab, d, False, False))
        if name == "qwen2.5-3b":
            out += [(name, "gate+up", 4096, c.d_ff, d, True, False),
                    (name, "down", 4096, d, c.d_ff, False, True)]
    return out


def build_baseline(_build, src_dir: Path, out_dir: Path):
    """nvcc of the older axqmm.cu (its own common.cuh) into ``out_dir``,
    bound with its C interface (no scratch or plan arguments)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libaxqmm_baseline.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
           str(src_dir / "axqmm.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"baseline build failed\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.axqmm_launch.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.axqmm_gated_launch.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.axqmm_launch.restype = lib.axqmm_gated_launch.restype = I
    return lib, _build.kernel_resources(_build._ptxas_lines(log.stdout + log.stderr))


def plans_of(A, M, N, K, bk, gated):
    """The launch plans a sweep tries at this shape."""
    nb = K // bk
    if M <= A.DECODE_M:
        out = []
        for part in (1, 2, 4):
            if bk % (part * A.KERNEL_KC):
                continue
            for s in sorted({1, 2, 3, 4, 6, 8, 12, 16, nb, nb * part}):
                if s <= nb * part and (s > nb or part == 1) and (s > 1 or part == 1):
                    out.append(A.Plan(A.DECODE, s, part))
        return out
    return [A.Plan(A.TILE_SMALL, s) for s in sorted({1, 2, 4, nb}) if s <= nb] + \
        ([A.Plan(A.TILE_LARGE)] if bk % 128 == 0 else [])


def kernel_times(torch, fn, n: int) -> dict:
    """Device time in us of each kernel of one ``fn(i)`` call, from a
    ``torch.profiler`` trace of ``n`` calls (by kernel name, template
    arguments kept)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / n for e in prof.key_averages()
            if e.self_device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None, metavar="DIR")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--ebits", type=int, nargs="+", default=[6])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    from chip_smoke import HBM_BPS, INT8_OPS, ROTATE_BYTES, Timer, bound
    from repro_torch.kernels import _build
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

    if not torch.cuda.is_available():
        print("no card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    _build.build_all()
    base, base_res = (build_baseline(_build, args.baseline, ROOT / "build" / "tune")
                      if args.baseline else (None, None))
    if base_res:
        print("baseline instantiations: " + "; ".join(
            f"{r['function']} {r['registers']} regs" for r in base_res), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = Timer(torch, True)
    record = {"card": smi, "rows": []}
    for model, proj, M, N, K, gated, residual in shapes():
        bk = resolve_block(K, 256)
        nb = K // bk
        gen = torch.Generator(device=dev).manual_seed(M + N + K)
        x = torch.randn(M, K, generator=gen, device=dev)
        res = torch.randn(M, N, generator=gen, device=dev) if residual else None
        G = 2 if gated else 1
        pack = [prepack_weight(torch.randn(K, N, generator=gen, device=dev) / K ** 0.5, bk)
                for _ in range(G)]
        wbytes = G * (N * K + N * nb * 4)
        n = max(1, min(1024, -(-ROTATE_BYTES // wbytes)))
        packs = [[PackedQWeight(p.qw.clone(), p.scales.clone()) for p in pack]
                 for _ in range(n)]
        qx, sx = A.quantize_for_axqmm(x, bk)
        qxl = qx if M > 16 else torch.cat([qx, qx.new_zeros(32 - M, K)])
        ops = 2.0 * G * M * N * K
        nbytes = M * K + M * nb * 4 + wbytes + M * N * 4 * (2 if residual else 1)
        bms, by = bound(nbytes, ops, INT8_OPS)
        lib_ms = timer.graph(lambda i: [torch._int_mm(qxl, p.qw.t()) for p in packs[i % n]], n)
        for ebits in args.ebits:
            e = torch.full((), ebits, dtype=torch.int32, device=dev)
            if gated:
                kernel = lambda i: A.axqmm_gated_quantized(qx, sx, *packs[i % n], e)
                ref = A.axqmm_gated_plain(x, *pack, ebits)
            else:
                kernel = lambda i: A.axqmm_quantized(qx, sx, packs[i % n][0], e, residual=res)
                ref = A.axqmm_packed_plain(x, pack[0], ebits, residual=res)
            p0 = A.plan(M, N, K, bk, gated, sms)
            row = {"model": model, "proj": proj, "M": M, "N": N, "K": K, "ebits": ebits,
                   "bound_ms": bms, "bound_by": by, "int_mm_ms_graph": lib_ms,
                   "plan": list(p0), "blocks_per_sm": A.blocks(p0, M, N, gated) / sms}
            exact = bool(torch.equal(kernel(0), ref))
            row.update(ms_graph=timer.graph(kernel, n), exact=exact)
            if base is not None:
                out = torch.empty((M, N), dtype=torch.float32, device=dev)
                # the stream is asked at each call: a graph captures on its own
                if gated:
                    old = lambda i: base.axqmm_gated_launch(
                        qx.data_ptr(), sx.data_ptr(), packs[i % n][0].qw.data_ptr(),
                        packs[i % n][0].scales.data_ptr(), packs[i % n][1].qw.data_ptr(),
                        packs[i % n][1].scales.data_ptr(), e.data_ptr(), out.data_ptr(),
                        M, N, K, bk, 0, _build.stream_of(x))
                else:
                    old = lambda i: base.axqmm_launch(
                        qx.data_ptr(), sx.data_ptr(), packs[i % n][0].qw.data_ptr(),
                        packs[i % n][0].scales.data_ptr(), None,
                        None if res is None else res.data_ptr(), e.data_ptr(),
                        out.data_ptr(), M, N, K, bk, _build.stream_of(x))
                _build.check(old(0), "baseline axqmm")
                torch.cuda.synchronize()
                row["baseline_exact"] = bool(torch.equal(out, ref))
                row["baseline_ms_graph"] = timer.graph(old, n)
                row["speedup"] = row["baseline_ms_graph"] / row["ms_graph"]
            row["tops_graph"] = ops / (row["ms_graph"] * 1e-3) / 1e12
            if args.kernels:
                row["kernel_us"] = kernel_times(torch, kernel, 20)
            if args.sweep and ebits == args.ebits[0]:
                row["sweep"] = {}
                chosen = A._plan_for
                for p in plans_of(A, M, N, K, bk, gated):
                    A._plan_for = lambda *a, p=p: p
                    try:
                        ok = bool(torch.equal(kernel(0), ref))
                        row["sweep"][str(tuple(p))] = (timer.graph(kernel, n), ok)
                    except RuntimeError as err:      # a plan the launcher refuses
                        row["sweep"][str(tuple(p))] = (None, str(err))
                    finally:
                        A._plan_for = chosen
            print(json.dumps(row), flush=True)
            record["rows"].append(row)
        del packs
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(f"bounds: bytes at {HBM_BPS:.3g} B/s, int8 at {INT8_OPS:.4g} op/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
