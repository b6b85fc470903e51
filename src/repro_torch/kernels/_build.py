"""Build and bind the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface under ``build/kernels/`` at the repository root, at first use;
all sources compile in parallel.  The libraries are loaded with ``ctypes``:
every pointer and the stream are ``c_void_p``, and every C entry point
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
Nothing here runs at import time.

The module also holds the launch counters: ``launches[name]`` rises by one
each time a wrapper launches kernel ``name`` (``flash_schedules`` splits
the ``flash_attention`` launches by schedule); ``plain_cuda_calls[name]``
counts calls of that kernel's plain PyTorch version on CUDA tensors (the
comparison phases use it; the serving path never should).
``backward_calls[name]`` counts the backward oracles run under autograd
(:data:`BACKWARDS`, on any device: no TPU kernel has a backward, so the
training path's backward is these PyTorch oracles by design); with
``time_backwards`` set they also record a pair of CUDA events each into
``backward_events``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: repository root (src/repro_torch/kernels -> three levels up)
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"

#: kernel name -> CUDA source
SOURCES = {
    "axqmm": "axqmm.cu",
    "flash_decode": "flash_decode.cu",
    "flash_attention": "flash_attention.cu",
    "axmult_elem": "axmult_elem.cu",
}
#: the kernels of the serving paths (two live in axqmm.cu, with their
#: expert-batched launches for the MoE experts, two in flash_decode.cu;
#: axmult_elem.cu holds the elementwise pr_multiply, which the offline FIR
#: bench layout takes, and pr_fir / pr_conv2d, the stream workload's stages)
KERNELS = ("axqmm", "axqmm_gated", "axqmm_experts", "axqmm_gated_experts",
           "flash_decode", "flash_decode_quant", "flash_attention", "pr_multiply",
           "pr_fir", "pr_conv2d")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: C signatures: entry point -> (library, argtypes)
SIGNATURES = {
    "axqmm_launch": ("axqmm", [_P] * 9 + [_I] * 7 + [_P]),
    "axqmm_gated_launch": ("axqmm", [_P] * 9 + [_I] * 8 + [_P]),
    "axqmm_experts_launch": ("axqmm", [_P] * 7 + [_I] * 8 + [_P]),
    "axqmm_gated_experts_launch": ("axqmm", [_P] * 9 + [_I] * 9 + [_P]),
    "flash_decode_launch": ("flash_decode", [_P] * 7 + [_I] * 6 + [_F, _P]),
    "flash_decode_quant_launch": ("flash_decode", [_P] * 10 + [_I] * 5 + [_F, _P]),
    "flash_decode_split_width": ("flash_decode", [_I]),
    "flash_decode_smem_bytes": ("flash_decode", [_I] * 3),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 5 + [_I] * 10 + [_LL] * 9 + [_I, _F, _P]),
    "flash_attention_smem_bytes": ("flash_attention", [_I] * 3),
    "pr_multiply_launch": ("axmult_elem", [_P] * 4 + [_LL, _I, _P]),
    "pr_fir_launch": ("axmult_elem", [_P] * 6 + [_I] * 6 + [_P]),
    "pr_conv2d_launch": ("axmult_elem", [_P] * 4 + [_I] * 9 + [_P]),
    "launch_floor_launch": ("axmult_elem", [_P]),
}

#: the backward oracles of the kernels' autograd Functions (training)
BACKWARDS = ("flash_attention_bwd", "axqmm_bwd", "axqmm_gated_bwd", "axqmm_experts_bwd")

launches = dict.fromkeys(KERNELS, 0)
plain_cuda_calls = dict.fromkeys(KERNELS, 0)
backward_calls = dict.fromkeys(BACKWARDS, 0)
#: (name, start event, end event) of each timed backward oracle on the card
backward_events: list = []
time_backwards = False
#: ``flash_attention`` launches by schedule (they sum to its ``launches``)
flash_schedules = dict.fromkeys(("dense", "tri", "band"), 0)

#: ptxas resource lines of each loaded library (chip_smoke prints them); kept
#: beside the library (``.ptxas``) so a cached build reports them too
ptxas_log: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_counts() -> None:
    for d in (launches, plain_cuda_calls, flash_schedules, backward_calls):
        for k in d:
            d[k] = 0
    backward_events.clear()


class backward_oracle:
    """Context of one backward oracle ``name``: counts it (unless ``t`` is
    a meta tensor: the dry run executes nothing) and, with
    ``time_backwards`` set and ``t`` on the card, brackets it with CUDA
    events (recorded on the current stream: no host sync)."""

    def __init__(self, name: str, t: torch.Tensor):
        if not t.is_meta:
            backward_calls[name] += 1
        self.name = name
        self.ev = None
        if time_backwards and t.is_cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if self.ev is not None:
            self.ev[0].record()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[1].record()
            backward_events.append((self.name, *self.ev))
        return False


def backward_ms() -> dict:
    """Milliseconds of the timed backward oracles by name (syncs)."""
    if backward_events:
        torch.cuda.synchronize()
    out: dict = {}
    for name, a, b in backward_events:
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): building the "
                       "CUDA kernels needs the CUDA toolkit")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc(src: Path, out: Path) -> subprocess.Popen:
    """Start one ``nvcc`` build of ``src`` into ``out`` (output and errors
    in one pipe)."""
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _ptxas_lines(log: str) -> list:
    return [ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]


def build_all(verbose: bool = False) -> dict:
    """Compile every missing library (one ``nvcc`` per source, all started
    together) and load them.  Returns {name: CDLL}.  Raises on a failed
    build with the compiler's output."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, src in SOURCES.items():
            if name in _libs:
                continue
            path = CSRC / src
            out = BUILD_DIR / f"lib{name}-{_digest(path)}.so"
            log_path = out.with_suffix(".ptxas")
            if out.exists() and log_path.exists():
                ptxas_log[name] = log_path.read_text().splitlines()
                _libs[name] = _load(name, out)
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (_nvcc(path, tmp), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            ptxas_log[name] = _ptxas_lines(log)
            if verbose:
                print(log, end="")
            if proc.returncode != 0:
                failed.append(f"--- nvcc {SOURCES[name]} (rc={proc.returncode})\n{log}")
                continue
            out.with_suffix(".ptxas").write_text("\n".join(ptxas_log[name]) + "\n")
            os.replace(tmp, out)
            _libs[name] = _load(name, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return dict(_libs)


def build_variants(name: str, sources: dict, out_dir: Path) -> dict:
    """Compile edited copies of library ``name``'s source ({tag: source
    text}) into ``out_dir``, one ``nvcc`` each, all started together, and
    load them (for the tuning tools).  Returns {tag: (CDLL, ptxas lines)};
    raises on a failed build with the compiler's output.  ``use`` swaps
    one in."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        cu = out_dir / f"{name}_{tag}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}_{tag}.so"
        procs[tag] = (_nvcc(cu, so), so)
    built = {}
    for tag, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {name} {tag}\n{log}")
        built[tag] = (_load(name, so), _ptxas_lines(log))
    return built


def use(name: str, lib: ctypes.CDLL) -> None:
    """Make ``lib`` (a ``build_variants`` library) the one the wrappers of
    library ``name`` launch."""
    _libs[name] = lib


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (owner, argtypes) in SIGNATURES.items():
        if owner == name:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


def kernel_resources(lines) -> list:
    """Per entry function of ``ptxas -v`` output lines (one library's
    ``ptxas_log``): its mangled name, registers, spill store/load bytes and
    static shared memory."""
    out = []
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            out.append({"function": m.group(1), "registers": None,
                        "spill_stores": None, "spill_loads": None, "smem": 0})
            continue
        if not out:
            continue
        cur = out[-1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


def flash_instance(function: str):
    """(body, dtype, D) of a mangled ``flash_attention`` kernel name from
    ``ptxas -v`` — ("tc", "bf16", D) for the tensor-core body,
    ("fwd", "f32", D) for the CUDA-core body — or None for any other."""
    m = re.search(r"flash_(tc|fwd)_kernelI(13__nv_bfloat16|f)?Li(\d+)E", function)
    if m is None:
        return None
    body = m.group(1)
    dtype = "bf16" if body == "tc" or m.group(2) != "f" else "f32"
    return body, dtype, int(m.group(3))


def decode_instance(function: str):
    """(kernel, cache, D, GQ) of a mangled name from ``ptxas -v`` of
    ``flash_decode.cu`` — ("decode", "bf16" / "f32" / "int8", D, query rows
    a P.V block) for the split kernel, ("combine", None, D, None) for the
    merge of its partials — or None for any other."""
    m = re.search(r"decode_kernelI(\S*?)Li(\d+)ELi(\d+)E", function)
    if m is not None:
        rows = m.group(1)
        cache = ("int8" if "Int8Rows" in rows else "bf16" if "__nv_bfloat16" in rows
                 else "f32")
        return "decode", cache, int(m.group(2)), int(m.group(3))
    m = re.search(r"combine_kernelILi(\d+)E", function)
    return None if m is None else ("combine", None, int(m.group(1)), None)


def axqmm_instance(function: str):
    """(kernel, template arguments) of a mangled name from ``ptxas -v`` of
    ``axqmm.cu`` — ("decode", (NT, gated, CH)), ("tile", (BM, BN, WM,
    WN, gated)), ("wgmma", (gated,)), ("combine", (gated,)), ("degrade", ())
    — or None for any other."""
    m = re.search(r"axq_(decode|tile|wgmma|combine|degrade)_kernel(I(?:L[ib]\d+E)+E)?",
                  function)
    if m is None:
        return None
    return m.group(1), tuple(int(v) for v in re.findall(r"L[ib](\d+)E", m.group(2) or ""))


def pr_instance(function: str):
    """The kernel of a mangled name from ``ptxas -v`` of ``axmult_elem.cu``
    — "pr_kernel<vec>" / "pr_kernel<scalar>" (elementwise),
    "pr_fir_kernel", "pr_conv2d_kernel", "launch_floor_kernel" — or None for
    any other."""
    m = re.search(r"\d+(pr_kernel|pr_fir_kernel|pr_conv2d_kernel|launch_floor_kernel)"
                  r"(ILb([01])EE)?", function)
    if m is None:
        return None
    if m.group(1) == "pr_kernel":
        return "pr_kernel<vec>" if m.group(3) == "1" else "pr_kernel<scalar>"
    return m.group(1)


def entry(fn: str):
    """The bound C entry point ``fn`` (building the libraries on first use)."""
    owner = SIGNATURES[fn][0]
    lib = _libs.get(owner)
    if lib is None:
        lib = build_all()[owner]
    return getattr(lib, fn)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# ---------------------------------------------------------------------------
# launch-side checks shared by the wrappers
# ---------------------------------------------------------------------------


def require_sm90(t: torch.Tensor) -> None:
    """The kernels are built for sm_90a only: refuse any other card."""
    cap = _capability(t.device.index)
    if cap != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels target sm_90a (Hopper); device {t.device} has "
            f"capability {cap}")


def sm_count(t: torch.Tensor) -> int:
    """The streaming multiprocessors of ``t``'s card (asked once a card)."""
    return _sm_count(t.device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple:
    # asked of each card once, not on every launch
    return torch.cuda.get_device_capability(index)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def expect(t: torch.Tensor, name: str, dtype, device, shape=None,
           align: int = 4) -> None:
    """Validate one kernel operand: device, dtype, contiguity, shape and
    pointer alignment (in bytes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")


#: (value, device) -> its int32 device constant
_consts: dict = {}


def _const_i32(value, device: str) -> torch.Tensor:
    """A cached int32 device constant: a scalar, or a vector for a tuple.
    Making one copies from the host, which a CUDA graph capture must not
    do (it would fail or keep a stale host pointer): the eager warm-up run
    before a capture makes every constant the captured call uses, and a
    constant first asked for inside a capture raises."""
    key = (value, device)
    t = _consts.get(key)
    if t is None:
        if device.startswith("cuda") and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"device constant {value!r} first asked for inside a CUDA graph "
                "capture: run the call eagerly once before capturing it")
        t = _consts[key] = torch.tensor(value, dtype=torch.int32, device=device)
    return t


def degree_ptr(ebits, device: torch.device) -> torch.Tensor:
    """The device int32 the kernels read the degree from.  A tensor degree
    (a ladder operand or one element of a per-site vector) is used in place
    — its address is passed, nothing is copied or synced; a Python int (a
    static spec) maps to a cached constant on the device."""
    if isinstance(ebits, torch.Tensor):
        if ebits.numel() != 1:
            raise ValueError(f"degree operand must be one element, got {tuple(ebits.shape)}")
        if ebits.dtype != torch.int32 or ebits.device != device:
            raise ValueError(f"degree operand must be int32 on {device}, got "
                             f"{ebits.dtype} on {ebits.device}")
        return ebits
    return _const_i32(int(ebits), str(device))


def pr_operand(pr, device: torch.device) -> torch.Tensor:
    """The device ``int32[2]`` the PR kernel reads (p, r) from.  A tensor
    pair (``dsp.degree_to_pr`` of a device degree) is used in place — its
    address is passed, nothing is copied or synced; a pair of Python ints
    (raw sweep knobs) maps to a cached constant on the device."""
    if isinstance(pr, torch.Tensor):
        if tuple(pr.shape) != (2,) or pr.dtype != torch.int32 or pr.device != device:
            raise ValueError(f"(p, r) operand must be int32[2] on {device}, got "
                             f"{pr.dtype}{tuple(pr.shape)} on {pr.device}")
        if not pr.is_contiguous():
            raise ValueError("(p, r) operand must be contiguous")
        return pr
    p, r = pr
    return _const_i32((int(p), int(r)), str(device))
