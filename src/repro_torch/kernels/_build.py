"""Build and bind the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface under ``build/kernels/`` at the repository root, at first use;
all sources compile in parallel.  The libraries are loaded with ``ctypes``:
every pointer and the stream are ``c_void_p``, and every C entry point
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
Nothing here runs at import time.

The module also holds the launch counters: ``launches[name]`` rises by one
each time a wrapper launches kernel ``name``; ``plain_cuda_calls[name]``
counts calls of that kernel's plain PyTorch version on CUDA tensors (the
comparison phases use it; the serving path never should).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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
#: the kernels of the serving paths (two live in axqmm.cu, two in
#: flash_decode.cu; pr_multiply, in axmult_elem.cu, serves the stream
#: workload)
KERNELS = ("axqmm", "axqmm_gated", "flash_decode", "flash_decode_quant",
           "flash_attention", "pr_multiply")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: C signatures: entry point -> (library, argtypes)
SIGNATURES = {
    "axqmm_launch": ("axqmm", [_P] * 8 + [_I] * 4 + [_P]),
    "axqmm_gated_launch": ("axqmm", [_P] * 8 + [_I] * 5 + [_P]),
    "flash_decode_launch": ("flash_decode", [_P] * 6 + [_I] * 6 + [_F, _P]),
    "flash_decode_quant_launch": ("flash_decode", [_P] * 9 + [_I] * 5 + [_F, _P]),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 5 + [_I] * 8 + [_LL] * 9 + [_I, _F, _P]),
    "pr_multiply_launch": ("axmult_elem", [_P] * 4 + [_LL, _I, _P]),
}

launches = dict.fromkeys(KERNELS, 0)
plain_cuda_calls = dict.fromkeys(KERNELS, 0)

#: ptxas resource lines of the last build, per library (chip_smoke prints them)
ptxas_log: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_counts() -> None:
    for d in (launches, plain_cuda_calls):
        for k in d:
            d[k] = 0


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


def build_all(verbose: bool = False) -> dict:
    """Compile every missing library (one ``nvcc`` per source, all started
    together) and load them.  Returns {name: CDLL}.  Raises on a failed
    build with the compiler's output."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, src in SOURCES.items():
            if name in _libs:
                continue
            path = CSRC / src
            out = BUILD_DIR / f"lib{name}-{_digest(path)}.so"
            if out.exists():
                _libs[name] = _load(name, out)
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(path)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            ptxas_log[name] = [ln for ln in log.splitlines()
                               if "ptxas" in ln or "spill" in ln]
            if verbose:
                print(log, end="")
            if proc.returncode != 0:
                failed.append(f"--- nvcc {SOURCES[name]} (rc={proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
            _libs[name] = _load(name, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return dict(_libs)


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (owner, argtypes) in SIGNATURES.items():
        if owner == name:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


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
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels target sm_90a (Hopper); device {t.device} has "
            f"capability {cap}")


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


@functools.lru_cache(maxsize=64)
def _const_i32(value, device: str) -> torch.Tensor:
    """A cached int32 device constant: a scalar, or a vector for a tuple."""
    return torch.tensor(value, dtype=torch.int32, device=device)


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
