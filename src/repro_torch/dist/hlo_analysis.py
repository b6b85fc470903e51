"""The work of one rank's step, counted on the meta device (the port of
``repro.dist.hlo_analysis``).

The reference walks the HLO text of a compiled step: dot FLOPs by
accumulator dtype and collective bytes by kind, each ``while`` body
weighted by its trip count.  The port has no HLO: a step runs eagerly, one
op at a time.  :func:`analyze_step` runs it instead on ``meta`` tensors
(shapes and dtypes, no storage, nothing computed) inside a counting
context, and reads the same quantities from what the step would execute:

  aten products   ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` / convolution
                  through ``torch.utils.flop_counter``'s formulas, and
                  ``aten._int_mm`` (which that registry does not count), each
                  under its output dtype in the reference's names (``f32``,
                  ``bf16``, ``s32`` for the int8 products, ...);
  the kernels     a meta tensor reaches each kernel as its op of
                  ``kernels/meta_ops.py`` (the kernel's output shape, no
                  data), and the mode adds the op's logical work from one
                  table (:data:`_KERNEL_WORK`), so a plain version's
                  step-by-step emulation is never counted.  An AXQ GEMM
                  counts 2 M N K under ``s32``, the gated one twice that, an
                  expert batch E times its product; attention counts QK^T
                  and PV over the extent the reference's dots cover (the
                  whole S x S_kv, ``tri`` included; a window's span; the
                  whole cache at decode).  The backward oracles run op by
                  op on meta and are counted as aten products;
  collectives     calls and bytes by kind, through the same
                  ``collectives.counter.add`` calls as the live path: on a
                  meta mesh (``launch.mesh.make_production_mesh``) every
                  axis wider than 1 holds a :class:`~repro_torch.dist.meshctx.MetaGroup`,
                  on which each collective counts and returns a meta result
                  of the right shape with no process group.

``while_trip_counts`` stays empty: an eager step unrolls its layers, so
every layer's work is counted where it runs.  The memory report is the
eager one: ``argument_bytes`` the tensors handed in (the rank's shards of
the parameters, the optimiser state, the cache and the batch, each storage
once), ``output_bytes`` the result's tensors (a cache updated in place
counts there too), ``peak_bytes`` the arguments plus the largest total of
live tensors the counting mode saw made, each freed when its last
reference (autograd's saved tensors included) dies.  The reference's
``temp_bytes`` is XLA's buffer assignment, a different quantity; the
caching allocator of the card is not modelled either.

The HLO text walker (``analyze_hlo``, ``shape_bytes``,
``_cond_trip_count``) has no counterpart: the port emits no HLO text.
"""

from __future__ import annotations

import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta_ops as K
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor

#: torch dtypes under the reference's HLO names
HLO_DTYPES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
    torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
}


def hlo_dtype(dtype: torch.dtype) -> str:
    return HLO_DTYPES.get(dtype, str(dtype).replace("torch.", ""))


@dataclass
class CollectiveReport:
    bytes_by_kind: dict[str, float] = field(default_factory=dict)
    calls_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add(self, kind: str, nbytes: float, calls: int = 1) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.calls_by_kind[kind] = self.calls_by_kind.get(kind, 0) + calls

    def as_dict(self) -> dict:
        return {"total_bytes": self.total_bytes, "by_kind": dict(self.bytes_by_kind),
                "calls_by_kind": dict(self.calls_by_kind)}


@dataclass
class MemoryReport:
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    def as_dict(self) -> dict:
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "peak_bytes": self.peak_bytes}


@dataclass
class HloReport:
    dot_flops: float = 0.0
    dot_flops_by_dtype: dict[str, float] = field(default_factory=dict)
    collectives: CollectiveReport = field(default_factory=CollectiveReport)
    while_trip_counts: dict[str, int] = field(default_factory=dict)
    memory: MemoryReport = field(default_factory=MemoryReport)
    #: every counted product: (what, dtype, flops), in the order it ran
    dots: list = field(default_factory=list)
    trace_s: float = 0.0
    #: what the step returned (meta tensors: its shapes and dtypes)
    output: Any = field(default=None, repr=False)

    def add_dot(self, what: str, dtype: str, flops: float) -> None:
        self.dot_flops += flops
        self.dot_flops_by_dtype[dtype] = self.dot_flops_by_dtype.get(dtype, 0.0) + flops
        self.dots.append((what, dtype, flops))

    def as_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
            "collectives": self.collectives.as_dict(),
            "while_trip_counts": dict(self.while_trip_counts),
        }


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------


def _storage_key(t: Tensor):
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    """The tensor leaves of a tree (other leaves are skipped)."""
    return [t for t in tree_leaves(tree) if isinstance(t, Tensor)]


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors, each storage once (a view adds
    nothing to the tensor it views)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _int_mm_flops(args) -> float:
    (m, k), n = args[0].shape, args[1].shape[1]
    return 2.0 * m * n * k


# ---------------------------------------------------------------------------
# the kernels' logical work, by op of kernels/meta_ops.py
# ---------------------------------------------------------------------------


def _gemm(x: Tensor, *qws: Tensor) -> list:
    """An AXQ GEMM kernel: each pack's int8 product with every row of x
    (two for the gated core; E experts' rows for a batch), 2 M N K each,
    under ``s32`` as the reference's integer einsum accumulates them."""
    return [("", "s32", 2.0 * x.numel() * qws[0].shape[-2] * len(qws))]


def _blocks(S: int, block: int) -> int:
    b = min(block, S)
    while S % b:
        b //= 2
    return b


def _prefill_attention(q: Tensor, k: Tensor, v: Tensor, window) -> list:
    """Prefill attention, q (B, S, H, D), k / v (B, S_kv, KVr, D): QK^T and
    PV over the extent the reference's jnp attention covers with its dots
    (``repro.models.attention.attn_blockwise``).  Up to 512 positions its
    one-shot form: the whole S x S_kv, the scores in f32 and PV in v's
    dtype; beyond, 512-position query blocks in f32 over every kv block
    (the causal ``tri`` schedule's skipped blocks included) or, with a
    window shorter than S, over the window's span of kv blocks."""
    B, S, H, D = q.shape
    span, pv = k.shape[1], hlo_dtype(v.dtype)
    if S > 512:
        pv = "f32"
        if window is not None and window < S:
            qb, kb = _blocks(S, 512), _blocks(S, 512)
            span = min(-(-(window + qb) // kb) * kb, S)
    flops = 2.0 * B * H * S * span * D
    return [(" q.k", "f32", flops), (" p.v", pv, flops)]


def _decode_attention(qg: Tensor, k: Tensor) -> list:
    """One decode token, grouped qg (B, KVr, G, D), against a cache of T
    positions: QK^T and PV over the whole cache in f32, as the reference's
    ``decode_attn`` reads it."""
    flops = 2.0 * qg.numel() * k.shape[1]
    return [(" q.k", "f32", flops), (" p.v", "f32", flops)]


def _fir_valid(x: Tensor, taps: Tensor) -> list:
    return [("", "s32", 2.0 * taps.shape[0] * (x.shape[0] - taps.shape[0]))]


#: op of ``kernels/meta_ops.py`` -> its kernel's products from the op's
#: operands: [(suffix of the product's name, dtype, flops)]
_KERNEL_WORK = {
    K.axqmm: _gemm, K.axqmm_gated: _gemm,
    K.axqmm_experts: _gemm, K.axqmm_gated_experts: _gemm,
    K.flash_attention: _prefill_attention,
    K.flash_decode: _decode_attention,
    K.fir_valid: _fir_valid,
    K.pr_fir: lambda x, taps, tail: [("", "s32", 2.0 * x.numel() * taps.shape[0])],
    K.pr_conv2d: lambda img, kern: [("", "s32", 2.0 * img.numel() * kern.numel())],
}


class _Counting(TorchDispatchMode):
    """Counts the products every aten op and every kernel op of the step
    runs and tracks the bytes of the tensors it makes until they die."""

    def __init__(self, report: HloReport, argument_keys: set):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.report = report
        self.registry = flop_registry
        self.keys = set(argument_keys)   # storages already accounted for
        self.refs: dict = {}             # storage -> live tensors made here
        self.sizes: dict = {}
        self.live = 0
        self.peak = 0

    def _release(self, key) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.sizes.pop(key)
            self.keys.discard(key)

    def _track(self, t: Tensor) -> None:
        if t.device.type != "meta":
            return
        key = _storage_key(t)
        if key in self.keys and key not in self.refs:
            return                       # an argument's storage, or a view of it
        if key not in self.refs:
            self.keys.add(key)
            self.refs[key] = 0
            self.sizes[key] = t.untyped_storage().nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = 0.0
        if packet in _KERNEL_WORK:
            for suffix, dtype, f in _KERNEL_WORK[packet](*args, **kwargs):
                self.report.add_dot(f"{packet}{suffix}", dtype, f)
        elif packet is torch.ops.aten._int_mm:
            flops = _int_mm_flops(args)
        elif packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
        if flops:
            first = out[0] if isinstance(out, (tuple, list)) else out
            self.report.add_dot(str(packet), hlo_dtype(first.dtype), float(flops))
        ins = [a for a in args if isinstance(a, Tensor)]
        for t in (out,) if isinstance(out, Tensor) else _tensors(out):
            if not any(t is a for a in ins):     # an in-place op returns its input
                self._track(t)
        return out


@contextmanager
def _fresh_counter():
    """The collectives count into a counter of their own while the step
    is analysed (the live counter is left as it was)."""
    from repro_torch.dist import collectives

    live = collectives.counter
    collectives.counter = collectives.CollectiveCounter()
    try:
        yield collectives.counter
    finally:
        collectives.counter = live


def analyze_step(fn, *args, **kw) -> HloReport:
    """Run ``fn(*args, **kw)`` on meta inputs and count its work: an
    :class:`HloReport` with the products, the collectives, the memory and
    the seconds the run took (``trace_s``).  Every tensor handed in must
    lie on the meta device."""
    inputs = _tensors((args, kw))
    off = sorted({str(t.device) for t in inputs if t.device.type != "meta"})
    if off:
        raise ValueError(f"analyze_step runs on meta tensors; got tensors on {off}")
    report = HloReport()
    report.memory.argument_bytes = tree_bytes((args, kw))
    mode = _Counting(report, {_storage_key(t) for t in inputs})
    t0 = time.perf_counter()
    with _fresh_counter() as ctr, mode:
        out = fn(*args, **kw)
    report.trace_s = time.perf_counter() - t0
    for kind, nbytes in ctr.bytes.items():
        report.collectives.add(kind, float(nbytes), ctr.calls[kind])
    report.memory.output_bytes = tree_bytes(out)
    report.memory.peak_bytes = report.memory.argument_bytes + mode.peak
    report.output = out
    return report
