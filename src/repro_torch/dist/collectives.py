"""Approximation-compressed collectives (the port of
``repro.dist.collectives``) and the exact collectives tensor parallelism
needs.

The dissertation trades arithmetic exactness for energy and area with a
runtime degree; the same trade on the interconnect moves gradients and
tensor-parallel partial sums as int8 on the wire.  Two parts:

  one device   :func:`dp_allreduce_compressed` is the quantize-dequantize
               of the local contribution — what the reference's pjit path
               does before the partitioner's all-reduce (the data-parallel
               all-reduce is the identity on one device);
  a group      :func:`ring_allreduce_int8`, the reference's two-phase ring
               (``ring_allreduce_int8_local``) over a ``torch.distributed``
               group: n-1 reduce-scatter hops that re-quantize the running
               partial, n-1 all-gather hops, each hop one int8 chunk plus
               its f32 scale through ``batch_isend_irecv``; and the exact
               :func:`all_reduce` / :func:`all_gather` the sharded model
               calls.

Training on a mesh differentiates through the model's collectives, the
Megatron pair and the kv-head gather made ``torch.autograd.Function``
classes over the counted :func:`all_reduce` / :func:`all_gather`:

  :func:`reduce_from_model`  forward an all-reduce sum over ``model``,
                             backward the identity (every consumer of the
                             sum is replicated across the ranks);
  :func:`copy_to_model`      forward the identity, backward an all-reduce
                             sum of the cotangent (the input of
                             column-parallel projections);
  :func:`gather_kv_heads`    forward an all-gather along the last dim,
                             backward an all-reduce sum then this rank's
                             slice (each rank narrows the gathered heads to
                             other repeated heads, so the cotangents differ
                             across ranks and must be summed);
  :func:`gather_from_model`  forward an all-gather along a dim, backward
                             this rank's slice of the cotangent, no
                             collective (the gathered tensor's consumers are
                             replicated, so every rank holds the same
                             cotangent: a frontend's column-parallel weight,
                             gathered whole before its product);
  :func:`ring_reduce_from_model`  forward the int8 ring all-reduce,
                             backward the identity (the straight-through
                             backward of the reference's ``_ring_psum_model``,
                             the MoE combine under ``REPRO_RING_TP``);
  :func:`sum_over_model`     forward and backward both an all-reduce sum
                             (a sum that rank-local values consume: the
                             sum of squares of a norm over a width split on
                             ``model``, whose cotangents differ across the
                             ranks);
  :func:`sum_grad_columns`   forward the identity, backward an all-reduce
                             sum of a range of the cotangent's last-dim
                             columns (the replicated columns of a weight
                             that rank-local heads consume: each rank's
                             gradient there is its heads' part).

Transport: on a gloo group, :func:`all_reduce` hands CUDA tensors to gloo,
which reduces them through its own host copies; the all-gather and the
ring's send/recv, which gloo moves only on CPU tensors, stage CUDA tensors
through host buffers explicitly.  So two ranks that share one card still
run every kernel on it.  An NCCL group takes CUDA tensors directly.  Every
collective counts the bytes it sends into :data:`counter`, by kind, the way
the reference's HLO analyzer reads a compiled step: an all-reduce or
all-gather by its operand bytes, a ring hop (``collective-permute``) by its
int8 payload plus its f32 scale, a :func:`broadcast_rows` (a fleet
replica's tick emission, sent from its first rank to the world) by its
payload.

On a meta mesh (``meshctx.make_meta_mesh``: a
:class:`~repro_torch.dist.meshctx.MetaGroup` on each axis, no process
group) every collective counts the calls and bytes it would send, the
same :data:`counter` entries, and returns an empty meta tensor of its
result's shape: the shape-only dry run of one rank's step
(``dist/hlo_analysis.py``).  A tensor that is not on the meta device
raises there.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.dist.meshctx import MetaGroup
from repro_torch.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


def quantize_dequantize(x: Tensor, bits: int = 8, amax=None) -> Tensor:
    """Symmetric per-tensor fake-quantization to ``bits`` (round to
    nearest, ties to even): error at most ``amax / qmax / 2``.  ``amax``
    (a device scalar) replaces ``max |x|``: the whole tensor's, for a
    shard of it."""
    qmax = float((1 << (bits - 1)) - 1)
    x32 = x.to(torch.float32)
    amax = torch.clamp(torch.max(torch.abs(x32)) if amax is None else amax, min=1e-30)
    scale = amax / qmax
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax)
    return (q * scale).to(x.dtype)


def ef_compress(g: Tensor, err: Tensor, bits: int = 8) -> tuple[Tensor, Tensor]:
    """Error-feedback compression: send the quantized (gradient + carried
    residual), carry the new residual.  ``sum(sent) + err_final ==
    sum(g_true)`` telescopes, so the residual stays within one step."""
    acc = g.to(torch.float32) + err.to(torch.float32)
    sent = quantize_dequantize(acc, bits)
    return sent, acc - sent


def dp_allreduce_compressed(x: Tensor, bits: int = 8) -> Tensor:
    """The data-parallel all-reduce with int-``bits`` wire emulation: on one
    device the quantize-dequantize of the local contribution."""
    return quantize_dequantize(x, bits)


def compress_tree_for_allreduce(grads, bits: int = 8, group=None):
    """:func:`dp_allreduce_compressed` on every matrix-shaped gradient; 1-d
    leaves (norm scales, biases) pass exactly.  On a mesh ``grads`` are
    this rank's shards of the global gradient and ``group`` the ``model``
    group: each leaf is quantized against the whole leaf's ``amax``, the
    maximum of the shards' (one MAX all-reduce of every leaf's local amax;
    a replicated leaf's is equal on every rank; with no group the local
    amax is the leaf's own)."""
    leaves = tree_leaves(grads)
    mats = [g for g in leaves if g.dim() >= 2]
    if not mats:
        return grads
    local = torch.stack([torch.max(torch.abs(g.to(torch.float32))) for g in mats])
    amax = iter(all_reduce(local, group, op="max").unbind(0))
    return tree_unflatten(grads, [quantize_dequantize(g, bits, next(amax))
                                  if g.dim() >= 2 else g for g in leaves])


# ---------------------------------------------------------------------------
# collectives over a group, with byte counters
# ---------------------------------------------------------------------------


class CollectiveCounter:
    """Bytes and calls of this process's collectives, by kind
    (``all-reduce``, ``all-gather``, ``collective-permute``: the ring's
    hops), and their host milliseconds: ``host_ms`` the collectives
    themselves (staging included), ``wait_ms`` the wait, before a gloo
    collective on a card, for the kernels already queued on the device."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: dict = {}
        self.calls: dict = {}
        self.host_ms = 0.0
        self.wait_ms = 0.0

    def add(self, kind: str, nbytes: int, calls: int = 1) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.calls[kind] = self.calls.get(kind, 0) + calls

    def snapshot(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "total": sum(self.bytes.values()), "host_ms": self.host_ms,
                "wait_ms": self.wait_ms}


#: this process's counts (one process a rank)
counter = CollectiveCounter()


def group_size(group) -> int:
    """The number of ranks of ``group`` (1 for None)."""
    if group is None:
        return 1
    if isinstance(group, MetaGroup):
        return group.size
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    if isinstance(group, MetaGroup):
        return group.rank
    return dist.get_rank(group)


def _on_meta(x: Tensor, group) -> bool:
    """Whether ``group`` is a meta mesh's axis (the collective then counts
    and returns shapes); a tensor with data on one raises."""
    if not isinstance(group, MetaGroup):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a collective over {group} takes meta tensors, got one on "
                         f"{x.device}")
    return True


def _staged(x: Tensor, group) -> bool:
    """A CUDA tensor on a gloo group (the all-gather and send/recv take it
    only through host copies)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _start(x: Tensor, group) -> float:
    """The start of a collective on the counter's clock.  On a gloo group
    a CUDA tensor is first waited for (the host copy would wait for it
    anyway): that wait, the kernels queued before the collective, goes to
    ``wait_ms``, so ``host_ms`` holds the collective alone."""
    t0 = time.perf_counter()
    if _staged(x, group):
        torch.cuda.synchronize(x.device)
        t1 = time.perf_counter()
        counter.wait_ms += (t1 - t0) * 1e3
        return t1
    return t0


def all_reduce(x: Tensor, group, op: str = "sum") -> Tensor:
    """The exact sum (``op="max"``: the maximum) of ``x`` over ``group`` (a
    new tensor on x's device; ``x`` itself when ``group`` is None).  A
    CUDA tensor goes to a gloo group as it is for a sum; a maximum, which
    only the small reductions take, is staged through the host."""
    if group is None:
        return x
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    if _on_meta(x, group):
        counter.add("all-reduce", x.numel() * x.element_size())
        return torch.empty_like(x)
    t0 = _start(x, group)
    counter.add("all-reduce", x.numel() * x.element_size())
    staged = op == "max" and _staged(x, group)
    out = x.detach().to("cpu") if staged else x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    if staged:
        out = out.to(x.device)
    counter.host_ms += (time.perf_counter() - t0) * 1e3
    return out


def all_gather(x: Tensor, group, dim: int = -1) -> Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    if _on_meta(x, group):
        counter.add("all-gather", x.numel() * x.element_size())
        shape = list(x.shape)
        shape[dim] *= group.size
        return x.new_empty(shape)
    t0 = _start(x, group)
    n = dist.get_world_size(group)
    counter.add("all-gather", x.numel() * x.element_size())
    staged = _staged(x, group)
    src = x.detach().to("cpu") if staged else x.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(x.device)
    counter.host_ms += (time.perf_counter() - t0) * 1e3
    return out


# ---------------------------------------------------------------------------
# collectives under autograd (training on a mesh)
# ---------------------------------------------------------------------------


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, wire_dtype):
        ctx.group, ctx.wire_dtype = group, wire_dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.wire_dtype is None or ctx.wire_dtype == g.dtype:
            return all_reduce(g.contiguous(), ctx.group), None, None
        return all_reduce(g.to(ctx.wire_dtype), ctx.group).to(g.dtype), None, None


class _GatherKvHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.first = group_rank(group) * x.shape[-1]
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        full = all_reduce(g.contiguous(), ctx.group)
        return full.narrow(-1, ctx.first, ctx.width).contiguous(), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.first = group_rank(group) * x.shape[dim]
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.first, ctx.width).contiguous(), None, None


class _RingReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return ring_allreduce_int8(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _SumGradColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, lo, hi):
        ctx.group, ctx.lo, ctx.hi = group, lo, hi
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[..., ctx.lo:ctx.hi] = all_reduce(g[..., ctx.lo:ctx.hi].contiguous(), ctx.group)
        return g, None, None, None


def reduce_from_model(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over ``group`` (the row-parallel partials, the
    vocab-parallel embedding, the sharded loss's sums); its backward passes
    the cotangent through unchanged, which is right because every consumer
    of the sum is replicated across the group.  ``x`` itself when
    ``group`` is None."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)


def copy_to_model(x: Tensor, group, wire_dtype=None) -> Tensor:
    """``x`` unchanged; its backward sums the cotangent over ``group`` (the
    input of column-parallel projections, whose ranks each contribute the
    partial dx of their columns).  ``wire_dtype`` (bf16 under
    ``REPRO_BWD_BF16``) is the dtype the cotangent crosses the wire in."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group, wire_dtype)


def gather_kv_heads(x: Tensor, group) -> Tensor:
    """The ranks' ``x`` concatenated along the last dim (a rank's wk / wv
    columns when the group does not divide the kv heads); its backward
    sums the cotangent over ``group`` and returns this rank's columns."""
    if group is None:
        return x
    return _GatherKvHeads.apply(x, group)


def gather_from_model(x: Tensor, group, dim: int = -1) -> Tensor:
    """The ranks' ``x`` concatenated along ``dim``; its backward returns
    this rank's slice of the cotangent, which every rank holds whole
    because every consumer of the gathered tensor is replicated across
    the group."""
    if group is None:
        return x
    return _GatherFromModel.apply(x, group, dim % x.dim())


def ring_reduce_from_model(x: Tensor, group) -> Tensor:
    """:func:`ring_allreduce_int8` of ``x`` over ``group`` with the
    straight-through backward of :func:`reduce_from_model`: the cotangent
    unchanged."""
    if group is None:
        return x
    return _RingReduceFromModel.apply(x, group)


def sum_over_model(x: Tensor, group) -> Tensor:
    """The exact sum of ``x`` over ``group``, whose backward sums the
    cotangent over ``group`` too: right where rank-local values consume
    the sum (every rank's cotangent is its own consumers' part).  Exact
    under the int8-ring lever.  ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    return _SumOverModel.apply(x, group)


def sum_grad_columns(w: Tensor, group, lo: int, hi: int) -> Tensor:
    """``w`` unchanged; its backward sums the cotangent's last-dim columns
    ``[lo, hi)`` over ``group`` and leaves the others as they are: the
    columns of a weight replicated over the ranks whose outputs each rank
    consumes only for its own heads, so each rank's gradient there is a
    part of the whole.  ``w`` itself when ``group`` is None."""
    if group is None:
        return w
    return _SumGradColumns.apply(w, group, lo, hi)


def broadcast_value(value: float, group, device) -> float:
    """Group rank 0's ``value`` on every rank of ``group`` (a host
    decision made once and shared; not counted as a model collective)."""
    if group is None or isinstance(group, MetaGroup):
        return value
    dev = device if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return float(t.item())


def broadcast_rows(x: Tensor, rows: int, src: int, group) -> Tensor:
    """World rank ``src``'s ``(rows, ...)`` tensor on every rank of
    ``group``: ``x`` is that whole tensor on ``src`` and, on every other
    rank, any tensor of its trailing shape and dtype (a rank outside a
    fleet replica holds none of its rows).  The result lies on ``x``'s
    device.  gloo moves host copies; NCCL moves CUDA buffers.  ``x``
    itself when ``group`` is None."""
    if group is None:
        return x
    if _on_meta(x, group):
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        counter.add("broadcast", out.numel() * out.element_size())
        return out
    t0 = _start(x, group)
    nccl = dist.get_backend(group) == "nccl"
    wire = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    if dist.get_rank() == src:
        if x.shape[0] != rows:
            raise ValueError(f"the source holds {x.shape[0]} rows, the broadcast moves {rows}")
        buf = x.detach().to(wire).contiguous()
    else:
        buf = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=wire)
    counter.add("broadcast", buf.numel() * buf.element_size())
    dist.broadcast(buf, src=src, group=group)
    out = buf.to(x.device)
    counter.host_ms += (time.perf_counter() - t0) * 1e3
    return out


def _q8_chunk(x: Tensor):
    """Per-chunk symmetric int8 quantization: (int8 codes, f32 scale (1,))."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-30)
    scale = (amax / 127.0).reshape(1)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _deq(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def _hop(q: Tensor, scale: Tensor, group, nxt: int, prv: int):
    """One ring hop: send (q, scale) to ``nxt``, receive the same shapes
    from ``prv`` — one message: the scale's 4 bytes, then the int8 payload."""
    counter.add("collective-permute", q.numel() + 4)
    payload = torch.cat([scale.view(torch.uint8), q.view(torch.uint8)])
    dev = payload.device
    if _staged(payload, group):
        payload = payload.cpu()
    buf = torch.empty_like(payload)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, payload, nxt, group),
                                   dist.P2POp(dist.irecv, buf, prv, group)])
    for r in reqs:
        r.wait()
    buf = buf.to(dev)
    return buf[4:].view(torch.int8), buf[:4].view(torch.float32)


def ring_allreduce_int8(x: Tensor, group) -> Tensor:
    """Ring all-reduce of ``x`` over ``group`` with an int8 wire format:
    the reference's ``ring_allreduce_int8_local``, op for op.

    The flat f32 value is padded with zeros to ``n`` equal chunks.
    Reduce-scatter: n-1 hops, each re-quantizing the running partial
    against its own range before it is sent, after which rank i owns
    chunk (i+1) % n.  All-gather: n-1 hops forwarding each owner's chunk,
    quantized once.  The owner keeps its own chunk as the exact f32
    partial.  Wire cost a rank: ``2 (n-1) (chunk + 4)`` bytes against
    ``4 |x|`` for an f32 all-reduce's operand.  Returns x's shape and
    dtype.  Equal bit for bit to the reference's ring run op by op; its
    compiled form contracts a hop's dequantize-and-add into one fused
    multiply-add, a rounding apart (ROADMAP §C)."""
    if group is None:
        return x
    n = group_size(group)
    if n == 1:
        return x
    if _on_meta(x, group):
        chunk = -(-x.numel() // n)
        counter.add("collective-permute", 2 * (n - 1) * (chunk + 4), calls=2 * (n - 1))
        return torch.empty_like(x)
    t0 = _start(x, group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    flat = x.detach().to(torch.float32).reshape(-1)
    size = flat.shape[0]
    chunk = -(-size // n)
    pad = chunk * n - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, chunk)
    # reduce-scatter: after n-1 hops rank i owns chunk (i+1) % n
    part = chunks[me]
    for s in range(n - 1):
        q, scale = _hop(*_q8_chunk(part), group, nxt, prv)
        part = _deq(q, scale) + chunks[(me - s - 1) % n]
    own = (me + 1) % n
    # all-gather: forward each owner's chunk around the ring
    out = torch.empty((n, chunk), dtype=torch.float32, device=x.device)
    cq, cs = _q8_chunk(part)
    for s in range(n - 1):
        cq, cs = _hop(cq, cs, group, nxt, prv)
        out[(me - s) % n] = _deq(cq, cs)
    out[own] = part
    counter.host_ms += (time.perf_counter() - t0) * 1e3
    return out.reshape(-1)[:size].reshape(x.shape).to(x.dtype)
