"""Approximation-aware building blocks (param-dict style, PyTorch).

Parameters are nested dicts of tensors; ``init_*`` builds them from an
explicit ``torch.Generator``, ``*_apply`` consumes them.  Every matmul goes
through :func:`repro_torch.kernels.ops.approx_matmul` with the ApproxSpec
resolved from the model's ApproxPolicy by parameter path (DESIGN.md §2.3).

On a mesh whose ``model`` axis is wider than 1 (``dist/meshctx.py``) the
parameters are this rank's shards (``dist/sharding.py``): a projection's
output is the global value (``approx_matmul`` reduces the row-parallel
ones), the embedding is vocab-parallel (:func:`embed_apply`: a masked
local lookup, then an all-reduce) and the unembedding column-parallel
(local logits; :func:`gather_vocab` all-gathers them where whole rows are
needed).  The same code trains: the reductions are
``collectives.reduce_from_model`` (backward the identity), each normed
input of column-parallel projections passes :func:`column_input` (backward
an all-reduce of its dx), :func:`vocab_parallel_ce` takes the loss of
the sharded logits without gathering them, and :func:`rmsnorm_split_apply`
normalizes over a width split on ``model`` (a Mamba-2 block's ``gnorm``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxMode, ApproxPolicy
from repro_torch.dist import collectives, meshctx
from repro_torch.kernels import ops as kops
from repro_torch.kernels.axqmm import ACTS
from repro_torch.kernels.ops import approx_gated_matmul, approx_matmul

Tensor = torch.Tensor


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     device) -> Tensor:
    """``stddev`` x a standard normal truncated at ±2 (the reference's
    ``jax.random.truncated_normal(key, -2, 2)``), drawn from ``gen``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return t.mul_(stddev)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def init_dense(gen, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None, stack: tuple = (), device="cpu"):
    """``stack`` prepends leading dims (stacked layers, one draw each)."""
    stddev = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal(gen, (*stack, d_in, d_out), stddev, device)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=torch.float32, device=device)
    return p


def dense_apply(p, x: Tensor, policy: ApproxPolicy, path: str, degree=None,
                residual: Optional[Tensor] = None) -> Tensor:
    """``x @ w (+ b) (+ residual)``.  On the AXQ route bias and residual ride
    the kernel's fused f32 epilogue; elsewhere they are post-cast adds."""
    spec = policy.spec_for(path)
    if spec.mode == ApproxMode.AXQ:
        return approx_matmul(x, p["w"], spec, degree=degree, out_dtype=x.dtype,
                             path=path, bias=p.get("b"), residual=residual)
    y = approx_matmul(x, p["w"], spec, degree=degree, out_dtype=x.dtype, path=path)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    if residual is not None:
        y = residual + y
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, stack: tuple = (), device="cpu"):
    return {"scale": torch.ones((*stack, d), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(dt)


def rmsnorm_split_apply(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    """:func:`rmsnorm_apply` over a last dim that is this rank's channels
    of a width split on ``model`` (``p`` this rank's scales): the sum of
    squares of the rank's channels is summed over ``model``
    (``collectives.sum_over_model``: rank-local values consume it, so its
    backward sums too) and divided by the global width.  On a 1-wide
    ``model`` axis it is :func:`rmsnorm_apply`."""
    mesh = meshctx.get_mesh()
    m = mesh.size("model")
    if m == 1:
        return rmsnorm_apply(p, x, eps)
    dt = x.dtype
    x32 = x.to(torch.float32)
    ss = collectives.sum_over_model(torch.sum(torch.square(x32), dim=-1, keepdim=True),
                                    mesh.group("model"))
    y = x32 * torch.rsqrt(ss / (x.shape[-1] * m) + eps)
    return (y * p["scale"]).to(dt)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int, device="cpu"):
    # 1/sqrt(d) keeps tied-unembedding logits at unit variance
    return {"emb": truncated_normal(gen, (vocab, d), 1.0 / math.sqrt(d), device)}


def embed_apply(p, tokens: Tensor, dtype=torch.bfloat16) -> Tensor:
    """The token rows of the table, cast to ``dtype``.  On a mesh the table
    is this rank's vocab rows: the ids outside them look up zeros, and the
    all-reduce over ``model`` sums one row and zeros (exact)."""
    mesh = meshctx.get_mesh()
    if mesh.size("model") == 1:
        return F.embedding(tokens, p["emb"]).to(dtype)
    emb = p["emb"]
    n = emb.shape[0]
    local = tokens - mesh.coord("model") * n
    hit = (local >= 0) & (local < n)
    x = F.embedding(torch.where(hit, local, 0), emb)
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return collectives.reduce_from_model(x, mesh.group("model")).to(dtype)


def column_input(x: Tensor, policy: ApproxPolicy, paths) -> Tensor:
    """``x``, the normed input of the column-parallel projections at
    ``paths``, made ready for them on a mesh: its backward sums the ranks'
    dx partials over ``model`` (``collectives.copy_to_model``; in bf16
    under ``REPRO_BWD_BF16``).  Under the int8-ring lever every EXACT
    projection sends its own dx through the ring (``ops.ring_dx_path``),
    so ``x`` passes unchanged; a mix of ring and exact projections on one
    input raises.  Unchanged on one device and without autograd
    (serving)."""
    mesh = meshctx.get_mesh()
    if mesh.size("model") == 1 or not torch.is_grad_enabled():
        return x
    ring = [kops.ring_dx_path(p, policy.spec_for(p)) for p in paths]
    if all(ring):
        return x
    if any(ring):
        raise NotImplementedError(
            f"the int8 ring reduces the dx of {[p for p, r in zip(paths, ring) if r]} but "
            f"not of the other projections of the same input {list(paths)}")
    return collectives.copy_to_model(x, mesh.group("model"),
                                     torch.bfloat16 if kops._BWD_BF16 else None)


def vocab_parallel_ce(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """(sum of the log-likelihoods of ``labels`` over the entries with
    ``labels >= 0``, their count as f32) of this rank's vocab columns
    ``logits`` (..., V / tp) on a mesh, as the reference's partitioner
    reduces its sharded logits: the row max over the vocab by a MAX
    all-reduce (detached: the log-sum-exp's gradient does not depend on
    it), the sum of exponentials and the target logit through
    ``reduce_from_model``.  The logits are never gathered.  With a 1-wide
    ``model`` axis the plain ``log_softmax``."""
    mask = (labels >= 0).to(torch.float32)
    labels_c = torch.clamp(labels, min=0).to(torch.int64)
    mesh = meshctx.get_mesh()
    if mesh.size("model") == 1:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels_c[..., None])[..., 0]
        return torch.sum(ll * mask), torch.sum(mask)
    g = mesh.group("model")
    n = logits.shape[-1]
    m = collectives.all_reduce(logits.detach().amax(dim=-1), g, op="max")
    z = logits - m[..., None]
    se = collectives.reduce_from_model(torch.sum(torch.exp(z), dim=-1), g)
    local = labels_c - mesh.coord("model") * n
    hit = (local >= 0) & (local < n)
    tz = torch.gather(z, -1, torch.where(hit, local, 0)[..., None])[..., 0]
    tz = collectives.reduce_from_model(torch.where(hit, tz, torch.zeros_like(tz)), g)
    ll = tz - torch.log(se)
    return torch.sum(ll * mask), torch.sum(mask)


def gather_vocab(logits: Tensor) -> Tensor:
    """Vocab-sharded logits (..., V / tp) gathered into whole rows (...,
    V) over the ``model`` group; unchanged on one device."""
    mesh = meshctx.get_mesh()
    if mesh.size("model") == 1:
        return logits
    return collectives.all_gather(logits, mesh.group("model"), dim=-1)


def unembed_apply(p, x: Tensor, policy: ApproxPolicy, path: str,
                  degree=None) -> Tensor:
    """logits = x @ emb.T (tied); a prepacked tied unembedding rides the
    embed dict as ``unembed_q``."""
    spec = policy.spec_for(path)
    w = p.get("unembed_q")
    if w is None:
        w = p["emb"].t()
    return approx_matmul(x, w, spec, degree=degree, out_dtype=torch.float32, path=path)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, S, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def act_fn(name: str):
    return ACTS[name]


def _as(dtype, v: float) -> float:
    """``v`` rounded to ``dtype`` (a constant the reference casts first)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def _silu_rounded(x: Tensor) -> Tensor:
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_rounded(x: Tensor) -> Tensor:
    c, k = _as(x.dtype, math.sqrt(2 / math.pi)), _as(x.dtype, 0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


_ROUNDED_ACTS = {"silu": _silu_rounded, "gelu": _gelu_rounded}


def act_rounded(name: str):
    """The activation outside a GEMM on a tensor in the model's dtype, as
    ``jax.nn.silu`` / ``gelu`` (tanh form) write it, op for op, each op
    rounded to x's dtype and gelu's constants cast to it first.  ``ACTS``
    (``act_fn``) is the GEMM epilogue's form, one rounding of an f32
    value, which the kernels compute.  The recurrent blocks need this one:
    in bf16 under AXQ the fused form rounds ~40% of values one ulp away
    from the reference, and the int8 codes carry that past the bf16
    bounds (tests/test_torch_rglru.py::test_rounded_activations_hold_bf16_parity)."""
    return _ROUNDED_ACTS[name]


def init_gated_mlp(gen, d: int, d_ff: int, stack: tuple = (), device="cpu"):
    return {
        "up": init_dense(gen, d, d_ff, stack=stack, device=device),
        "gate": init_dense(gen, d, d_ff, stack=stack, device=device),
        "down": init_dense(gen, d_ff, d, scale=1.0 / math.sqrt(d_ff),
                           stack=stack, device=device),
    }


def gated_mlp_apply(p, x: Tensor, policy: ApproxPolicy, path: str,
                    act: str = "silu", degree=None,
                    residual: Optional[Tensor] = None) -> Tensor:
    """up/gate/act(gate)*up/down.  When up and gate share one AXQ spec the
    first half runs as ONE fused kernel; the down projection fuses
    ``residual`` into its epilogue."""
    spec_up = policy.spec_for(path + "/up")
    spec_gate = policy.spec_for(path + "/gate")
    if (spec_up.mode == ApproxMode.AXQ and spec_gate == spec_up
            and "b" not in p["up"] and "b" not in p["gate"]):
        h = approx_gated_matmul(x, p["up"]["w"], p["gate"]["w"], spec_up,
                                act=act, degree=degree, out_dtype=x.dtype)
    else:
        up = dense_apply(p["up"], x, policy, path + "/up", degree)
        gate = dense_apply(p["gate"], x, policy, path + "/gate", degree)
        h = act_fn(act)(gate) * up
    return dense_apply(p["down"], h, policy, path + "/down", degree,
                       residual=residual)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (the RG-LRU / Mamba front conv)
# ---------------------------------------------------------------------------


def init_conv1d(gen, channels: int, width: int, stack: tuple = (), device="cpu"):
    return {"w": truncated_normal(gen, (*stack, width, channels), 1.0 / math.sqrt(width),
                                  device),
            "b": torch.zeros((*stack, channels), dtype=torch.float32, device=device)}


def conv1d_apply(p, x: Tensor, state: Optional[Tensor] = None):
    """Causal depthwise conv.  x: (B, S, C).  With ``state`` (B, width-1, C)
    (decode) it is prepended in place of the zero history.  The f32 taps
    are summed in order ``i = 0..width-1``.  Returns (out in x.dtype, the
    last ``width - 1`` inputs: the state decode continues from)."""
    width = p["w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + S].to(torch.float32) * p["w"][i]
    out = (out + p["b"]).to(x.dtype)
    new_state = xp[:, xp.shape[1] - (width - 1):] if width > 1 else pad
    return out, new_state
