"""Mamba-2 (SSD, state-space duality) in PyTorch: the chunked dual form for
prefill and the one-step recurrent update for decode (arXiv:2405.21060).

Port of ``repro.models.ssm``.  Layer parameters are stacked along a leading
(n_layers, ...) axis as in the reference; its layer ``scan`` is a Python
loop over the stack.  The projections go through the approximation layer
(the fused ``in_proj`` and ``out_proj``, the residual in the latter's
epilogue); the SSD algebra is plain PyTorch in f32, as the reference's
einsums are jnp (no TPU kernel computes it).

Chunked algorithm (chunk length Q, per head h; state (H, P, N)):

  h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x) X_t
  y_t = C_t . h_t + D * X_t
  intra-chunk: Y[s] += sum_{t<=s} (C_s . B_t) exp(cum_s - cum_t) dt_t X_t
  inter-chunk: Y[s] += C_s . h_prev exp(cum_s); h = exp(cum_Q) h_prev + states

The chunk products run batched over every (row, chunk) at once, as the
reference's einsums do, and the state passes from chunk to chunk in a loop
of elementwise updates.  A product's batch count follows the rows and the
padding, its per-element sums do not: a bucket-padded prefill gives the
exact-length one's state bit for bit (``chip_smoke.py`` phase 4 checks it
on the card).  The f32 products need TF32 off, which the chunked path
checks on the card.

Decode is the O(1) recurrent update; the state cache (:class:`SSMCache`:
h, the conv tail, length) is updated in place, so a step captured in a
CUDA graph advances the engine's tensors.

Tensor parallelism (a mesh whose ``model`` axis is wider than 1, serving
and training alike): the parameters are this rank's heads
(``dist/sharding.py``): ``in_proj``'s columns ``[z_r | x_r | B | C | dt_r]``
(one launch), the conv's channels ``[x_r | B | C]``, the heads' ``dt_bias``
/ ``a_log`` / ``D`` and ``gnorm`` scales, ``out_proj``'s rows.  Every rank
computes B and C whole and runs the SSD on its heads; ``gnorm`` sums its
channels' squares over ``model`` (``layers.rmsnorm_split_apply``) and
``out_proj``'s partials are all-reduced (``ops.approx_matmul``), so a
decode tick makes 2L + 1 all-reduces (and the embedding's).  B and C are
replicated values that rank-local heads consume: under autograd each
rank's cotangent of them is its heads' part, so the gradient of their
weights (``in_proj``'s B / C columns, the conv's B / C channels) is summed
over ``model`` (``collectives.sum_grad_columns``), while the normed input's
dx takes each rank's part once, in ``layers.column_input``'s sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxPolicy
from repro_torch.dist import collectives, meshctx
from repro_torch.models import layers as L
from repro_torch.models.cache_ops import cache_reset_slot
from repro_torch.models.degrees import split_degree
from repro_torch.models.transformer import (_dtype, _head, layer_params, remat_call,
                                            state_write_plan, write_lengths, write_rows)

Tensor = torch.Tensor


def _dims(cfg: ArchConfig, m: int = 1):
    """(d_in, H, P, N) of one of ``m`` ranks: d_in and H its heads' (the
    global ones for ``m`` = 1)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.headdim
    if H % m:
        raise ValueError(f"{cfg.name}: {H} SSM heads do not split over tp={m}")
    return d_in // m, H // m, s.headdim, s.d_state


def _local_dims(cfg: ArchConfig):
    """:func:`_dims` of this rank on the active mesh's ``model`` axis."""
    return _dims(cfg, meshctx.model_size())


def init_ssm_block(gen: torch.Generator, cfg: ArchConfig, stack: tuple = (), device="cpu"):
    """One block's parameters (``stack`` prepends leading dims)."""
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    s = cfg.ssm
    u = torch.rand((*stack, H), generator=gen, device=device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    return {
        "ln": L.init_rmsnorm(d, stack, device),
        # fused input projection: [z, x, B, C, dt]
        "in_proj": L.init_dense(gen, d, 2 * d_in + 2 * N + H, stack=stack, device=device),
        "conv": L.init_conv1d(gen, d_in + 2 * N, s.conv_width, stack, device),
        "dt_bias": torch.log(torch.expm1(dt)),               # softplus^-1(dt)
        "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=device)
                           ).expand(*stack, H).clone(),
        "D": torch.ones((*stack, H), dtype=torch.float32, device=device),
        "gnorm": L.init_rmsnorm(d_in, stack, device),
        "out_proj": L.init_dense(gen, d_in, d, scale=1.0 / math.sqrt(d_in), stack=stack,
                                 device=device),
    }


def _split_proj(proj: Tensor, d_in: int, N: int):
    return proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N], proj[..., 2 * d_in + 2 * N:]


def _grad_whole_bc(bp, d_in: int, N: int):
    """``bp`` with the gradients of B and C's weights summed over
    ``model`` under autograd on a mesh (module docstring): ``in_proj``'s
    columns ``[2 d_in, 2 d_in + 2N)`` and the conv's channels ``[d_in,
    d_in + 2N)`` (local widths).  ``bp`` itself otherwise (serving: packed
    weights, or none that requires a gradient)."""
    mesh = meshctx.get_mesh()
    w = bp["in_proj"]["w"]
    if (mesh.size("model") == 1 or not torch.is_grad_enabled()
            or not isinstance(w, Tensor) or not w.requires_grad):
        return bp
    g = mesh.group("model")
    lo = 2 * d_in
    return {**bp,
            "in_proj": {**bp["in_proj"], "w": collectives.sum_grad_columns(
                bp["in_proj"]["w"], g, lo, lo + 2 * N)},
            "conv": {k: collectives.sum_grad_columns(v, g, d_in, d_in + 2 * N)
                     for k, v in bp["conv"].items()}}


def _segsum_decay(dtA: Tensor) -> tuple[Tensor, Tensor]:
    """dtA: (..., Q, H) negative log-decays.  Returns (cum inclusive
    (..., Q, H), L (..., H, Q, Q) lower-triangular exp(cum_s - cum_t))."""
    cum = torch.cumsum(dtA, dim=-2)
    diff = cum[..., :, None, :] - cum[..., None, :, :]        # (..., Q, Q, H) s,t
    Q = dtA.shape[-2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dtA.device))
    diff = torch.where(mask[..., None], diff, -math.inf)
    return cum, torch.movedim(torch.exp(diff), -1, -3)


def _conv_tail(ci: Tensor, lengths: Tensor, width: int) -> Tensor:
    """Per-row causal-conv state: the ``width - 1`` inputs ending at
    position ``length - 1`` (zeros where the row is shorter); lengths are
    clamped to the row, so a dummy row's length reads nothing out of range."""
    B, S, C = ci.shape
    pad = torch.zeros((B, width - 1, C), dtype=ci.dtype, device=ci.device)
    xp = torch.cat([pad, ci], dim=1)                          # xp[t + w - 1] = ci[t]
    n = torch.clamp(lengths.to(torch.int64), 0, S)
    idx = n[:, None] + torch.arange(width - 1, dtype=torch.int64, device=ci.device)[None]
    return torch.gather(xp, 1, idx[..., None].expand(B, width - 1, C))


def _check_f32_products(x: Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the SSD chunk products need f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _chunks(Xc, Bc, Cc, dtc, A, Dh):
    """Every chunk of every row at once: X (B, nc, Q, H, P), B/C (B, nc, Q,
    N), dt (B, nc, Q, H) f32.  Returns (Y (B, nc, Q, H, P), the state after
    the last chunk (B, H, P, N))."""
    B_, nc, Q, H, P = Xc.shape
    N = Bc.shape[-1]
    cum, Lmat = _segsum_decay(dtc * A)                   # (B, nc, Q, H), (B, nc, H, Q, Q)
    # intra-chunk
    scores = (Cc @ Bc.transpose(-1, -2))[:, :, None] * Lmat          # (B, nc, H, Q, Q) s,t
    dtX = (dtc[..., None] * Xc).permute(0, 1, 3, 2, 4)               # (B, nc, H, Q, P)
    Y = torch.matmul(scores, dtX).permute(0, 1, 3, 2, 4)             # (B, nc, Q, H, P)
    # chunk summaries, then the state entering each chunk
    decay_out = torch.exp(cum[:, :, -1:] - cum)                      # (B, nc, Q, H)
    w = ((decay_out * dtc)[..., None] * Xc).reshape(B_, nc, Q, H * P)
    states = torch.matmul(w.transpose(-1, -2), Bc).reshape(B_, nc, H, P, N)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]           # (B, nc, H, 1, 1)
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=Xc.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c] * h + states[:, c]
    h_prevs = torch.stack(h_prevs, 1).permute(0, 1, 4, 2, 3).reshape(B_, nc, N, H * P)
    # the state entering the chunk, decayed to each position
    Y = Y + torch.matmul(Cc, h_prevs).reshape(B_, nc, Q, H, P) * torch.exp(cum)[..., None]
    return Y + Dh[:, None] * Xc, h


def ssm_block_apply(bp, x_res: Tensor, cfg: ArchConfig, policy: ApproxPolicy, path: str,
                    degree=None, state=None, return_state: bool = False,
                    lengths: Tensor | None = None):
    """x_res: (B, S, d).  ``state`` = (h (B, H, P, N), conv (B, w-1, C))
    for decode.  Returns (out, new_state): the chunked (prefill) path
    returns the post-sequence (h, conv) state with ``return_state``.

    The chunked path pads the tail to the configured chunk length with
    zero-dt steps (exp(0) = 1 decay, zero input: an identity update); with
    ``lengths`` (B,) the same dt masking applies per row and the state is
    the row's at its true length.  On a mesh: this rank's heads (module
    docstring); ``state`` and the returned one are the rank's."""
    d_in, H, P, N = _local_dims(cfg)
    s = cfg.ssm
    B_, S, _ = x_res.shape
    bp = _grad_whole_bc(bp, d_in, N)
    xln = L.rmsnorm_apply(bp["ln"], x_res, cfg.norm_eps)
    xln = L.column_input(xln, policy, (path + "/in_proj",))
    proj = L.dense_apply(bp["in_proj"], xln, policy, path + "/in_proj", degree)
    z, xBC, dt_raw = _split_proj(proj, d_in, N)
    ci = L.act_rounded("silu")(xBC)
    xBC, new_conv = L.conv1d_apply(bp["conv"], ci, None if state is None else state[1])
    Xf = xBC[..., :d_in].reshape(B_, S, H, P).to(torch.float32)
    Bm = xBC[..., d_in:d_in + N].to(torch.float32)
    Cm = xBC[..., d_in + N:].to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + bp["dt_bias"])            # (B, S, H)
    A = -torch.exp(bp["a_log"])                                          # (H,)

    if state is not None:
        # decode: one step, the recurrent update
        a = torch.exp(dt[:, 0] * A)                                      # (B, H)
        dBx = (dt[:, 0, :, None] * Xf[:, 0])[..., None] * Bm[:, 0, None, None, :]
        h = a[..., None, None] * state[0] + dBx                          # (B, H, P, N)
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h)
        y = (y + bp["D"][None, :, None] * Xf[:, 0]).reshape(B_, 1, d_in)
        new_state = (h, new_conv)
    else:
        _check_f32_products(x_res)
        Q = s.chunk
        S_pad = -(-S // Q) * Q
        if lengths is not None:
            vmask = torch.arange(S, device=x_res.device)[None] < lengths[:, None]
            dt = torch.where(vmask[..., None], dt, 0.0)
        if S_pad != S:
            Xf = F.pad(Xf, (0, 0, 0, 0, 0, S_pad - S))
            Bm, Cm, dt = (F.pad(t, (0, 0, 0, S_pad - S)) for t in (Bm, Cm, dt))
        nc = S_pad // Q
        Y, h_last = _chunks(Xf.reshape(B_, nc, Q, H, P), Bm.reshape(B_, nc, Q, N),
                            Cm.reshape(B_, nc, Q, N), dt.reshape(B_, nc, Q, H), A, bp["D"])
        y = Y.reshape(B_, S_pad, d_in)[:, :S]
        new_state = None
        if return_state:
            if lengths is not None:
                new_conv = _conv_tail(ci, lengths, s.conv_width)
            new_state = (h_last, new_conv)

    y = y.to(x_res.dtype) * L.act_rounded("silu")(z)
    y = L.rmsnorm_split_apply(bp["gnorm"], y, cfg.norm_eps)
    # the residual rides the out-projection's epilogue (in-kernel on AXQ)
    y = L.dense_apply(bp["out_proj"], y, policy, path + "/out_proj", degree,
                      residual=x_res)
    return y, new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_ssm_lm(gen: torch.Generator, cfg: ArchConfig, tp: int = 1, device="cpu"):
    return {
        "embed": L.init_embedding(gen, cfg.padded(tp).vocab, cfg.d_model, device),
        "layers": init_ssm_block(gen, cfg, (cfg.n_layers,), device),
        "ln_f": L.init_rmsnorm(cfg.d_model, device=device),
    }


def _layer_degree(ldeg, i):
    return None if ldeg is None else ldeg[i]


def ssm_forward(params, cfg: ArchConfig, policy: ApproxPolicy, batch: dict, tp: int = 1,
                degree=None, remat: str = "dots") -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, vocab_padded) f32, a zero aux loss).  Under
    autograd each layer runs under ``remat`` (``transformer.remat_call``)."""
    tokens = batch["tokens"]
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))

    def body(bp, h, dg):
        return ssm_block_apply(bp, h, cfg, policy, "layer", dg)[0]

    for i in range(cfg.n_layers):
        x = remat_call(remat, body, layer_params(params["layers"], i), x,
                       _layer_degree(ldeg, i))
    return (_head(params, cfg, policy, x, hdeg),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def init_conv_tail(shape, cfg: ArchConfig, dtype, device) -> Tensor:
    """A state cache's conv-tail field, zeros in the model's compute dtype:
    the dtype the reference's decode returns it in.  Where the cache dtype
    differs, the tensor carries ``tail_round = dtype``: prefill writes round
    through it (:func:`tail_value`), as the reference's prefills write into
    its cache-dtype field, until the cache's first decode step
    (:func:`tail_decoded`), after which the reference's field holds the
    compute dtype and its prefills write unrounded.  The field keeps one
    address throughout, as a captured step needs."""
    t = torch.zeros(shape, dtype=_dtype(cfg), device=device)
    t.tail_round = dtype if dtype != t.dtype else None
    return t


def tail_value(conv: Tensor, nc: Tensor) -> Tensor:
    """A prefill's conv tail ``nc`` as ``conv`` stores it."""
    rd = getattr(conv, "tail_round", None)
    return (nc if rd is None else nc.to(rd)).to(conv.dtype)


def tail_decoded(conv: Tensor) -> None:
    """The cache took a decode step: prefills stop rounding its tails."""
    if getattr(conv, "tail_round", None) is not None:
        conv.tail_round = None


class SSMCache(NamedTuple):
    h: Tensor       # (L, B, H, P, N) f32
    conv: Tensor    # (L, B, w-1, C)
    length: Tensor  # (B,) int32


def init_ssm_cache(cfg: ArchConfig, tp: int, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu") -> SSMCache:
    """The state cache of this rank's heads (all of them on one device):
    its bytes do not depend on ``max_len``."""
    m = meshctx.model_size()
    if m > 1 and tp != m:
        raise ValueError(f"tp={tp} on a mesh whose model axis is {m}")
    d_in, H, P, N = _dims(cfg, m)
    w = cfg.ssm.conv_width
    return SSMCache(
        h=torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32, device=device),
        conv=init_conv_tail((cfg.n_layers, batch, w - 1, d_in + 2 * N), cfg, dtype, device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def ssm_prefill(params, cfg: ArchConfig, policy: ApproxPolicy, cache: SSMCache,
                tokens: Tensor, slot, tp: int = 1, degree=None):
    """Fused prefill: one chunked-dual-form forward over the prompt, the
    final recurrent and conv state written into ``slot``'s region in place
    (the region is reset first: reuse equals fresh).

    tokens: (P,) int.  The prompt is padded to the chunk multiple at the
    token level and its true length passed down as a mask, as the
    reference does.  Returns (last-position logits (1, V) f32, the cache
    with ``length[slot] = P``)."""
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    cache_reset_slot(cache, slot)
    P = tokens.shape[0]
    Q = cfg.ssm.chunk
    S_pad = -(-P // Q) * Q
    if S_pad != P:
        tokens = F.pad(tokens, (0, S_pad - P))
    lengths = torch.full((1,), P, dtype=torch.int64, device=tokens.device)
    x = L.embed_apply(params["embed"], tokens[None], _dtype(cfg))      # (1, S_pad, d)
    for i in range(cfg.n_layers):
        x, (nh, nc) = ssm_block_apply(layer_params(params["layers"], i), x, cfg, policy,
                                      "layer", _layer_degree(ldeg, i), return_state=True,
                                      lengths=lengths)
        cache.h[i, slot] = nh[0]
        cache.conv[i, slot] = tail_value(cache.conv, nc[0])
    cache.length[slot] = P
    logits = _head(params, cfg, policy, x[:, P - 1:P], hdeg)
    return logits[:, 0], cache


def ssm_prefill_batch(params, cfg: ArchConfig, policy: ApproxPolicy, cache: SSMCache,
                      tokens: Tensor, slots, lengths, tp: int = 1, degree=None) -> SSMCache:
    """Bucketed/packed prefill: rows (N, Pb) padded to one bucket length,
    each row's final state written into its slot in place, its length set;
    per row bit-identical to :func:`ssm_prefill` at the exact length (the
    zero-dt tail masking: a padded chunk is an identity update).  ``slots`` /
    ``lengths`` as in ``transformer.lm_prefill_batch`` (device tensors: no
    host read, capturable).  A row with ``slot`` outside ``[0, B)`` writes
    nothing; a live row of length 0 writes a reset state.  Returns the
    cache."""
    ldeg, _ = split_degree(degree, cfg.n_layers, tokens.device)
    plan = state_write_plan(tokens, slots, lengths, cache.length.shape[0])
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))            # (N, Pb, d)
    for i in range(cfg.n_layers):
        x, (nh, nc) = ssm_block_apply(layer_params(params["layers"], i), x, cfg, policy,
                                      "layer", _layer_degree(ldeg, i), return_state=True,
                                      lengths=plan.lengths)
        write_rows(cache.h[i], plan, nh)
        write_rows(cache.conv[i], plan, tail_value(cache.conv, nc))
    write_lengths(cache, plan)
    return cache


def ssm_decode_step(params, cfg: ArchConfig, policy: ApproxPolicy, cache: SSMCache,
                    tokens: Tensor, tp: int = 1, degree=None):
    """tokens: (B, 1).  One recurrent step over every slot, h and the conv
    tail advanced in place.  Returns (logits (B, 1, V) f32, the cache with
    ``length + 1``)."""
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))
    for i in range(cfg.n_layers):
        x, (nh, nc) = ssm_block_apply(layer_params(params["layers"], i), x, cfg, policy,
                                      "layer", _layer_degree(ldeg, i),
                                      state=(cache.h[i], cache.conv[i]))
        cache.h[i].copy_(nh)
        cache.conv[i].copy_(nc)
    tail_decoded(cache.conv)
    return _head(params, cfg, policy, x, hdeg), cache._replace(length=cache.length + 1)
