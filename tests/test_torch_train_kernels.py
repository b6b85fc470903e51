"""The kernels' gradients under autograd, held to the JAX reference on the
CPU: ``flash_attention_vjp`` (the plain forward here, the kernel on the
card; the backward through the materialized oracle) against ``jax.grad``
through the reference's ``flash_attention_vjp`` with K/V repeated to every
head (its router's GQA), and the blockwise AXQ backward against autograd
through the port's ``qmm_ref`` / ``qmm_gated_ref`` (1e-6 relative to each
gradient's largest entry) and against ``jax.vjp`` of the reference's
(1e-5), with ties in a block's amax (both split the gradient evenly).

Tolerance of attention: rtol 1e-5 / atol 1e-5 in f32 (the two frameworks
sum the softmax and the products in other orders)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import flash_attention as jfa
from repro.models.attention import repeat_kv as jrepeat
from repro_torch.core import quantization as tq
from repro_torch.kernels import _build, axq_grad
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.axqmm import ACTS

torch.set_num_threads(2)


def _jax_grouped_grads(q, k, v, g, causal, window):
    """jax.grad through the reference's flash_attention_vjp in the model
    layout: K/V repeated to all heads, flattened to (B*H, S, D)."""
    B, S, H, D = q.shape

    def flat(x):
        return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)

    def f(q, k, v):
        o = jfa.flash_attention_vjp(flat(q), flat(jrepeat(k, H)), flat(jrepeat(v, H)),
                                    causal, window)
        return jnp.sum(o.reshape(B, H, S, D).transpose(0, 2, 1, 3) * g)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("H,KVr,S,causal,window", [(4, 2, 40, True, None),
                                                   (4, 4, 33, False, None),
                                                   (6, 1, 150, True, None),
                                                   (4, 2, 150, True, 48)])
def test_flash_attention_vjp_grads_match_reference(H, KVr, S, causal, window):
    rng = np.random.default_rng(S + H)
    B, D = 2, 16
    q, g = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, KVr, D)).astype(np.float32) for _ in range(2))
    jg = _jax_grouped_grads(*(jnp.asarray(a) for a in (q, k, v, g)), causal, window)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = _build.backward_calls["flash_attention_bwd"]
    o = tdispatch.prefill_attention(qt, kt, vt, causal=causal, window=window)
    (o * torch.from_numpy(g)).sum().backward()
    assert _build.backward_calls["flash_attention_bwd"] == before + 1
    for t, j in zip((qt, kt, vt), jg):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_flash_attention_ref_is_the_plain_forward():
    """The oracle's forward equals the plain version the forward runs."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 70, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 70, 2, 16)).astype(np.float32))
            for _ in range(2))
    for window in (None, 20):
        torch.testing.assert_close(tfa.flash_attention_ref(q, k, v, True, window),
                                   tfa.flash_attention_grouped_plain(q, k, v, window=window),
                                   rtol=1e-5, atol=1e-5)


def _operands(seed, M, K, N, ties):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wu, wg = ((rng.standard_normal((K, N)) / math.sqrt(K)).astype(np.float32)
              for _ in range(2))
    g = rng.standard_normal((M, N)).astype(np.float32)
    if ties:
        # two and three equal |maxima| in some blocks of x and of the weights
        x[0, 3] = np.abs(x[0, :64]).max() + 1.0
        x[0, 9] = -x[0, 3]
        x[2, 70] = x[2, 71] = x[2, 75] = np.abs(x[2, 64:128]).max() + 0.5
        wu[5, 1] = np.abs(wu[:64, 1]).max() + 0.25
        wu[7, 1] = wu[5, 1]
    return x, wu, wg, g


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("ebits", [8, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_blockwise_axq_backward_matches_autograd_and_jax(ebits, ties):
    M, K, N, blk = 9, 256, 24, 64
    x, wu, wg, g = _operands(ebits + 10 * ties, M, K, N, ties)
    xs, wus, wgs, gs = (torch.from_numpy(a) for a in (x, wu, wg, g))
    # autograd through the port's oracles
    leaves = [t.clone().requires_grad_() for t in (xs, wus)]
    auto = torch.autograd.grad(tq.qmm_ref(*leaves, block=blk, ebits=ebits), leaves, gs)
    block = axq_grad.qmm_grads(xs, wus, gs, blk, ebits)
    leaves3 = [t.clone().requires_grad_() for t in (xs, wus, wgs)]
    auto3 = torch.autograd.grad(
        tq.qmm_gated_ref(*leaves3, ACTS["silu"], block=blk, ebits=ebits), leaves3, gs)
    block3 = axq_grad.qmm_gated_grads(xs, wus, wgs, gs, ACTS["silu"], blk, ebits)
    for a, b in zip(block + block3, auto + auto3):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6
    # jax.vjp of the reference's oracles
    _, vjp = jax.vjp(lambda a, b: jq.qmm_ref(a, b, block=blk, ebits=ebits),
                     jnp.asarray(x), jnp.asarray(wu))
    _, vjp3 = jax.vjp(lambda a, b, c: jq.qmm_gated_ref(a, b, c, jax.nn.silu, block=blk,
                                                        ebits=ebits),
                      jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wg))
    for a, b in zip(block + block3, vjp(jnp.asarray(g)) + vjp3(jnp.asarray(g))):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5
    # the gradient reaches only the entries at a block's amax, split evenly
    dx = block[0].numpy()
    if ties:
        assert dx[0, 3] == -dx[0, 9] != 0
        assert dx[2, 70] == dx[2, 71] == dx[2, 75] != 0
    nz = np.count_nonzero(dx.reshape(M, K // blk, blk), axis=-1)
    assert nz.max() <= 3


def test_axq_router_backward_counts_and_moe_experts():
    """The routers' autograd Functions run the blockwise backward (counted
    as axqmm_bwd / axqmm_gated_bwd), equal to axq_grad's directly."""
    x, wu, wg, g = _operands(1, 7, 256, 40, False)
    xs, wus, wgs = (torch.from_numpy(a).requires_grad_() for a in (x, wu, wg))
    _build.reset_counts()
    y = tdispatch.axq_matmul(xs, wus, block=128, ebits=6)
    (y * torch.from_numpy(g)).sum().backward()
    want = axq_grad.qmm_grads(xs.detach(), wus.detach(), torch.from_numpy(g), 128, 6)
    assert torch.equal(xs.grad, want[0]) and torch.equal(wus.grad, want[1])
    yg = tdispatch.axq_gated(xs, wus, wgs, block=128, ebits=6)
    (yg * torch.from_numpy(g)).sum().backward()
    assert _build.backward_calls["axqmm_bwd"] == 1
    assert _build.backward_calls["axqmm_gated_bwd"] == 1
    _build.reset_counts()
    assert _build.backward_calls["axqmm_bwd"] == 0
