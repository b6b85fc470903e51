"""Port parity for each kernel module: the plain PyTorch version (what a
CPU tensor takes) against the JAX Pallas kernel in interpret mode, as
tests/test_kernels.py and tests/test_flash_decode.py run it (the CUDA
kernels against the same plain versions: tests/test_torch_gpu.py).

Tolerance: rtol 1e-5 / atol 1e-4, the ``qmm_*`` oracle tolerance of the
reference's kernel tests, for every comparison in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import axqmm as jaxq
from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro.kernels.qstore import prepack_weight as jprepack
from repro.models import attention as jattn
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _packed(w: np.ndarray, block: int):
    jp = jprepack(jnp.asarray(w), block)
    return jp, params_from_numpy(jax.tree.map(np.asarray, {"w": jp}))["w"]


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ebits", [8, 5])
def test_axqmm_packed_bias_residual_matches_pallas(ebits):
    rng = np.random.default_rng(ebits)
    M, K, N = 5, 512, 130                      # ragged M and N
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    jp, tp = _packed(w, 256)
    yj = jaxq.axqmm_packed(jnp.asarray(x), jp, ebits, bias=jnp.asarray(b),
                           residual=jnp.asarray(r), interpret=True)
    yt = taxq.axqmm_packed(_t(x), tp, torch.tensor(ebits, dtype=torch.int32),
                           bias=_t(b), residual=_t(r))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_axqmm_gated_packed_matches_pallas(act):
    rng = np.random.default_rng(len(act))
    M, K, N = 7, 256, 96
    x = rng.standard_normal((M, K)).astype(np.float32)
    wu = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    wg = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    ju, tu = _packed(wu, 128)
    jg, tg = _packed(wg, 128)
    yj = jaxq.axqmm_gated_packed(jnp.asarray(x), ju, jg, 6, act=act, interpret=True)
    yt = taxq.axqmm_gated_packed(_t(x), tu, tg, 6, act=act)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal,skip_grid", [(True, True), (True, False),
                                              (False, True)])
def test_flash_attention_matches_pallas_with_steps(causal, skip_grid):
    rng = np.random.default_rng(int(causal) + 2 * int(skip_grid))
    BH, S, D = 3, 200, 32                      # S pads past one 128 block
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, skip_grid=skip_grid,
                                 interpret=True, return_steps=True)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 skip_grid=skip_grid, return_steps=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    planned = tfa.planned_grid_steps(BH, S, causal=causal, skip_grid=skip_grid)
    assert int(st) == int(sj) == planned
    assert planned == jfa.planned_grid_steps(BH, S, causal=causal, skip_grid=skip_grid)


def test_flash_attention_grouped_entry_matches_flat():
    """The router's grouped (B, S, KVr, D) entry equals the (BH, S, D)
    entry on K/V repeated to every head."""
    rng = np.random.default_rng(7)
    B, S, H, KVr, D = 2, 21, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    og = tfa.flash_attention_grouped(q, k, v, causal=True)
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    of = tfa.flash_attention(flat(q), flat(tattn.repeat_kv(k, H)),
                             flat(tattn.repeat_kv(v, H)), causal=True)
    assert torch.equal(flat(og), of)


def test_flash_attention_window_not_ported_raises():
    """The sliding window is ported (the ``band`` schedule): window 8 on
    S = 40 matches the Pallas kernel with its step count; only a window
    without the causal mask raises, as in the reference."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 40, 16)).astype(np.float32) for _ in range(3))
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=True, window=8, interpret=True,
                                 return_steps=True)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=8,
                                 return_steps=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    assert int(st) == int(sj) == tfa.planned_grid_steps(2, 40, window=8)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(_t(q), _t(k), _t(v), causal=False, window=8)


def _decode_inputs(rng, B, T, KVr, G, D):
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    return qg, k, v


def test_flash_decode_mixed_lengths_freed_slot_matches_pallas():
    rng = np.random.default_rng(11)
    B, T, KVr, G, D = 4, 150, 2, 3, 16         # ragged last tile (T > 128)
    qg, k, v = _decode_inputs(rng, B, T, KVr, G, D)
    nvalid = np.array([1, 77, 150, 129], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    oj = jfd.flash_decode(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(nvalid), jnp.asarray(active), interpret=True)
    ot = tfd.flash_decode(_t(qg), _t(k), _t(v), _t(nvalid), _t(active))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    assert (ot[2] == 0).all()                  # freed slot: exact zeros


@pytest.mark.parametrize("window", [None, 16])
def test_decode_attn_flash_writes_cache_like_reference(window):
    """The wrapper's in-place cache write (and ring wrap) matches the
    reference's functional write; outputs match its Pallas kernel."""
    rng = np.random.default_rng(3)
    B, T, KVr, H, D = 3, 16, 2, 4, 16
    cache = jattn.init_kv_cache(B, T, KVr, D, dtype=jnp.float32)
    cache = cache._replace(
        k=jnp.asarray(rng.standard_normal((B, T, KVr, D)), jnp.float32),
        v=jnp.asarray(rng.standard_normal((B, T, KVr, D)), jnp.float32),
        length=jnp.asarray([0, 9, 40], jnp.int32))
    q1 = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KVr, D)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KVr, D)).astype(np.float32)
    act = np.array([True, False, True])
    oj, cj = jfd.decode_attn_flash(jnp.asarray(q1), jnp.asarray(kn), jnp.asarray(vn),
                                   cache, window=window, active=jnp.asarray(act),
                                   interpret=True)
    c = cache_from_numpy(jax.tree.map(np.asarray, cache))
    tc = tattn.KVCache(c.k, c.v, c.length)
    ot, ct = tfd.decode_attn_flash(_t(q1), _t(kn), _t(vn), tc, window=window,
                                   active=torch.from_numpy(act))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    assert torch.equal(ct.k, _t(cj.k)) and torch.equal(ct.v, _t(cj.v))
    assert ct.length.tolist() == np.asarray(cj.length).tolist()


@pytest.mark.parametrize("ste", [False, True])
def test_float_weight_route_grads_match_reference(ste):
    """The training route (float weights through the autograd Function)
    gives the reference custom-VJP's forward and gradients: the qmm_ref
    oracle's backward, or the straight-through bf16 matmul for ``ste``."""
    from repro.kernels import dispatch as jdispatch
    from repro_torch.kernels import dispatch as tdispatch

    rng = np.random.default_rng(int(ste))
    M, K, N = 6, 256, 40
    x = rng.standard_normal((M, K)).astype(np.float32)
    wu = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    wg = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)

    def jloss(x, wu, wg):
        y = jdispatch.axq_matmul(x, wu, block=128, ebits=6, ste=ste)
        yg = jdispatch.axq_gated(x, wu, wg, block=128, ebits=6, ste=ste)
        return jnp.sum((y + yg) * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wu),
                                                jnp.asarray(wg))
    xs, wus, wgs = (_t(a).requires_grad_() for a in (x, wu, wg))
    y = tdispatch.axq_matmul(xs, wus, block=128, ebits=6, ste=ste)
    yg = tdispatch.axq_gated(xs, wus, wgs, block=128, ebits=6, ste=ste)
    ((y + yg) * _t(g)).sum().backward()
    for jg_, t in zip(jgrads, (xs, wus, wgs)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("S,causal,window", [(40, True, None), (40, False, None),
                                             (640, True, None), (640, True, 100)])
def test_plain_attention_paths_match_reference(S, causal, window):
    """The port's plain full/blockwise attention (the reference's jnp paths)
    on the model's grouped layout; S = 640 takes the blockwise walk."""
    rng = np.random.default_rng(S)
    B, H, KVr, D = 1, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVr, D)).astype(np.float32)
    oj = jattn.attn_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    ot = tattn.attn_blockwise(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)


def test_plain_decode_attn_matches_reference():
    rng = np.random.default_rng(4)
    B, T, KVr, H, D = 3, 16, 2, 4, 16
    cache = jattn.KVCache(
        jnp.asarray(rng.standard_normal((B, T, KVr, D)), jnp.float32),
        jnp.asarray(rng.standard_normal((B, T, KVr, D)), jnp.float32),
        jnp.asarray([0, 9, 40], jnp.int32))
    q1, kn, vn = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, 1, H, D), (B, 1, KVr, D), (B, 1, KVr, D)))
    oj, cj = jattn.decode_attn(jnp.asarray(q1), jnp.asarray(kn), jnp.asarray(vn), cache)
    c = cache_from_numpy(jax.tree.map(np.asarray, cache))
    ot, ct = tattn.decode_attn(_t(q1), _t(kn), _t(vn), tattn.KVCache(c.k, c.v, c.length))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    assert torch.equal(ct.k, _t(cj.k)) and ct.length.tolist() == [1, 10, 41]
