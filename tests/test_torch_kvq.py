"""Port parity of the int8 KV cache: the quantizer and the cache writes
bit for bit, the plain version of the int8 decode kernel against the JAX
Pallas kernel in interpret mode, the slot primitives on the int8 stack, and
the dense LM's prefill/decode/bucketed prefill on the int8 cache against
the JAX package.

Tolerances: the quantizer, the cache writes, slot reset and masking are
bit-identical (as the reference asserts for its own paths).  The decode
kernel's plain version is held to 1e-5 abs, the reference's kernel-vs-jnp
tolerance.  The LM in f32: logits to 1e-4, as on the bf16 cache
(test_torch_models.py); the cache's int8 codes exactly; its scales to
rtol 1e-6.  The scales are amax/127 of K/V rows that the two packages
compute an f32 ulp or two apart (XLA's and torch's exp/sin/rsqrt and sum
orders), while no code of these inputs sits close enough to a rounding
boundary to move (a moved code would be a parity gap, recorded in
ROADMAP §C).

Reference: the degree-aware Pallas route (``flash_decode_quant`` in
interpret mode).  The jnp ``decode_attn_quant`` ignores the degree and does
not zero free slots, so it is the reference only at ebits 8 and for live
slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.kernels import flash_decode as jfd
from repro.models import attention as jattn
from repro.models import cache_ops as jcache_ops
from repro_torch.convert import cache_from_numpy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as tattn
from repro_torch.models import cache_ops as tcache_ops
from repro_torch.models.transformer import LMCacheQ

torch.set_num_threads(2)

ATOL_KERNEL = 1e-5
ATOL_LOGITS = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy().copy()


# ---------------------------------------------------------------------------
# quantizer and cache writes: bit-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (3, 1, 2, 16)), (1, (4, 7, 4, 64)),
                                        (2, (2, 5, 1, 8))])
def test_q8_bit_identical(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 100, shape[:-1])[..., None]
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                              # amax 0: the 1e-30 floor
    x[-1, -1, -1, :4] = [1.5, -2.5, 0.5, 127.5]   # exact halves: ties to even
    qj, sj = jattn._q8(jnp.asarray(x))
    qt, st = tattn._q8(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


def _decode_inputs(rng, B, H, KVr, D):
    q1 = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KVr, D)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KVr, D)).astype(np.float32)
    return q1, kn, vn


def _filled_quant_cache(rng, B, T, KVr, D, lengths):
    """A JAX int8 cache filled through its own write path, lengths pinned."""
    c = jattn.init_quant_kv_cache(B, T, KVr, D)
    for _ in range(max(lengths)):
        q1, kn, vn = _decode_inputs(rng, B, 2 * KVr, KVr, D)
        _, c = jattn.decode_attn_quant(jnp.asarray(q1), jnp.asarray(kn),
                                       jnp.asarray(vn), c)
    return c._replace(length=jnp.asarray(lengths, jnp.int32))


def _port_attn_cache(jc):
    return tattn.QuantKVCache(*(_t(getattr(jc, f)) for f in ("k", "v", "ks", "vs")),
                              _t(jc.length).to(torch.int32))


@pytest.mark.parametrize("window,lengths", [(None, [0, 5, 31]), (None, [40, 33, 50]),
                                            (32, [40, 33, 7])])
def test_decode_attn_quant_writes_bit_identical(window, lengths):
    """The new token's codes and scales land in the same rows, bit for bit
    (dense, saturated and ring caches); the jnp attention agrees in f32."""
    rng = np.random.default_rng(len(lengths) + (window or 0))
    B, T, KVr, H, D = 3, 32, 2, 4, 16
    jc = _filled_quant_cache(rng, B, T, KVr, D, lengths)
    tc = _port_attn_cache(jc)
    q1, kn, vn = _decode_inputs(rng, B, H, KVr, D)
    oj, jc2 = jattn.decode_attn_quant(jnp.asarray(q1), jnp.asarray(kn),
                                      jnp.asarray(vn), jc, window=window)
    ot, tc2 = tattn.decode_attn_quant(_t(q1), _t(kn), _t(vn), tc, window=window)
    for f in ("k", "v", "ks", "vs", "length"):
        np.testing.assert_array_equal(_np(getattr(tc2, f)), np.asarray(getattr(jc2, f)),
                                      err_msg=f)
    np.testing.assert_allclose(_np(ot), np.asarray(oj), rtol=0, atol=ATOL_KERNEL)


# ---------------------------------------------------------------------------
# the int8 decode kernel's plain version vs the Pallas kernel
# ---------------------------------------------------------------------------


def _kernel_inputs(rng, B, T, KVr, G, D):
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    return qg, k, ks, v, vs


@pytest.mark.parametrize("ebits", [8, 6, 4])
@pytest.mark.parametrize("T", [64, 135])
def test_flash_decode_quant_plain_matches_pallas(ebits, T):
    """Mixed lengths (one past a tile, one at T), one free slot; the odd
    T=135 leaves a ragged last tile in the reference's 128-row tiling."""
    rng = np.random.default_rng(ebits * 1000 + T)
    B, KVr, G, D = 4, 2, 4, 16
    qg, k, ks, v, vs = _kernel_inputs(rng, B, T, KVr, G, D)
    nvalid = np.array([1, T // 2 + 1, T, 7], np.int32)
    active = np.array([1, 1, 1, 0], np.int32)
    oj = jfd.flash_decode_quant(*map(jnp.asarray, (qg, k, ks, v, vs, nvalid, active)),
                                jnp.asarray([ebits], jnp.int32), interpret=True)
    ot = tfd.flash_decode_quant(*map(_t, (qg, k, ks, v, vs, nvalid, active)),
                                torch.tensor(ebits, dtype=torch.int32))
    np.testing.assert_allclose(_np(ot), np.asarray(oj), rtol=0, atol=ATOL_KERNEL)
    assert (_np(ot)[3] == 0).all() and (np.asarray(oj)[3] == 0).all()   # free slot


def test_flash_decode_quant_degree_moves_the_result():
    """The degree is an operand: ebits 5 degrades the codes (the output
    moves), ebits 8 (and above) dequantizes exactly."""
    rng = np.random.default_rng(3)
    qg, k, ks, v, vs = _kernel_inputs(rng, 2, 40, 2, 4, 16)
    args = tuple(map(_t, (qg, k, ks, v, vs))) + (torch.tensor([40, 17], dtype=torch.int32),
                                                 torch.ones(2, dtype=torch.int32))
    o8 = tfd.flash_decode_quant(*args, torch.tensor(8, dtype=torch.int32))
    o9 = tfd.flash_decode_quant(*args, 9)
    o5 = tfd.flash_decode_quant(*args, torch.tensor([8, 5], dtype=torch.int32)[1])
    assert torch.equal(o8, o9)
    assert float((o8 - o5).abs().max()) > 1e-3


def test_decode_dispatch_routes_the_int8_cache():
    """A QuantKVCache on the CPU takes the plain version of the int8 kernel
    through the decode router (and an unknown cache type raises)."""
    rng = np.random.default_rng(4)
    B, T, KVr, H, D = 3, 32, 2, 4, 16
    jc = _filled_quant_cache(rng, B, T, KVr, D, [3, 9, 20])
    q1, kn, vn = _decode_inputs(rng, B, H, KVr, D)
    active = np.array([True, False, True])
    deg = torch.tensor(6, dtype=torch.int32)
    oj, _ = jfd.decode_attn_flash(jnp.asarray(q1), jnp.asarray(kn), jnp.asarray(vn), jc,
                                  active=jnp.asarray(active), degree=jnp.int32(6),
                                  interpret=True)
    ot, tc = tdispatch.decode_attention(_t(q1), _t(kn), _t(vn), _port_attn_cache(jc),
                                        degree=deg, active=torch.from_numpy(active))
    assert tdispatch.last_route["decode"] == "torch"
    assert tc.length.tolist() == [4, 10, 21]
    np.testing.assert_allclose(_np(ot), np.asarray(oj), rtol=0, atol=ATOL_KERNEL)
    with pytest.raises(TypeError):
        tdispatch.decode_attention(_t(q1), _t(kn), _t(vn), (tc.k, tc.v, tc.length))


# ---------------------------------------------------------------------------
# slot primitives and conversion on the int8 stack
# ---------------------------------------------------------------------------


def _random_stack(rng, L=2, B=3, T=8, KVr=2, D=4):
    from repro.models.transformer import LMCacheQ as JLMCacheQ

    return JLMCacheQ(
        jnp.asarray(rng.integers(-127, 128, (L, B, T, KVr, D)).astype(np.int8)),
        jnp.asarray(rng.integers(-127, 128, (L, B, T, KVr, D)).astype(np.int8)),
        jnp.asarray(rng.uniform(0, 1, (L, B, T, KVr)).astype(np.float32)),
        jnp.asarray(rng.uniform(0, 1, (L, B, T, KVr)).astype(np.float32)),
        jnp.asarray([3, 5, 7], jnp.int32))


def test_int8_stack_slot_reset_and_mask_bit_identical():
    rng = np.random.default_rng(5)
    jc = _random_stack(rng)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc))
    assert isinstance(tc, LMCacheQ) and tc.k.dtype == torch.int8
    jr = jcache_ops.cache_reset_slot(jc, jnp.int32(1))
    tr = tcache_ops.cache_reset_slot(tc, 1)
    for f in LMCacheQ._fields:
        np.testing.assert_array_equal(_np(getattr(tr, f)), np.asarray(getattr(jr, f)),
                                      err_msg=f)
    active = np.array([True, False, True])
    adv_j = jr._replace(length=jr.length + 1)
    adv_t = tr._replace(length=tr.length + 1)
    mj = jcache_ops.cache_mask_update(jr, adv_j, jnp.asarray(active))
    mt = tcache_ops.cache_mask_update(tr, adv_t, torch.from_numpy(active))
    assert isinstance(mt, LMCacheQ)
    np.testing.assert_array_equal(_np(mt.length), np.asarray(mj.length))


# ---------------------------------------------------------------------------
# the dense LM on the int8 cache
# ---------------------------------------------------------------------------


#: the cache scales: an f32 ulp or two of the K/V rows they scale
RTOL_SCALES = 1e-6


def _check_field(name, ref, port):
    if name == "logits":
        np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL_LOGITS, err_msg=name)
    elif name in ("ks", "vs"):
        np.testing.assert_allclose(port, ref, rtol=RTOL_SCALES, atol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=name)


def _check(prefill, decode):
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            _check_field(name, ref, port)


@pytest.mark.parametrize("degree", [8, (8, 6, 7)])
def test_lm_prefill_decode_int8_cache_match_reference(degree):
    """f32 smoke model under axq8 at a scalar and a per-site degree, against
    the reference's degree-aware Pallas route: logits within 1e-4, the
    cache's codes bit for bit, its scales to RTOL_SCALES."""
    _check(*P.run_prefill_decode("float32", "axq8", degree, "pallas", quant=True))


@pytest.mark.parametrize("quant", [False, True])
def test_lm_prefill_batch_matches_reference(quant):
    """Three packed rows (one a dummy with slot = B) padded to a 16-token
    bucket, then one decode step, against the reference's
    ``lm_prefill_batch`` on its Pallas route."""
    jm, jp, tm, tp = P.models("float32", "axq8")
    rng = np.random.default_rng(6)
    B, Pb = 3, 16
    lens = [5, 16, 0]
    slots = [2, 0, B]
    toks = np.zeros((3, Pb), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, 512, n)
    toks[2] = rng.integers(0, 512, Pb)            # dummy content
    jdeg, tdeg = P.degrees(6)
    fields = ("k", "v", "ks", "vs", "length") if quant else ("k", "v", "length")
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=B, max_len=32, quant=quant)
        tc = P.port_cache(jc)
        jc = jax.jit(jm.prefill_batch)(jp, jc, jnp.asarray(toks),
                                       jnp.asarray(slots, jnp.int32),
                                       jnp.asarray(lens, jnp.int32), degree=jdeg)
        tc = tm.prefill_batch(tp, tc, torch.from_numpy(toks).long(), slots, lens,
                              degree=tdeg)
        for f in fields:
            _check_field(f, P.to_np(getattr(jc, f)), P.to_np(getattr(tc, f)))
        nxt = rng.integers(0, 512, (B, 1)).astype(np.int32)
        lj, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt), degree=jdeg)
        lt, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(), degree=tdeg)
    live = [0, 2]
    np.testing.assert_allclose(P.to_np(lt)[live], P.to_np(lj)[live], rtol=0,
                               atol=ATOL_LOGITS)


def test_init_cache_reads_repro_kv_int8(monkeypatch):
    """``init_cache(quant=None)`` reads REPRO_KV_INT8 as the reference does."""
    _, _, tm, _ = P.models("float32", "axq8")
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    c = tm.init_cache(1, 2, 16)
    assert isinstance(c, LMCacheQ)
    assert c.k.shape == (2, 2, 16, 2, 16) and c.ks.shape == (2, 2, 16, 2)
    monkeypatch.setenv("REPRO_KV_INT8", "0")
    assert not isinstance(tm.init_cache(1, 2, 16), LMCacheQ)
    assert isinstance(tm.init_cache(1, 2, 16, quant=True), LMCacheQ)
