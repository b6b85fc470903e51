"""Port parity at head_dim 128, the reference's own TPU head dim: the two
registered dense archs with D = 128, qwen2.5-3b (QKV bias, GQA 16/2) and
mistral-nemo-12b (GQA 32/8), at smoke size against the JAX package.

Here: ``test_grouped_head128_entry_matches_flat``, ``test_plain_flash_decode_head128_matches_pallas``, ``test_plain_flash_decode_quant_head128_matches_pallas``, ``test_head_dim_128_launches_the_kernel``, ``test_unbuilt_head_dim_raises_without_fallback``, ``test_prefill_decode_match_reference`` (the rest in ``test_torch_head128_2.py``).

The shared setup and helpers are in ``_torch_head128.py``."""

from _torch_head128 import *  # noqa: F401,F403


def test_grouped_head128_entry_matches_flat():
    """The model-layout entry at qwen's grouping (16 heads over 2 kv heads)
    equals the (BH, S, D) entry on K/V repeated to every head."""
    rng = np.random.default_rng(16)
    B, S, H, KVr = 1, 150, 16, 2
    q = _t(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _t(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    v = _t(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    og = tfa.flash_attention_grouped(q, k, v, causal=True)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    of = tfa.flash_attention(flat(q), flat(k.repeat_interleave(H // KVr, 2)),
                             flat(v.repeat_interleave(H // KVr, 2)), causal=True)
    assert torch.equal(flat(og), of)


@pytest.mark.parametrize("KVr,G", [(2, 8), (8, 4)], ids=["qwen", "nemo"])
def test_plain_flash_decode_head128_matches_pallas(KVr, G):
    """The bf16/f32-cache decode at D = 128 with qwen's and mistral-nemo's
    grouping: mixed lengths past the reference's 128-row tile, a freed
    slot of exact zeros."""
    rng = np.random.default_rng(KVr * 10 + G)
    B, T = 4, 150
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    nvalid = np.array([1, 77, 150, 129], np.int32)
    active = np.array([1, 0, 1, 1], np.int32)
    oj = jfd.flash_decode(*map(jnp.asarray, (qg, k, v, nvalid, active)), interpret=True)
    ot = tfd.flash_decode(*map(_t, (qg, k, v, nvalid, active)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    assert (ot[1] == 0).all()


@pytest.mark.parametrize("ebits", [8, 5])
@pytest.mark.parametrize("KVr,G", [(2, 8), (8, 4)], ids=["qwen", "nemo"])
def test_plain_flash_decode_quant_head128_matches_pallas(KVr, G, ebits):
    """The int8-cache decode at D = 128, degraded at ``ebits``, on a ragged
    T = 135 with one free slot."""
    rng = np.random.default_rng(ebits * 100 + KVr)
    B, T = 4, 135
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    nvalid = np.array([1, T // 2 + 1, T, 7], np.int32)
    active = np.array([1, 1, 1, 0], np.int32)
    oj = jfd.flash_decode_quant(*map(jnp.asarray, (qg, k, ks, v, vs, nvalid, active)),
                                jnp.asarray([ebits], jnp.int32), interpret=True)
    ot = tfd.flash_decode_quant(*map(_t, (qg, k, ks, v, vs, nvalid, active)),
                                torch.tensor(ebits, dtype=torch.int32))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=ATOL_QUANT)
    assert (ot[3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_128_launches_the_kernel(fake_card, dtype):
    """qwen's prefill shapes (16 heads over 2 kv heads, D = 128) reach the
    C launcher with D = 128 and the tri schedule; the views pass the
    16-byte rule at H * D = 2048 and KVr * D = 256."""
    before = dict(_build.launches)
    B, S, H, KVr = 2, 300, 16, 2
    out = tfa.flash_attention_grouped(_meta(B, S, H, D, dtype=dtype),
                                      _meta(B, S, KVr, D, dtype=dtype),
                                      _meta(B, S, KVr, D, dtype=dtype), causal=True)
    assert out.shape == (B, S, H, D)
    (fn, args), = fake_card
    assert fn == "flash_attention_launch"
    assert args[5:15] == (B, S, H, H // KVr, D, 128, 1, 1, 0, 0)
    assert _build.launches["flash_attention"] == before["flash_attention"] + 1
    for t, name in ((_meta(B, S, H * D).view(B, S, H, D), "q"),
                    (_meta(B, S, KVr * D).view(B, S, KVr, D), "k")):
        assert tfa.tc_view_error(t, name) is None


@pytest.mark.parametrize("bad", [96, 512])
def test_unbuilt_head_dim_raises_without_fallback(fake_card, bad):
    """A head dim the kernel was not instantiated for raises before any
    launch, on every entry, and never runs the plain version instead."""
    before = dict(_build.launches)
    q = _meta(1, 40, 4, bad)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_grouped(q, _meta(1, 40, 2, bad), _meta(1, 40, 2, bad))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(_meta(4, 40, bad), _meta(4, 40, bad), _meta(4, 40, bad))
    assert fake_card == []
    assert _build.launches == before


# ---------------------------------------------------------------------------
# the models and the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,head_dim,approx,degree", [
    (QWEN, 16, "exact", None), (QWEN, 16, "axq8", 6), (QWEN, 16, "axq8", "vector"),
    (QWEN, D, "exact", None), (QWEN, D, "axq8", 6), (QWEN, D, "axq8", "vector"),
    (NEMO, D, "exact", None), (NEMO, D, "axq8", 6)])
def test_prefill_decode_match_reference(arch, head_dim, approx, degree):
    """``lm_prefill`` then ``lm_decode_step`` in f32: logits and the live
    cache rows within 1e-4 of the Pallas route (qwen with its seeded QKV
    biases).  The cache is f32, as in tests/test_torch_swa.py: on a bf16
    cache a K/V value the packages compute an f32 ulp apart now and then
    rounds to neighbouring bf16 values (1 of 49,152 cached values at
    head_dim 128, by 2**-11), which says nothing of the model."""
    bias_seed = 3 if arch == QWEN else None
    prefill, decode = P.run_prefill_decode("float32", approx, degree, "pallas",
                                           cache_dtype=jnp.float32, arch=arch,
                                           bias_seed=bias_seed, head_dim=head_dim)
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL_LOGITS, err_msg=name)
