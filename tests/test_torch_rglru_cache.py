"""The RG-LRU hybrid's state cache (recurrentgemma-2b-smoke): bucketed and
packed prefill, slot reuse, packs through convert, cache ops, the quality
tap; and head_dim 256 in the two attention kernels (plain versions
against Pallas, the launch path on meta tensors).

The shared setup and helpers are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", (8, 6, 7, 5, 6))])
def test_prefill_batch_matches_reference(approx, degree):
    """``hybrid_prefill_batch`` on rows padded to a 48-token bucket (past
    the window: the masked tail scatter keeps each row's last 32 tokens),
    one dummy row (slot 7) and one live row of length 0: every cache field
    within 1e-4 of the reference's, the dummy writing nothing."""
    jm, jp, tm, tp = _models("float32", approx)
    jdeg, tdeg = P.degrees(degree)
    lens = [48, 17, 3, 0]
    slots = [2, 0, 7, 1]
    _, toks = P.padded_rows(lens, 48, 9)
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=3, max_len=64, dtype=jnp.float32)
        jc = jc._replace(h=jc.h + 0.5, k=jc.k + 0.25)      # a dummy must not touch these
        tc = P.port_cache(jc)
        jc = jax.jit(jm.prefill_batch)(jp, jc, jnp.asarray(toks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    tc = tm.prefill_batch(tp, tc, _t(toks).long(), slots, lens, degree=tdeg)
    for f in tc._fields:
        np.testing.assert_allclose(_np(getattr(tc, f)), _np(getattr(jc, f)), rtol=0,
                                   atol=ATOL, err_msg=f)


@pytest.mark.parametrize("seed,lens,Pb", [(0, (5, 16, 31, 2), 32), (1, (40, 3, 17, 33), 64),
                                          (2, (1, 64, 12, 20), 128)])
def test_bucketed_prefill_is_bit_identical_to_exact(seed, lens, Pb):
    """Within the port: rows padded to one bucket (past the window of 32
    included) give each row's exact-length cache region bit for bit, on
    fixed seeds, in bf16 under axq8 at degree 6; the device-tensor form of
    ``slots`` / ``lengths`` equals the host form."""
    _, _, tm, tp = _models("bfloat16", "axq8")
    deg = torch.tensor(6, dtype=torch.int32)
    rows, toks = P.padded_rows(lens, Pb, seed)
    exact = tm.init_cache(1, len(lens), Pb)
    for i, r in enumerate(rows):
        tm.prefill(tp, exact, _t(r).long(), i, degree=deg)
    padded = tm.prefill_batch(tp, tm.init_cache(1, len(lens), Pb), _t(toks).long(),
                              list(range(len(lens))), list(lens), degree=deg)
    dev = tm.prefill_batch(tp, tm.init_cache(1, len(lens), Pb), _t(toks).long(),
                           torch.arange(len(lens)), torch.tensor(lens), degree=deg)
    for f in exact._fields:
        assert torch.equal(getattr(exact, f), getattr(padded, f)), f
        assert torch.equal(getattr(dev, f), getattr(padded, f)), f


def test_slot_reuse_equals_a_fresh_slot():
    """A slot that served a prompt past the window and decoded, then takes
    a new prompt, holds exactly what a fresh cache's slot holds after it,
    and the next step's logits are equal."""
    _, _, tm, tp = _models("float32", "axq8")
    rng = np.random.default_rng(13)
    a, b = (_t(rng.integers(0, 512, n)).long() for n in (45, 11))
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    used = tm.init_cache(1, 2, 64, dtype=torch.float32)
    tm.prefill(tp, used, a, 0)
    tm.decode_step(tp, used, toks)
    fresh = tm.init_cache(1, 2, 64, dtype=torch.float32)
    for f in used._fields:
        if f == "length":
            fresh.length[1] = used.length[1]
        else:
            getattr(fresh, f)[:, 1] = getattr(used, f)[:, 1]
    l_used, _ = tm.prefill(tp, used, b, 0)
    l_fresh, _ = tm.prefill(tp, fresh, b, 0)
    assert torch.equal(l_used, l_fresh)
    for f in used._fields:
        assert torch.equal(getattr(used, f), getattr(fresh, f)), f
    lu, _ = tm.decode_step(tp, used, toks)
    lf, _ = tm.decode_step(tp, fresh, toks)
    assert torch.equal(lu, lf)


# ---------------------------------------------------------------------------
# packs, convert, cache_ops
# ---------------------------------------------------------------------------


def test_packs_through_convert_match_prepack():
    """The reference's packed tree through ``params_from_numpy`` (the
    ``tail`` list included) equals the port's ``prepack_params`` of the
    converted float tree bit for bit: every group block's projections and
    gated MLP (stacked over groups), the tail block's, the unembedding; the
    recurrence parameters and the embedding stay f32."""
    jm, jp_packed, tm, tp_packed = _models("float32", "axq8")
    jp = jm.init(jax.random.PRNGKey(0), tp=1)
    pol = ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8, dynamic=True))
    tp = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tm.cfg, pol)
    pairs = [(tp_packed["unembed"]["w"], tp["unembed"]["w"])]
    for gkey, keys in (("rec0", ("wx", "wg", "wa", "wi", "wo")),
                       ("rec1", ("wx", "wg", "wa", "wi", "wo")),
                       ("attn2", ("wq", "wk", "wv", "wo"))):
        pairs += [(tp_packed["groups"][gkey][k]["w"], tp["groups"][gkey][k]["w"])
                  for k in keys]
        pairs += [(tp_packed["groups"][gkey]["mlp"][k]["w"], tp["groups"][gkey]["mlp"][k]["w"])
                  for k in ("up", "gate", "down")]
    assert isinstance(tp_packed["tail"], list) and len(tp_packed["tail"]) == 1
    pairs += [(tp_packed["tail"][0]["wx"]["w"], tp["tail"][0]["wx"]["w"]),
              (tp_packed["tail"][0]["mlp"]["down"]["w"], tp["tail"][0]["mlp"]["down"]["w"])]
    for a, b in pairs:
        assert isinstance(a, PackedQWeight) and isinstance(b, PackedQWeight)
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scales, b.scales)
    assert tp["groups"]["rec0"]["wx"]["w"].qw.shape[0] == 1          # stacked over groups
    for leaf in (tp["groups"]["rec0"]["lam"], tp["tail"][0]["conv"]["w"], tp["embed"]["emb"]):
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
    jcfg = dataclasses.replace(jget_config(ARCH), n_layers=LAYERS)
    jpk = jprepack_params(jp, jcfg, jm.policy)
    assert np.array_equal(np.asarray(jpk["tail"][0]["wo"]["w"].qw),
                          tp["tail"][0]["wo"]["w"].qw.numpy())


def test_cache_ops_on_the_hybrid_cache_match_reference():
    """``cache_reset_slot`` (host and masked device forms),
    ``cache_mask_update`` and ``cache_bit_flip`` on a HybridCache follow the
    reference's layout convention on every field (the rings, h, conv)."""
    jm, _, _, _ = _models("float32", "exact")
    jc = jm.init_cache(tp=1, batch=3, max_len=16, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)
                                            if a.dtype != jnp.int32
                                            else rng.integers(1, 9, a.shape).astype(np.int32)),
                      jc)
    fresh = lambda: cache_from_numpy(jax.tree.map(np.asarray, jc))
    jr = jcache_ops.cache_reset_slot(jc, 2)
    tr = tcache_ops.cache_reset_slot(fresh(), 2)
    tm = tcache_ops.cache_reset_slot(fresh(), torch.tensor([0, 2]),
                                     mask=torch.tensor([False, True]))
    for f in jc._fields:
        np.testing.assert_array_equal(_np(getattr(tr, f)), _np(getattr(jr, f)))
        np.testing.assert_array_equal(_np(getattr(tm, f)), _np(getattr(jr, f)))
    active = np.array([False, True, True])
    ju = jcache_ops.cache_mask_update(jc, jc._replace(length=jc.length + 1), jnp.asarray(active))
    tc = fresh()
    tu = tcache_ops.cache_mask_update(tc, tc._replace(length=tc.length + 1),
                                      torch.from_numpy(active), into=tc)
    np.testing.assert_array_equal(_np(tu.length), _np(ju.length))
    for name, index, bit in (("k", 40, 31), ("h", 3, 12), ("conv", 17, 0)):
        jf = jcache_ops.cache_bit_flip(jc, name, 1, index, bit)
        tf = tcache_ops.cache_bit_flip(fresh(), name, 1, index, bit)
        np.testing.assert_array_equal(_np(getattr(tf, name)), _np(getattr(jf, name)))


def test_quality_tap_leaves_the_hybrid_cache_as_it_found_it():
    """The logit-RMS probe restores what its two decode steps wrote on the
    hybrid's cache: each slot's ring row at its position (past the window:
    the wrapped row) and the whole h and conv fields; every field bit for
    bit after it."""
    from repro_torch.obs.quality import lm_logit_rms_probe

    _, _, tm, tp = _models("float32", "axq8")
    cache = tm.init_cache(1, 2, 64)
    rng = np.random.default_rng(3)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 45)).long(), 0)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 7)).long(), 1)
    before = [t.clone() for t in cache]
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    val = lm_logit_rms_probe(tm)(tp, cache, toks, torch.tensor([True, True]),
                                 torch.tensor(5, dtype=torch.int32),
                                 torch.tensor(8, dtype=torch.int32))
    assert 0 < float(val) < float("inf")
    for a, b in zip(before, cache):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# head_dim 256 in the attention kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,window", [("tri", 160, None), ("band", 300, 100),
                                           ("dense", 130, None)])
def test_plain_flash_attention_head256_matches_pallas(kind, S, window):
    """The plain flash_attention at D = 256 on every schedule against the
    Pallas kernel in interpret mode: within rtol 1e-5 / atol 1e-4, the same
    block-step count as its counter and ``planned_grid_steps``."""
    rng = np.random.default_rng(S)
    BH = 2
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    kw = dict(causal=True, window=window, skip_grid=kind != "dense")
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 interpret=True, return_steps=True, **kw)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), return_steps=True, **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL_K, atol=ATOL_K)
    assert int(st) == int(sj) == tfa.planned_grid_steps(BH, S, **kw)


def test_grouped_head256_mqa_entry_matches_flat():
    """The model-layout entry at recurrentgemma's MQA (10 query heads on 1
    kv head, window 2048 > S: plain causal) equals the flat entry on the
    kv head repeated to every head."""
    rng = np.random.default_rng(10)
    B, S, H = 1, 70, 10
    q = _t(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _t(rng.standard_normal((B, S, 1, D)).astype(np.float32))
    v = _t(rng.standard_normal((B, S, 1, D)).astype(np.float32))
    og = tfa.flash_attention_grouped(q, k, v, causal=True, window=2048)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    of = tfa.flash_attention(flat(q), flat(k.repeat_interleave(H, 2)),
                             flat(v.repeat_interleave(H, 2)), causal=True)
    assert torch.equal(flat(og), of)


def test_plain_flash_decode_head256_group10_matches_pallas():
    """The bf16/f32-cache decode at D = 256 with a group of 10 over one kv
    head (two 8-row P.V blocks in the kernel, the second ragged): mixed
    lengths around the 128-row split width, a full ring, a freed slot of
    exact zeros."""
    rng = np.random.default_rng(256)
    B, T, KVr, G = 5, 260, 1, 10
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    nvalid = np.array([129, 128, 260, 1, 77], np.int32)
    active = np.array([1, 1, 1, 1, 0], np.int32)
    oj = jfd.flash_decode(*map(jnp.asarray, (qg, k, v, nvalid, active)), interpret=True)
    ot = tfd.flash_decode(*map(_t, (qg, k, v, nvalid, active)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL_K, atol=ATOL_K)
    assert (ot[4] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_256_launches_both_kernels(fake_card, dtype):
    """recurrentgemma's shapes reach the C launchers with D = 256: prefill
    (10 heads over 1 kv head, window 2048 past S: band) and decode (B 8,
    G 10, a 2048 ring: a (8, 1, 16, 10, 260) partial scratch); the views
    pass the 16-byte rule at H * D = 2560 and KVr * D = 256."""
    before = dict(_build.launches)
    B, S, H = 1, 2500, 10
    out = tfa.flash_attention_grouped(_meta(B, S, H, D, dtype=dtype),
                                      _meta(B, S, 1, D, dtype=dtype),
                                      _meta(B, S, 1, D, dtype=dtype), causal=True, window=2048)
    assert out.shape == (B, S, H, D)
    qg = _meta(8, 1, 10, D, dtype=torch.float32)
    kv = _meta(8, 2048, 1, D, dtype=dtype)
    n = _meta(8, dtype=torch.int32)
    assert tfd.flash_decode(qg, kv, kv, n, n).shape == (8, 1, 10, D)
    (fa, fa_args), (fd, fd_args) = fake_card
    assert fa == "flash_attention_launch" and fd == "flash_decode_launch"
    assert fa_args[5:15] == (B, S, H, H, D, 128, 1, 2, 17, 2048)
    assert fd_args[7:12] == (8, 2048, 1, 10, D)
    assert _build.launches["flash_attention"] == before["flash_attention"] + 1
    assert _build.launches["flash_decode"] == before["flash_decode"] + 1
    for t, name in ((_meta(B, S, H * D).view(B, S, H, D), "q"),
                    (_meta(B, S, D).view(B, S, 1, D), "k")):
        assert tfa.tc_view_error(t, name) is None


def test_int8_decode_is_not_built_at_head_dim_256(fake_card):
    """No path reaches the int8 cache at D = 256 (the hybrid has none): its
    kernel is not instantiated there and the wrapper raises before a
    launch, with no fallback."""
    qg, n = _meta(2, 1, 10, D, dtype=torch.float32), _meta(2, dtype=torch.int32)
    k8, s8 = _meta(2, 64, 1, D, dtype=torch.int8), _meta(2, 64, 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode_quant(qg, k8, s8, k8, s8, n, n, 8)
    assert fake_card == []
    assert 256 in tfd.HEAD_DIMS and 256 not in tfd.QUANT_HEAD_DIMS
