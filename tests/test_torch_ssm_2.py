"""Part 2 of the ``test_torch_ssm`` tests: ``test_conv_tail_matches_reference_and_the_full_length_state``, ``test_block_chunked_form_matches_reference``, ``test_block_recurrent_form_matches_reference_and_the_chunked_form``, ``test_forward_matches_reference``, ``test_bucketed_prefill_is_bit_identical_to_exact``, ``test_cache_is_the_state_and_does_not_grow_with_max_len``, ``test_cache_ops_on_the_state_cache_match_reference``, ``test_engine_streams_match_reference``, ``test_full_width_builds_with_its_widths``, ``test_smoke_config_is_the_reference_config``, ``test_forward_and_prefill_batch_bf16_match_reference`` (the rest in ``test_torch_ssm.py``).

The shared setup and helpers are in ``_torch_ssm.py``."""

from _torch_ssm import *  # noqa: F401,F403


def test_conv_tail_matches_reference_and_the_full_length_state():
    """``_conv_tail`` gathers each row's last ``width - 1`` inputs at its
    length (zeros where the row is shorter) as the reference does, and at
    the full length equals the state ``conv1d_apply`` keeps."""
    rng = np.random.default_rng(3)
    ci = rng.standard_normal((4, 9, 5)).astype(np.float32)
    lengths = np.array([0, 2, 9, 5], np.int32)
    oj = jssm._conv_tail(jnp.asarray(ci), jnp.asarray(lengths), 4)
    ot = tssm._conv_tail(_t(ci), _t(lengths), 4)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    p = {"w": torch.ones((4, 5)), "b": torch.zeros(5)}
    _, full = TL.conv1d_apply(p, _t(ci))
    assert torch.equal(tssm._conv_tail(_t(ci), torch.full((4,), 9), 4), full)


@pytest.mark.parametrize("S,lengths", [(16, None), (37, None), (37, (37, 20, 1, 0))])
def test_block_chunked_form_matches_reference(S, lengths):
    """The chunked dual form (one chunk, a padded tail past two chunks, and
    per-row lengths masking dt): output and the returned (h, conv) state
    within 1e-4."""
    jcfg, tcfg, jpol, tpol, jb, tb = _block()
    rng = np.random.default_rng(S)
    B = 4 if lengths else 2
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ln = None if lengths is None else np.array(lengths, np.int32)
    with P.jax_backend("pallas"):
        yj, (hj, cj) = jssm.ssm_block_apply(jb, jnp.asarray(x), jcfg, jpol, "layer",
                                            return_state=True,
                                            lengths=None if ln is None else jnp.asarray(ln))
    yt, (ht, ct) = tssm.ssm_block_apply(tb, _t(x), tcfg, tpol, "layer", return_state=True,
                                        lengths=None if ln is None else _t(ln))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=ATOL)


def test_block_recurrent_form_matches_reference_and_the_chunked_form():
    """The one-step recurrent update from a carried (h, conv) state equals
    the reference's; stepping it over a sequence gives the chunked form's
    outputs and final state (the duality) within 1e-4."""
    jcfg, tcfg, jpol, tpol, jb, tb = _block()
    rng = np.random.default_rng(11)
    B, S = 2, 6
    d_in, H, Pd, N = tssm._dims(tcfg)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((B, H, Pd, N)).astype(np.float32) * 0.1
    c0 = rng.standard_normal((B, 3, d_in + 2 * N)).astype(np.float32)
    yj, (hj, cj) = jssm.ssm_block_apply(jb, jnp.asarray(x), jcfg, jpol, "layer",
                                        state=(jnp.asarray(h0), jnp.asarray(c0)))
    yt, (ht, ct) = tssm.ssm_block_apply(tb, _t(x), tcfg, tpol, "layer",
                                        state=(_t(h0), _t(c0)))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    xs = _t(rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32))
    yc, (hc, cc) = tssm.ssm_block_apply(tb, xs, tcfg, tpol, "layer", return_state=True)
    h, c = torch.zeros((B, H, Pd, N)), torch.zeros((B, 3, d_in + 2 * N))
    ys = []
    for t in range(S):
        y, (h, c) = tssm.ssm_block_apply(tb, xs[:, t:t + 1], tcfg, tpol, "layer",
                                         state=(h, c))
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), yc.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), hc.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(c, cc)


# ---------------------------------------------------------------------------
# the model: forward, prefill, prefill_batch, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 6), ("axq8", "vector")])
def test_forward_matches_reference(approx, degree):
    """``ssm_forward``'s logits on a (2, 21) batch within 1e-4, the aux
    loss zero."""
    jm, jp, tm, tp = P.models("float32", approx, arch=ARCH)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(np.int32)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
    lt, at = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    assert float(at) == 0.0


@pytest.mark.parametrize("seed,lens,Pb", [(0, (5, 16, 31, 2), 32), (1, (40, 3, 17, 33), 64),
                                          (2, (1, 48, 12, 20), 128)])
def test_bucketed_prefill_is_bit_identical_to_exact(seed, lens, Pb):
    """Within the port: rows padded to one bucket (chunk counts that differ
    from the exact prompt's included) give each row's exact-length state
    bit for bit, on fixed seeds, in bf16 under axq8 at degree 6; the
    device-tensor form of ``slots`` / ``lengths`` (the captured call's)
    equals the host form."""
    _, _, tm, tp = P.models("bfloat16", "axq8", arch=ARCH)
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


def test_cache_is_the_state_and_does_not_grow_with_max_len():
    """``init_cache`` returns the state cache whatever ``quant`` or
    REPRO_KV_INT8 say; its bytes do not depend on max_len."""
    model = build_model(tget_config(ARCH), device="cpu")
    sizes = set()
    for max_len, quant in ((16, None), (4096, True), (1 << 20, False)):
        c = model.init_cache(1, 3, max_len, quant=quant)
        assert isinstance(c, tssm.SSMCache)
        sizes.add(sum(t.numel() * t.element_size() for t in c))
    assert len(sizes) == 1


def test_cache_ops_on_the_state_cache_match_reference():
    """``cache_reset_slot`` (host and masked device forms),
    ``cache_mask_update`` and ``cache_bit_flip`` on an SSMCache follow the
    reference's layout convention (batch at axis 1, length at axis 0)."""
    jm, _, _, _ = P.models("float32", "exact", arch=ARCH)
    jc = jm.init_cache(tp=1, batch=3, max_len=16, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)
                                            if a.dtype != jnp.int32
                                            else rng.integers(1, 9, a.shape).astype(np.int32)),
                      jc)
    jr = jcache_ops.cache_reset_slot(jc, 1)
    tr = tcache_ops.cache_reset_slot(cache_from_numpy(jax.tree.map(np.asarray, jc)), 1)
    tm = tcache_ops.cache_reset_slot(cache_from_numpy(jax.tree.map(np.asarray, jc)),
                                     torch.tensor([1, 2]), mask=torch.tensor([True, False]))
    for f in jc._fields:
        np.testing.assert_array_equal(_np(getattr(tr, f)), _np(getattr(jr, f)))
        np.testing.assert_array_equal(_np(getattr(tm, f)), _np(getattr(jr, f)))
    active = np.array([True, False, True])
    jn = jc._replace(length=jc.length + 1)
    ju = jcache_ops.cache_mask_update(jc, jn, jnp.asarray(active))
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc))
    tu = tcache_ops.cache_mask_update(tc, tc._replace(length=tc.length + 1),
                                      torch.from_numpy(active), into=tc)
    np.testing.assert_array_equal(_np(tu.length), _np(ju.length))
    jf = jcache_ops.cache_bit_flip(jc, "h", 2, 7, 30)
    tf = tcache_ops.cache_bit_flip(cache_from_numpy(jax.tree.map(np.asarray, jc)), "h", 2, 7,
                                   30)
    np.testing.assert_array_equal(_np(tf.h), _np(jf.h))


@pytest.mark.parametrize("admission", [False, True], ids=["exact", "buckets-pack2"])
def test_engine_streams_match_reference(admission, monkeypatch):
    """Five requests on two slots in f32 on f32 caches under axq8 with the
    QoS ladder 8 -> 6, exact-length or bucketed packed admission (one
    prompt past the largest bucket): the port's greedy streams equal the
    JAX engine's on its Pallas route, and the degree walks the same
    rungs."""
    jm, jp, tm, tp = P.models("float32", "axq8", arch=ARCH)
    f32_caches(monkeypatch, jm, tm)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 40, 14, 3, 11)]
    jadm = JAdmissionConfig(buckets=(8, 16), pack=2) if admission else None
    tadm = AdmissionConfig(buckets=(8, 16), pack=2) if admission else None
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=jadm, emitter=False)
        jreqs = [jeng.submit(p, 5) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()), admission=tadm,
                       emitter=False)
    assert isinstance(teng.cache, tssm.SSMCache)
    assert teng.workload._max_prompt is None and not teng.workload._chunk_ok
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 5) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 5, LOGIT_TOL)
    assert (teng.workload.trace_counts["prefill_batch"] > 0) == admission
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg, (tdeg, jdeg)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


def test_full_width_builds_with_its_widths():
    """mamba2-370m builds at its registered widths (a meta-device init):
    48 stacked layers, the fused in_proj N = 2 * 2048 + 2 * 128 + 32 =
    4384, the tied 50280-row embedding; its state cache 8 slots x 48 x 32
    x 64 x 128 f32."""
    cfg = tget_config("mamba2-370m")
    TT.check_supported(cfg)
    params = tssm.init_ssm_lm(torch.Generator(), cfg, device="meta")
    assert params["layers"]["in_proj"]["w"].shape == (48, 1024, 4384)
    assert params["embed"]["emb"].shape == (50280, 1024) and "unembed" not in params
    c = tssm.init_ssm_cache(cfg, 1, 8, 8192, device="meta")
    assert c.h.shape == (48, 8, 32, 64, 128) and c.conv.shape == (48, 8, 3, 2304)


def test_smoke_config_is_the_reference_config():
    """The port's smoke config equals the reference's field for field."""
    assert dataclasses.asdict(tget_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8)])
def test_forward_and_prefill_batch_bf16_match_reference(approx, degree):
    """In bf16 against the compiled reference, at tests/test_torch_models_
    bf16.py's tolerances: ``ssm_forward``'s logits, and every state field
    after ``ssm_prefill_batch`` (three rows in a 40-token bucket)."""
    jm, jp, tm, tp = P.models("bfloat16", approx, arch=ARCH)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(6).integers(0, 512, (2, 21)).astype(np.int32)
    lens, slots = [40, 17, 3], [2, 0, 1]
    _, btoks = P.padded_rows(lens, 40, 8)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
        jc = jax.jit(jm.prefill_batch)(jp, jm.init_cache(tp=1, batch=3, max_len=48),
                                       jnp.asarray(btoks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    lt, _ = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=LOGIT_ATOL_BF16)
    tc = tm.prefill_batch(tp, tm.init_cache(1, 3, 48), _t(btoks).long(), slots, lens,
                          degree=tdeg)
    for f in ("h", "conv"):
        assert _rel(_np(getattr(tc, f)), _np(getattr(jc, f))) <= STATE_REL_BF16, f
