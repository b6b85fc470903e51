"""Part 2 of the ``test_torch_head128`` tests: ``test_plain_flash_attention_head128_matches_pallas_with_steps``, ``test_qkv_bias_leaves_round_trip_through_convert``, ``test_engine_head128_streams_match_reference`` (the rest in ``test_torch_head128.py``).

The shared setup and helpers are in ``_torch_head128.py``."""

from _torch_head128 import *  # noqa: F401,F403


# ---------------------------------------------------------------------------
# the plain kernels at D = 128 vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,window,blk", [
    ("tri", 200, None, 128), ("dense", 200, None, 128),
    ("tri", 250, None, 32), ("band", 250, 40, 32), ("band", 250, 100, 32)])
def test_plain_flash_attention_head128_matches_pallas_with_steps(kind, S, window, blk):
    """Each schedule at D = 128 (S = 200 pads past one 128-row block; 250
    leaves a ragged last 32-row block): within the f32 tolerance of the
    Pallas kernel, the same block-step count as its in-kernel counter and
    ``planned_grid_steps``; ``tri`` and ``band`` bit for bit the plain
    ``dense`` run under the same mask."""
    rng = np.random.default_rng(S + blk + (window or 0))
    BH = 2
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    skip = kind != "dense"
    kw = dict(causal=True, window=window, bq=blk, bk=blk, skip_grid=skip)
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 interpret=True, return_steps=True, **kw)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), return_steps=True, **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    planned = tfa.planned_grid_steps(BH, S, window=window, bq=blk, bk=blk, skip_grid=skip)
    assert int(st) == int(sj) == planned
    assert planned == jfa.planned_grid_steps(BH, S, window=window, bq=blk, bk=blk,
                                             skip_grid=skip)
    assert tfa._plan(S, True, window, blk, blk, skip)[0] == kind
    od = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window, bq=blk,
                             bk=blk, skip_grid=False)
    assert torch.equal(ot, od)


# ---------------------------------------------------------------------------
# the QKV bias leaves through convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx", ["exact", "axq8"])
def test_qkv_bias_leaves_round_trip_through_convert(approx):
    """qwen's wq/wk/wv bias leaves (seeded, nonzero) come through
    ``params_from_numpy`` bit for bit beside their weights, packed or
    not; wo and the MLP carry no bias."""
    jm, jp, tm, tp = P.models("float32", approx, arch=QWEN, bias_seed=3, head_dim=D)
    for key in ("wq", "wk", "wv"):
        jb, tb = np.asarray(jp["layers"][key]["b"]), tp["layers"][key]["b"]
        assert tb.dtype == torch.float32 and tuple(tb.shape) == jb.shape
        np.testing.assert_array_equal(tb.numpy(), jb)
        assert np.abs(jb).max() > 0.1
        w = tp["layers"][key]["w"]
        assert isinstance(w, PackedQWeight) == (approx != "exact")
    assert "b" not in tp["layers"]["wo"] and "b" not in tp["layers"]["mlp"]["up"]
    again = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert torch.equal(again["layers"]["wk"]["b"], tp["layers"]["wk"]["b"])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_engine_head128_streams_match_reference(quant, monkeypatch):
    """qwen2.5-3b-smoke at D = 128 with seeded QKV biases, f32 under axq8
    with the QoS ladder 8 -> 6: five requests on two slots, exact-length
    admission on the bf16 cache and bucketed, packed (pack 2) admission on
    the int8 cache; the port's greedy streams equal the JAX engine's on its
    Pallas route, and the degree walks the same rungs."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    jm, jp, tm, tp = P.models("float32", "axq8", arch=QWEN, bias_seed=3, head_dim=D)
    rng = np.random.default_rng(128)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 20, 3, 12)]
    jadm, tadm = ((JAdmissionConfig(pack=2), AdmissionConfig(pack=2)) if quant
                  else (None, None))
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=jadm, emitter=False)
        jreqs = [jeng.submit(p, 6) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()),
                       admission=tadm, emitter=False)
    assert isinstance(teng.cache, LMCacheQ) == quant
    assert teng.cache.k.shape[-1] == D
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 6, LOGIT_TOL)
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg and {(8,), (6,)} <= set(tdeg), (tdeg, jdeg)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")
