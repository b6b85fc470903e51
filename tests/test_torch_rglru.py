"""Port parity of the RG-LRU hybrid family (``repro_torch.models.rglru``) on
recurrentgemma-2b-smoke against the JAX package: the group degrees, the
doubling scan, the recurrent block's two forms, the f32 forward and
prefill / decode, the smoke and full-width configs.

The shared setup and helpers are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


# ---------------------------------------------------------------------------
# degrees, the scan, the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "recurrentgemma-2b-smoke"])
@pytest.mark.parametrize("kind", [None, 6, "vector"])
def test_group_degrees_match_reference(arch, kind):
    """The group-major split of a runtime degree into (groups x pattern,
    tail, head) equals the reference's ``_group_degrees``: 26 layers as 8
    groups of 3 and 2 tail blocks, and the smoke's one group."""
    cfg = tget_config(arch)
    n = cfg.n_layers + 1
    if kind == "vector":
        vals = [8 - (i % 4) for i in range(n)]
        jdeg, tdeg = jnp.asarray(vals, jnp.int32), torch.tensor(vals, dtype=torch.int32)
    else:
        jdeg, tdeg = P.degrees(kind)
    jg, jt, jh = jrg._group_degrees(jdeg, jget_config(arch))
    tg, tt, th = trg._group_degrees(tdeg, cfg)
    if kind is None:
        assert jg is jt is jh is tg is tt is th is None
        return
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    assert int(th) == int(jh)
    assert tuple(tg.shape) == (cfg.n_layers // 3, 3)
    hosted, _, _ = trg._group_degrees(7, cfg)
    assert hosted == [[7, 7, 7]] * (cfg.n_layers // 3)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_doubling_scan_matches_associative_scan(S):
    """The Hillis-Steele doubling scan against the reference's
    ``jax.lax.associative_scan`` on the same (B, S, d) f32 inputs (decays
    in (0, 1) as the block makes them), with and without an initial state,
    within f32 atol 1e-5."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    a = rng.uniform(0.05, 0.999, (2, S, 6)).astype(np.float32)
    h0 = rng.standard_normal((2, 6)).astype(np.float32)
    for init in (None, h0):
        hj = jrg._rglru_scan(jnp.asarray(x), jnp.asarray(a),
                             None if init is None else jnp.asarray(init))
        ht = trg._rglru_scan(_t(x), _t(a), None if init is None else _t(init))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=SCAN_ATOL)


def test_doubling_scan_does_not_depend_on_the_padded_length():
    """Every prefix of the scan is bit-identical whatever the padded length
    past it (each position depends only on positions at or before it)."""
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((3, 100, 8)).astype(np.float32))
    a = _t(rng.uniform(0.05, 0.999, (3, 100, 8)).astype(np.float32))
    full = trg._rglru_scan(x, a)
    for n in (1, 5, 31, 32, 33, 64, 99):
        assert torch.equal(trg._rglru_scan(x[:, :n], a[:, :n]), full[:, :n]), n


@pytest.mark.parametrize("lengths", [None, (9, 4, 1, 0)])
def test_rec_block_prefill_form_matches_reference(lengths):
    """The recurrent block's scan form (the last position's state, or each
    row's at its length with a zero state for length 0): output, h and
    the conv tail within 1e-4."""
    jm, tm, jb, tb = _block()
    rng = np.random.default_rng(1)
    B = 4 if lengths else 2
    x = rng.standard_normal((B, 9, tm.cfg.d_model)).astype(np.float32)
    ln = None if lengths is None else np.array(lengths, np.int32)
    yj, (hj, cj) = jrg.rec_block_apply(jb, jnp.asarray(x), jm.cfg, jm.policy, "g",
                                       lengths=None if ln is None else jnp.asarray(ln))
    yt, (ht, ct) = trg.rec_block_apply(tb, _t(x), tm.cfg, tm.policy, "g",
                                       lengths=None if ln is None else _t(ln))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


def test_rec_block_decode_form_matches_reference_and_the_scan_form():
    """The one-step update from a carried (h, conv) state equals the
    reference's; stepping it over a sequence from zeros gives the scan
    form's outputs and final state within 1e-4."""
    jm, tm, jb, tb = _block()
    rng = np.random.default_rng(2)
    d = tm.cfg.d_model
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    h0 = rng.standard_normal((2, d)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, d)).astype(np.float32)
    yj, (hj, cj) = jrg.rec_block_apply(jb, jnp.asarray(x), jm.cfg, jm.policy, "g",
                                       state=(jnp.asarray(h0), jnp.asarray(c0)))
    yt, (ht, ct) = trg.rec_block_apply(tb, _t(x), tm.cfg, tm.policy, "g",
                                       state=(_t(h0), _t(c0)))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    xs = _t(rng.standard_normal((2, 7, d)).astype(np.float32))
    ys_scan, (h_scan, c_scan) = trg.rec_block_apply(tb, xs, tm.cfg, tm.policy, "g")
    h, c, ys = torch.zeros((2, d)), torch.zeros((2, 3, d)), []
    for t in range(7):
        y, (h, c) = trg.rec_block_apply(tb, xs[:, t:t + 1], tm.cfg, tm.policy, "g",
                                        state=(h, c))
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), ys_scan.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), h_scan.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(c, c_scan)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 6),
                                           ("axq8", (8, 6, 7, 5, 6))])
def test_forward_matches_reference(approx, degree):
    """``hybrid_forward``'s logits on a (2, 40) batch (past the window of
    32) within 1e-4, the aux loss zero."""
    jm, jp, tm, tp = _models("float32", approx)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(4).integers(0, 512, (2, 40)).astype(np.int32)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
    lt, at = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    assert float(at) == 0.0


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8), ("axq8", 6),
                                           ("axq8", (8, 6, 7, 5, 6))])
def test_prefill_decode_match_reference(approx, degree):
    """``hybrid_prefill`` then ``hybrid_decode_step`` (slot 0 free) in f32
    on an f32 cache: logits, the attention ring, h and the conv tails
    within 1e-4."""
    for stage in run_prefill_decode("float32", approx, degree):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


def test_full_width_builds_with_its_widths():
    """recurrentgemma-2b builds at its registered widths (a meta-device
    init): 8 groups of (rec, rec, attn) stacked, 2 tail blocks, MQA 10/1
    at head_dim 256, d_ff 7680, an untied 256000-wide unembedding; its
    cache 8 rings of 2048 and 18 recurrent states."""
    cfg = tget_config("recurrentgemma-2b")
    TT.check_supported(cfg)
    params = trg.init_hybrid(torch.Generator(), cfg, device="meta")
    g = params["groups"]
    assert g["rec0"]["wx"]["w"].shape == (8, 2560, 2560)
    assert g["attn2"]["wq"]["w"].shape == (8, 2560, 2560)
    assert g["attn2"]["wk"]["w"].shape == (8, 2560, 256)
    assert g["attn2"]["mlp"]["up"]["w"].shape == (8, 2560, 7680)
    assert len(params["tail"]) == 2 and params["unembed"]["w"].shape == (2560, 256000)
    c = trg.init_hybrid_cache(cfg, 1, 8, 8192, device="meta")
    assert c.k.shape == (8, 8, 2048, 1, 256) and c.h.shape == (18, 8, 2560)
    assert c.conv.shape == (18, 8, 3, 2560)


def test_smoke_config_is_the_reference_config():
    """The port's smoke config equals the reference's field for field."""
    assert dataclasses.asdict(tget_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
