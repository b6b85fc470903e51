"""Port parity of the Mamba-2 (SSD) family, ``repro_torch.models.ssm``, on
mamba2-370m-smoke against the JAX package, and of the pieces it shares with
the hybrid: the causal depthwise ``conv1d_apply``, ``_conv_tail``, the state
caches through ``convert`` and ``cache_ops``.

Here: ``test_conv1d_apply_matches_reference``, ``test_prefill_decode_match_reference``, ``test_prefill_decode_bf16_match_reference``, ``test_prefill_decode_bf16_match_op_by_op_reference``, ``test_prefill_batch_matches_reference``, ``test_slot_reuse_equals_a_fresh_slot``, ``test_packs_through_convert_match_prepack``, ``test_launch_serve_under_qos``, ``test_quality_tap_leaves_the_state_cache_as_it_found_it`` (the rest in ``test_torch_ssm_2.py``).

The shared setup and helpers are in ``_torch_ssm.py``."""

from _torch_ssm import *  # noqa: F401,F403


# ---------------------------------------------------------------------------
# conv1d and the conv tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,with_state", [(4, False), (4, True), (1, False), (3, True)])
def test_conv1d_apply_matches_reference(width, with_state):
    """The causal depthwise conv over (B, S, C), with and without a carried
    state (the decode form prepends it): output and the new state within
    1e-6 of the reference (the taps summed in f32, in order)."""
    rng = np.random.default_rng(width * 10 + with_state)
    B, S, C = 3, 7, 12
    p = {"w": rng.standard_normal((width, C)).astype(np.float32),
         "b": rng.standard_normal(C).astype(np.float32)}
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    st = rng.standard_normal((B, width - 1, C)).astype(np.float32) if with_state else None
    oj, sj = JL.conv1d_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             None if st is None else jnp.asarray(st))
    ot, stt = TL.conv1d_apply({k: _t(v) for k, v in p.items()}, _t(x),
                              None if st is None else _t(st))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(stt.numpy(), np.asarray(sj), rtol=0, atol=0)


@pytest.mark.parametrize("approx,degree,P_len", [
    ("exact", None, 37), ("axq8", 8, 16), ("axq8", 6, 37), ("axq8", "vector", 5)])
def test_prefill_decode_match_reference(approx, degree, P_len):
    """``ssm_prefill`` (one chunk exactly, a padded chunk tail, a prompt
    shorter than the conv) then ``ssm_decode_step`` with slot 0 free, in
    f32 on an f32 cache: logits, h and the conv tail within 1e-4."""
    for stage in P.run_state_prefill_decode("float32", approx, degree, prompt_len=P_len,
                                            arch=ARCH):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8)])
def test_prefill_decode_bf16_match_reference(approx, degree):
    """The same in bf16 on the bf16 conv cache (h stays f32), against the
    compiled reference, at tests/test_torch_models_bf16.py's tolerances."""
    _check_bf16(P.run_state_prefill_decode("bfloat16", approx, degree, prompt_len=37,
                                           arch=ARCH))


@pytest.mark.parametrize("approx,degree", [("axq8", "vector")])
def test_prefill_decode_bf16_match_op_by_op_reference(approx, degree):
    """In bf16 under AXQ at degrees 6 and 5 (a per-site vector), against the
    reference evaluated op by op (the module docstring: its compiled form
    is further from its own op-by-op form than these bounds), at
    tests/test_torch_models_bf16.py's tolerances."""
    _check_bf16(P.run_state_prefill_decode("bfloat16", approx, degree, prompt_len=16,
                                           compiled=False, arch=ARCH))


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", "vector")])
def test_prefill_batch_matches_reference(approx, degree):
    """``ssm_prefill_batch`` on rows padded to a 40-token bucket, one of
    them a dummy (slot 5, outside the cache) and one a live row of length
    0: every cache field within 1e-4 of the reference's, the dummy writing
    nothing."""
    jm, jp, tm, tp = P.models("float32", approx, arch=ARCH)
    jdeg, tdeg = P.degrees(degree)
    lens = [40, 17, 3, 0]
    slots = [2, 0, 5, 1]
    _, toks = P.padded_rows(lens, 40, 9)
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=3, max_len=48, dtype=jnp.float32)
        jc = jc._replace(h=jc.h + 0.5)               # a dummy must not touch this
        tc = P.port_cache(jc)
        jc = jax.jit(jm.prefill_batch)(jp, jc, jnp.asarray(toks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    tc = tm.prefill_batch(tp, tc, _t(toks).long(), slots, lens, degree=tdeg)
    for f in tc._fields:
        np.testing.assert_allclose(_np(getattr(tc, f)), _np(getattr(jc, f)), rtol=0,
                                   atol=ATOL, err_msg=f)


def test_slot_reuse_equals_a_fresh_slot():
    """A slot that served one prompt and decoded, then takes a new prompt,
    holds exactly what a fresh cache's slot holds after that prompt, and
    the next step's logits are equal."""
    _, _, tm, tp = P.models("float32", "axq8", arch=ARCH)
    rng = np.random.default_rng(13)
    a, b = (_t(rng.integers(0, 512, n)).long() for n in (23, 11))
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    used = tm.init_cache(1, 2, 32, dtype=torch.float32)
    tm.prefill(tp, used, a, 0)
    tm.decode_step(tp, used, toks)
    fresh = tm.init_cache(1, 2, 32, dtype=torch.float32)
    fresh.length[1] = used.length[1]
    fresh.h[:, 1], fresh.conv[:, 1] = used.h[:, 1], used.conv[:, 1]
    l_used, _ = tm.prefill(tp, used, b, 0)
    l_fresh, _ = tm.prefill(tp, fresh, b, 0)
    assert torch.equal(l_used, l_fresh)
    for f in used._fields:
        assert torch.equal(getattr(used, f), getattr(fresh, f)), f


# ---------------------------------------------------------------------------
# packs, convert, cache_ops
# ---------------------------------------------------------------------------


def test_packs_through_convert_match_prepack():
    """The reference's packed tree through ``params_from_numpy`` equals the
    port's ``prepack_params`` of the converted float tree bit for bit: the
    stacked in_proj / out_proj packs and the tied unembedding's
    ``unembed_q``; the conv, dt and norm leaves stay f32."""
    jm, jp_packed, _, tp_packed = P.models("float32", "axq8", arch=ARCH)
    jp = jm.init(jax.random.PRNGKey(0), tp=1)
    pol = ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8, dynamic=True))
    tp = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tget_config(ARCH),
                        pol)
    for a, b in ((tp_packed["layers"]["in_proj"]["w"], tp["layers"]["in_proj"]["w"]),
                 (tp_packed["layers"]["out_proj"]["w"], tp["layers"]["out_proj"]["w"]),
                 (tp_packed["embed"]["unembed_q"], tp["embed"]["unembed_q"])):
        assert isinstance(a, PackedQWeight) and isinstance(b, PackedQWeight)
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scales, b.scales)
    assert tp["layers"]["in_proj"]["w"].qw.shape[0] == tget_config(ARCH).n_layers
    for key in ("conv", "dt_bias", "a_log", "D"):
        assert not isinstance(tp["layers"][key], PackedQWeight)
    jpk = jprepack_params(jp, jget_config(ARCH), jm.policy)
    assert np.array_equal(np.asarray(jpk["layers"]["in_proj"]["w"].qw),
                          tp["layers"]["in_proj"]["w"].qw.numpy())


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "buckets"])
def test_launch_serve_under_qos(buckets):
    """``launch.serve --arch mamba2-370m-smoke --device cpu --approx axq8
    --qos`` (with ``--prefill-buckets auto --pack 4``, and a chunk size
    asked for, which the SSM does not take): every request finishes with
    its tokens, the ladder moves, the weights are packed."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", ARCH, "--device", "cpu", "--approx", "axq8", "--qos",
            "--requests", "6", "--new-tokens", "5", "--max-len", "64"]
    if buckets:
        argv += ["--prefill-buckets", "auto", "--pack", "4", "--chunk-tokens", "16"]
    s, eng = launch_serve.run(argv)
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert isinstance(eng.cache, tssm.SSMCache)
    assert (eng.workload.admission is not None) == buckets
    assert eng.workload.trace_counts["prefill_chunk"] == 0
    assert isinstance(eng.params["layers"]["in_proj"]["w"], PackedQWeight)
    assert len({d for _, d in eng.stats.degree_history}) > 1


def test_quality_tap_leaves_the_state_cache_as_it_found_it():
    """The logit-RMS probe (``obs/quality.py``) runs two decode steps on the
    live cache and restores what they wrote: for the SSM the whole h and
    conv fields; every field bit for bit after it, its value finite and
    positive at a low rung."""
    from repro_torch.obs.quality import lm_logit_rms_probe

    _, _, tm, tp = P.models("float32", "axq8", arch=ARCH)
    cache = tm.init_cache(1, 2, 32)
    rng = np.random.default_rng(3)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 20)).long(), 0)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 7)).long(), 1)
    before = [t.clone() for t in cache]
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    val = lm_logit_rms_probe(tm)(tp, cache, toks, torch.tensor([True, True]),
                                 torch.tensor(5, dtype=torch.int32),
                                 torch.tensor(8, dtype=torch.int32))
    assert 0 < float(val) < float("inf")
    for a, b in zip(before, cache):
        assert torch.equal(a, b)
