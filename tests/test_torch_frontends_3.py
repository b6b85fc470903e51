"""Part 3 of the ``test_torch_frontends`` tests: ``test_forward_logits_match_reference``, ``test_loss_matches_reference``, ``test_bf16_forward_within_bf16_bounds``, ``test_head_degree_drives_the_frontends``, ``test_packs_bit_for_bit``, ``test_params_convert_with_frontend_leaves``, ``test_input_specs_match_reference``, ``test_encoder_only_refusals_match_reference``, ``test_vlm_prefill_decode_match_reference``, ``test_remat_policies_give_equal_steps``, ``test_pipeline_frontend_batches_train_on_both_archs`` (the rest in ``test_torch_frontends.py``, ``test_torch_frontends_2.py``).

The shared setup and helpers are in ``_torch_frontends.py``."""

from _torch_frontends import *  # noqa: F401,F403


@pytest.mark.parametrize("approx,degree", DEGREES, ids=["exact", "axq8-8", "axq8-6",
                                                        "axq8-vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, approx, degree):
    """f32 logits within 1e-4, over the VLM's image and text positions."""
    jm, jp, tm, tp = P.models("float32", approx, arch=arch)
    jb, tb = _batch(jm.cfg)
    jd, td = _degrees(degree, jm.cfg)
    with P.jax_backend("pallas"):
        jl, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(jp, jb, jd)
    with torch.no_grad():
        tl, _ = tm.forward(tp, tb, degree=td)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


@pytest.mark.parametrize("approx,degree", DEGREES, ids=["exact", "axq8-8", "axq8-6",
                                                        "axq8-vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, approx, degree):
    """The masked cross-entropy (the VLM's over its text positions only)
    and its token count."""
    jm, jp, tm, tp = P.models("float32", approx, arch=arch)
    jb, tb = _batch(jm.cfg, seed=1)
    jd, td = _degrees(degree, jm.cfg)
    with P.jax_backend("pallas"):
        jl, jmet = jax.jit(lambda p, b, d: jm.loss(p, b, degree=d))(jp, jb, jd)
    with torch.no_grad():
        tl, tmet = tm.loss(tp, tb, degree=td)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["ntokens"]) == float(jmet["ntokens"]) == float((tb["labels"] >= 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_bf16_bounds(arch):
    """bf16 forward logits under axq8 at degree 8 within the bf16 gate of
    tests/test_torch_models_bf16.py (the frameworks' f32 ulps flip bf16
    roundings; the VLM's gelu is rounded op by op as the reference's)."""
    jm, jp, tm, tp = P.models("bfloat16", "axq8", arch=arch)
    jb, tb = _batch(jm.cfg, seed=2)
    jd, td = P.degrees(8)
    with P.jax_backend("pallas"):
        jl, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(jp, jb, jd)
    with torch.no_grad():
        tl, _ = tm.forward(tp, tb, degree=td)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL_BF16)


def test_head_degree_drives_the_frontends():
    """The frontend projections run at the per-site vector's head entry:
    moving it moves ``embed_inputs``; moving a layer entry does not."""
    for arch in ARCHS:
        _, _, tm, tp = P.models("float32", "axq8", arch=arch)
        _, tb = _batch(tm.cfg)
        n = tm.cfg.n_layers + 1
        x = lambda degs: TM.embed_inputs(tp, tm.cfg, tb, torch.float32, tm.policy,
                                         torch.tensor(degs, dtype=torch.int32)[-1])[0]
        base = x([8] * n)
        assert torch.equal(base, x([5] * (n - 1) + [8]))
        assert not torch.equal(base, x([8] * (n - 1) + [5]))
        plan = uniform_plan(tm.cfg)
        plan.validate_for(tm.cfg)
        assert site_names(tm.cfg)[-1] == "head" and len(plan.sites) == n


# ---------------------------------------------------------------------------
# packs, specs, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_packs_bit_for_bit(arch):
    """The reference's ``prepack_params`` of its float tree equals the
    port's of the converted tree, leaf for leaf, the frontend packs and
    their float biases included."""
    from repro.kernels.qstore import prepack_params as jprepack

    jm, jp, _, _ = P.models("float32", "exact", arch=arch)
    cfg = tget_config(arch)
    tm = build_model(cfg, P.tpolicy("axq8", dynamic=True), device="cpu")
    jpk = jprepack(jp, jget_config(arch), P.jpolicy("axq8", dynamic=True))
    tpk = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), cfg, tm.policy)
    fe = "v_proj" if arch == VLM else "a_proj"
    fcs = ("fc1", "fc2") if arch == VLM else ("fc1",)
    for k in fcs:
        assert isinstance(tpk[fe][k]["w"], PackedQWeight)
        assert not isinstance(tpk[fe][k]["b"], PackedQWeight)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jpk)]
    tl = [x.numpy() for x in tree_leaves(tpk)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_convert_with_frontend_leaves(arch):
    """The converted tree carries the frontend leaves, biases included, and
    the port's own init builds the same shapes."""
    _, jp, _, tp = P.models("float32", "exact", arch=arch)
    fe = "v_proj" if arch == VLM else "a_proj"
    assert set(tp[fe]) == set(jp[fe])
    for k, leaf in tp[fe].items():
        np.testing.assert_array_equal(leaf["w"].numpy(), np.asarray(jp[fe][k]["w"]))
        np.testing.assert_array_equal(leaf["b"].numpy(), np.asarray(jp[fe][k]["b"]))
    own = TM.init_lm(torch.Generator().manual_seed(0), tget_config(arch))
    shapes = lambda t: [tuple(x.shape) for x in tree_leaves(t)]
    assert shapes(own) == [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(jp)]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_input_specs_match_reference(arch, shape):
    js = jregistry.input_specs(jget_config(arch), shape)
    ts = tregistry.input_specs(tget_config(arch), shape)
    assert set(js) == set(ts)
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape)
    b = tregistry.concrete_batch(tget_config(arch + "-smoke"), 24, 2)
    assert set(b) == set(ts)


def test_encoder_only_refusals_match_reference():
    """hubert has no decode step: ``init_cache`` raises the reference's
    error, and so does ``launch.serve``; the VLM's cache is the dense one
    (text-only decode), with no chunked prefill."""
    from repro_torch.launch import serve as launch_serve

    jm = jregistry.build_model(jget_config(AUDIO))
    with pytest.raises(ValueError, match="encoder-only arch has no decode step") as je:
        jm.init_cache(1, 2, 16)
    tm = build_model(tget_config(AUDIO), device="cpu")
    with pytest.raises(ValueError, match="encoder-only arch has no decode step") as te:
        tm.init_cache(1, 2, 16)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="encoder-only arch has no decode step"):
        launch_serve.run(["--arch", AUDIO, "--device", "cpu"])
    vm = build_model(tget_config(VLM), device="cpu")
    assert not vm.supports_chunked_prefill()
    assert isinstance(vm.init_cache(1, 2, 16, quant=True), LMCacheQ)


# ---------------------------------------------------------------------------
# serving (the VLM, text-only) and training
# ---------------------------------------------------------------------------


def test_vlm_prefill_decode_match_reference():
    """``lm_prefill`` then ``lm_decode_step`` of the VLM's backbone on
    text-only prompts (as the reference serves it), f32 on an f32 cache:
    logits and cache rows within 1e-4."""
    prefill, decode = P.run_prefill_decode("float32", "axq8", 6, "pallas",
                                           cache_dtype=jnp.float32, arch=VLM)
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_steps(arch):
    """remat none / dots / full on the frontend archs: the same loss and
    update bit for bit."""
    from repro_torch.train import step as tstep

    jm, tm = TT.models(arch, "axq8")
    _, ts = TT.states(jm)
    _, tb = _batch(jm.cfg)
    outs = []
    for remat in ("none", "dots", "full"):
        _, cfg = TT.step_cfgs(remat=remat)
        st, met = tstep.train_step(tm, cfg, ts, tb, degree=torch.tensor(6, dtype=torch.int32))
        outs.append((float(met["loss"]), [x.clone() for x in tree_leaves(st.params)]))
    for loss, leaves in outs[1:]:
        assert loss == outs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(leaves, outs[0][1]))


def test_pipeline_frontend_batches_train_on_both_archs():
    """The synthetic pipeline's batches (bit for bit the reference's) drive
    the port's loss: the VLM's labels cover its text only, hubert's are
    mostly ignored (masked-prediction spans)."""
    from repro.data.pipeline import make_pipeline as jpipe
    from repro_torch.data.pipeline import make_pipeline as tpipe

    for arch, seq in ((VLM, 24), (AUDIO, 32)):
        cfg = tget_config(arch)
        jb = jpipe(jget_config(arch), seq_len=seq, global_batch=2).batch_at(3)
        tb = tpipe(cfg, seq_len=seq, global_batch=2).batch_at(3)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        m = build_model(cfg, device="cpu")
        params = m.init(seed=0)
        batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
                 for k, v in tb.items()}
        with torch.no_grad():
            loss, met = m.loss(params, batch)
        assert np.isfinite(float(loss))
        assert float(met["ntokens"]) == float((batch["labels"] >= 0).sum())
        if arch == VLM:
            assert batch["labels"].shape[1] == seq - cfg.frontend_tokens
