"""Port parity of the MoE family (``repro_torch.models.moe`` and its wiring
through the transformer, the packs, the registry, the LM adapter and the
engine) against the JAX package, at granite-moe-3b-a800m-smoke and
qwen2-moe-a2.7b-smoke (shared experts, QKV bias) in f32, on numpy-seeded
inputs; and the expert-batched GEMM launches (``axqmm_experts`` /
``axqmm_gated_experts``) on the CPU: their plain versions against the
reference's ``vmap`` of ``axq_matmul`` / ``axq_gated``, and their launch
path on ``meta`` tensors (no card here).

Here: ``test_capacity_copies_the_reference_formula``, ``test_moe_int8_lever_and_ring_lever``, ``test_batched_routers_float_weights_and_backward``, ``test_expert_batched_launch_hands_the_kernel_e_and_its_plan``, ``test_plan_counts_every_experts_tiles``, ``test_bad_expert_pack_raises_without_fallback``, ``test_lm_forward_aux_matches_reference``, ``test_engine_streams_match_reference``, ``test_adapter_and_registry_keep_moe_exact_length``, ``test_check_supported_admits_frontend_families``, ``test_moe_archs_build_with_their_full_widths`` (the rest in ``test_torch_moe_2.py``).

The shared setup and helpers are in ``_torch_moe.py``."""

from _torch_moe import *  # noqa: F401,F403


def test_capacity_copies_the_reference_formula():
    """The capacity at the serving shapes: granite's 8 decode slots give 4,
    an exact-length prefill of 512 tokens 128; qwen2-moe's 8 slots 4, a
    255-token prefill 22 and a 512-token one 43."""
    g, q = tget_config("granite-moe-3b-a800m"), tget_config("qwen2-moe-a2.7b")
    assert [tmoe.capacity(g, t) for t in (8, 512, 64)] == [4, 128, 16]
    assert [tmoe.capacity(q, t) for t in (8, 255)] == [4, 22]
    assert tmoe.capacity(q, 512) == 43


def test_moe_int8_lever_and_ring_lever(monkeypatch):
    """REPRO_MOE_INT8 promotes an EXACT expert spec to AXQ-8 on both sides
    (and the prepack then packs the experts); REPRO_RING_TP's ring combine
    is the identity on one device, as the reference's ring is on a 1-wide
    model axis (tests/test_torch_tp_moe.py holds it on a mesh)."""
    monkeypatch.setattr(jmoe, "_MOE_INT8", True)
    monkeypatch.setattr(tmoe, "_MOE_INT8", True)
    js, ts = jmoe.expert_spec(JPolicy(), "layer/moe"), tmoe.expert_spec(ApproxPolicy(),
                                                                        "layer/moe")
    assert (js.mode.value, js.ebits, js.block) == (ts.mode.value, ts.ebits, ts.block) == \
        ("axq", 8, 256)
    _, tcfg = _cfgs(GRANITE)
    params = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    packed = prepack_params(params, tcfg, ApproxPolicy())
    assert isinstance(packed["layers"]["moe"]["experts"]["down"], PackedQWeight)
    assert isinstance(packed["layers"]["wq"]["w"], torch.Tensor)
    x = torch.randn((1, 4, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    lp = TT.layer_params(params["layers"], 0)["moe"]
    want = tmoe.moe_apply(lp, x, tcfg, ApproxPolicy(), "layer/moe")
    monkeypatch.setattr(tmoe, "_MOE_RING", True)
    got = tmoe.moe_apply(lp, x, tcfg, ApproxPolicy(), "layer/moe")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_batched_routers_float_weights_and_backward():
    """The float-weight routers pack on the fly (equal to the packed
    route) and differentiate per expert like the 2-D routers, straight
    through and through the oracle."""
    E, C, K, N, bk = 3, 4, 128, 64, 64
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32))
    wu, wg = (torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32) / 8)
              for _ in range(2))
    pu, pg = (taxq.prepack_weight(w, bk) for w in (wu, wg))
    assert torch.equal(tdispatch.axq_gated_experts(x, wu, wg, block=bk, ebits=6),
                       tdispatch.axq_gated_experts(x, pu, pg, block=bk, ebits=6))
    assert torch.equal(tdispatch.axq_matmul_experts(x, wu, block=bk, ebits=6),
                       tdispatch.axq_matmul_experts(x, pu, block=bk, ebits=6))
    for ste in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, wu, wg)]
        tdispatch.axq_gated_experts(*leaves, block=bk, ebits=6, ste=ste).sum().backward()
        for i in range(E):
            ref = [t[i].detach().clone().requires_grad_() for t in (x, wu, wg)]
            tdispatch.axq_gated(*ref, block=bk, ebits=6, ste=ste).sum().backward()
            for a, b in zip(leaves, ref):
                assert torch.equal(a.grad[i], b.grad)
        xl, wl = x.clone().requires_grad_(), wu.clone().requires_grad_()
        tdispatch.axq_matmul_experts(xl, wl, block=bk, ebits=6, ste=ste).sum().backward()
        xr, wr = x[1].clone().requires_grad_(), wu[1].clone().requires_grad_()
        tdispatch.axq_matmul(xr, wr, block=bk, ebits=6, ste=ste).sum().backward()
        assert torch.equal(xl.grad[1], xr.grad) and torch.equal(wl.grad[1], wr.grad)


@pytest.mark.parametrize("E,C,N,K,bk,gated", [
    (40, 4, 512, 1536, 256, True), (40, 4, 1536, 512, 256, False),      # granite decode
    (40, 128, 512, 1536, 256, True), (40, 128, 1536, 512, 256, False),  # 512-token prefill
    (60, 4, 1408, 2048, 256, True), (60, 4, 2048, 1408, 128, False),    # qwen2-moe decode
    (60, 43, 1408, 2048, 256, True), (60, 43, 2048, 1408, 128, False),
    (2, 4, 64, 4096, 256, True), (3, 2048, 256, 1024, 256, False)])     # split; pre-pass
def test_expert_batched_launch_hands_the_kernel_e_and_its_plan(fake_card, E, C, N, K, bk,
                                                               gated):
    """One launch for the E experts, with (E, C, N, K, bk[, act], cfg,
    n_split, part) after the pointers; the plan counts every expert's tiles
    (granite's decode: 1280 or 3840 one-warp blocks, no split); a split or
    pre-degraded plan gets one scratch an expert on a leading axis."""
    calls, scratches = fake_card
    before = dict(_build.launches)
    qx, sx = _meta(E, C, K, dtype=torch.int8), _meta(E, C, K // bk)
    if gated:
        out = taxq.axqmm_gated_experts_quantized(qx, sx, _meta_pack(E, N, K, bk),
                                                 _meta_pack(E, N, K, bk), 6)
    else:
        out = taxq.axqmm_experts_quantized(qx, sx, _meta_pack(E, N, K, bk), 6)
    assert out.shape == (E, C, N) and out.dtype == torch.float32
    p = taxq.plan(C, N, K, bk, gated, SMS, E)
    (fn, args), = calls
    name = "axqmm_gated_experts" if gated else "axqmm_experts"
    assert fn == name + "_launch"
    n_ptr = 9 if gated else 7
    assert args[n_ptr:n_ptr + 5] == (E, C, N, K, bk)
    assert args[-4:-1] == tuple(p)
    (s,) = scratches
    g = 2 if gated else 1
    if p.n_split > 1:
        assert s.shape == (E, g, K // bk * p.part, C, N) and s.dtype == torch.int32
    elif p.cfg == taxq.TILE_LARGE and C >= taxq.PREDEGRADE_M:
        assert s.shape == (E, (C + g * N) * K) and s.dtype == torch.int8
    else:
        assert s is None and args[n_ptr - 1] is None
    if C <= taxq.DECODE_M and E >= 40:
        assert p == taxq.Plan(taxq.DECODE)
        assert taxq.blocks(p, C, N, gated, E) == E * N // 16 >= 2 * SMS
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1


def test_plan_counts_every_experts_tiles():
    """plan(..., experts) is the 2-D plan of a call with E times the tiles:
    one expert's decode at granite's gated shape would split K, 40 do not;
    a 43-row prefill takes 128-row tiles once the experts fill the card."""
    assert taxq.plan(4, 512, 1536, 256, True, SMS) == taxq.plan(4, 512, 1536, 256, True,
                                                                  SMS, 1)
    assert taxq.plan(4, 512, 1536, 256, True, SMS).n_split > 1
    assert taxq.plan(4, 512, 1536, 256, True, SMS, 40) == taxq.Plan(taxq.DECODE)
    assert taxq.plan(43, 1408, 2048, 256, True, SMS).cfg == taxq.TILE_SMALL
    assert taxq.plan(43, 1408, 2048, 256, True, SMS, 60) == taxq.Plan(taxq.TILE_LARGE)
    assert taxq.blocks(taxq.Plan(taxq.TILE_LARGE), 43, 1408, True, 60) == 22 * 60


@pytest.mark.parametrize("bad", ["experts", "shape", "block", "x_rank", "pair"])
def test_bad_expert_pack_raises_without_fallback(fake_card, bad):
    """A pack whose leading E, (N, K) or block disagrees with x, an x that
    is not (E, C, K), and an up/gate pair that disagrees all raise before
    any launch, and never run the plain version instead."""
    calls, _ = fake_card
    E, C, N, K, bk = 4, 4, 64, 256, 128
    before = dict(_build.launches)
    qx, sx = _meta(E, C, K, dtype=torch.int8), _meta(E, C, K // bk)
    pw = {"experts": _meta_pack(E + 1, N, K, bk), "shape": _meta_pack(E, N, K // 2, bk),
          "block": _meta_pack(E, N, K, 32), "x_rank": _meta_pack(E, N, K, bk),
          "pair": _meta_pack(E, N, K, bk)}[bad]
    if bad == "x_rank":
        qx = _meta(E * C, K, dtype=torch.int8)
    with pytest.raises(ValueError):
        if bad == "pair":
            taxq.axqmm_gated_experts_quantized(qx, sx, pw, _meta_pack(E, 2 * N, K, bk), 8)
        else:
            taxq.axqmm_experts_quantized(qx, sx, pw, 8)
    with pytest.raises(ValueError):
        taxq.axqmm_gated_experts_quantized(qx, sx, pw, _meta_pack(E, 2 * N, K, bk)
                                           if bad == "pair" else pw, 8)
    assert calls == []
    assert _build.launches == before


def test_lm_forward_aux_matches_reference():
    """``lm_forward``'s logits (1e-4) and the summed aux loss of the
    layers (1e-6) on granite-smoke under axq8 at degree 6."""
    jm, jp, tm, tp = P.models("float32", "axq8", arch=GRANITE)
    toks = np.random.default_rng(4).integers(0, 512, (2, 10)).astype(np.int32)
    with P.jax_backend("xla"):
        lj, aj = jax.jit(lambda p, b: jm.forward(p, b, degree=jnp.int32(6)))(
            jp, {"tokens": jnp.asarray(toks)})
    lt, at = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                        degree=torch.tensor(6, dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL_LOGITS)
    np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-6)
    assert float(at) > 0


@pytest.mark.parametrize("arch,quant", [(GRANITE, False), (GRANITE, True), (QWEN, False)],
                         ids=["granite-bf16-cache", "granite-int8-cache", "qwen-bf16-cache"])
def test_engine_streams_match_reference(arch, quant, monkeypatch):
    """Five requests on two slots in f32 under axq8 with the QoS ladder
    8 -> 6, exact-length admission (asked for buckets and packing, which
    both engines drop for MoE): the port's greedy streams equal the JAX
    engine's on its Pallas route, and the degree walks the same rungs."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    from repro.serve.admission import AdmissionConfig as JAdmissionConfig

    jm, jp, tm, tp = P.models("float32", "axq8", arch=arch)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 14, 3, 11)]
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=JAdmissionConfig(pack=2), emitter=False)
        jreqs = [jeng.submit(p, 5) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()),
                       admission=AdmissionConfig(pack=2), emitter=False)
    assert isinstance(teng.cache, LMCacheQ) == quant
    assert teng.workload.admission is None
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 5) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 5, LOGIT_TOL)
    assert teng.workload.trace_counts["prefill_batch"] == 0
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg, (tdeg, jdeg)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


def test_adapter_and_registry_keep_moe_exact_length():
    """The LM adapter drops bucketed / packed / chunked admission for MoE;
    the model's prefill_batch and the transformer's batch and chunk
    prefills raise; chunked prefill is not offered."""
    _, tcfg = _cfgs(GRANITE)
    model = build_model(tcfg, device="cpu")
    ad = LMAdapter(model, max_len=64, admission=AdmissionConfig(pack=4, chunk_tokens=16))
    assert ad.admission is None and not ad._chunk_ok
    assert not model.supports_chunked_prefill()
    params = model.init(seed=0)
    cache = model.init_cache(1, 2, 16, quant=False)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="exact-length only for MoE"):
        model.prefill_batch(params, cache, toks, [0, 1], [8, 8])
    with pytest.raises(ValueError, match="exact-length only for MoE"):
        TT.lm_prefill_batch(params, tcfg, model.policy, cache, toks, [0, 1], [8, 8])
    with pytest.raises(ValueError, match="exact-length only for MoE"):
        TT.lm_prefill_chunk(params, tcfg, model.policy, cache, toks[0], 0, 0, 8)
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        model.prefill_chunk(params, cache, toks[0], 0, 0, 8)


@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge", "internvl2-1b-smoke",
                                  "hubert-xlarge-smoke"])
def test_check_supported_admits_frontend_families(arch):
    """The frontend families are ported: ``check_supported``,
    ``build_model`` and ``prepack_params`` admit them, and each builds its
    frontend projections (``v_proj`` fc1 / fc2, ``a_proj`` fc1, with
    biases) at its registered widths (a meta device init: no weights
    made); a config whose frontend does not match its family is refused."""
    import dataclasses

    cfg = tget_config(arch)
    TT.check_supported(cfg)
    build_model(cfg, device="cpu")
    params = TT.init_lm(torch.Generator(), cfg, device="meta")
    d, fd = cfg.d_model, cfg.frontend_dim
    if cfg.frontend == "vision":
        assert params["v_proj"]["fc1"]["w"].shape == (fd, d)
        assert params["v_proj"]["fc2"]["w"].shape == (d, d)
        assert params["v_proj"]["fc2"]["b"].shape == (d,)
        assert "a_proj" not in params
    else:
        assert params["a_proj"]["fc1"]["w"].shape == (fd, d)
        assert params["a_proj"]["fc1"]["b"].shape == (d,)
        assert "v_proj" not in params and not cfg.causal
    assert params["unembed"]["w"].shape == (d, cfg.padded(1).vocab)
    if not arch.endswith("-smoke"):
        packed = prepack_params(TT.init_lm(torch.Generator(), tget_config(arch + "-smoke")),
                                tget_config(arch + "-smoke"), ApproxPolicy())
        assert ("v_proj" in packed) == (cfg.frontend == "vision")
    with pytest.raises(NotImplementedError):
        TT.check_supported(dataclasses.replace(cfg, frontend=None))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_archs_build_with_their_full_widths(arch):
    """The two MoE archs build (no weights made: a meta device init) with
    their registered widths: the stacked expert tree's shapes."""
    cfg = tget_config(arch)
    TT.check_supported(cfg)
    params = TT.init_lm(torch.Generator(), cfg, device="meta")
    m, L, d = cfg.moe, cfg.n_layers, cfg.d_model
    moe = params["layers"]["moe"]
    assert moe["router"]["w"].shape == (L, d, m.n_experts)
    assert moe["experts"]["up"].shape == (L, m.n_experts, d, m.d_expert)
    assert moe["experts"]["down"].shape == (L, m.n_experts, m.d_expert, d)
    assert ("shared" in moe) == bool(m.n_shared)
    assert "mlp" not in params["layers"]
