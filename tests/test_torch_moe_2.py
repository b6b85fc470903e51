"""Part 2 of the ``test_torch_moe`` tests: ``test_moe_apply_routing_and_output_match_reference``, ``test_batched_plain_gemms_match_vmapped_reference``, ``test_moe_packs_through_convert_match_prepack``, ``test_prefill_decode_match_reference``, ``test_prefill_decode_bf16_match_reference``, ``test_launch_serve_moe_under_qos`` (the rest in ``test_torch_moe.py``).

The shared setup and helpers are in ``_torch_moe.py``."""

from _torch_moe import *  # noqa: F401,F403


@pytest.mark.parametrize("arch,spec,degree,shape,packed,cf", MOE_CASES)
def test_moe_apply_routing_and_output_match_reference(monkeypatch, arch, spec, degree, shape,
                                                      packed, cf):
    """``moe_apply`` on the same h: the top-k ids, the capacity and the
    dispatched buffer (so the keep mask) equal the reference's, the output
    within 1e-5 and the aux loss within 1e-6.  ``vector`` passes one entry
    of a per-site (n_layers + 1,) degree vector, as the layer loop does; a
    decode-shaped call (8 slots, one token each) counts every slot in the
    capacity."""
    jcfg, tcfg = _cfgs(arch, **({} if cf is None else {"capacity_factor": cf}))
    jpol, tpol = _policies(spec)
    jp = _moe_params(arch)
    if packed:
        espec = jmoe.expert_spec(jpol, "layer/moe")
        jp = {**jp, "experts": {k: jprepack(jnp.asarray(w), espec.block)
                                for k, w in jp["experts"].items()}}
        jp = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(jp)
    assert isinstance(tp["experts"]["up"], PackedQWeight) == packed
    rng = np.random.default_rng(sum(shape) + (degree if isinstance(degree, int) else 0))
    x = rng.standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    if degree == "vector":
        jdeg, tdeg = jnp.asarray([8, 6, 5], jnp.int32)[1], torch.tensor([8, 6, 5],
                                                                         dtype=torch.int32)[1]
    elif degree is None:
        jdeg, tdeg = None, None
    else:
        jdeg, tdeg = jnp.int32(degree), torch.tensor(degree, dtype=torch.int32)

    rec = _Recorder(monkeypatch)
    with P.jax_backend("xla"):
        fn = jax.jit(lambda p, h, d: jmoe.moe_apply(p, h, jcfg, jpol, "layer/moe", d))
        yj, aj = fn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jdeg)
        jax.effects_barrier()
    bufs = _port_routing(monkeypatch)
    yt, at = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, tpol, "layer/moe", tdeg)

    B, S = shape
    t = B * S
    C = tmoe.capacity(tcfg, t)
    _, ids, _ = tmoe.route(tp["router"]["w"], torch.from_numpy(x).reshape(t, -1), tcfg)
    (jids,), (jbuf,), (tbuf,) = rec.ids, rec.bufs, bufs
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert jbuf.shape == tuple(tbuf.shape) == (tcfg.moe.n_experts, C, tcfg.d_model)
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    _, _, keep = tmoe.dispatch_plan(ids, C, tcfg.moe.n_experts)
    kept = np.bincount(ids.reshape(-1)[keep].numpy(), minlength=tcfg.moe.n_experts)
    np.testing.assert_array_equal(kept, (np.abs(jbuf).sum(-1) > 0).sum(-1))
    if cf is not None:
        assert C == 4 and not bool(keep.all())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL_MOE)
    np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("act", ["relu", "silu", "gelu"])
def test_batched_plain_gemms_match_vmapped_reference(route, act):
    """``axqmm_gated_experts_plain`` / ``axqmm_experts_plain`` against the
    reference's ``vmap`` of ``axq_gated`` / ``axq_matmul`` over packed
    experts (E 5, C 6 with two all-zero capacity rows, ragged N 72), at
    ebits 8, 5 and 1; the xla route without an activation bit for bit,
    the others within GEMM_ATOL; each expert's slice bit for bit the 2-D
    plain version on it."""
    E, C, K, N, bk = 5, 6, 128, 72, 64
    (ju, jg), (tu, tg) = _expert_weights(E, K, N, bk, 11)
    x = np.random.default_rng(12).standard_normal((E, C, K)).astype(np.float32)
    x[:, -2:] = 0.0
    worst = 0.0
    for e in (8, 5, 1):
        with P.jax_backend(route):
            gj = jax.vmap(lambda xe, u, g: jdispatch.axq_gated(
                xe, u, g, act=act, block=bk, ebits=e, ste=True))(jnp.asarray(x), ju, jg)
            dj = jax.vmap(lambda xe, w: jdispatch.axq_matmul(
                xe, w, block=bk, ebits=e, ste=True))(jnp.asarray(x[..., :K]), ju)
        gt = taxq.axqmm_gated_experts_plain(torch.from_numpy(x), tu, tg, e, act=act)
        dt = taxq.axqmm_experts_plain(torch.from_numpy(x), tu, e)
        for ref, port, exact in ((gj, gt, route == "xla" and act == "relu"),
                                 (dj, dt, route == "xla")):
            if exact:
                np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=GEMM_ATOL)
            worst = max(worst, float(np.abs(port.numpy() - np.asarray(ref)).max()))
        assert (gt[:, -2:] == 0).all() and (dt[:, -2:] == 0).all()
        for i in range(E):
            xi = torch.from_numpy(x[i])
            assert torch.equal(gt[i], taxq.axqmm_gated_plain(
                xi, taxq.expert_pack(tu, i), taxq.expert_pack(tg, i), e, act=act))
            assert torch.equal(dt[i], taxq.axqmm_packed_plain(xi, taxq.expert_pack(tu, i), e))
    print(f"largest |port - reference| on the {route} route under {act}: {worst:.3g}")


# ---------------------------------------------------------------------------
# packs, models, engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_packs_through_convert_match_prepack(arch):
    """The reference's packed MoE tree through ``params_from_numpy``
    equals the port's ``prepack_params`` of the converted float tree, bit
    for bit: the experts per (layer, expert) slice with leading (L, E), the
    shared experts (qwen2-moe) per their own spec; the router stays f32."""
    jm, jp_packed, _, tp_packed = P.models("float32", "axq8", arch=arch)
    jp = jm.init(jax.random.PRNGKey(0), tp=1)
    _, tcfg = _cfgs(arch)
    tp = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tcfg,
                        ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8,
                                                        dynamic=True)))
    a, b = tp_packed["layers"]["moe"], tp["layers"]["moe"]
    L, E = tcfg.n_layers, tcfg.moe.n_experts
    for k in ("up", "gate", "down"):
        pa, pb = a["experts"][k], b["experts"][k]
        assert isinstance(pa, PackedQWeight) and pa.qw.shape[:2] == (L, E)
        assert torch.equal(pa.qw, pb.qw) and torch.equal(pa.scales, pb.scales)
        if "shared" in a:
            assert torch.equal(a["shared"][k].qw, b["shared"][k].qw)
            assert torch.equal(a["shared"][k].scales, b["shared"][k].scales)
    assert ("shared" in a) == (arch == QWEN)
    assert torch.equal(a["router"]["w"], b["router"]["w"])
    assert a["router"]["w"].dtype == torch.float32 and a["router"]["w"].shape == (
        L, tcfg.d_model, E)
    jpk = jprepack_params(jp, jget_config(arch), jm.policy)
    assert np.array_equal(np.asarray(jpk["layers"]["moe"]["experts"]["up"].qw),
                          a["experts"]["up"].qw.numpy())


@pytest.mark.parametrize("arch,approx,degree", [
    (GRANITE, "exact", None), (GRANITE, "axq8", 6), (GRANITE, "axq8", "vector"),
    (QWEN, "exact", None), (QWEN, "axq8", 6), (QWEN, "axq8", "vector")])
def test_prefill_decode_match_reference(arch, approx, degree):
    """``lm_prefill`` then ``lm_decode_step`` (slot 0 free) in f32 on an f32
    cache: logits and the live cache rows within 1e-4 of the reference's
    Pallas route."""
    prefill, decode = P.run_prefill_decode("float32", approx, degree, "pallas",
                                           cache_dtype=jnp.float32, arch=arch)
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL_LOGITS, err_msg=name)


@pytest.mark.parametrize("arch,approx,degree", [(GRANITE, "axq8", 6), (QWEN, "exact", None),
                                                (QWEN, "axq8", "vector")])
def test_prefill_decode_bf16_match_reference(arch, approx, degree):
    """The same in bf16 on the bf16 cache, at tests/test_torch_models_bf16.py's
    tolerances."""
    prefill, decode = P.run_prefill_decode("bfloat16", approx, degree, "pallas", arch=arch)
    for stage in (prefill, decode):
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL_BF16)
        for name in ("k", "v"):
            ref, port = stage[name]
            assert np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30) <= \
                CACHE_REL_BF16


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_launch_serve_moe_under_qos(monkeypatch, quant):
    """``launch.serve --arch granite-moe-3b-a800m-smoke --approx axq8
    --qos`` on the CPU, on either cache (buckets and packing asked for and
    dropped): every request finishes with its tokens through exact-length
    prefills, and the ladder moves."""
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    s, eng = launch_serve.run(["--arch", GRANITE, "--device", "cpu", "--approx", "axq8",
                               "--qos", "--requests", "6", "--new-tokens", "5",
                               "--prefill-buckets", "auto", "--pack", "4"])
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert isinstance(eng.cache, LMCacheQ) == quant
    assert eng.workload.admission is None and eng.stats.prefill_calls > 0
    assert isinstance(eng.params["layers"]["moe"]["experts"]["up"], PackedQWeight)
    assert len({d for _, d in eng.stats.degree_history}) > 1
