"""Part 2 of the ``test_torch_train_step`` tests: ``test_remat_policies_give_equal_steps``, ``test_remat_recurrent_families_match_reference``, ``test_grad_accum_matches_reference_and_full_batch``, ``test_compressed_grads_step_matches_reference``, ``test_collectives_match_reference_and_telescope``, ``test_bwd_bf16_lever_matches_reference`` (the rest in ``test_torch_train_step.py``).

The shared setup and helpers are in ``_torch_train_step.py``."""

from _torch_train_step import *  # noqa: F401,F403


@pytest.mark.parametrize("approx", ["exact", "axq8"])
def test_remat_policies_give_equal_steps(approx):
    """none, dots and full: the same loss, gradients and update bit for bit
    (remat changes what is kept, never a value)."""
    _, tm = TT.models("tinyllama-1.1b-smoke", approx)
    jm, _ = TT.models("tinyllama-1.1b-smoke", approx)
    _, ts = TT.states(jm)
    _, tb = TT.batches(tm.cfg)
    deg = torch.tensor(6, dtype=torch.int32)
    outs = {}
    for remat in ("none", "dots", "full"):
        (loss, _), grads = tstep.value_and_grad(tm, ts.params, tb, degree=deg, remat=remat)
        outs[remat] = (loss, tree_leaves(grads))
    for remat in ("dots", "full"):
        assert torch.equal(outs[remat][0], outs["none"][0])
        for a, b in zip(outs[remat][1], outs["none"][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "recurrentgemma-2b-smoke"])
def test_remat_recurrent_families_match_reference(arch):
    """The SSM (per layer) and hybrid (per group) remat paths against the
    reference's ``dots`` policy after one step."""
    jm, tm = TT.models(arch, "axq8")
    js, ts = TT.states(jm)
    jb, tb = TT.batches(jm.cfg)
    jcfg, tcfg = TT.step_cfgs(remat="dots")
    jdeg, tdeg = TT.degrees(7, 0)
    (js1, jmet), = TT.jax_steps(jm, jcfg, js, jb, jdeg, 1)
    (ts1, tmet), = TT.port_steps(tm, tcfg, ts, tb, tdeg, 1)
    TT.assert_states_close(ts1, tmet, js1, jmet, param_atol=TT.RTOL)


def test_grad_accum_matches_reference_and_full_batch():
    """grad_accum 2: microbatches' f32 gradients summed then divided, the
    loss averaged, metrics of the last microbatch — against the reference's
    accumulated step, and within 2e-4 of the full-batch step (as
    tests/test_train.py holds the reference)."""
    jm, tm = TT.models("tinyllama-1.1b-smoke", "exact")
    js, ts = TT.states(jm)
    jb, tb = TT.batches(jm.cfg, B=4)
    jcfg, tcfg = TT.step_cfgs(remat="none", grad_accum=2, warmup=0)
    (js2, jmet), = TT.jax_steps(jm, jcfg, js, jb, None, 1)
    (ts2, tmet), = TT.port_steps(tm, tcfg, ts, tb, None, 1)
    TT.assert_states_close(ts2, tmet, js2, jmet, param_atol=TT.RTOL)
    _, tcfg1 = TT.step_cfgs(remat="none", grad_accum=1, warmup=0)
    (ts1, _), = TT.port_steps(tm, tcfg1, ts, tb, None, 1)
    for a, b in zip(TT.leaves(ts1.params), TT.leaves(ts2.params)):
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_compressed_grads_step_matches_reference():
    """--compress-grads: every matrix gradient quantize-dequantized to int8
    before the update (1-d leaves exact), against the reference's step."""
    jm, tm = TT.models("tinyllama-1.1b-smoke", "axq8")
    js, ts = TT.states(jm)
    jb, tb = TT.batches(jm.cfg)
    jcfg, tcfg = TT.step_cfgs(remat="none", compress_grads=True)
    jdeg, tdeg = TT.degrees(8, 0)
    jout = TT.jax_steps(jm, jcfg, js, jb, jdeg, 2)
    tout = TT.port_steps(tm, tcfg, ts, tb, tdeg, 2)
    TT.assert_states_close(*tout[0], *jout[0], param_atol=TT.RTOL)
    TT.assert_states_close(*tout[1], *jout[1], param_atol=TT.PARAM_ATOL_3)


@pytest.mark.parametrize("bits", [8, 4])
def test_collectives_match_reference_and_telescope(bits):
    """quantize_dequantize / dp_allreduce_compressed bit for bit against the
    reference; ef_compress telescopes: sum(sent) + err_final ==
    sum(g_true) up to f32 rounding of the sums (tests/test_collectives.py),
    and each residual stays within one quantization step."""
    import jax.numpy as jnp

    rng = np.random.default_rng(bits)
    gs = [rng.standard_normal((16, 8)).astype(np.float32) for _ in range(12)]
    for g in gs[:3]:
        np.testing.assert_array_equal(
            tcoll.quantize_dequantize(torch.from_numpy(g), bits).numpy(),
            np.asarray(jcoll.quantize_dequantize(jnp.asarray(g), bits)))
        np.testing.assert_array_equal(
            tcoll.dp_allreduce_compressed(torch.from_numpy(g), bits).numpy(),
            np.asarray(jcoll.dp_allreduce_compressed(jnp.asarray(g), bits)))
    err = torch.zeros(16, 8)
    jerr = jnp.zeros((16, 8))
    sent_sum = torch.zeros(16, 8, dtype=torch.float64)
    for g in gs:
        sent, err = tcoll.ef_compress(torch.from_numpy(g), err, bits)
        jsent, jerr = jcoll.ef_compress(jnp.asarray(g), jerr, bits)
        np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        sent_sum += sent.double()
        qmax = (1 << (bits - 1)) - 1
        assert float(err.abs().max()) <= float((sent + err).abs().max()) / qmax / 2 * 1.0001
    total = np.sum(np.stack(gs).astype(np.float64), axis=0)
    np.testing.assert_allclose(sent_sum.numpy() + err.double().numpy(), total, atol=1e-4)
    tree = {"w": torch.from_numpy(gs[0]), "s": torch.from_numpy(gs[1][0])}
    out = tcoll.compress_tree_for_allreduce(tree, bits)
    assert torch.equal(out["s"], tree["s"])
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(
        jcoll.compress_tree_for_allreduce({"w": jnp.asarray(gs[0])}, bits)["w"]))


def test_bwd_bf16_lever_matches_reference(monkeypatch):
    """REPRO_BWD_BF16=1 (the modules' import-time flag set on both sides):
    the EXACT products' bf16 forward partials and bf16 dx, f32 dw.  Held
    to the bf16 bounds: loss 2e-2 relative, every gradient within 2e-2
    relative Frobenius, and the step moves away from the f32 product's."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    jm, tm = TT.models("tinyllama-1.1b-smoke", "exact")
    js, ts = TT.states(jm)
    jb, tb = TT.batches(jm.cfg)
    _, tcfg = TT.step_cfgs(remat="none")
    (ts_f32, _), = TT.port_steps(tm, tcfg, ts, tb, None, 1)
    monkeypatch.setattr(jops, "_BWD_BF16", True)
    monkeypatch.setattr(tops, "_BWD_BF16", True)
    import jax

    with TT.jax_backend("pallas"):
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb, remat="none"), has_aux=True))(js.params)
    (tl, _), tg = tstep.value_and_grad(tm, ts.params, tb, remat="none")
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)
    for a, b in zip(TT.leaves(tg), TT.leaves(jg)):
        assert np.linalg.norm(a - b) <= 2e-2 * max(np.linalg.norm(b), 1e-30)
    (ts_bf16, _), = TT.port_steps(tm, tcfg, ts, tb, None, 1)
    assert any(not np.array_equal(a, b) for a, b in
               zip(TT.leaves(ts_bf16.params), TT.leaves(ts_f32.params)))
