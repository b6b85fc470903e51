"""Port parity of ``train_step`` (forward, backward, clipping, AdamW, the
cosine schedule): the same converted state and numpy batch through the JAX
reference's jitted step on its Pallas route (interpret mode) and through the
port's eager step on the CPU (the plain kernel versions forward, the
backward oracles), for the four ported families at smoke size in f32.

Tolerances (tests/_torch_train.py): loss, grad_norm and params after one
step rtol 1e-5 (atol 1e-5 on params), mu and nu within 1e-5 of each leaf's
largest entry after every step, params after 3 steps atol 1e-4.  Within the
port, remat policies and grad_accum are held to each other, and the
bf16-backward lever (REPRO_BWD_BF16) to the reference's at bf16 bounds."""
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.dist import collectives as jcoll
from repro_torch.dist import collectives as tcoll
from repro_torch.tree import tree_leaves
from repro_torch.train import step as tstep

torch.set_num_threads(2)

CASES = [("tinyllama-1.1b-smoke", "exact", None),
         ("tinyllama-1.1b-smoke", "axq8", 6),
         ("tinyllama-1.1b-smoke", "axq8", "vector"),
         ("granite-moe-3b-a800m-smoke", "axq8", 6),
         ("mamba2-370m-smoke", "axq8", 6),
         ("recurrentgemma-2b-smoke", "axq8", 6)]


@pytest.mark.parametrize("arch,approx,degree", CASES,
                         ids=[f"{a.split('-')[0]}-{p}-{d}" for a, p, d in CASES])
def test_train_step_matches_reference(arch, approx, degree):
    """One and three steps: loss, grad_norm, params, mu, nu and the step
    counters; the MoE aux loss enters the loss as 0.01 x aux."""
    jm, tm = TT.models(arch, approx)
    js, ts = TT.states(jm)
    jb, tb = TT.batches(jm.cfg)
    jdeg, tdeg = TT.degrees(degree, jm.cfg.n_layers + 1)
    jcfg, tcfg = TT.step_cfgs(remat="none")
    jout = TT.jax_steps(jm, jcfg, js, jb, jdeg, 3)
    tout = TT.port_steps(tm, tcfg, ts, tb, tdeg, 3)
    TT.assert_states_close(*tout[0], *jout[0], param_atol=TT.RTOL)
    TT.assert_states_close(*tout[2], *jout[2], param_atol=TT.PARAM_ATOL_3)
    for (_, tmet), (_, jmet) in zip(tout, jout):
        np.testing.assert_allclose(float(tmet["lr_scale"]), float(jmet["lr_scale"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]), rtol=1e-5,
                                   atol=1e-6)
        assert float(tmet["ntokens"]) == float(jmet["ntokens"])
    if jm.cfg.moe:
        assert float(tout[0][1]["aux"]) > 0


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
