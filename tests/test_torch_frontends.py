"""Port parity of the frontend archs: internvl2-1b-smoke (the VLM: patch
embeddings through ``v_proj`` fc1, gelu, fc2, prepended to the tokens) and
hubert-xlarge-smoke (the audio encoder: frame features through
``a_proj/fc1`` plus sinusoidal positions, non-causal ``dense`` attention,
no rope, no decode step), each built in the JAX reference from a seed and
converted through numpy, run through the reference's Pallas route
(interpret mode on the CPU) and the port's plain versions.

Here: ``test_train_step_matches_reference`` (the rest in ``test_torch_frontends_2.py``, ``test_torch_frontends_3.py``).

The shared setup and helpers are in ``_torch_frontends.py``."""

from _torch_frontends import *  # noqa: F401,F403


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 6),
                                           ("axq8", "vector")],
                         ids=["exact", "axq8-6", "axq8-vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, approx, degree):
    """One and three ``train_step``s against the reference's jitted step:
    loss, grad norm, every parameter (hubert's unused ``embed`` included:
    a zero gradient, still decayed by AdamW), mu and nu."""
    jm, tm = TT.models(arch, approx)
    js, ts = TT.states(jm)
    jb, tb = _batch(jm.cfg)
    jdeg, tdeg = TT.degrees(degree, jm.cfg.n_layers + 1)
    jcfg, tcfg = TT.step_cfgs(remat="none")
    # the gradients of the start state, every leaf within 1e-5 of its
    # largest entry
    from repro_torch.train import step as tstep

    (_, _), tg = tstep.value_and_grad(tm, ts.params, tb, degree=tdeg, remat="none")
    with P.jax_backend("pallas"):
        jg = jax.jit(jax.grad(lambda p, d: jm.loss(p, jb, degree=d, remat="none")[0]))(
            js.params, jdeg)
    jgl = TT.leaves(jg)
    for a, b in zip(TT.leaves(tg), jgl):
        assert TT.rel_to_max(a, b) <= TT.RTOL
    ill = [np.abs(g) < ILL_GRAD for g in jgl]
    start = TT.leaves(js.params)
    jout = TT.jax_steps(jm, jcfg, js, jb, jdeg, 3)
    tout = TT.port_steps(tm, tcfg, ts, tb, tdeg, 3)
    _assert_states_close(*tout[0], *jout[0], ill, start, param_atol=TT.RTOL)
    _assert_states_close(*tout[2], *jout[2], ill, start, param_atol=TT.PARAM_ATOL_3)
    for (_, tmet), (_, jmet) in zip(tout, jout):
        assert float(tmet["ntokens"]) == float(jmet["ntokens"])
    if arch == VLM:
        assert sum(int(m.sum()) for m in ill) > 0    # the biases' near-zero entries
    if arch == AUDIO:
        e0 = ts.params["embed"]["emb"]
        e3 = tout[2][0].params["embed"]["emb"]
        assert float(tout[0][0].opt.mu["embed"]["emb"].abs().max()) == 0.0
        assert not torch.equal(e0, e3) and float((e3.abs() - e0.abs()).max()) <= 0.0
