"""Port parity of ``train_step`` (forward, backward, clipping, AdamW, the
cosine schedule): the same converted state and numpy batch through the JAX
reference's jitted step on its Pallas route (interpret mode) and through the
port's eager step on the CPU (the plain kernel versions forward, the
backward oracles), for the four ported families at smoke size in f32.

Here: ``test_train_step_matches_reference`` (the rest in ``test_torch_train_step_2.py``).

The shared setup and helpers are in ``_torch_train_step.py``."""

from _torch_train_step import *  # noqa: F401,F403


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
