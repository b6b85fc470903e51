"""Part 2 of the ``test_torch_frontends`` tests: ``test_sinusoidal_within_two_ulps``, ``test_embed_inputs_match_reference``, ``test_vlm_engine_streams_match_reference``, ``test_launch_train_cpu`` (the rest in ``test_torch_frontends.py``, ``test_torch_frontends_3.py``).

The shared setup and helpers are in ``_torch_frontends.py``."""

from _torch_frontends import *  # noqa: F401,F403


# ---------------------------------------------------------------------------
# the frontend pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,d", [(8, 32), (16, 64), (1024, 1280), (4096, 512)])
def test_sinusoidal_within_two_ulps(S, d):
    """The (S, d) table, ``[sin | cos]`` halves: the angles within 2 f32
    ulps of the reference's, the table within 2 ulps of its angle plus 2
    of its own value."""
    ref = np.asarray(JT._sinusoidal(S, d))
    got = TM._sinusoidal(S, d).numpy()
    assert got.shape == ref.shape == (S, d) and got.dtype == np.float32
    pos = np.arange(S, dtype=np.float32)[:, None]
    jfreq = np.asarray(jnp.power(10_000.0, 2 * jnp.arange(d // 2, dtype=jnp.float32) / d))
    tfreq = torch.pow(10_000.0, 2 * torch.arange(d // 2, dtype=torch.float32) / d).numpy()
    assert np.all(np.abs(jfreq - tfreq) <= 2 * np.spacing(jfreq))
    ang = pos / jfreq[None]
    bound = 2 * np.spacing(np.concatenate([ang, ang], -1)) + 2 * np.spacing(np.abs(ref))
    assert np.all(np.abs(got - ref) <= bound)
    # the halves are sin then cos, not interleaved
    np.testing.assert_allclose(got[:, 0], np.sin(np.arange(S, dtype=np.float32)), atol=1e-6)
    np.testing.assert_allclose(got[:, d // 2], np.cos(np.arange(S, dtype=np.float32)),
                               atol=1e-6)


@pytest.mark.parametrize("approx,degree", DEGREES[:3], ids=["exact", "axq8-8", "axq8-6"])
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_match_reference(arch, approx, degree):
    """``embed_inputs`` alone in f32 at the head site's degree: x and the
    positions."""
    jm, jp, tm, tp = P.models("float32", approx, arch=arch)
    jb, tb = _batch(jm.cfg)
    jd, td = P.degrees(degree)
    with P.jax_backend("pallas"):
        jx, jpos = JT.embed_inputs(jp, jm.cfg, jb, jnp.float32, jm.policy, jd)
    tx, tpos = TM.embed_inputs(tp, tm.cfg, tb, torch.float32, tm.policy, td)
    S = 16 + (jm.cfg.frontend_tokens if arch == VLM else 0)
    assert tuple(tx.shape) == tuple(jx.shape) == (2, S, jm.cfg.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_vlm_engine_streams_match_reference(quant, monkeypatch):
    """internvl2-1b-smoke in f32 under axq8 with the QoS ladder 8 -> 6:
    five text prompts on two slots, exact-length admission on the bf16
    cache and bucketed, packed admission on the int8 cache; the port's
    greedy streams equal the JAX engine's on its Pallas route, and the
    degree walks the same rungs."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    jm, jp, tm, tp = P.models("float32", "axq8", arch=VLM)
    rng = np.random.default_rng(26)
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
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 6, LOGIT_TOL)
    assert [d for _, d in teng.stats.degree_history] == \
        [d for _, d in jeng.stats.degree_history]
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_cpu(arch, capsys):
    """``launch.train --device cpu`` on the pipeline's frontend batches
    (the VLM's image and text tokens, the audio encoder's masked frames)
    under axq8 with --qos: every step runs, finite losses."""
    from repro_torch.launch import train as tlaunch

    seq = 24 if arch == VLM else 16
    out = tlaunch.main(["--arch", arch, "--steps", "6", "--seq", str(seq), "--batch", "2",
                        "--approx", "axq8", "--qos", "--device", "cpu"])
    assert out["final_step"] == 6 and not out["preempted"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "done at step 6" in capsys.readouterr().out
