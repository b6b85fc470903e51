"""The RG-LRU hybrid in bf16 against the compiled JAX reference
(recurrentgemma-2b-smoke): prefill and decode, and the forward and
bucketed prefill.

The shared setup and helpers are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8), ("axq8", 6)])
def test_prefill_decode_bf16_match_reference(approx, degree):
    """The same in bf16 on the bf16 cache (h f32) against the compiled
    reference, prompts within and past the window, at tests/test_torch_
    models_bf16.py's tolerances."""
    _check_bf16(run_prefill_decode("bfloat16", approx, degree, steps=2))
    _check_bf16(run_prefill_decode("bfloat16", approx, degree, prompt_len=45, max_len=64))


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8)])
def test_forward_and_prefill_batch_bf16_match_reference(approx, degree):
    """In bf16 against the compiled reference, at tests/test_torch_models_
    bf16.py's tolerances: ``hybrid_forward``'s logits past the window, and
    every cache field after ``hybrid_prefill_batch`` (three rows in a
    48-token bucket, past the window)."""
    jm, jp, tm, tp = _models("bfloat16", approx)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(6).integers(0, 512, (2, 40)).astype(np.int32)
    lens, slots = [48, 17, 3], [2, 0, 1]
    _, btoks = P.padded_rows(lens, 48, 8)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
        jc = jax.jit(jm.prefill_batch)(jp, jm.init_cache(tp=1, batch=3, max_len=64),
                                       jnp.asarray(btoks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    lt, _ = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=LOGIT_ATOL_BF16)
    tc = tm.prefill_batch(tp, tm.init_cache(1, 3, 64), _t(btoks).long(), slots, lens,
                          degree=tdeg)
    for f in ("k", "v", "h", "conv"):
        assert _rel(_np(getattr(tc, f)), _np(getattr(jc, f))) <= CACHE_REL_BF16, f
