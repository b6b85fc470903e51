"""An f32 model on a bf16 state cache, the port's engines against the
reference's greedy streams (mamba2-370m-smoke, recurrentgemma-2b-smoke cut
to 4 layers).  The reference's prefill writes each conv tail into its
bf16 field (rounded), and its decode returns the tail in the compute
dtype, so its functional cache turns f32 at the first decode step and later
prefills write unrounded.  The port keeps the conv-tail field in the
compute dtype at one address (a captured step binds it) and rounds a
prefill's tails through the cache dtype until the cache's first decode
step (``ssm.init_conv_tail``), so the caches hold the same values and the
streams are equal (a token where the port's top-2 margin is under 1e-2 is
a near-tie, as in tests/test_torch_serve.py).  Five requests on two slots:
admissions before and after the first decode step.

Here: mamba2-370m-smoke's engines and the conv tail's rounding (recurrentgemma-2b-smoke's engines in ``test_torch_conv_tail_hybrid.py`` and ``test_torch_conv_tail_hybrid_buckets.py``).

The shared setup and helpers are in ``_torch_conv_tail.py``."""

from _torch_conv_tail import *  # noqa: F401,F403


def test_conv_tail_rounds_until_the_first_decode():
    """The field's contract on its own: compute dtype, prefill values
    rounded through the cache dtype before the first decode step, exact
    after it; equal dtypes never round."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-370m-smoke")
    f32 = tssm.init_conv_tail((2, 3), cfg.__class__(**{**cfg.__dict__, "dtype": "float32"}),
                              torch.bfloat16, "cpu")
    v = torch.tensor([1.0 + 2 ** -10, 3.0])
    assert torch.equal(tssm.tail_value(f32, v), v.to(torch.bfloat16).float())
    tssm.tail_decoded(f32)
    assert torch.equal(tssm.tail_value(f32, v), v)
    same = tssm.init_conv_tail((2, 3), cfg, torch.bfloat16, "cpu")
    assert same.dtype == torch.bfloat16 and same.tail_round is None


@pytest.mark.parametrize("admission", [False, True], ids=["exact", "buckets-pack2"])
@pytest.mark.parametrize("arch,over", CASES[:1], ids=["mamba2"])
def test_f32_engine_on_bf16_state_cache_matches_reference(arch, over, admission):
    """:func:`f32_engine_on_bf16_state_cache_matches_reference` for
    mamba2-370m-smoke (recurrentgemma-2b-smoke's cases in
    ``test_torch_conv_tail_hybrid.py`` and ``test_torch_conv_tail_hybrid_buckets.py``)."""
    f32_engine_on_bf16_state_cache_matches_reference(arch, over, admission)
