"""An f32 engine on a bf16 state cache against the reference's streams:
recurrentgemma-2b-smoke (cut to 4 layers) with exact-length admission (its
bucketed case is in ``test_torch_conv_tail_hybrid_buckets.py``,
mamba2-370m-smoke's in ``test_torch_conv_tail.py``).

The shared setup and the test's body are in ``_torch_conv_tail.py``."""

from _torch_conv_tail import *  # noqa: F401,F403


@pytest.mark.parametrize("admission", [False], ids=["exact"])
@pytest.mark.parametrize("arch,over", CASES[1:], ids=["recurrentgemma"])
def test_f32_engine_on_bf16_state_cache_matches_reference(arch, over, admission):
    """:func:`f32_engine_on_bf16_state_cache_matches_reference` for
    recurrentgemma-2b-smoke, exact-length admission."""
    f32_engine_on_bf16_state_cache_matches_reference(arch, over, admission)
