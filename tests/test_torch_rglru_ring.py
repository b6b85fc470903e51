"""The RG-LRU hybrid's attention ring past its window against the JAX package
(recurrentgemma-2b-smoke, f32).

The shared setup and helpers are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


@pytest.mark.parametrize("prompt_len,steps", [(31, 3), (32, 2), (40, 6), (70, 4)])
def test_ring_wrap_past_the_window_matches_reference(prompt_len, steps):
    """Prompts at, past and twice past the window of 32 (the prefill writes
    its last 32 tokens at ``j % 32``, ``band`` attention), then decode
    steps that wrap the ring again: every stage within 1e-4 in f32 under
    axq8 at degree 6."""
    for stage in run_prefill_decode("float32", "axq8", 6, prompt_len=prompt_len, steps=steps,
                                    max_len=64):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)
