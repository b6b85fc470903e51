"""The RG-LRU hybrid served (recurrentgemma-2b-smoke): the prompt bound of
the local window and ``launch.serve`` under QoS.

The shared setup and helpers are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


def test_prompt_bound_follows_the_local_window():
    """The adapter bounds prompts by the cache only when the local window
    does not fit in max_len (the ring wraps only then), as the reference."""
    from repro_torch.models.registry import build_model
    from repro_torch.serve.lm import LMAdapter

    model = build_model(tget_config(ARCH), device="cpu")
    assert LMAdapter(model, max_len=32)._max_prompt is None
    assert LMAdapter(model, max_len=16)._max_prompt == 16
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        LMAdapter(model, max_len=16).validate(np.arange(17))


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "buckets"])
def test_launch_serve_under_qos(buckets):
    """``launch.serve --arch recurrentgemma-2b-smoke --device cpu --approx
    axq8 --qos`` (with ``--prefill-buckets auto --pack 4`` and a chunk size,
    which the hybrid does not take): every request finishes with its
    tokens, the ladder moves, the weights are packed against the serve-time
    paths."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", ARCH, "--device", "cpu", "--approx", "axq8", "--qos",
            "--requests", "6", "--new-tokens", "5", "--max-len", "64"]
    if buckets:
        argv += ["--prefill-buckets", "auto", "--pack", "4", "--chunk-tokens", "16"]
    s, eng = launch_serve.run(argv)
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert isinstance(eng.cache, trg.HybridCache)
    assert (eng.workload.admission is not None) == buckets
    assert eng.workload.trace_counts["prefill_chunk"] == 0
    assert isinstance(eng.params["groups"]["rec0"]["wx"]["w"], PackedQWeight)
    assert len({d for _, d in eng.stats.degree_history}) > 1
