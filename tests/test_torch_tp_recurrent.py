"""Tensor-parallel serving of the recurrent families on the CPU:
mamba2-370m-smoke (8 SSD heads) and recurrentgemma-2b-smoke (4 query
heads over 1 kv head: MQA) in f32 as 2 (and, under EXACT, 4) spawned gloo
ranks, each with its heads and channels of the reference's tp-padded
parameters (``model.init(key, tp=tp)`` in JAX, through numpy): a Mamba-2
rank holds ``in_proj``'s ``[z_r | x_r | B | C | dt_r]``, an RG-LRU rank its
channels, an attention rank its query heads and, through the kv-split
path, its repeated kv head.

Here: tp 2 (tp 4 in ``test_torch_tp_recurrent_tp4.py``).

The shared setup and helpers are in ``_torch_tp_recurrent.py``."""

from _torch_tp_recurrent import *  # noqa: F401,F403


@pytest.mark.parametrize("arch", ARCHS, ids=["mamba2", "recurrentgemma"])
def test_ring_lever_and_one_tick_collectives(arch):
    """EXACT at tp=2.  The int8 ring's logits within rel 0.05 of the exact
    ones.  One steady decode tick on 2 slots: the embedding's all-reduce
    and two a layer (a Mamba-2 layer's gnorm sum of squares, (2, 1) f32,
    and out_proj's (2, d) partials; an RG-LRU or attention block's wo and
    down), each attention block's k and v gathered (the kv-split path:
    MQA's one kv head over 2 ranks), and the logits' all-gather.  Under
    the ring the row-parallel partials ride the ring's hops and only the
    embedding's and gnorm's all-reduces stay, exact (2 (n - 1) hops a
    ring)."""
    cfg = jget_config(arch)
    got, _ = _run(2)[(arch, "exact")]
    r0 = got[0]
    rel = np.abs(r0["ring_logits"] - r0["logits"]).mean() / (np.abs(r0["logits"]).mean()
                                                             + 1e-9)
    assert 0 < rel < 0.05, rel
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded(2).vocab
    n_attn = cfg.block_pattern.count("attn") if cfg.block_pattern else 0
    kv = 2 * cfg.n_kv_heads * cfg.head_dim // 2 * 4           # (2, 1, KV D / 2) f32
    # the ring's reductions: out_proj a Mamba-2 layer, wo and down a block
    if cfg.family == "ssm":
        want_bytes = {"all-reduce": 2 * d * 4 + L * (2 * 4 + 2 * d * 4)}
        ring_reduces, rings = L + 1, L
    else:
        want_bytes = {"all-reduce": (2 * L + 1) * 2 * d * 4}
        ring_reduces, rings = 1, 2 * L
    want_bytes["all-gather"] = 2 * (V // 2) * 4 + 2 * n_attn * kv
    for g in got:
        assert g["tick"]["calls"] == {"all-reduce": 2 * L + 1, "all-gather": 2 * n_attn + 1}
        assert g["tick"]["bytes"] == want_bytes
        ring = g["ring_tick"]["calls"]
        assert ring["all-reduce"] == ring_reduces
        assert ring["collective-permute"] == 2 * rings       # 2 (n - 1) hops a ring
        assert ring["all-gather"] == 2 * n_attn + 1


def test_launch_serve_tp2_recurrent(capfd):
    """``launch.serve --tp 2`` on mamba2-370m-smoke: every request ok and
    the ranks' streams equal; a tick's all-reduces as the layer count
    predicts (the embedding's, gnorm's and out_proj's a layer)."""
    argv = ["--tp", "2", "--dist-backend", "gloo", "--device", "cpu", "--requests", "5",
            "--new-tokens", "6", "--slots", "2", "--arch", "mamba2-370m-smoke"]
    s, eng = launch_serve.run(argv + ["--metrics"])
    assert eng is None
    assert s["requests"] == 5 and s["statuses"] == {"ok": 5} and s["streams_equal"]
    assert s["tp"] == 2 and s["transport"] == "gloo"
    assert s["collective_calls_per_tick"]["all-gather"] == 1.0
    assert capfd.readouterr().out.count("[launch.serve] tp=2 (gloo") == 1


@pytest.mark.parametrize("arch", ARCHS, ids=["mamba2", "recurrentgemma"])
@pytest.mark.parametrize("tp,policy", CASES[:2], ids=["tp2-exact", "tp2-axq8-b16"])
def test_sharded_recurrent_engine_matches_reference(arch, tp, policy):
    """:func:`sharded_recurrent_engine_matches_reference` at tp 2 (tp 4 in
    ``test_torch_tp_recurrent_tp4.py``)."""
    sharded_recurrent_engine_matches_reference(arch, tp, policy)
