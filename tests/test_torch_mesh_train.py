"""Training on a mesh on the CPU: tinyllama-1.1b-smoke in f32 as spawned
gloo ranks (``tests/_torch_mesh.py``), each with its shards of the
reference's tp-padded state (``init_state(model, key, tp)`` in JAX, through
numpy and ``convert.train_state_from_numpy(mesh=...)``) and its rows of the
batch, held to the reference's jitted one-device ``train_step`` (AXQ on its
Pallas route in interpret mode, as tests/_torch_train.py runs it).

Here: the 1x2, 2x1 and 2x2 meshes (1x4 in ``test_torch_mesh_train_1x4.py``).

The shared setup and helpers are in ``_torch_mesh_train.py``."""

from _torch_mesh_train import *  # noqa: F401,F403


def test_unequal_token_counts_over_data_ranks():
    """2x1 with most labels of rank 0's rows masked: each rank's share is
    over the global token count, so the sum is the reference's mean."""
    batch = _batch(mask_rows=[0, 1])
    assert (batch["labels"][:2] >= 0).sum() < (batch["labels"][2:] >= 0).sum()
    per, ref = _mesh_run((2, 1))["unequal"]
    _assert_matches(per[0], *ref)
    assert per[0]["metrics"][0]["ntokens"] == float((batch["labels"] >= 0).sum())
    _assert_rank_identity(per, (2, 1))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_compressed_grads_match_reference(shape):
    """--compress-grads: the global gradient quantize-dequantized to int8 (a
    sharded leaf against the whole leaf's amax), against the reference's
    compressed step; one MAX all-reduce of the amaxes on the model axis."""
    per, ref = _mesh_run(shape)["compress"]
    _assert_matches(per[0], *ref)
    if shape[1] > 1:
        assert per[0]["collectives"]["calls"]["all-reduce"] == MODEL_ALL_REDUCES + 1


def test_ring_lever_converges_and_stays_near_exact():
    """REPRO_RING_TP's lever under EXACT at 2x2 (global batch 4 x 32,
    labels = tokens, 25 steps): the loss falls by more than 0.5, as the
    reference's test_ring_tp_training_subprocess asks, on every rank alike;
    at 1x2 the ring's gradients within rel 0.05 (Frobenius, each leaf) of
    the exact mesh step's, and the step's collective bytes at most half the
    exact step's (the dx alone: 5 int8 rings a layer against 2 f32
    all-reduces, 5/8)."""
    per, _ = _mesh_run((2, 2))["ring_train"]
    losses = [m["loss"] for m in per[0]["metrics"]]
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert all([m["loss"] for m in r["metrics"]] == losses for r in per)
    run = _mesh_run((1, 2))
    exact, ring = run["exact"][0][0], run["ring_grads"][0][0]
    for a, b in zip(tree_leaves(ring["grads"]), tree_leaves(exact["grads"])):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 0.05, rel
    assert any(not np.array_equal(a, b) for a, b in
               zip(tree_leaves(ring["grads"]), tree_leaves(exact["grads"])))
    eb, rb = exact["grad_bytes"]["total"], ring["grad_bytes"]["total"]
    assert ring["grad_bytes"]["bytes"]["collective-permute"] > 0
    assert rb <= 0.5 * eb, (rb, eb)


def test_autograd_collectives_backward():
    """gather_kv_heads, reduce_from_model and copy_to_model on two ranks:
    each rank's gradient of its input equals the one-process autograd
    gradient of the sum of the ranks' losses (the mesh's semantics)."""
    world = 2
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(world)]
    ws = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(world)]
    ranks = meshctx.spawn_ranks(H.autograd_rank, world, timeout_s=H.TIMEOUT_S,
                                args=(xs, ws, None))
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    full = torch.cat(tx, dim=-1)
    width = xs[0].shape[-1]
    loss = sum((full.narrow(-1, ((r + 1) % world) * width, width)
                * torch.from_numpy(ws[r])).sum() for r in range(world))
    grads = torch.autograd.grad(loss, tx)
    for r in range(world):
        np.testing.assert_allclose(ranks[r]["gather"], grads[r].numpy(), rtol=1e-6)
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    y = sum(x * torch.from_numpy(w) for x, w in zip(tx, ws))
    grads = torch.autograd.grad(torch.sin(y).sum(), tx)
    for r in range(world):
        np.testing.assert_allclose(ranks[r]["reduce"], grads[r].numpy(), rtol=1e-6)
    x = torch.from_numpy(xs[0]).requires_grad_()
    g = torch.autograd.grad(sum((torch.cos(x) * torch.from_numpy(w)).sum() for w in ws), x)[0]
    for r in range(world):
        np.testing.assert_allclose(ranks[r]["copy"], g.numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape", MESHES[:3], ids=[f"{d}x{m}" for d, m in MESHES[:3]])
def test_mesh_step_matches_reference(shape):
    """:func:`mesh_step_matches_reference` at 1x2, 2x1 and 2x2 (1x4 in
    ``test_torch_mesh_train_1x4.py``)."""
    mesh_step_matches_reference(shape)
