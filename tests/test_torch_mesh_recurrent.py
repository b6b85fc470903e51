"""Training the recurrent families on a mesh on the CPU: mamba2-370m-smoke
and recurrentgemma-2b-smoke in f32 as spawned gloo ranks
(``tests/_torch_mesh.py``), each with its heads and channels of the
reference's tp-padded state (``init_state(model, key, tp=M)`` in JAX,
through numpy and ``convert.train_state_from_numpy(mesh=...)``) and its
rows of the batch, held to the reference's jitted one-device
``train_step`` on that state (AXQ on its Pallas route in interpret mode):
the reference has no mesh-specific function for these families (GSPMD
partitions their one-device function), so at every mesh shape the port is
held to it.

Here: the 1x2, 2x1 and 2x2 meshes (1x4 in ``test_torch_mesh_recurrent_1x4.py``).

The shared setup and helpers are in ``_torch_mesh_recurrent.py``."""

from _torch_mesh_recurrent import *  # noqa: F401,F403


def test_reference_trees_are_tp_invariant():
    """mamba2-370m-smoke's tp-padded state is the same tree at tp 1, 2 and
    4 (``_ref_tp``'s reason)."""
    cfg = dataclasses.replace(jget_config(ARCHS[0]), dtype="float32")
    jm = jbuild_model(cfg)
    trees = [jstep.init_state(jm, jax.random.PRNGKey(0), tp=t) for t in (1, 2, 4)]
    for t in trees[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(trees[0]), jax.tree_util.tree_leaves(t)):
            assert np.array_equal(a, b)


def test_split_collectives_backward():
    """sum_over_model and sum_grad_columns on two ranks with rank-local
    consumers: each rank's gradient equals the one-process autograd
    gradient of the sum of the ranks' losses (columns 2-3 of the weight
    shared by both ranks, the rest each rank's own)."""
    world = 2
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(world)]
    ws = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(world)]
    w0 = rng.standard_normal((4, 4)).astype(np.float32)
    ranks = meshctx.spawn_ranks(H.split_collectives_rank, world, timeout_s=H.TIMEOUT_S,
                                args=(xs, ws, w0))
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    y = sum(torch.square(x).sum(-1, keepdim=True) for x in tx)
    loss = sum((torch.rsqrt(y + 1.0) * x * torch.from_numpy(w)).sum() for x, w in zip(tx, ws))
    grads = torch.autograd.grad(loss, tx)
    for r in range(world):
        np.testing.assert_allclose(ranks[r]["sum"], grads[r].numpy(), rtol=1e-6)
    own = [torch.autograd.grad((torch.tanh(torch.from_numpy(x) @ (w := torch.from_numpy(
        w0).requires_grad_())) * torch.from_numpy(v)).sum(), w)[0] for x, v in zip(xs, ws)]
    for r in range(world):
        want = own[r].clone()
        want[:, 2:4] = sum(o[:, 2:4] for o in own)
        np.testing.assert_allclose(ranks[r]["columns"], want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_compressed_grads_match_reference(arch):
    """--compress-grads at 1x2 under EXACT: the global gradient quantized
    against each whole leaf's amax, as the reference's compressed step.
    chip_smoke.py 5i's rule: a gradient summed in another order can round
    to the next int8 code, so mu within one quantum (1/127) of each leaf's
    largest entry and nu within two (it is g^2), each plus 1e-5; the
    parameters within Adam's step bound (2 lr); loss and grad norm rtol
    1e-5."""
    per, ref = _mesh_run((1, 2))[(arch, "compress")]
    _, ref_state, ref_met = ref
    met, g = per[0]["metrics"][0], per[0]["global"]
    np.testing.assert_allclose(met["loss"], ref_met["loss"], rtol=TT.RTOL)
    np.testing.assert_allclose(met["grad_norm"], ref_met["grad_norm"], rtol=TT.RTOL)
    for a, b in zip(tree_leaves(g.params), jax.tree_util.tree_leaves(ref_state.params)):
        assert np.abs(a - b).max() <= 2 * 3e-4
    for field, quanta in (("mu", 1), ("nu", 2)):
        for a, b in zip(tree_leaves(getattr(g.opt, field)),
                        jax.tree_util.tree_leaves(getattr(ref_state.opt, field))):
            assert TT.rel_to_max(a, b) <= quanta / 127 + TT.RTOL, field


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_ring_lever_converges_and_stays_near_exact(arch):
    """REPRO_RING_TP under EXACT at 2x2 (global batch 4 x 32, labels =
    tokens, 25 steps): the loss falls by more than 0.5 on every rank
    alike; at 1x2 the ring's gradients (out_proj's / wo's and down's
    partials through the int8 ring forward, the column projections' dx
    through it backward where the reference sends it) within RING_REL
    (Frobenius, each leaf) of the exact mesh step's, moving fewer bytes."""
    per, _ = _mesh_run((2, 2))[(arch, "ring_train")]
    losses = [m["loss"] for m in per[0]["metrics"]]
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert all([m["loss"] for m in r["metrics"]] == losses for r in per)
    run = _mesh_run((1, 2))
    exact, ring = run[(arch, "exact")][0][0], run[(arch, "ring_grads")][0][0]
    for a, b in zip(tree_leaves(ring["grads"]), tree_leaves(exact["grads"])):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < RING_REL[arch], rel
    assert any(not np.array_equal(a, b) for a, b in
               zip(tree_leaves(ring["grads"]), tree_leaves(exact["grads"])))
    assert ring["grad_bytes"]["bytes"]["collective-permute"] > 0
    assert ring["grad_bytes"]["total"] < exact["grad_bytes"]["total"]


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
def test_checkpoint_restores_at_1x1_and_2x1(arch):
    """A 1x2 trainer's checkpoint (the gathered state, written by rank 0)
    restored by the port's 1x1 trainer and by a 2x1 trainer, each bit for
    bit the 1x2 ranks' gathered state."""
    one_two = _mesh_run((1, 2))["extra"]
    saved = one_two[0][IDS[arch]]
    assert all(r[IDS[arch]]["saved"] == [TRAIN_STEPS] for r in one_two)
    gathered = tree_leaves(saved["global"])
    t = Trainer(H.model_for("exact", arch), tstep.StepConfig(remat="none"),
                TrainerConfig(total_steps=TRAIN_STEPS, ckpt_dir=_ckpt_dir(arch)), pipeline=None)
    state, start = t.init_or_restore()
    assert start == TRAIN_STEPS
    for a, b in zip(tree_leaves(state), gathered):
        np.testing.assert_array_equal(a.numpy(), b)
    two_one = _mesh_run((2, 1))["extra"]
    restored = two_one[0][IDS[arch]]
    assert restored["final_step"] == TRAIN_STEPS and restored["losses"] == []
    for a, b in zip(tree_leaves(restored["global"]), gathered):
        np.testing.assert_array_equal(a, b)
    assert two_one[0][IDS[arch]]["digest"] == two_one[1][IDS[arch]]["digest"]


def test_launch_train_mesh_recurrent_cpu(tmp_path, capfd):
    """``launch.train --mesh 1x2 --arch mamba2-370m-smoke --device cpu``:
    two spawned gloo ranks train to the end, the all-reduces of a step
    counted, and checkpoint."""
    from repro_torch.launch import train as tlaunch

    out = tlaunch.main(["--arch", "mamba2-370m-smoke", "--steps", "2", "--seq", "16",
                        "--batch", "2", "--mesh", "1x2", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "ck")])
    assert out["final_step"] == 2 and not out["preempted"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["collective_bytes_per_step"]["all-reduce"] > 0
    assert (tmp_path / "ck" / "step_0000000002" / "manifest.json").exists()
    assert "mesh 1x2 (gloo)" in capfd.readouterr().out


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
@pytest.mark.parametrize("shape", MESHES[:3], ids=[f"{d}x{m}" for d, m in MESHES[:3]])
def test_mesh_step_matches_reference(shape, arch):
    """:func:`mesh_step_matches_reference` at 1x2, 2x1 and 2x2 (1x4 in
    ``test_torch_mesh_recurrent_1x4.py``)."""
    mesh_step_matches_reference(shape, arch)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
@pytest.mark.parametrize("shape", [(1, 2)], ids=["1x2"])
def test_every_gradient_leaf(shape, arch):
    """:func:`every_gradient_leaf` at 1x2 (1x4 in
    ``test_torch_mesh_recurrent_1x4.py``)."""
    every_gradient_leaf(shape, arch)
