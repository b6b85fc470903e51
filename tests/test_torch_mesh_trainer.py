"""The fault-tolerant trainer on a mesh on the CPU: tinyllama-1.1b-smoke in
f32 on two spawned gloo ranks (``tests/_torch_mesh.py``), global batch 4 x
16 of the synthetic pipeline, each rank its data coordinate's rows.

Held to: a checkpoint written at 1x2 (gathered, rank 0 writes) restores at
1x1 through the port's trainer and through the reference's
``Checkpointer``, bit for bit equal to the ranks' gathered state; a SIGTERM
to rank 1 alone checkpoints every rank at one step and stops them; the
run resumed from that checkpoint gives the uninterrupted run's losses
exactly (the same state and data, the same order of sums); a QoS ladder
moves at the same steps on every rank (the loss it reads is the global
one); the 2x1 trainer's ranks end bit-identical."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_mesh as H
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.train import step as jstep
from repro_torch.dist import meshctx
from repro_torch.tree import tree_leaves
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

TOTAL = 6


def _spawn(shape, **opts):
    return meshctx.spawn_ranks(H.trainer_rank, shape[0] * shape[1], timeout_s=H.TIMEOUT_S,
                               args=(shape, opts))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted 1x2 run, the run with rank 1 preempted at step 2,
    its resumption, a QoS run and a 2x1 run."""
    base = tmp_path_factory.mktemp("mesh_trainer")
    out = {"dir": base}
    out["full"] = _spawn((1, 2), total=TOTAL, ckpt_dir=str(base / "full"))
    out["cut"] = _spawn((1, 2), total=TOTAL, ckpt_dir=str(base / "cut"), sigterm_rank=1,
                        sigterm_at=2)
    out["resumed"] = _spawn((1, 2), total=TOTAL, ckpt_dir=str(base / "cut"))
    out["qos"] = _spawn((1, 2), total=TOTAL, ckpt_dir=str(base / "qos"), policy="axq8/32",
                        qos=True)
    out["data"] = _spawn((2, 1), total=3, ckpt_dir=str(base / "data"))
    return out


def test_checkpoint_restores_at_1x1_and_in_the_reference(runs):
    """The 1x2 run's last checkpoint (step 6): the port's 1x1 trainer
    restores it, and so does the reference's checkpointer, both bit for bit
    equal to the ranks' gathered state."""
    full = runs["full"]
    assert all(r["saved"] == [TOTAL] for r in full)
    gathered = tree_leaves(full[0]["global"])
    model = H.model_for("exact")
    t = Trainer(model, tstep.StepConfig(remat="none"),
                TrainerConfig(total_steps=TOTAL, ckpt_dir=str(runs["dir"] / "full")),
                pipeline=None)
    state, start = t.init_or_restore()
    assert start == TOTAL
    mine = [x.numpy() for x in tree_leaves(state)]
    assert len(mine) == len(gathered)
    for a, b in zip(mine, gathered):
        np.testing.assert_array_equal(a, b)
    cfg = dataclasses.replace(jget_config(H.ARCH), dtype="float32")
    js = jstep.init_state(jbuild_model(cfg), jax.random.PRNGKey(0), tp=2)
    step, tree, extra = JCheckpointer(runs["dir"] / "full").restore_latest(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js))
    assert step == TOTAL and extra["data_step"] == TOTAL
    for a, b in zip(jax.tree_util.tree_leaves(jstep.TrainState(*tree)), gathered):
        np.testing.assert_array_equal(a, b)


def test_sigterm_to_one_rank_checkpoints_every_rank_and_resumes(runs):
    """Rank 1 signals itself while step 2's batch is drawn: both ranks
    finish step 2, checkpoint at 3 and stop; the resumed ranks start at 3
    and their losses equal the uninterrupted run's bit for bit."""
    cut, resumed, full = runs["cut"], runs["resumed"], runs["full"]
    assert all(r["preempted"] and r["final_step"] == 3 for r in cut)
    assert all(r["saved"] == [3] for r in cut)
    assert all(r["steps"] == [3, 4, 5] and not r["preempted"] for r in resumed)
    for r in resumed:
        assert cut[0]["losses"] + r["losses"] == full[0]["losses"]
    assert resumed[0]["digest"] == full[0]["digest"]


def test_qos_moves_alike_on_every_rank(runs):
    """A ladder 8 -> 7 -> 6 checked every 2 steps under axq8: every rank
    moves the degree at the same steps, on the same (global) losses."""
    q = runs["qos"]
    assert q[0]["degrees"] == q[1]["degrees"] and q[0]["losses"] == q[1]["losses"]
    assert len(set(q[0]["degrees"])) > 1, q[0]["degrees"]
    assert all(np.isfinite(q[0]["losses"]))


def test_data_parallel_trainer_ranks_stay_identical(runs):
    """2x1: each rank trains on its half of every batch; the states stay
    bit-identical and the losses are the global ones on both."""
    d = runs["data"]
    assert d[0]["digest"] == d[1]["digest"] and d[0]["losses"] == d[1]["losses"]
    assert d[0]["final_step"] == 3
