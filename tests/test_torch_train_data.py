"""The training inputs and checkpoints of the port against the reference:
the synthetic pipeline's batches bit-identical at every step (markov,
uniform, file-backed and the frontends' fields), the byte tokenizer, the
checkpointer's cases of tests/test_checkpoint.py on the port's tensors,
and checkpoints crossing packages: one the JAX Trainer wrote restored into
the port's state and stepped once, equal to the reference's next step
(tests/_torch_train.py tolerances), and one the port wrote restored by
the reference's checkpointer bit for bit."""
import dataclasses
import json
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.data.pipeline import make_pipeline as jmake_pipeline
from repro.data.tokenizer import ByteTokenizer as JTok
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import train_state_to_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline, make_pipeline
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)


def _equal_batches(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hubert-xlarge-smoke", "internvl2-1b-smoke",
                                  "mamba2-370m-smoke"])
@pytest.mark.parametrize("kind", ["markov", "uniform"])
def test_pipeline_batches_bit_identical(arch, kind):
    """Every field (tokens, labels, frame_feats, patch_embeds) at steps 0,
    1, 7 and 1000, and a host slice, equal to the reference's."""
    seq = 96 if arch == "tinyllama-1.1b" else 24
    jp = jmake_pipeline(jget_config(arch), seq_len=seq, global_batch=3, seed=5, kind=kind)
    tp = make_pipeline(tget_config(arch), seq_len=seq, global_batch=3, seed=5, kind=kind)
    for step in (0, 1, 7, 1000):
        _equal_batches(tp.batch_at(step), jp.batch_at(step))
    _equal_batches(tp.batch_at(3, host_slice=slice(1, 3)), jp.batch_at(3, host_slice=slice(1, 3)))
    it_t, it_j = tp.iterate(4), jp.iterate(4)
    for _ in range(2):
        _equal_batches(next(it_t), next(it_j))


def test_file_pipeline_bit_identical(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(0).integers(0, 500, 4000).astype(np.int32))
    jp = JPipeline(JDataConfig(vocab=512, seq_len=32, global_batch=4, kind="file",
                               file_path=str(path)))
    tp = SyntheticPipeline(DataConfig(vocab=512, seq_len=32, global_batch=4, kind="file",
                                      file_path=str(path)))
    for step in (0, 9):
        _equal_batches(tp.batch_at(step), jp.batch_at(step))


def test_byte_tokenizer_matches_reference():
    t, j = ByteTokenizer(), JTok()
    for text, bos, eos in (("héllo, wörld", True, False), ("", False, True), ("abc", True, True)):
        ids = t.encode(text, bos=bos, eos=eos)
        np.testing.assert_array_equal(ids, j.encode(text, bos=bos, eos=eos))
        assert t.decode(ids) == j.decode(ids) == text
    assert (t.BOS, t.EOS, t.PAD, t.vocab_size) == (j.BOS, j.EOS, j.PAD, j.vocab_size)


# ---------------------------------------------------------------------------
# checkpointer (tests/test_checkpoint.py's cases on tensors)
# ---------------------------------------------------------------------------


def _tree(v):
    return {"a": torch.full((4, 4), float(v)),
            "b": {"c": torch.arange(8, dtype=torch.int32) + int(v)}}


def test_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (10, 20, 30):
        ck.save(s, _tree(s), extra={"data_step": s}, blocking=True)
    assert ck.all_steps() == [20, 30]
    step, tree, extra = ck.restore_latest(_tree(0))
    assert step == 30 and extra["data_step"] == 30
    assert float(tree["a"][0, 0]) == 30.0 and tree["b"]["c"].dtype == np.int32


def test_torn_write_detected(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(1, _tree(1), blocking=True)
    ck.save(2, _tree(2), blocking=True)
    newest = Path(tmp_path) / "step_0000000002"
    manifest = json.loads((newest / "manifest.json").read_text())
    (newest / next(iter(manifest["arrays"].values()))["file"]).unlink()
    assert ck.latest_valid_step() == 1


def test_async_save_and_error_surfaces(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _tree(5), blocking=False)
    ck.wait()
    assert ck.all_steps() == [5]
    # a failed background write is raised at the next wait
    ck._write = lambda *a: (_ for _ in ()).throw(OSError("disk full"))
    ck.save(6, _tree(6), blocking=False)
    with pytest.raises(OSError):
        ck.wait()


def test_same_size_bit_corruption_detected(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(1, _tree(1), blocking=True)
    ck.save(2, _tree(2), blocking=True)
    newest = Path(tmp_path) / "step_0000000002"
    manifest = json.loads((newest / "manifest.json").read_text())
    victim = newest / next(iter(manifest["arrays"].values()))["file"]
    blob = bytearray(victim.read_bytes())
    blob[-1] ^= 0x40
    victim.write_bytes(bytes(blob))
    assert ck.latest_valid_step() == 1
    with pytest.raises((ValueError, KeyError)):
        ck.restore(2, _tree(0))


def test_port_checkpoint_reads_back_in_the_reference(tmp_path):
    """The port's layout and manifest: the reference's checkpointer restores
    a port TrainState bit for bit into its own TrainState structure."""
    jm, tm = TT.models("tinyllama-1.1b-smoke", "exact")
    js, ts = TT.states(jm, seed=3)
    Checkpointer(tmp_path).save(4, ts, extra={"data_step": 4})
    step, tree, extra = JCheckpointer(tmp_path).restore_latest(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js))
    assert step == 4 and extra == {"data_step": 4}
    want = jax.tree_util.tree_leaves(train_state_to_numpy(ts))
    got = jax.tree_util.tree_leaves(jstep.TrainState(*tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_jax_trainer_checkpoint_restores_into_port_and_steps(tmp_path):
    """The reference's Trainer runs 3 steps and checkpoints; the port's
    Trainer restores that state (bit for bit) and takes step 3 on the same
    pipeline batch, equal to the reference trainer's step 3."""
    arch = "tinyllama-1.1b-smoke"
    jcfg = dataclasses.replace(jget_config(arch), dtype="float32")
    jm, tm = TT.models(arch, "exact")
    scj, sct = TT.step_cfgs(remat="none", total_steps=20, warmup=2)
    d1, d2 = tmp_path / "j", tmp_path / "j4"
    with TT.jax_backend("pallas"):
        JTrainer(jm, scj, JTrainerConfig(total_steps=3, ckpt_every=3, ckpt_dir=str(d1),
                                         log_every=100, async_ckpt=False),
                 jmake_pipeline(jcfg, seq_len=16, global_batch=2)).run()
        shutil.copytree(d1, d2)
        jout = JTrainer(jm, scj, JTrainerConfig(total_steps=4, ckpt_every=100,
                                                ckpt_dir=str(d2), log_every=100),
                        jmake_pipeline(jcfg, seq_len=16, global_batch=2)).run()
    tr = Trainer(tm, sct, TrainerConfig(total_steps=4, ckpt_every=100, ckpt_dir=str(d1),
                                        log_every=100),
                 make_pipeline(tm.cfg, seq_len=16, global_batch=2))
    state, start = tr.init_or_restore(seed=0)
    assert start == 3 and int(state.step) == 3
    _, jtree, _ = JCheckpointer(d1).restore_latest(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                     jstep.init_state(jm, jax.random.PRNGKey(0))))
    for a, b in zip(TT.leaves(state), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    tout = tr.run()
    assert [h["step"] for h in tout["history"]] == [3] == [h["step"] for h in jout["history"]]
    np.testing.assert_allclose(tout["history"][0]["loss"], jout["history"][0]["loss"],
                               rtol=TT.RTOL)
    np.testing.assert_allclose(tout["history"][0]["grad_norm"],
                               jout["history"][0]["grad_norm"], rtol=TT.RTOL)
    # the final checkpoints (step 4) of both trainers hold the same state
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstep.init_state(jm, jax.random.PRNGKey(0)))
    s_t, t4, _ = JCheckpointer(d1).restore_latest(like)
    s_j, j4, _ = JCheckpointer(d2).restore_latest(like)
    assert s_t == s_j == 4
    for a, b in zip(jax.tree_util.tree_leaves(t4), jax.tree_util.tree_leaves(j4)):
        np.testing.assert_allclose(a, b, rtol=TT.RTOL, atol=TT.RTOL)
