"""Port parity for the streaming DSP workload: ``repro_torch.serve.stream``
against ``repro.serve.stream`` on the same clips (``make_clip`` from
seeds) and the same deterministic weights, through the plain route on the
CPU (the JAX side on its ``xla`` route, bit-identical to its Pallas route
by the reference's own tests).  Every frame is held bit-identical
(integer pipeline, no tolerance), and the engines' degree histories equal.
Frame counts are small so the file runs in seconds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dynamic import QoSController as JQoS
from repro.kernels import dispatch as jdispatch
from repro.serve import stream as jstream
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models.cache_ops import cache_mask_update, cache_reset_slot
from repro_torch.serve import stream as tstream

torch.set_num_threads(2)

CFG = tstream.StreamConfig()


@pytest.fixture(autouse=True)
def _backends():
    prev = jdispatch._override
    jdispatch.set_backend("xla")
    yield
    jdispatch.set_backend(prev)
    tdispatch.set_backend(None)


def _adapters():
    return jstream.StreamAdapter(jstream.StreamConfig()), tstream.StreamAdapter(device="cpu")


def _clip(n, seed, kind="chirp"):
    return tstream.make_clip(n, CFG.frame, q=CFG.q, seed=seed, kind=kind)


def _ladder(cls):
    return cls(ladder=[{"degrees": [e] * 3} for e in (8, 7, 6, 5)],
               low_water=0.25, high_water=0.75, cooldown_steps=8)


def test_config_params_and_clips_equal_reference():
    ja, ta = _adapters()
    assert tstream.StreamConfig() == tstream.StreamConfig(**vars(jstream.StreamConfig()))
    assert CFG.site_names() == jstream.StreamConfig().site_names()
    jp, tp = ja.init_params(), ta.init_params()
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == torch.int32 and tp[k].device.type == "cpu"
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for kind in ("chirp", "noise"):
        np.testing.assert_array_equal(
            _clip(3, 4, kind), jstream.make_clip(3, CFG.frame, q=CFG.q, seed=4, kind=kind))
    assert tstream.PSNR_BUCKETS == jstream.PSNR_BUCKETS
    assert tstream.psnr_metric.metric_name == jstream.psnr_metric.metric_name
    ref, out = _clip(1, 1), _clip(1, 2)
    assert tstream.psnr_metric(ref, out) == jstream.psnr_metric(ref, out)
    assert ta.guard_limit == ja.guard_limit


@pytest.mark.parametrize("degree", [None, [8, 8, 8], [6, 6, 6], [8, 5, 7], [4, 6, 5]])
def test_step_over_frames_matches_reference(degree):
    """Three slots (one free), several frames: each step's frame and the
    carried state equal the reference's."""
    ja, ta = _adapters()
    jp, tp = ja.init_params(), ta.init_params()
    B = 3
    js, ts = ja.init_state(batch=B), ta.init_state(batch=B)
    active = np.array([True, False, True])
    jd = None if degree is None else jnp.asarray(degree, jnp.int32)
    td = None if degree is None else torch.tensor(degree, dtype=torch.int32)
    clips = [_clip(4, s) for s in range(B)]
    for f in range(4):
        feed = np.stack([c[f] for c in clips])
        jo, js = ja.step(jp, js, jnp.asarray(feed), jnp.asarray(active), None, jd)
        to, ts = ta.step(tp, ts, torch.from_numpy(feed), torch.from_numpy(active), None, td)
        assert to.dtype == torch.int32 and tuple(to.shape) == (B, CFG.frame)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))
        np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))
    assert tdispatch.last_route["fir"] == tdispatch.last_route["conv2d"] == "torch"


@pytest.mark.parametrize("degree", [None, [8, 8, 8], [5, 5, 5], [7, 4, 6]])
def test_forward_matches_reference(degree):
    ja, ta = _adapters()
    frames = np.stack([_clip(3, s) for s in (0, 1)])
    jd = None if degree is None else jnp.asarray(degree, jnp.int32)
    td = None if degree is None else torch.tensor(degree, dtype=torch.int32)
    jo, _ = ja.forward(ja.init_params(), {"frames": frames}, degree=jd)
    to, aux = ta.forward(ta.init_params(), {"frames": frames}, degree=td)
    assert aux == {} and to.dtype == torch.float32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("slots", [2, 4])
def test_engine_matches_reference_under_qos(slots):
    """The same clips (more than the slots, mixed lengths) through both
    engines with the QoS ladder [e] * 3, e = 8 -> 5: every clip's frames and
    the degree history are identical, and the degree moved."""
    ja, ta = _adapters()
    clips = [_clip(2 + (i % 3), seed=i) for i in range(3 * slots)]
    je = jstream.StreamServeEngine(ja, slots=slots, qos=_ladder(JQoS))
    te = tstream.StreamServeEngine(ta, slots=slots, qos=_ladder(TQoS))
    jr = [je.submit(c) for c in clips]
    tr = [te.submit(c) for c in clips]
    jdone, tdone = je.run_until_drained(), te.run_until_drained()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b, c in zip(tr, jr, clips):
        assert a.done and len(a.out) == len(b.out) == len(c)
        for x, y in zip(a.out, b.out):
            np.testing.assert_array_equal(x, np.asarray(y))
    th = [(t, tuple(d)) for t, d in te.stats.degree_history]
    jh = [(t, tuple(d)) for t, d in je.stats.degree_history]
    assert th == jh
    assert len({d for _, d in th}) > 1
    assert te.stats.decode_steps == je.stats.decode_steps


def test_validate_rejects_bad_payloads():
    _, ta = _adapters()
    with pytest.raises(ValueError):
        ta.validate(np.zeros((2, CFG.frame + 1), np.int32))
    with pytest.raises(ValueError):
        ta.validate(np.zeros((0, CFG.frame), np.int32))
    with pytest.raises(ValueError):
        ta.validate(np.full((1, CFG.frame), 2**15, np.int32))
    assert ta.validate(np.zeros(CFG.frame, np.int32)).shape == (1, CFG.frame)
    eng = tstream.StreamServeEngine(ta, slots=1)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((1, 7), np.int32))


def test_cache_ops_over_stream_state():
    st = tstream.StreamState(length=torch.arange(1, 4, dtype=torch.int32),
                             tail=torch.arange(21, dtype=torch.int32).reshape(1, 3, 7))
    before = tstream.StreamState(st.length.clone(), st.tail.clone())
    cache_reset_slot(st, 1)
    assert int(st.length[1]) == 0 and not st.tail[0, 1].any()
    for s in (0, 2):
        assert int(st.length[s]) == int(before.length[s])
        assert torch.equal(st.tail[0, s], before.tail[0, s])
    new = tstream.StreamState(st.length + 5, st.tail + 100)
    out = cache_mask_update(st, new, torch.tensor([True, False, True]))
    assert out.length.tolist() == [int(st.length[0]) + 5, 0, int(st.length[2]) + 5]


def test_reuse_after_free_bit_identity():
    """A slot that served an earlier clip produces bit-identical frames for
    a new clip vs a fresh engine (the admission reset leaves no residue)."""
    _, ta = _adapters()
    clip = _clip(3, 11)
    fresh = tstream.StreamServeEngine(ta, slots=1)
    r0 = fresh.submit(clip)
    fresh.run_until_drained()
    used = tstream.StreamServeEngine(ta, slots=1)
    used.submit(_clip(2, 12, kind="noise"))
    used.run_until_drained()
    r1 = used.submit(clip)
    used.run_until_drained()
    assert len(r0.out) == len(r1.out) == 3
    for a, b in zip(r0.out, r1.out):
        np.testing.assert_array_equal(a, b)


def test_more_clips_than_slots_equal_solo_runs():
    _, ta = _adapters()
    eng = tstream.StreamServeEngine(ta, slots=2)
    clips = [_clip(3, i) for i in range(5)]
    reqs = [eng.submit(c) for c in clips]
    assert len(eng.run_until_drained()) == 5
    solo = tstream.StreamServeEngine(ta, slots=1)
    for r, c in zip(reqs, clips):
        s = solo.submit(c)
        solo.run_until_drained()
        assert len(r.out) == len(s.out) == 3
        for a, b in zip(r.out, s.out):        # batching never changes the bits
            np.testing.assert_array_equal(a, b)


def test_engine_matches_manual_steps():
    _, ta = _adapters()
    params = ta.init_params()
    eng = tstream.StreamServeEngine(ta, params, slots=2)
    clip = _clip(4, 7)
    req = eng.submit(clip)
    assert [r.rid for r in eng.run_until_drained()] == [req.rid]
    state = ta.init_state(batch=1)
    for frame, got in zip(clip, req.out):
        out, state = ta.step(params, state, torch.from_numpy(frame[None]),
                             torch.tensor([True]), None, None)
        np.testing.assert_array_equal(out[0].numpy(), got)


def test_stream_engine_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamAdapter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamServeEngine()
    assert tstream.StreamServeEngine(device="cpu").device.type == "cpu"


def test_launch_serve_stream_finishes_every_clip(capsys):
    from repro_torch.launch import serve as launch_serve

    s = launch_serve.main(["--workload", "stream", "--device", "cpu", "--qos",
                           "--metrics", "--requests", "6", "--frames", "3",
                           "--slots", "2"])
    out = capsys.readouterr().out
    assert "stream: 6 clips, 18 frames" in out and "kernels=torch" in out
    assert "degree ladder visits" in out
    assert s["requests"] == 6 and s["generated_tokens"] == 18
