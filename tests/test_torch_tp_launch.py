"""``launch.serve --tp`` on the CPU (2 spawned gloo ranks of the smoke
arch), and the refusals of sharded serving: the audio encoder (no decode
step), ranks that share a card without gloo asked for, ``capture=True``
under gloo, a data axis that does not divide the slots, a data axis with
``--replicas``, the MoE family on a data axis, a fleet replica wider than
the world.  Nothing runs silently on one device or falls back.  The data
axis (``--mesh 2x1``) serves; the recurrent families serve at tp
(tests/test_torch_tp_recurrent.py), the data axis and sharded fleets in
tests/test_torch_dp_serve.py and tests/test_torch_fleet_mesh.py."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import fleet as tfleet
from repro_torch.dist import meshctx
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve.sharded import ShardedServeEngine

torch.set_num_threads(2)

ARGV = ["--tp", "2", "--dist-backend", "gloo", "--device", "cpu", "--requests", "5",
        "--new-tokens", "6", "--slots", "2"]


@pytest.mark.parametrize("ring", [False, True], ids=["exact", "ring"])
def test_launch_serve_tp2_on_gloo(ring, capfd):
    """Every request ok, the ranks' streams equal (the engine compares them
    at drain), rank 0 prints the report; the ring moves ring hops and no
    row-parallel all-reduce beyond the embedding's."""
    s, eng = launch_serve.run(ARGV + (["--ring"] if ring else []) + ["--metrics"])
    assert eng is None
    assert s["requests"] == 5 and s["statuses"] == {"ok": 5} and s["streams_equal"]
    assert s["tp"] == 2 and s["transport"] == "gloo"
    calls = s["collective_calls_per_tick"]
    assert calls["all-gather"] == 1.0
    if ring:
        assert calls["collective-permute"] > 0
    else:
        assert "collective-permute" not in calls
    out = capfd.readouterr().out
    assert out.count("[launch.serve] tp=2 (gloo") == 1
    assert ", ring)" in out if ring else ", ring)" not in out


def test_launch_serve_tp_refusals():
    """The paths this slice opened run (``--mesh 2x1``: one engine's slots
    over two data ranks); the refusals that stay true raise."""
    s, eng = launch_serve.run(ARGV[2:] + ["--mesh", "2x1"])
    assert eng is None and s["data"] == 2 and s["tp"] == 1 and s["statuses"] == {"ok": 5}
    with pytest.raises(SystemExit, match="does not divide"):
        launch_serve.run(ARGV[2:] + ["--mesh", "2x1", "--slots", "3"])
    with pytest.raises(SystemExit, match=r"a fleet replica is a \(1, M\) mesh"):
        launch_serve.run(ARGV + ["--replicas", "3", "--mesh", "2x2"])
    with pytest.raises(SystemExit, match="lm workload"):
        launch_serve.run(ARGV + ["--workload", "stream"])
    if torch.cuda.device_count() < 2:
        # ranks that would share a card: gloo must be asked for by name
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            launch_serve.run(["--tp", "2"])


def _mesh(shape, backend="gloo"):
    return meshctx.Mesh(shape, ("data", "model"), rank=0, backend=backend)


def test_engine_refusals():
    """capture=True under gloo; a (2, 1) mesh's data axis that does not
    divide the slots, and the MoE family on it; the audio encoder; a fleet
    replica wider than the world.  (A (2, 1) mesh serves: the data-axis
    tests.)"""
    model = build_model(get_config("tinyllama-1.1b-smoke"), device="cpu")
    with pytest.raises(ValueError, match="gloo collective cannot be captured"):
        ShardedServeEngine(model, {}, mesh=_mesh((1, 2)), capture=True)
    with pytest.raises(NotImplementedError, match="capture of the sharded step under NCCL"):
        ShardedServeEngine(model, {}, mesh=_mesh((1, 2), "nccl"), capture=True)
    with pytest.raises(ValueError, match="slots=3 do not divide over the data axis"):
        ShardedServeEngine(model, {}, mesh=_mesh((2, 1)), slots=3)
    moe = build_model(get_config("granite-moe-3b-a800m-smoke"), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE family on a serving data axis"):
        ShardedServeEngine(moe, {}, mesh=_mesh((2, 1)))
    from repro_torch.models.transformer import check_tp_supported

    with pytest.raises(NotImplementedError, match="audio encoder.*ROADMAP §A"):
        check_tp_supported(get_config("hubert-xlarge"), 2)
    with pytest.raises(ValueError, match="tp=2 ranks does not fit a world of 1"):
        tfleet.fleet_meshes(2, tp=2, device="cpu")
