"""``launch.serve --tp`` on the CPU (2 spawned gloo ranks of the smoke
arch), and the refusals of tensor-parallel serving: a mesh data axis above
1, the audio encoder (no decode step), ranks that share a card without
gloo asked for, ``capture=True`` under gloo, tensor-parallel fleet
replicas.  Nothing runs silently on one device or falls back.  The
recurrent families serve at tp (tests/test_torch_tp_recurrent.py)."""
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
    with pytest.raises(SystemExit, match="data axis above 1"):
        launch_serve.run(ARGV + ["--mesh", "2x2"])
    with pytest.raises(SystemExit, match="fleet replicas"):
        launch_serve.run(ARGV + ["--replicas", "3"])
    with pytest.raises(SystemExit, match="lm workload"):
        launch_serve.run(ARGV + ["--workload", "stream"])
    if torch.cuda.device_count() < 2:
        # ranks that would share a card: gloo must be asked for by name
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            launch_serve.run(["--tp", "2"])


def _mesh(shape, backend="gloo"):
    return meshctx.Mesh(shape, ("data", "model"), rank=0, backend=backend)


def test_engine_refusals():
    """capture=True under gloo; a data axis above 1; the audio encoder."""
    model = build_model(get_config("tinyllama-1.1b-smoke"), device="cpu")
    with pytest.raises(ValueError, match="gloo collective cannot be captured"):
        ShardedServeEngine(model, {}, mesh=_mesh((1, 2)), capture=True)
    with pytest.raises(NotImplementedError, match="capture of the sharded step under NCCL"):
        ShardedServeEngine(model, {}, mesh=_mesh((1, 2), "nccl"), capture=True)
    with pytest.raises(NotImplementedError, match="serving data axis above 1"):
        ShardedServeEngine(model, {}, mesh=_mesh((2, 1)))
    from repro_torch.models.transformer import check_tp_supported

    with pytest.raises(NotImplementedError, match="audio encoder.*ROADMAP §A"):
        check_tp_supported(get_config("hubert-xlarge"), 2)
    with pytest.raises(NotImplementedError, match="tensor parallelism inside a fleet replica"):
        tfleet.fleet_devices(2, tp=2, device="cpu")
