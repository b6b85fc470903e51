"""The RG-LRU hybrid's engine streams against the JAX engine
(recurrentgemma-2b-smoke, f32, axq8 with the QoS ladder), bucketed packed
admission; exact-length admission is in ``test_torch_rglru_engine.py``.

The shared setup and the test's body are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


@pytest.mark.parametrize("admission", [True], ids=["buckets-pack2"])
def test_engine_streams_match_reference(admission, monkeypatch):
    """``_torch_rglru.engine_streams_match_reference``: the port's greedy
    streams equal the JAX engine's, the degree walks the same rungs."""
    engine_streams_match_reference(admission, monkeypatch)
