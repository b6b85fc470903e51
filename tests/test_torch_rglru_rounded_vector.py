"""The RG-LRU hybrid's op-by-op activations hold bf16 parity at the
per-site degree vector (8, 6, 7, 5, 6) (recurrentgemma-2b-smoke, against
the JAX reference evaluated op by op); degree 6's case is in
``test_torch_rglru_rounded.py``.

The shared setup and the test's body are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


@pytest.mark.parametrize("degree", [(8, 6, 7, 5, 6)], ids=["degree1"])
def test_rounded_activations_hold_bf16_parity(degree, monkeypatch):
    """``_torch_rglru.rounded_activations_hold_bf16_parity``: with
    ``layers.act_rounded`` the port sits within the bf16 bounds of the
    op-by-op reference; the fused ``ACTS`` forms put the logits past them."""
    rounded_activations_hold_bf16_parity(degree, monkeypatch)
