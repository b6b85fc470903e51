"""The RG-LRU hybrid's op-by-op activations hold bf16 parity at degree 6
(recurrentgemma-2b-smoke, against the JAX reference evaluated op by op);
the per-site vector's case is in ``test_torch_rglru_rounded_vector.py``.

The shared setup and the test's body are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


@pytest.mark.parametrize("degree", [6])
def test_rounded_activations_hold_bf16_parity(degree, monkeypatch):
    """``_torch_rglru.rounded_activations_hold_bf16_parity``: with
    ``layers.act_rounded`` the port sits within the bf16 bounds of the
    op-by-op reference; the fused ``ACTS`` forms put the logits past them."""
    rounded_activations_hold_bf16_parity(degree, monkeypatch)
