"""The RG-LRU hybrid in bf16 under AXQ down to degree 5 against the JAX
reference evaluated op by op (recurrentgemma-2b-smoke).

The shared setup and helpers are in ``_torch_rglru.py``."""

from _torch_rglru import *  # noqa: F401,F403


def test_prefill_decode_bf16_match_op_by_op_reference():
    """In bf16 under AXQ at degrees 8 to 5 (a per-site vector), against the
    reference evaluated op by op, at tests/test_torch_models_bf16.py's
    tolerances (the module docstring: at this degree and a 45-token prompt
    the compiled reference is 5.4e-2 away from its own op-by-op form)."""
    _check_bf16(run_prefill_decode("bfloat16", "axq8", (8, 6, 7, 5, 6), prompt_len=12,
                                   steps=2, compiled=False))
