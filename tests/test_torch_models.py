"""Port parity of the dense LM in f32: ``lm_prefill`` then
``lm_decode_step`` logits and cache contents against the JAX reference, for
the smoke config under EXACT and axq8 at a scalar degree of 8 and 6 and at
a per-site degree vector (the bf16 runs are in test_torch_models_bf16.py).

Reference: the JAX Pallas route in interpret mode, whose kernels the port's
plain versions mirror (same quantized-GEMM arithmetic, same online softmax,
free slots zeroed).  Tolerance: atol 1e-4 on logits and on the caches'
live rows.  Only f32 rounding separates the two packages here — XLA's and
torch's exp/sin/rsqrt and sum orders differ in the last ulp (observed
differences ~2e-6) — and at this short prompt no int8 activation code sits
close enough to a rounding boundary to move.  (At long prompts one does,
and AXQ's cascade then moves logits by the model's noise floor:
chip_smoke.py phase 4.)  A second test ties the port to the reference's
jnp (XLA) route.  The KV cache is bf16, as in serving."""
import jax  # noqa: F401  (the JAX reference runs in this process)
import numpy as np
import pytest
import torch

import _torch_parity as P

torch.set_num_threads(2)

ATOL = 1e-4


def _check(prefill, decode):
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8),
                                           ("axq8", 6), ("axq8", "vector")])
def test_prefill_decode_match_reference(approx, degree):
    _check(*P.run_prefill_decode("float32", approx, degree, "pallas"))


def test_matches_reference_jnp_route():
    """The reference's jnp route does not zero free slots; only live slots
    are compared (free slots are reset on admission and never read)."""
    _check(*P.run_prefill_decode("float32", "axq8", 6, "xla"))
