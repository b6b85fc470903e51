"""Port parity of the dense LM in bf16 (the serving dtype): ``lm_prefill``
then ``lm_decode_step`` against the JAX reference's Pallas route (interpret
mode), for EXACT and axq8 at a scalar degree of 8 and 6 and a per-site
degree vector.

Tolerance, and why it is looser than f32's (test_torch_models.py): the two
frameworks' rsqrt, mean and sin/cos differ in the last f32 ulp, and where an
f32 value lies next to a bf16 rounding boundary that ulp flips the bf16
activation by one bf16 ulp (2**-8 relative).  Under AXQ a flipped input can
move an int8 activation code, and at 5-6 effective bits a code step is 4-8
int8 steps, so the flips cascade through the layers.  Observed over 24 runs
(seeds x prompt lengths x degrees): max |d logit| 0.20 (|logits| <= 3.6)
and a relative Frobenius error of the cache of 2.0e-2.  Held to: |d logit|
<= 0.25, cache relative error <= 3e-2.  A wrong kernel moves logits by O(1)
and the cache by O(1) relative."""
import jax  # noqa: F401  (the JAX reference runs in this process)
import numpy as np
import pytest
import torch

import _torch_parity as P

torch.set_num_threads(2)

LOGIT_ATOL = 0.25
CACHE_REL = 3e-2


def _check(prefill, decode):
    for stage in (prefill, decode):
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL)
        for name in ("k", "v"):
            ref, port = stage[name]
            rel = np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= CACHE_REL, (name, rel)


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8),
                                           ("axq8", 6), ("axq8", "vector")])
def test_prefill_decode_match_reference(approx, degree):
    _check(*P.run_prefill_decode("bfloat16", approx, degree, "pallas"))
