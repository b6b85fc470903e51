"""Shared setup and helpers of the ``test_torch_conv_tail*.py`` files (moved out
of ``tests/test_torch_conv_tail.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

An f32 model on a bf16 state cache, the port's engines against the
reference's greedy streams (mamba2-370m-smoke, recurrentgemma-2b-smoke cut
to 4 layers).  The reference's prefill writes each conv tail into its
bf16 field (rounded), and its decode returns the tail in the compute
dtype, so its functional cache turns f32 at the first decode step and later
prefills write unrounded.  The port keeps the conv-tail field in the
compute dtype at one address (a captured step binds it) and rounds a
prefill's tails through the cache dtype until the cache's first decode
step (``ssm.init_conv_tail``), so the caches hold the same values and the
streams are equal (a token where the port's top-2 margin is under 1e-2 is
a near-tie, as in tests/test_torch_serve.py).  Five requests on two slots:
admissions before and after the first decode step.
"""
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core.dynamic import QoSController as JQoS
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.models import ssm as tssm
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

LOGIT_TOL = 1e-2
CASES = [("mamba2-370m-smoke", {}), ("recurrentgemma-2b-smoke", {"n_layers": 4})]


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


def f32_engine_on_bf16_state_cache_matches_reference(arch, over, admission):
    jm, jp, tm, tp = P.models("float32", "axq8", arch=arch, **over)
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 40, 14, 3, 11)]
    jadm = JAdmissionConfig(buckets=(8, 16), pack=2) if admission else None
    tadm = AdmissionConfig(buckets=(8, 16), pack=2) if admission else None
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=jadm, emitter=False)
        assert jeng.cache.conv.dtype.name == "bfloat16"
        jreqs = [jeng.submit(p, 5) for p in prompts]
        jeng.run_until_drained()
    assert jeng.cache.conv.dtype.name == "float32"
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()), admission=tadm,
                       emitter=False)
    conv = teng.cache.conv
    assert conv.dtype == torch.float32 and conv.tail_round == torch.bfloat16
    assert (teng.cache.k.dtype if hasattr(teng.cache, "k") else torch.bfloat16) == \
        torch.bfloat16
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 5) for p in prompts]
    teng.run_until_drained()
    assert teng.cache.conv is conv and conv.tail_round is None
    near_ties = P.compare_streams(jreqs, treqs, margins, 5, LOGIT_TOL)
    np.testing.assert_allclose(teng.cache.conv.numpy(), np.asarray(jeng.cache.conv),
                               rtol=1e-4, atol=1e-4)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


__all__ = [
    'np',
    'pytest',
    'torch',
    'P',
    'JQoS',
    'JAdmissionConfig',
    'JServeEngine',
    'TQoS',
    'tssm',
    'AdmissionConfig',
    'ServeEngine',
    'LOGIT_TOL',
    'CASES',
    '_ladder',
    'f32_engine_on_bf16_state_cache_matches_reference',
]
