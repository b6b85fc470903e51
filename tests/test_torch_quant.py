"""Port parity: block quantization, degrade, the packed GEMM oracle and the
prepack pass are bit-identical to the JAX reference on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import quantization as JQ
from repro.core.approx import policy_from_flag as jpolicy
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as TQ
from repro_torch.core.approx import policy_from_flag as tpolicy
from repro_torch.kernels import qstore as tqstore

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("ebits", [8, 6, 4])
def test_quantize_degrade_qmm_bit_identical(block, ebits):
    rng = np.random.default_rng(block * 10 + ebits)
    for M, K, N in [(5, 512, 48)]:
        x = (rng.standard_normal((M, K)) * rng.uniform(0.1, 10)).astype(np.float32)
        w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
        jq = JQ.quantize_block(jnp.asarray(x), block)
        tq = TQ.quantize_block(torch.from_numpy(x), block)
        np.testing.assert_array_equal(np.asarray(jq.values), tq.values.numpy())
        np.testing.assert_array_equal(_bits(jq.scales), _bits(tq.scales.numpy()))
        np.testing.assert_array_equal(np.asarray(JQ.degrade(jq.values, ebits)),
                                      TQ.degrade(tq.values, ebits).numpy())
        np.testing.assert_array_equal(_bits(JQ.dequantize(jq)),
                                      _bits(TQ.dequantize(tq).numpy()))
        jw = JQ.quantize_block(jnp.asarray(w.T), block)
        yj = JQ.qmm_packed_ref(jnp.asarray(x), jw.values, jw.scales, ebits)
        yt = TQ.qmm_packed_ref(torch.from_numpy(x),
                               torch.from_numpy(np.array(jw.values)),
                               torch.from_numpy(np.array(jw.scales)), ebits)
        np.testing.assert_array_equal(_bits(yj), _bits(yt.numpy()))


def test_degree_from_device_tensor_matches_int():
    """A 0-d int32 degree (the serving operand) degrades like the int."""
    q = torch.arange(-127, 128, dtype=torch.int8)
    for e in (8, 7, 5, 3):
        assert torch.equal(TQ.degrade(q, torch.tensor(e, dtype=torch.int32)),
                           TQ.degrade(q, e))
    # a per-site vector is sliced by view: each site's kernels read its
    # element in place (no copy, no host read)
    from repro_torch.kernels.dispatch import site_degree
    vec = torch.tensor([8, 6, 5], dtype=torch.int32)
    d = site_degree(vec, 1)
    assert d.data_ptr() == vec.data_ptr() + 4 and int(d) == 6
    assert site_degree(None, 1) is None and site_degree(7, 1) == 7


@pytest.mark.parametrize("tied", [False, True])
def test_prepack_params_matches_reference(tied):
    """The port's prepack of converted float params gives the same int8
    values and scales as the reference's, unembedding included."""
    jcfg = jget_config("tinyllama-1.1b-smoke")
    tcfg = tget_config("tinyllama-1.1b-smoke")
    if tied:
        jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
        tcfg = dataclasses.replace(tcfg, tie_embeddings=True)
    jm = jbuild_model(jcfg, jpolicy("axq8"))
    params = jm.init(jax.random.PRNGKey(3), tp=1)
    jpacked = params_from_numpy(jax.tree.map(np.asarray, jm.prepack(params)))
    tpacked = tqstore.prepack_params(
        params_from_numpy(jax.tree.map(np.asarray, params)), tcfg, tpolicy("axq8"))

    leaves = []

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, tqstore.PackedQWeight):
            leaves.append(path)
            assert torch.equal(a.qw, b.qw), path
            np.testing.assert_array_equal(_bits(a.scales.numpy()),
                                          _bits(b.scales.numpy()), err_msg=path)
        else:
            assert torch.equal(a, b), path

    walk(jpacked, tpacked, "")
    head = "/embed/unembed_q" if tied else "/unembed/w"
    assert head in leaves, leaves
    assert {"/layers/wq/w", "/layers/mlp/gate/w", "/layers/mlp/down/w"} <= set(leaves)
