"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper card (``gpu`` marker; they skip elsewhere).  This file imports no
JAX, so it runs where only the port's stack (PyTorch with CUDA) is
installed; the plain versions it compares against are held to the JAX
reference in tests/test_torch_kernels.py.

Tolerances: the GEMMs rtol 1e-5 / atol 1e-4 (the qmm oracle tolerance; the
kernels were observed bit-identical), the f32 attention kernels the same
on f32 inputs, the decode kernel 1e-4 on a bf16 cache (f32 sums in another
order), the int8-cache decode kernel 1e-5 abs (the reference's kernel-vs-
jnp tolerance)."""
import math

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels.qstore import prepack_weight as tprepack

RTOL, ATOL = 1e-5, 1e-4




@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 37])
def test_gpu_axqmm_kernels_match_plain(hopper, M):
    g = torch.Generator(device=hopper).manual_seed(M)
    K, N = 512, 200
    x = torch.randn(M, K, generator=g, device=hopper)
    pw = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 256)
    pg = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 256)
    b = torch.randn(N, generator=g, device=hopper)
    r = torch.randn(M, N, generator=g, device=hopper)
    e = torch.tensor([8, 5], dtype=torch.int32, device=hopper)[1]   # a vector element
    before = dict(_build.launches)
    y = taxq.axqmm_packed(x, pw, e, bias=b, residual=r)
    yg = taxq.axqmm_gated_packed(x, pw, pg, e)
    torch.cuda.synchronize()
    assert _build.launches["axqmm"] == before["axqmm"] + 1
    assert _build.launches["axqmm_gated"] == before["axqmm_gated"] + 1
    torch.testing.assert_close(y, taxq.axqmm_packed_plain(x, pw, e, bias=b, residual=r),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(yg, taxq.axqmm_gated_plain(x, pw, pg, e),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_gpu_flash_kernels_match_plain(hopper):
    g = torch.Generator(device=hopper).manual_seed(0)
    B, T, KVr, G, D = 4, 300, 4, 8, 64
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    k = torch.randn(B, T, KVr, D, generator=g, device=hopper).bfloat16()
    v = torch.randn(B, T, KVr, D, generator=g, device=hopper).bfloat16()
    nv = torch.tensor([1, 129, 300, 64], dtype=torch.int32, device=hopper)
    act = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=hopper)
    o = tfd.flash_decode(qg, k, v, nv, act)
    torch.testing.assert_close(o, tfd.flash_decode_plain(qg, k, v, nv, act),
                               rtol=1e-4, atol=1e-4)
    assert (o[1] == 0).all()
    q = torch.randn(16, 200, 64, generator=g, device=hopper)
    out, steps = tfa.flash_attention(q, q.flip(1), q.roll(3, 1), causal=True,
                                     return_steps=True)
    ref, ref_steps = tfa.flash_attention_plain(q, q.flip(1), q.roll(3, 1), causal=True)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    assert int(steps) == ref_steps == tfa.planned_grid_steps(16, 200)


@pytest.mark.gpu
@pytest.mark.parametrize("ebits,T", [(8, 300), (5, 300), (6, 135)])
def test_gpu_flash_decode_quant_matches_plain(hopper, ebits, T):
    g = torch.Generator(device=hopper).manual_seed(ebits * 1000 + T)
    B, KVr, G, D = 4, 4, 8, 64
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    k = torch.randint(-127, 128, (B, T, KVr, D), generator=g, device=hopper).to(torch.int8)
    v = torch.randint(-127, 128, (B, T, KVr, D), generator=g, device=hopper).to(torch.int8)
    ks = torch.rand(B, T, KVr, generator=g, device=hopper) * 0.02 + 1e-3
    vs = torch.rand(B, T, KVr, generator=g, device=hopper) * 0.02 + 1e-3
    nv = torch.tensor([1, T // 2 + 1, T, 33], dtype=torch.int32, device=hopper)
    act = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=hopper)
    e = torch.tensor([8, ebits], dtype=torch.int32, device=hopper)[1]   # a vector element
    before = _build.launches["flash_decode_quant"]
    o = tfd.flash_decode_quant(qg, k, ks, v, vs, nv, act, e)
    torch.cuda.synchronize()
    assert _build.launches["flash_decode_quant"] == before + 1
    torch.testing.assert_close(o, tfd.flash_decode_quant_plain(qg, k, ks, v, vs, nv, act, e),
                               rtol=0, atol=1e-5)
    assert (o[2] == 0).all()


@pytest.mark.gpu
def test_gpu_wrappers_refuse_bad_operands(hopper):
    x = torch.randn(4, 512, device=hopper)
    pw = tprepack(torch.randn(512, 64, device=hopper), 256)
    with pytest.raises(ValueError):
        taxq.axqmm_packed(x, pw, torch.tensor(8, device=hopper))     # int64 degree
    with pytest.raises(ValueError):
        taxq.axqmm_packed(x, tprepack(torch.randn(512, 64, device=hopper), 32))
    q = torch.zeros(2, 2, 4, 64, device=hopper)
    k8 = torch.zeros(2, 16, 2, 64, dtype=torch.int8, device=hopper)
    s8 = torch.ones(2, 16, 2, device=hopper)
    n = torch.ones(2, dtype=torch.int32, device=hopper)
    with pytest.raises(ValueError):                                   # bf16 codes
        tfd.flash_decode_quant(q, k8.bfloat16(), s8, k8, s8, n, n)
    with pytest.raises(ValueError):                                   # int64 lengths
        tfd.flash_decode_quant(q, k8, s8, k8, s8, n.long(), n)
