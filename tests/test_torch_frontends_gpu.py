"""The frontend archs' kernel shapes on a Hopper card (``gpu`` marker; they
skip elsewhere), each against its plain PyTorch version: non-causal
``dense`` attention (the audio encoder's: no mask, no rope) at head_dim 64
and 80, ``tri`` and both decode kernels at internvl2-1b's GQA 14/2 (G = 7,
the first odd group), and the GEMMs at internvl2-1b's odd, unpadded vocab
N = 151655, its ``v_proj/fc1`` (K 1024, bias) and hubert-xlarge's N = 504.
This file imports no JAX: the plain versions are held to the reference in
tests/test_torch_kernels.py and tests/test_torch_frontends.py.

Tolerances (as tests/test_torch_gpu.py): f32 attention rtol 1e-5 / atol
1e-4; bf16 attention (the tensor-core body, bf16 P) atol 1/64 against the
f64 plain version; decode on a bf16 cache 1e-4, on the int8 cache 1e-5
abs; the GEMMs bit for bit."""
import math

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels.qstore import prepack_weight as tprepack
from repro_torch.models.attention import _q8

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _attn_tol(dtype):
    return (0.0, 1 / 64) if dtype == torch.bfloat16 else (RTOL, ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [7, 129, 1000])
@pytest.mark.parametrize("D", [64, 80])
def test_gpu_dense_noncausal_matches_plain(hopper, D, S, dtype):
    """``causal=False`` takes the ``dense`` schedule: every (q block, kv
    block) pair, the in-kernel step count == ``planned_grid_steps``, the
    grouped entry (16 heads over 16 and over 4 KV heads) == the flat one on
    repeated K/V bit for bit, within tolerance of the plain version."""
    g = torch.Generator(device=hopper).manual_seed(100 * D + S)
    B, H = 2, 16
    for KVr in (16, 4):
        G = H // KVr
        q = torch.randn(B, S, H, D, generator=g, device=hopper).to(dtype)
        k = torch.randn(B, S, KVr, D, generator=g, device=hopper).to(dtype)
        v = torch.randn(B, S, KVr, D, generator=g, device=hopper).to(dtype)
        flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
        qf, kf, vf = flat(q), flat(k.repeat_interleave(G, 2)), flat(v.repeat_interleave(G, 2))
        before = dict(_build.flash_schedules)
        out, steps = tfa.flash_attention(qf, kf, vf, causal=False, return_steps=True)
        og = tfa.flash_attention_grouped(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert _build.flash_schedules["dense"] == before["dense"] + 2
        assert int(steps) == tfa.planned_grid_steps(B * H, S, causal=False)
        assert torch.equal(flat(og), out)
        ref, ref_steps = tfa.flash_attention_plain(qf, kf, vf, causal=False)
        assert ref_steps == int(steps)
        rtol, atol = _attn_tol(dtype)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [9, 255, 1030])
def test_gpu_tri_g7_matches_plain(hopper, S, dtype):
    """``tri`` at internvl2-1b's GQA 14/2 (G = 7), head_dim 64: the grouped
    entry == the flat one on repeated K/V, == ``dense`` under the causal
    mask, within tolerance of the plain version."""
    g = torch.Generator(device=hopper).manual_seed(7000 + S)
    B, H, KVr, D = 2, 14, 2, 64
    G = H // KVr
    q = torch.randn(B, S, H, D, generator=g, device=hopper).to(dtype)
    k = torch.randn(B, S, KVr, D, generator=g, device=hopper).to(dtype)
    v = torch.randn(B, S, KVr, D, generator=g, device=hopper).to(dtype)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    qf, kf, vf = flat(q), flat(k.repeat_interleave(G, 2)), flat(v.repeat_interleave(G, 2))
    out, steps = tfa.flash_attention(qf, kf, vf, causal=True, return_steps=True)
    dense = tfa.flash_attention(qf, kf, vf, causal=True, skip_grid=False)
    og = tfa.flash_attention_grouped(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert torch.equal(flat(og), out)
    assert int(steps) == tfa.planned_grid_steps(B * H, S)
    ref, _ = tfa.flash_attention_plain(qf, kf, vf, causal=True)
    rtol, atol = _attn_tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [300, 1024])
def test_gpu_decode_g7_matches_plain(hopper, T):
    """Both decode kernels at KVr 2, G 7, D 64 (internvl2-1b's decode):
    the bf16 cache within 1e-4, the int8 cache at ebits 8 and 5 within
    1e-5 of the plain versions, a free slot exactly zero."""
    g = torch.Generator(device=hopper).manual_seed(T)
    B, KVr, G, D = 8, 2, 7, 64
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    kf = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    vf = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    nv = torch.tensor([T, 1, T // 2, 64, 65, T - 1, 7, 200], dtype=torch.int32,
                      device=hopper).clamp(max=T)
    act = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.int32, device=hopper)
    k, v = kf.bfloat16(), vf.bfloat16()
    o = tfd.flash_decode(qg, k, v, nv, act)
    torch.testing.assert_close(o, tfd.flash_decode_plain(qg, k, v, nv, act),
                               rtol=1e-4, atol=1e-4)
    assert (o[3] == 0).all()
    kq, ks = _q8(kf)
    vq, vs = _q8(vf)
    for ebits in (8, 5):
        e = torch.tensor([8, ebits], dtype=torch.int32, device=hopper)[1]
        oq = tfd.flash_decode_quant(qg, kq, ks, vq, vs, nv, act, e)
        ref = tfd.flash_decode_quant_plain(qg, kq, ks, vq, vs, nv, act, e)
        torch.testing.assert_close(oq, ref, rtol=0, atol=1e-5)
        assert (oq[3] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,bias", [(8, 151655, 896, False), (255, 151655, 896, False),
                                        (1024, 896, 1024, True), (8, 504, 1280, False),
                                        (300, 504, 1280, False)],
                         ids=["vlm-unembed-decode", "vlm-unembed-prefill", "v_proj-fc1",
                              "audio-unembed-8", "audio-unembed-300"])
def test_gpu_axqmm_frontend_shapes_bit_identical(hopper, M, N, K, bias):
    """The GEMM at the frontend archs' shapes, the odd N = 151655 on its
    unpaired-store path included: bit for bit against the plain version
    at degrees 8 and 5."""
    g = torch.Generator(device=hopper).manual_seed(M + N + K)
    x = torch.randn(M, K, generator=g, device=hopper)
    pw = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 128)
    b = torch.randn(N, generator=g, device=hopper) if bias else None
    for ebits in (8, 5):
        e = torch.tensor([8, ebits], dtype=torch.int32, device=hopper)[1]
        y = taxq.axqmm_packed(x, pw, e, bias=b)
        torch.cuda.synchronize()
        assert torch.equal(y, taxq.axqmm_packed_plain(x, pw, e, bias=b))
