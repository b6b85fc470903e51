"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper card (``gpu`` marker; they skip elsewhere).  This file imports no
JAX, so it runs where only the port's stack (PyTorch with CUDA) is
installed; the plain versions it compares against are held to the JAX
reference in tests/test_torch_kernels.py.

Tolerances: the GEMMs rtol 1e-5 / atol 1e-4 (the qmm oracle tolerance),
and bit for bit (atol 0) across degrees 1..8, split plans, batch sizes and
graph replays (exact int32 block sums, the plain version's f32 fold
order); the f32 attention kernels rtol 1e-5 / atol 1e-4
on f32 inputs, the decode kernel 1e-4 on a bf16 cache (f32 sums in another
order), the int8-cache decode kernel 1e-5 abs (the reference's kernel-vs-
jnp tolerance), a decode slot's output exactly across launches, caches,
batches and graph replays (the kernel's fixed split order), the PR
product and the FIR / conv product-sums exactly (integer bit math, also
across graph replays with the degree moved).  bf16 attention
takes the kernel's tensor-core body (bf16 P in the P V product): atol 1/64
against the f64 plain version, one bf16 ulp at |o| < 4."""
import math

import numpy as np

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import axmult_elem as tpr
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import dsp as tdsp
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


def _gemm_operands(hopper, M, N, K, seed):
    g = torch.Generator(device=hopper).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=hopper)
    pw = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 256)
    pg = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 256)
    b = torch.randn(N, generator=g, device=hopper)
    r = torch.randn(M, N, generator=g, device=hopper)
    return x, pw, pg, b, r


@pytest.mark.gpu
@pytest.mark.parametrize("N,K", [(200, 512), (256, 512), (2560, 512), (200, 11008),
                                 (256, 11008), (2560, 11008)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 255, 4096])
def test_gpu_axqmm_kernels_are_the_plain_versions_bit_for_bit(hopper, M, N, K):
    """Both GEMM kernels equal their plain versions exactly (atol 0) on the
    decode kernel (M <= 16), both tile sizes and the split plans the
    wrapper picks, at every degree 1..8 set in one device int32."""
    x, pw, pg, b, r = _gemm_operands(hopper, M, N, K, M + N + K)
    e = torch.zeros((), dtype=torch.int32, device=hopper)
    for ebits in range(1, 9):
        e.fill_(ebits)
        y = taxq.axqmm_packed(x, pw, e, bias=b, residual=r)
        yg = taxq.axqmm_gated_packed(x, pw, pg, e, act="gelu")
        torch.cuda.synchronize()
        assert torch.equal(y, taxq.axqmm_packed_plain(x, pw, ebits, bias=b, residual=r)), ebits
        assert torch.equal(yg, taxq.axqmm_gated_plain(x, pw, pg, ebits, act="gelu")), ebits


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [False, True])
def test_gpu_axqmm_slot_bits_do_not_depend_on_split_or_batch(hopper, monkeypatch, gated):
    """Row 0 of x gives the same bits at M = 1, 8, 16, 17 and 255 and under
    every plan the kernels take (decode: K split at whole blocks and at
    parts of blocks; 64-row tiles: whole blocks; the 128-row wgmma tiles),
    at ebits 5 and 8."""
    N, K = 200, 11008
    x, pw, pg, b, r = _gemm_operands(hopper, 255, N, K, 11)
    call = ((lambda xx, e: taxq.axqmm_gated_packed(xx, pw, pg, e)) if gated else
            (lambda xx, e: taxq.axqmm_packed(xx, pw, e, bias=b)))
    nb = K // 256
    for ebits in (5, 8):
        first = call(x[:1], ebits)[0]
        for M in (1, 8, 16, 17, 255):
            decode = M <= taxq.DECODE_M
            plans = ([taxq.Plan(taxq.DECODE, s, p) for s, p in
                      ((1, 1), (2, 1), (5, 1), (nb, 1), (nb * 4 - 1, 4), (nb * 2, 2))]
                     if decode else
                     [taxq.Plan(taxq.TILE_SMALL, s) for s in (1, 3, nb)]
                     + [taxq.Plan(taxq.TILE_LARGE)])
            for p in plans:
                monkeypatch.setattr(taxq, "_plan_for", lambda *a, p=p: p)
                y = call(x[:M], ebits)
                torch.cuda.synchronize()
                assert torch.equal(y[0], first), (ebits, M, p)
            monkeypatch.undo()


def _expert_operands(hopper, E, C, N, K, seed):
    g = torch.Generator(device=hopper).manual_seed(seed)
    x = torch.randn(E, C, K, generator=g, device=hopper)
    x[:, -1] = 0.0                                  # an empty capacity row
    bk = 256 if K % 256 == 0 else 128
    pw, pg = (tprepack(torch.randn(E, K, N, generator=g, device=hopper) / math.sqrt(K), bk)
              for _ in range(2))
    return x, pw, pg, bk


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,N,K", [(40, 4, 512, 1536), (40, 4, 1536, 512), (3, 9, 200, 1024),
                                     (40, 128, 512, 1536), (60, 43, 1408, 2048),
                                     (6, 43, 2048, 1408), (2, 1024, 200, 512)])
def test_gpu_expert_batched_kernels_are_the_plain_versions_bit_for_bit(hopper, monkeypatch,
                                                                       E, C, N, K):
    """The expert-batched launches equal their plain versions exactly (atol
    0), and so each expert the 2-D launch on its slice, at every degree
    1..8 set in one device int32 and under every plan the kernels take at
    that shape (decode: K split at whole blocks and at parts of blocks;
    64-row tiles split or not; 128-row wgmma tiles, with the pre-pass at
    C = 1024); every expert's empty capacity row comes out as the plain
    version gives it."""
    x, pw, pg, bk = _expert_operands(hopper, E, C, N, K, E + C + N + K)
    nb = K // bk
    planned = taxq.plan(C, N, K, bk, True, _build.sm_count(x), E)
    plans = ([taxq.Plan(taxq.DECODE, s, p) for s, p in ((1, 1), (2, 1), (nb, 1), (nb * 2, 2))]
             if C <= taxq.DECODE_M else
             [taxq.Plan(taxq.TILE_SMALL, s) for s in sorted({1, min(3, nb), nb})]
             + [taxq.Plan(taxq.TILE_LARGE)])
    e = torch.zeros((), dtype=torch.int32, device=hopper)
    for p in [planned] + plans:
        monkeypatch.setattr(taxq, "plan", lambda *a, p=p: p)
        for ebits in range(1, 9):
            e.fill_(ebits)
            y = taxq.axqmm_experts_packed(x, pw, e)
            yg = taxq.axqmm_gated_experts_packed(x, pw, pg, e)
            torch.cuda.synchronize()
            assert torch.equal(y, taxq.axqmm_experts_plain(x, pw, ebits)), (p, ebits)
            assert torch.equal(yg, taxq.axqmm_gated_experts_plain(x, pw, pg, ebits)), (p, ebits)
        monkeypatch.undo()
    # one expert's slice through the 2-D launch gives the same bits
    i = E - 1
    y = taxq.axqmm_experts_packed(x, pw, 5)
    assert torch.equal(y[i], taxq.axqmm_packed(x[i], taxq.expert_pack(pw, i), 5))


@pytest.mark.gpu
def test_gpu_expert_batched_launch_counts_and_refusals(hopper):
    """One batched call is one launch of its kernel (no loop of 2-D
    launches), and a pack whose leading E disagrees with x raises."""
    x, pw, pg, bk = _expert_operands(hopper, 8, 4, 256, 512, 3)
    before = dict(_build.launches)
    taxq.axqmm_gated_experts_packed(x, pw, pg, 6)
    taxq.axqmm_experts_packed(x, pw, 6)
    torch.cuda.synchronize()
    assert _build.launches["axqmm_gated_experts"] == before["axqmm_gated_experts"] + 1
    assert _build.launches["axqmm_experts"] == before["axqmm_experts"] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 2
    with pytest.raises(ValueError):
        taxq.axqmm_experts_packed(x[:7], pw, 6)


@pytest.mark.gpu
def test_gpu_axqmm_degree_moves_between_graph_replays(hopper):
    """One capture of both GEMMs (a decode-shaped split plan and a
    prefill tile) replays at each degree written into the device int32
    between replays: the outputs follow the degree, bit for bit, with no
    rebuild and no recapture."""
    x, pw, pg, b, r = _gemm_operands(hopper, 255, 2560, 2048, 5)
    e = torch.full((), 8, dtype=torch.int32, device=hopper)
    xs = (x[:8].clone(), x)

    def step():
        return [taxq.axqmm_packed(xx, pw, e, residual=r[:xx.shape[0]]) for xx in xs] + \
               [taxq.axqmm_gated_packed(xx, pw, pg, e) for xx in xs]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    libs = dict(_build._libs)
    seen = []
    for ebits in (8, 5, 2, 7):
        e.fill_(ebits)
        graph.replay()
        torch.cuda.synchronize()
        want = [taxq.axqmm_packed_plain(xx, pw, ebits, residual=r[:xx.shape[0]]) for xx in xs] + \
               [taxq.axqmm_gated_plain(xx, pw, pg, ebits) for xx in xs]
        for o, w in zip(outs, want):
            assert torch.equal(o, w), ebits
        seen.append(outs[0].clone())
    assert not torch.equal(seen[0], seen[1])
    assert dict(_build._libs) == libs


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
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_gpu_flash_band_matches_dense_and_plain(hopper, D):
    """The ``band`` schedule (window 300 on S = 1000: 4 of 8 kv blocks per
    q block) equals ``dense`` under the same window bit for bit, counts
    ``planned_grid_steps`` in the kernel, is within the f32 tolerance of
    the plain version, and its grouped entry equals the flat one on
    repeated K/V."""
    g = torch.Generator(device=hopper).manual_seed(D)
    B, S, H, KVr, W = 2, 1000, 4, 2, 300
    q = torch.randn(B, S, H, D, generator=g, device=hopper)
    k = torch.randn(B, S, KVr, D, generator=g, device=hopper)
    v = torch.randn(B, S, KVr, D, generator=g, device=hopper)
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    qf, kf, vf = flat(q), flat(k.repeat_interleave(H // KVr, 2)), flat(
        v.repeat_interleave(H // KVr, 2))
    before = dict(_build.flash_schedules)
    out, steps = tfa.flash_attention(qf, kf, vf, causal=True, window=W, return_steps=True)
    dense, dsteps = tfa.flash_attention(qf, kf, vf, causal=True, window=W,
                                        skip_grid=False, return_steps=True)
    og = tfa.flash_attention_grouped(q, k, v, causal=True, window=W)
    torch.cuda.synchronize()
    assert _build.flash_schedules["band"] == before["band"] + 2
    assert _build.flash_schedules["dense"] == before["dense"] + 1
    assert int(steps) == tfa.planned_grid_steps(B * H, S, window=W) == B * H * 8 * 4
    assert int(dsteps) == tfa.planned_grid_steps(B * H, S, window=W, skip_grid=False)
    assert torch.equal(out, dense)
    assert torch.equal(flat(og), out)
    ref, ref_steps = tfa.flash_attention_plain(qf, kf, vf, causal=True, window=W)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    assert ref_steps == int(steps)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [1, 7, 16, 129, 1000])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_gpu_flash_bf16_tensor_core_body(hopper, D, S, G):
    """The bf16 (tensor-core) body on every schedule: ``tri`` == ``dense``
    and ``band`` == ``dense`` under the same window, bit for bit; the
    in-kernel step count == ``planned_grid_steps``; the grouped entry ==
    the flat one on repeated K/V; within atol 1/64 of the plain version.
    The window is 300 at S = 1000 (4 of 8 kv blocks per q block) and S // 2
    below it, so the window mask also cuts inside one block."""
    g = torch.Generator(device=hopper).manual_seed(1000 * D + 10 * S + G)
    B, KVr = 2, 2
    H, W = KVr * G, (300 if S > 300 else max(1, S // 2))
    q = torch.randn(B, S, H, D, generator=g, device=hopper).bfloat16()
    k = torch.randn(B, S, KVr, D, generator=g, device=hopper).bfloat16()
    v = torch.randn(B, S, KVr, D, generator=g, device=hopper).bfloat16()
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    qf, kf, vf = flat(q), flat(k.repeat_interleave(G, 2)), flat(v.repeat_interleave(G, 2))
    for window in (None, W):
        before = _build.launches["flash_attention"]
        out, steps = tfa.flash_attention(qf, kf, vf, causal=True, window=window,
                                         return_steps=True)
        dense, dsteps = tfa.flash_attention(qf, kf, vf, causal=True, window=window,
                                            skip_grid=False, return_steps=True)
        og = tfa.flash_attention_grouped(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert _build.launches["flash_attention"] == before + 3
        assert torch.equal(out, dense)
        assert torch.equal(flat(og), out)
        assert int(steps) == tfa.planned_grid_steps(B * H, S, window=window)
        assert int(dsteps) == tfa.planned_grid_steps(B * H, S, window=window,
                                                     skip_grid=False)
        ref, ref_steps = tfa.flash_attention_plain(qf, kf, vf, causal=True, window=window)
        assert ref_steps == int(steps)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1 / 64)


@pytest.mark.gpu
def test_gpu_flash_bf16_refuses_misaligned_views(hopper):
    """The tensor-core body copies 16-byte pieces: a view whose pointer
    (offset by one element) or head stride (68 elements) is not 16-byte
    aligned is refused before anything launches; the f32 body takes the
    same views."""
    g = torch.Generator(device=hopper).manual_seed(16)
    kv = torch.randn(2, 64, 4, 64, generator=g, device=hopper)
    for dt in (torch.bfloat16, torch.float32):
        base = torch.randn(2, 64, 4, 72, generator=g, device=hopper).to(dt)
        padded = torch.randn(2, 64, 4, 68, generator=g, device=hopper).to(dt)
        for x in (base[..., 1:65], padded[..., :64]):
            before = _build.launches["flash_attention"]
            if dt == torch.bfloat16:
                with pytest.raises(ValueError, match="16"):
                    tfa.flash_attention_grouped(x, kv.to(dt), kv.to(dt))
                assert _build.launches["flash_attention"] == before
                continue
            out = tfa.flash_attention_grouped(x, kv, kv)
            assert _build.launches["flash_attention"] == before + 1
            torch.testing.assert_close(out, tfa.flash_attention_grouped_plain(x, kv, kv),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_gpu_flash_decode_head_dim_80_full_ring(hopper):
    """Both decode kernels at head_dim 80 on a full ring (every slot at
    nvalid = T) with one freed slot."""
    g = torch.Generator(device=hopper).manual_seed(80)
    B, T, KVr, G, D = 4, 256, 2, 4, 80
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    k = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    v = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    nv = torch.full((B,), T, dtype=torch.int32, device=hopper)
    act = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=hopper)
    o = tfd.flash_decode(qg, k.bfloat16(), v.bfloat16(), nv, act)
    torch.testing.assert_close(o, tfd.flash_decode_plain(qg, k.bfloat16(), v.bfloat16(),
                                                         nv, act), rtol=1e-4, atol=1e-4)
    from repro_torch.models.attention import _q8
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    e = torch.tensor([8, 5], dtype=torch.int32, device=hopper)[1]
    oq = tfd.flash_decode_quant(qg, kq, ks, vq, vs, nv, act, e)
    torch.testing.assert_close(oq, tfd.flash_decode_quant_plain(qg, kq, ks, vq, vs, nv,
                                                                act, e), rtol=0, atol=1e-5)
    assert (o[2] == 0).all() and (oq[2] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("KVr,G", [(2, 8), (8, 4)], ids=["qwen-16-2", "nemo-32-8"])
def test_gpu_flash_decode_head_dim_128_full_ring(hopper, KVr, G):
    """Both decode kernels at head_dim 128 with qwen2.5-3b's and
    mistral-nemo-12b's grouping, every live slot at nvalid = T and one
    freed slot."""
    g = torch.Generator(device=hopper).manual_seed(128 + KVr)
    B, T, D = 4, 300, 128
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    k = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    v = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    nv = torch.full((B,), T, dtype=torch.int32, device=hopper)
    act = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=hopper)
    before = dict(_build.launches)
    o = tfd.flash_decode(qg, k.bfloat16(), v.bfloat16(), nv, act)
    torch.testing.assert_close(o, tfd.flash_decode_plain(qg, k.bfloat16(), v.bfloat16(),
                                                         nv, act), rtol=1e-4, atol=1e-4)
    from repro_torch.models.attention import _q8
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    e = torch.tensor([8, 6], dtype=torch.int32, device=hopper)[1]
    oq = tfd.flash_decode_quant(qg, kq, ks, vq, vs, nv, act, e)
    torch.cuda.synchronize()
    assert _build.launches["flash_decode"] == before["flash_decode"] + 1
    assert _build.launches["flash_decode_quant"] == before["flash_decode_quant"] + 1
    torch.testing.assert_close(oq, tfd.flash_decode_quant_plain(qg, kq, ks, vq, vs, nv,
                                                                act, e), rtol=0, atol=1e-5)
    assert (o[1] == 0).all() and (oq[1] == 0).all()


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


def _decode_calls(qg, k, v, nv, act, e):
    """Both decode kernels on one set of rows: the bf16 cache and the int8
    cache (its codes and scales from the same f32 rows), degree ``e``."""
    from repro_torch.models.attention import _q8
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    return (tfd.flash_decode(qg, k.bfloat16(), v.bfloat16(), nv, act),
            tfd.flash_decode_quant(qg, kq, ks, vq, vs, nv, act, e))


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_gpu_decode_split_edges_match_plain(hopper, D, G):
    """Both decode kernels (and the f32 cache) at lengths W - 1, W, W + 1,
    2 W and T of the split width W, on a cache of T = 2 W + 37 rows (no
    multiple of W), a freed slot of exact zeros, the degree read from a
    device-vector element at 8 and 5; one launch a call."""
    from repro_torch.models.attention import _q8
    W = tfd.split_width(D)
    T, KVr = 2 * W + 37, 2
    g = torch.Generator(device=hopper).manual_seed(100 * D + G)
    nv = torch.tensor([W - 1, W, W + 1, 2 * W, T, 5], dtype=torch.int32, device=hopper)
    act = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.int32, device=hopper)
    B = nv.numel()
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    k = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    v = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    for kv in ((k, v), (k.bfloat16(), v.bfloat16())):
        before = _build.launches["flash_decode"]
        o = tfd.flash_decode(qg, *kv, nv, act)
        torch.cuda.synchronize()
        assert _build.launches["flash_decode"] == before + 1
        torch.testing.assert_close(o, tfd.flash_decode_plain(qg, *kv, nv, act),
                                   rtol=1e-4, atol=1e-4)
        assert (o[5] == 0).all()
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    deg = torch.tensor([8, 8, 5], dtype=torch.int32, device=hopper)
    for e in (deg[1], deg[2]):
        before = _build.launches["flash_decode_quant"]
        o = tfd.flash_decode_quant(qg, kq, ks, vq, vs, nv, act, e)
        torch.cuda.synchronize()
        assert _build.launches["flash_decode_quant"] == before + 1
        torch.testing.assert_close(o, tfd.flash_decode_quant_plain(qg, kq, ks, vq, vs, nv,
                                                                   act, e), rtol=0, atol=1e-5)
        assert (o[5] == 0).all()


@pytest.mark.gpu
def test_gpu_decode_slot_is_bit_identical_across_launches_caches_and_batches(hopper):
    """A slot's output from both decode kernels is a function of its own
    rows and length: bit for bit the same across two launches, with its
    rows in a cache of another capacity (other rows past its length), and
    in a batch of another size beside other slots and a freed one."""
    D, KVr, G = 128, 2, 8
    W = tfd.split_width(D)
    T1, T2, n = 3 * W + 5, 5 * W + 64, 2 * W + 17
    g = torch.Generator(device=hopper).manual_seed(17)
    qg = torch.randn(1, KVr, G, D, generator=g, device=hopper)
    k = torch.randn(1, T1, KVr, D, generator=g, device=hopper)
    v = torch.randn(1, T1, KVr, D, generator=g, device=hopper)
    e = torch.tensor([8, 5], dtype=torch.int32, device=hopper)[1]
    one = lambda t: torch.tensor([t], dtype=torch.int32, device=hopper)
    first = _decode_calls(qg, k, v, one(n), one(1), e)
    again = _decode_calls(qg, k, v, one(n), one(1), e)

    def bigger(x):
        y = torch.randn(1, T2, KVr, D, generator=g, device=hopper)
        y[:, :T1] = x
        return y
    wide = _decode_calls(qg, bigger(k), bigger(v), one(n), one(1), e)
    B = 4
    qb = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    kb = torch.randn(B, T1, KVr, D, generator=g, device=hopper)
    vb = torch.randn(B, T1, KVr, D, generator=g, device=hopper)
    qb[2], kb[2], vb[2] = qg[0], k[0], v[0]
    nvb = torch.tensor([T1, 7, n, W], dtype=torch.int32, device=hopper)
    actb = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=hopper)
    batch = _decode_calls(qb, kb, vb, nvb, actb, e)
    torch.cuda.synchronize()
    for f, a, w, bt in zip(first, again, wide, batch):
        assert torch.equal(f, a)
        assert torch.equal(f, w)
        assert torch.equal(f[0], bt[2])
        assert (bt[3] == 0).all()


@pytest.mark.gpu
def test_gpu_decode_replays_from_a_cuda_graph(hopper):
    """One ``flash_decode`` and one ``flash_decode_quant`` call captured in
    a CUDA graph; lengths, active flags and the degree element changed in
    place between replays give what eager calls on the same operands give,
    bit for bit: nothing is read on the host and no state outlives a
    call."""
    from repro_torch.models.attention import _q8
    D, KVr, G, B = 128, 2, 8, 4
    W = tfd.split_width(D)
    T = 4 * W
    g = torch.Generator(device=hopper).manual_seed(23)
    qg = torch.randn(B, KVr, G, D, generator=g, device=hopper)
    k = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    v = torch.randn(B, T, KVr, D, generator=g, device=hopper)
    kb, vb = k.bfloat16(), v.bfloat16()
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    nv = torch.tensor([T, 1, W + 1, 3 * W], dtype=torch.int32, device=hopper)
    act = torch.ones(B, dtype=torch.int32, device=hopper)
    deg = torch.tensor([8, 8], dtype=torch.int32, device=hopper)
    e = deg[1]

    def calls():
        return (tfd.flash_decode(qg, kb, vb, nv, act),
                tfd.flash_decode_quant(qg, kq, ks, vq, vs, nv, act, e))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for lens, flags, ebits in (([T, 1, W + 1, 3 * W], [1, 1, 1, 1], 8),
                               ([W, 2 * W + 1, T, 5], [1, 0, 1, 1], 5),
                               ([3, T, W - 1, 2 * W], [0, 1, 1, 0], 6)):
        nv.copy_(torch.tensor(lens, dtype=torch.int32))
        act.copy_(torch.tensor(flags, dtype=torch.int32))
        deg[1] = ebits
        graph.replay()
        torch.cuda.synchronize()
        eager = calls()
        torch.cuda.synchronize()
        for c, o in zip(captured, eager):
            assert torch.equal(c, o)
        torch.testing.assert_close(eager[0], tfd.flash_decode_plain(qg, kb, vb, nv, act),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(eager[1], tfd.flash_decode_quant_plain(
            qg, kq, ks, vq, vs, nv, act, e), rtol=0, atol=1e-5)
        for i, f in enumerate(flags):
            if not f:
                assert (captured[0][i] == 0).all() and (captured[1][i] == 0).all()


@pytest.mark.gpu
def test_gpu_decode_refuses_misaligned_cache(hopper):
    """The decode kernels copy 16-byte pieces: a contiguous cache whose
    pointer is off by one element is refused before anything launches."""
    B, T, KVr, G, D = 2, 64, 2, 4, 64
    qg = torch.zeros(B, KVr, G, D, device=hopper)
    n = torch.full((B,), T, dtype=torch.int32, device=hopper)
    flat = torch.zeros(B * T * KVr * D + 1, dtype=torch.bfloat16, device=hopper)
    off = flat[1:].view(B, T, KVr, D)
    before = _build.launches["flash_decode"]
    with pytest.raises(ValueError, match="16"):
        tfd.flash_decode(qg, off, off, n, n)
    assert _build.launches["flash_decode"] == before


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


@pytest.mark.gpu
@pytest.mark.parametrize("numel", [3, 1001, 4 * 4096, 3 * 4096 + 7, 1 << 20])
def test_gpu_pr_multiply_matches_plain(hopper, numel):
    """Bit-exact against the plain version at ragged and aligned sizes, at
    the (p, r) of every degree (read from a device vector element, as the
    stream engine passes it) and at raw knobs; an operand offset by one
    lane takes the scalar path.  The wrapper refuses int64, non-contiguous
    and CPU operands."""
    rng = np.random.default_rng(numel)
    a = torch.from_numpy(rng.integers(-2**15, 2**15, numel + 1).astype(np.int32)).to(hopper)
    b = torch.from_numpy(rng.integers(-2**15, 2**15, numel + 1).astype(np.int32)).to(hopper)
    degrees = torch.tensor(list(range(9)), dtype=torch.int32, device=hopper)
    knobs = [tdsp.degree_to_pr(degrees[e]) for e in range(9)] + [(1, 4), (2, 8), (3, 8)]
    for pr in knobs:
        for x, y in ((a[:numel], b[:numel]), (a[1:], b[1:])):     # aligned, offset
            before = _build.launches["pr_multiply"]
            out = tpr.pr_multiply(x, y, pr)
            torch.cuda.synchronize()
            assert _build.launches["pr_multiply"] == before + 1
            assert torch.equal(out, tpr.pr_multiply_plain(x, y, pr))
    with pytest.raises(ValueError):
        tpr.pr_multiply(a.long(), b.long(), (1, 2))
    with pytest.raises(ValueError):
        tpr.pr_multiply(a[::2], b[::2], (1, 2))
    with pytest.raises(ValueError):
        tpr.pr_multiply(a, b.cpu(), (1, 2))
    with pytest.raises(ValueError):
        tpr.pr_multiply(a, b, torch.tensor([1, 2], dtype=torch.int32))     # CPU knobs


def _pr_knobs(hopper):
    """The product-sums' knobs: every degree as an element of a device
    vector, None (exact), an int degree and raw (p, r) pairs."""
    degrees = torch.tensor(list(range(9)), dtype=torch.int32, device=hopper)
    return ([{"degree": degrees[e]} for e in range(9)] + [{"degree": None}, {"degree": 5}]
            + [{"pr": k} for k in ((1, 4), (2, 8), (3, 8))])


def _ints(rng, shape, hopper, lim=2**12):
    return torch.from_numpy(rng.integers(-lim, lim + 1, shape).astype(np.int32)).to(hopper)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,T", [(64, 256, 8), (3, 1001, 13), (2, 5, 13), (1, 4096, 32),
                                   (4, 300, 1), (2, 600, 256)])
def test_gpu_pr_fir_matches_plain(hopper, B, L, T):
    """Bit-exact against the plain version (and the old route: the planes
    through pr_multiply, then an int32 sum) at every knob, with tiles of
    ragged length, frames shorter than the tail, one tap and the most
    taps; one launch a call; sums that wrap."""
    rng = np.random.default_rng(B * 7 + L + T)
    frames, tail = _ints(rng, (B, L), hopper), _ints(rng, (B, T - 1), hopper)
    taps = _ints(rng, (T,), hopper, lim=2**15)              # past l1: the sums wrap
    for kw in _pr_knobs(hopper):
        before = dict(_build.launches)
        y, nt = tpr.pr_fir(frames, tail, taps, shift=12, **kw)
        torch.cuda.synchronize()
        assert _build.launches["pr_fir"] == before["pr_fir"] + 1
        assert sum(_build.launches.values()) == sum(before.values()) + 1
        yp, ntp = tpr.pr_fir_plain(frames, tail, taps, shift=12, **kw)
        assert torch.equal(y, yp) and torch.equal(nt, ntp), kw
        pr = kw.get("pr") or tdsp.degree_to_pr(kw["degree"], device=hopper)
        a, win, _ = tpr.fir_planes(frames, tail, taps)
        old = torch.sum(tpr.pr_multiply(a.expand(win.shape).contiguous(), win.contiguous(), pr),
                        dim=0, dtype=torch.int32) >> 12
        assert torch.equal(y, old), kw


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,kh,kw,pad", [(64, 16, 16, 3, 3, "edge"),
                                             (64, 16, 16, 1, 1, "zero"),
                                             (1, 128, 128, 5, 5, "zero"),
                                             (1, 128, 128, 5, 5, "edge"),
                                             (3, 37, 45, 4, 6, "edge"),
                                             (2, 20, 9, 3, 5, "zero"),
                                             (2, 5, 3, 16, 16, "edge")])
def test_gpu_pr_conv2d_matches_plain(hopper, B, H, W, kh, kw, pad):
    """Bit-exact against the plain version and the old route at every knob:
    both paddings, odd, even and one-by-one kernels, ragged tiles, a kernel
    larger than the image, sums that wrap; one launch a call."""
    rng = np.random.default_rng(B + H * W + kh * kw)
    img = _ints(rng, (B, H, W), hopper)
    kern = _ints(rng, (kh, kw), hopper, lim=2**15)
    for knob in _pr_knobs(hopper):
        before = _build.launches["pr_conv2d"]
        out = tpr.pr_conv2d(img, kern, shift=8, pad=pad, **knob)
        torch.cuda.synchronize()
        assert _build.launches["pr_conv2d"] == before + 1
        assert torch.equal(out, tpr.pr_conv2d_plain(img, kern, shift=8, pad=pad, **knob)), knob
        pr = knob.get("pr") or tdsp.degree_to_pr(knob["degree"], device=hopper)
        a, patches = tpr.conv_planes(img, kern, pad)
        old = torch.sum(tpr.pr_multiply(a.expand(patches.shape).contiguous(),
                                        patches.contiguous(), pr), dim=0, dtype=torch.int32) >> 8
        assert torch.equal(out, old), knob


@pytest.mark.gpu
def test_gpu_pr_stages_follow_the_degree_between_graph_replays(hopper):
    """One capture of the stream tick's three stages replays at each degree
    written into the device vector between replays: the outputs follow the
    degree, bit for bit, with no rebuild and no recapture."""
    rng = np.random.default_rng(3)
    frames, tail = _ints(rng, (64, 256), hopper), _ints(rng, (64, 7), hopper)
    taps = _ints(rng, (8,), hopper, lim=2**9)
    kern, gain = _ints(rng, (3, 3), hopper, lim=2**5), _ints(rng, (1, 1), hopper)
    vec = torch.full((3,), 8, dtype=torch.int32, device=hopper)

    def tick():
        y, nt = tpr.pr_fir(frames, tail, taps, degree=vec[0], shift=12)
        img = tpr.pr_conv2d(y.reshape(64, 16, 16), kern, degree=vec[1], shift=8, pad="edge")
        return tpr.pr_conv2d(img, gain, degree=vec[2], shift=12), nt

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tick()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, nt = tick()
    libs = dict(_build._libs)
    seen = []
    for e in (8, 5, 0, 7):
        vec.fill_(e)
        graph.replay()
        torch.cuda.synchronize()
        y, _ = tpr.pr_fir_plain(frames, tail, taps, degree=e, shift=12)
        img = tpr.pr_conv2d_plain(y.reshape(64, 16, 16), kern, degree=e, shift=8, pad="edge")
        assert torch.equal(out, tpr.pr_conv2d_plain(img, gain, degree=e, shift=12)), e
        assert torch.equal(nt, frames[:, -7:]), e
        seen.append(out.clone())
    assert not torch.equal(seen[0], seen[1])
    assert dict(_build._libs) == libs


@pytest.mark.gpu
def test_gpu_pr_stages_refuse_bad_operands(hopper):
    """int64 operands, strided views, CPU knobs, an int64 degree and sizes
    past the limits raise before any launch; nothing falls back."""
    fr = torch.zeros(4, 32, dtype=torch.int32, device=hopper)
    tl = torch.zeros(4, 7, dtype=torch.int32, device=hopper)
    tp = torch.ones(8, dtype=torch.int32, device=hopper)
    img = torch.zeros(2, 16, 16, dtype=torch.int32, device=hopper)
    k = torch.ones(3, 3, dtype=torch.int32, device=hopper)
    before = dict(_build.launches)
    for call, match in (
            (lambda: tpr.pr_fir(fr.long(), tl, tp), "dtype"),
            (lambda: tpr.pr_fir(fr[:, ::2], tl, tp), "contiguous"),
            (lambda: tpr.pr_fir(fr, tl.cpu(), tp), "tail is on"),
            (lambda: tpr.pr_fir(fr, tl, tp, torch.tensor([1, 2], dtype=torch.int32)), "int32"),
            (lambda: tpr.pr_fir(fr, tl, tp, degree=torch.tensor(6, device=hopper)), "int32"),
            (lambda: tpr.pr_fir(fr, torch.zeros(4, 256, dtype=torch.int32, device=hopper),
                                torch.ones(257, dtype=torch.int32, device=hopper)), "256 taps"),
            (lambda: tpr.pr_conv2d(img.long(), k), "dtype"),
            (lambda: tpr.pr_conv2d(img[:, :, ::2], k), "contiguous"),
            (lambda: tpr.pr_conv2d(img, k.cpu()), "kern is on"),
            (lambda: tpr.pr_conv2d(img, k, degree=torch.tensor(6, dtype=torch.int32)), "int32"),
            (lambda: tpr.pr_conv2d(img, torch.ones(17, 3, dtype=torch.int32, device=hopper)),
             "1..16")):
        with pytest.raises(ValueError, match=match):
            call()
    assert _build.launches == before


# ---------------------------------------------------------------------------
# per-layer plans and the quality tap on the card
# ---------------------------------------------------------------------------


def _smoke_lm(device, arch="tinyllama-1.1b-smoke"):
    from repro_torch.configs import get_config
    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model

    m = build_model(get_config(arch), policy_from_flag("axq8", dynamic=True), device=device)
    return m, m.prepack(m.init(seed=0))


def _mixed_plan(cfg):
    from repro_torch import tune

    plan = tune.uniform_plan(cfg, ebits_ladder=(8, 6, 5, 4))
    S = cfg.n_layers + 1
    plan.ladder[1] = tune.PlanPoint("mixed", tuple([8, 5] * S)[:S], 0.1, 0.9)
    return plan


@pytest.mark.gpu
@pytest.mark.parametrize("rung", [0, 1, 3])
def test_gpu_plan_rung_served_by_the_kernels_equals_the_vector_by_hand(hopper, rung):
    """An engine held on a plan rung (its operand built at construction)
    and one given the rung's vector as ``degree=`` emit the same greedy
    tokens, through the kernels."""
    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.lm import ServeEngine

    m, params = _smoke_lm(hopper)
    plan = _mixed_plan(m.cfg)
    rng = np.random.default_rng(rung)
    prompts = [rng.integers(0, m.cfg.vocab, int(rng.integers(2, 20))) for _ in range(3)]

    def serve(**kw):
        eng = ServeEngine(m, params, slots=2, max_len=64, prepack=False, **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run_until_drained()
        return [r.out_tokens for r in reqs]

    before = dict(_build.launches)
    held = QoSController(ladder=[], low_water=-1.0, high_water=2.0, degree=rung)
    through_plan = serve(plan=plan, qos=held)
    assert _build.launches["axqmm"] > before["axqmm"]
    assert _build.launches["flash_decode"] > before["flash_decode"]
    assert through_plan == serve(degree=plan.degrees(rung))


@pytest.mark.gpu
def test_gpu_decode_graph_replay_follows_a_plan_rung_move(hopper):
    """One decode step captured in a CUDA graph with a device degree
    vector; each plan rung written into that vector between replays gives
    the eager step's logits at that rung, bit for bit, with no rebuild."""
    m, params = _smoke_lm(hopper)
    plan = _mixed_plan(m.cfg)
    cache = m.init_cache(tp=1, batch=2, max_len=64)
    for slot, n in ((0, 9), (1, 17)):
        toks = torch.arange(1, n + 1, device=hopper) % m.cfg.vocab
        _, cache = m.prefill(params, cache, toks, slot)
    feed = torch.tensor([[3], [5]], device=hopper)
    active = torch.ones(2, dtype=torch.bool, device=hopper)
    deg = torch.tensor(plan.degrees(0), device=hopper)

    def step():
        return m.decode_step(params, cache, feed, degree=deg, active=active)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    libs = dict(_build._libs)
    seen = []
    for r in (0, 1, 3, 0):
        deg.copy_(torch.tensor(plan.degrees(r), device=hopper))
        graph.replay()
        torch.cuda.synchronize()
        want = m.decode_step(params, cache, feed, degree=deg, active=active)[0]
        assert torch.equal(out, want), r
        seen.append(out.clone())
    assert not torch.equal(seen[0], seen[2]) and torch.equal(seen[0], seen[3])
    assert dict(_build._libs) == libs


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8", "ring"])
def test_gpu_quality_tap_leaves_the_cache_bit_identical(hopper, kind):
    """The tap's two decode forwards write the cache rows the next step
    writes; it restores them, so the state after ``sample()`` is the state
    before, bit for bit, on the bf16, int8 and ring caches."""
    from repro_torch.obs.quality import QualityTap
    from repro_torch.obs.metrics import Registry

    arch = "h2o-danube-1.8b-smoke" if kind == "ring" else "tinyllama-1.1b-smoke"
    m, params = _smoke_lm(hopper, arch)
    cache = m.init_cache(tp=1, batch=3, max_len=64, quant=kind == "int8")
    for slot, n in ((0, 45 if kind == "ring" else 11), (1, 7)):
        toks = torch.arange(2, n + 2, device=hopper) % m.cfg.vocab
        _, cache = m.prefill(params, cache, toks, slot)
    if kind == "ring":
        assert cache.k.shape[2] == 32 and int(cache.length.max()) > 32
    before = [t.clone() for t in cache]
    tap = QualityTap(m, every=1, registry=Registry())
    feed = torch.tensor([[3], [5], [0]], device=hopper)
    active = torch.tensor([True, True, False], device=hopper)
    launches = _build.launches["flash_decode_quant" if kind == "int8" else "flash_decode"]
    for deg in (torch.full((3,), 5, dtype=torch.int32, device=hopper),
                torch.tensor([8, 4, 6], dtype=torch.int32, device=hopper)):
        val = tap.sample(0, params, cache, feed, active, deg)
        assert math.isfinite(val) and val > 0
        for a, b in zip(before, cache):
            assert torch.equal(a, b)
    name = "flash_decode_quant" if kind == "int8" else "flash_decode"
    assert _build.launches[name] == launches + 2 * 2 * m.cfg.n_layers


# ---------------------------------------------------------------------------
# the compiled serve step: one CUDA graph per call shape
# ---------------------------------------------------------------------------


def _capture_engine(m, params, capture, kind, **kw):
    """An engine on ``kind``'s cache (bf16 / int8 / ring: the window arch's
    bf16 ring) with buckets, pack 2 and (bf16 only) 8-token chunks, under
    the global QoS ladder 8 -> 5 unless ``kw`` says otherwise."""
    import os

    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.admission import AdmissionConfig
    from repro_torch.serve.lm import ServeEngine

    kw.setdefault("qos", QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)],
                                       low_water=0.25, high_water=0.75, cooldown_steps=2))
    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if kind == "int8" else "0"
    try:
        return ServeEngine(m, params, slots=3, max_len=64, prepack=False, seed=5,
                           capture=capture, emitter=False,
                           admission=AdmissionConfig(pack=2, chunk_tokens=8), **kw)
    finally:
        if prev is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = prev


def _serve(eng, prompts, n=6):
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run_until_drained()
    return [r.out_tokens for r in reqs], [d for _, d in eng.stats.degree_history]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8", "ring"])
@pytest.mark.parametrize("plan", [False, True])
def test_gpu_captured_engine_tokens_equal_eager(hopper, kind, plan):
    """The captured engine's greedy tokens and degree history equal the
    eager engine's on the same traffic (short prompts through the buckets
    and pack, long ones through the chunks or the exact path), with the QoS
    rung moving between replays — the global ladder or a plan's per-site
    rungs — and the rung operand copied into the graphs' degree buffer."""
    from repro_torch.core.dynamic import QoSController

    arch = "h2o-danube-1.8b-smoke" if kind == "ring" else "tinyllama-1.1b-smoke"
    m, params = _smoke_lm(hopper, arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, m.cfg.vocab, int(n)) for n in (5, 40, 9, 3, 30, 12, 50)]
    kw = {}
    if plan:
        kw = lambda: dict(plan=_mixed_plan(m.cfg), qos=QoSController(
            ladder=[], low_water=0.25, high_water=0.75, cooldown_steps=2))
    runs = {}
    for capture in (False, True):
        eng = _capture_engine(m, params, capture, kind, **(kw() if plan else {}))
        assert (eng.graphs is not None) == capture
        runs[capture] = _serve(eng, prompts)
        if capture:
            c = eng.graphs.graphs[eng._step_key]
            assert c.replays == eng.stats.decode_steps > 0
            assert eng.workload.trace_counts["step"] == 1
    assert runs[True] == runs[False]
    assert len(set(map(tuple, map(np.atleast_1d, runs[True][1])))) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_gpu_captured_moe_engine_tokens_equal_eager(hopper, kind):
    """granite-moe-3b-a800m-smoke served captured (one graph for the decode
    step: the routing reads nothing on the host) and eagerly: the same
    greedy tokens and degree history, with the QoS rung moving; admission
    stays exact-length (the engine drops the buckets it was asked for)."""
    m, params = _smoke_lm(hopper, "granite-moe-3b-a800m-smoke")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, m.cfg.vocab, int(n)) for n in (5, 40, 9, 3, 30, 12, 50)]
    runs = {}
    before = dict(_build.launches)
    plain_before = dict(_build.plain_cuda_calls)
    for capture in (False, True):
        eng = _capture_engine(m, params, capture, kind)
        assert eng.workload.admission is None
        runs[capture] = _serve(eng, prompts)
        if capture:
            assert eng.graphs.graphs[eng._step_key].replays == eng.stats.decode_steps > 0
            assert eng.workload.trace_counts["step"] == 1
    assert runs[True] == runs[False]
    assert len(set(map(tuple, map(np.atleast_1d, runs[True][1])))) > 1
    for name in ("axqmm_experts", "axqmm_gated_experts"):
        assert _build.launches[name] > before[name]
    assert _build.plain_cuda_calls == plain_before


@pytest.mark.gpu
def test_gpu_captured_sampling_is_reproducible_from_the_seed(hopper):
    """Top-k sampling from the engine's generator, registered with the
    step's graph: two captured runs from one seed give the same tokens.
    Whether they equal the eager run's is printed, not asserted."""
    from repro_torch.serve.lm import ServeEngine

    m, params = _smoke_lm(hopper)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.cfg.vocab, int(n)) for n in (5, 9, 12)]

    def run(capture):
        eng = ServeEngine(m, params, slots=2, max_len=64, prepack=False, seed=9,
                          greedy=False, top_k=8, temperature=0.8, capture=capture)
        return _serve(eng, prompts, 8)[0]

    a, b = run(True), run(True)
    assert a == b
    print(f"captured sampling equals the eager run: {a == run(False)}")


@pytest.mark.gpu
def test_gpu_captured_stream_frames_equal_eager(hopper):
    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.stream import StreamServeEngine, make_clip

    clips = [make_clip(3 + i % 4, 256, seed=i) for i in range(10)]
    runs = {}
    for capture in (False, True):
        qos = QoSController(ladder=[{"degrees": [e] * 3} for e in (8, 7, 6, 5)],
                            low_water=0.25, high_water=0.75, cooldown_steps=2)
        eng = StreamServeEngine(slots=4, device=hopper, qos=qos, capture=capture)
        reqs = [eng.submit(c) for c in clips]
        eng.run_until_drained()
        runs[capture] = ([np.stack(r.out) for r in reqs],
                         [tuple(d) for _, d in eng.stats.degree_history])
    assert runs[True][1] == runs[False][1] and len(set(runs[True][1])) > 1
    for x, y in zip(runs[True][0], runs[False][0]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_gpu_capture_leaves_live_state_bit_identical(hopper, kind):
    """Capturing the buckets, the chunk and the step against a live cache
    (slots mid-request) changes no byte of it: a capture executes nothing,
    and the warm-ups run dummy rows or a scratch copy."""
    m, params = _smoke_lm(hopper)
    from repro_torch.serve.admission import AdmissionConfig
    from repro_torch.serve.lm import ServeEngine
    import os

    os.environ["REPRO_KV_INT8"] = "1" if kind == "int8" else "0"
    try:
        eng = ServeEngine(m, params, slots=3, max_len=64, prepack=False, seed=11,
                          emitter=False, capture=True,
                          admission=AdmissionConfig(pack=2, chunk_tokens=16, warmup=False))
    finally:
        os.environ.pop("REPRO_KV_INT8")
    rng = np.random.default_rng(4)
    for n in (5, 9, 12):
        eng.submit(rng.integers(0, m.cfg.vocab, n), 8)
    for _ in range(3):
        eng.tick()
    torch.cuda.synchronize()
    before = [t.clone() for t in eng.cache]
    shapes = len(eng.graphs.graphs)
    eng._warmup()                                      # captures the other buckets
    del eng.graphs.graphs[eng._step_key]
    eng._capture_step()                                # and the step again
    torch.cuda.synchronize()
    assert len(eng.graphs.graphs) > shapes
    for a, b in zip(before, eng.cache):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["lm", "stream"])
def test_gpu_replay_runs_clean_under_sync_debug_mode(hopper, workload):
    """Staging the tick's inputs and replaying the step's graph makes no
    synchronizing call (``set_sync_debug_mode("error")`` raises on one)."""
    if workload == "lm":
        m, params = _smoke_lm(hopper)
        eng = _capture_engine(m, params, True, "bf16")
        eng.submit(np.arange(1, 9), 4)
    else:
        from repro_torch.serve.stream import StreamServeEngine, make_clip

        eng = StreamServeEngine(slots=2, device=hopper, capture=True)
        eng.submit(make_clip(4, 256))
    eng.tick()
    mask = np.array([s is not None for s in eng.slot_req])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.graphs.run(eng._step_key, {"feed": eng._feed, "active": mask})
        eng.graphs.run(eng._step_key, {"feed": eng._feed, "active": mask})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_capture_failure_raises_and_never_serves_eagerly(hopper, monkeypatch):
    """A step that reads a value on the host cannot be captured: the
    engine's construction raises with the call shape in the message."""
    from repro_torch.serve import lm as tlm

    m, params = _smoke_lm(hopper)
    step = tlm.LMAdapter.step

    def host_reading_step(self, *a, **kw):
        nxt, cache = step(self, *a, **kw)
        return nxt + int(nxt.sum()) * 0, cache

    monkeypatch.setattr(tlm.LMAdapter, "step", host_reading_step)
    with pytest.raises(RuntimeError, match=r"capture of call shape \('step'"):
        tlm.ServeEngine(m, params, slots=2, max_len=64, prepack=False)
    eng = tlm.ServeEngine(m, params, slots=2, max_len=64, prepack=False, capture=False)
    assert eng.graphs is None


@pytest.mark.gpu
def test_gpu_replay_launches_what_its_capture_recorded(hopper):
    """One replay of the step's graph runs, under the profiler, the same
    compute kernels as one eager step (copies aside), and the hand-written
    ones among them number what the graph set recorded at capture (the
    counts each replay adds)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    m, params = _smoke_lm(hopper)
    eng = _capture_engine(m, params, True, "bf16")
    c = eng.graphs.graphs[eng._step_key]
    L = m.cfg.n_layers
    assert c.delta[0] == {"axqmm": 5 * L + 1, "axqmm_gated": L, "flash_decode": L}
    assert c.delta[1] == {} and c.delta[2] == {}
    mask = np.ones(3, bool)

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not any(w in e.name.lower() for w in ("copy", "memcpy", "memset")))

    eng.graphs.stage(eng._step_key, {"feed": eng._feed, "active": mask})
    replayed = kernels(lambda: eng.graphs.replay(eng._step_key))
    feed = torch.from_numpy(eng._feed).to(hopper)
    active = torch.from_numpy(mask).to(hopper)
    scratch = type(eng.state)(*(t.clone() for t in eng.state))
    gen = torch.Generator(device=hopper).manual_seed(0)
    eager = kernels(lambda: eng.workload.step(eng.params, scratch, feed, active, gen,
                                              eng._degree))
    gemm = r"axq_(decode|tile|wgmma)_kernel"
    attn = r"(?<!axq_)decode_kernel"
    n = lambda names, pat: sum(bool(re.search(pat, k)) for k in names)
    assert n(replayed, gemm) == (5 * L + 1) + L
    assert n(replayed, attn) == L
    assert replayed == eager


# ---------------------------------------------------------------------------
# the EMUL / POW2_W products and the resilience layer on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pr_emul", "rad_emul", "roup_emul", "pow2_w"])
def test_gpu_emul_products_match_cpu(hopper, mode):
    """``approx_matmul`` under each emulation mode on the card (the integer
    product by ``torch._int_mm``, M <= 16 padded to 32 rows) gives the CPU's
    output bit for bit, packed and on the fly, eagerly and replayed from a
    CUDA graph; POW2_W's snapped weights equal the CPU snap (its product is
    an f32 GEMM, held to 1e-5)."""
    from repro_torch.core import encodings as enc
    from repro_torch.core.approx import ApproxMode, ApproxSpec
    from repro_torch.kernels import ops, qstore

    kw = {"pr_emul": dict(p=1, r=2), "rad_emul": dict(k=4),
          "roup_emul": dict(k=4, p=1, r=1), "pow2_w": {}}[mode]
    spec = ApproxSpec(mode=ApproxMode(mode), **kw)
    g = torch.Generator().manual_seed(5)
    K, N = 256, 200
    w = torch.randn(K, N, generator=g) / math.sqrt(K)
    for M in (1, 8, 255):
        x = torch.randn(M, K, generator=g)
        for packed in ((False, True) if mode != "pow2_w" else (False,)):
            wc = qstore.pack_for_spec(w, spec) if packed else w
            wg = (qstore.PackedEmulWeight(wc.qw.to(hopper), wc.scale.to(hopper))
                  if packed else w.to(hopper))
            if packed:
                assert wg.qw.stride() == (1, K)
            want = ops.approx_matmul(x, wc, spec)
            xg = x.to(hopper)
            got = ops.approx_matmul(xg, wg, spec)
            if mode == "pow2_w":
                torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-5)
                assert torch.equal(enc.pow2_snap(w.to(hopper)).cpu(), enc.pow2_snap(w))
                continue
            assert torch.equal(got.cpu(), want), (M, packed)
            graph = torch.cuda.CUDAGraph()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                ops.approx_matmul(xg, wg, spec)
            torch.cuda.current_stream().wait_stream(s)
            with torch.cuda.graph(graph):
                out = ops.approx_matmul(xg, wg, spec)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want), (M, packed, "graph")


@pytest.mark.gpu
def test_gpu_guarded_step_captured_and_flip_reaches_the_replay(hopper):
    """Under guards the captured step is the guarded one (the fault vector a
    static input, the ok bits packed into the one pinned read).  An
    in-place flip of the unembedding's first scale (bit 30) at tick 2
    reaches that tick's replay: its ok bits fall (the trip is logged when
    that step's tick has counted, one past the injection's), the slots are quarantined
    and retried, the scrub restores the parameters byte for byte, and the
    tokens equal a clean captured run's and the eager twin's; no graph is
    captured after warmup."""
    from repro_torch.resil import FaultEvent, FaultPlan, GuardConfig
    from repro_torch.resil.faults import tree_leaves
    from repro_torch.serve.lm import ServeEngine

    m, params = _smoke_lm(hopper)
    target = next(i for i, t in enumerate(tree_leaves(params))
                  if t is params["unembed"]["w"].scales)
    prompts = [np.arange(1, 9), np.arange(3, 8)]

    def run(faults=None, capture=True, guards=None):
        eng = ServeEngine(m, params, slots=2, max_len=64, prepack=False, seed=0,
                          emitter=False, capture=capture, faults=faults, guards=guards)
        n = None if eng.graphs is None else len(eng.graphs.graphs)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run_until_drained()
        assert n is None or len(eng.graphs.graphs) == n
        return eng, [r.out_tokens for r in reqs]

    flip = lambda: FaultPlan(events=[FaultEvent(tick=2, kind="seu_param", leaf=target,
                                                target=str(target), index=0, bit=30)])
    clean, clean_tokens = run(guards=GuardConfig())
    c = clean.graphs.graphs[clean._step_key]
    assert set(c.inputs) == {"feed", "active", "fault"} and clean.resil_log == []
    assert tuple(clean._out_pin.shape) == (2, 2)          # one token + the ok bit a slot
    eng, tokens = run(faults=flip())
    names = [n for _, n, _ in eng.resil_log]
    assert names[:2] == ["fault_injected", "guard_tripped"]
    assert (eng.resil_log[0][0], eng.resil_log[1][0]) == (2, 3)
    assert "param_scrub" in names and "retry" in names
    assert eng.params_golden() and tokens == clean_tokens
    eager, eager_tokens = run(faults=flip(), capture=False)
    assert eager.resil_log == eng.resil_log and eager_tokens == tokens


# ---------------------------------------------------------------------------
# head_dim 256 and the recurrent families (recurrentgemma-2b, mamba2-370m)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("S", [7, 129, 1000])
def test_gpu_flash_head256_mqa_matches_plain(hopper, S, dtype):
    """Both bodies at D = 256 with recurrentgemma's MQA (10 query heads on
    one kv head): ``tri`` == ``dense`` and ``band`` == ``dense`` under the
    same window (300, cutting inside a block) bit for bit, the in-kernel
    step count == ``planned_grid_steps``, the grouped entry == the flat one;
    within atol 1/64 (bf16 body) or rtol 1e-5 / atol 1e-4 (f32 body) of the
    plain version."""
    g = torch.Generator(device=hopper).manual_seed(256 + S)
    B, H, D = 1, 10, 256
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(B, S, H, D, generator=g, device=hopper).to(dt)
    k = torch.randn(B, S, 1, D, generator=g, device=hopper).to(dt)
    v = torch.randn(B, S, 1, D, generator=g, device=hopper).to(dt)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    qf, kf, vf = flat(q), flat(k.repeat_interleave(H, 2)), flat(v.repeat_interleave(H, 2))
    for window in (None, 300):
        out, steps = tfa.flash_attention(qf, kf, vf, causal=True, window=window,
                                         return_steps=True)
        dense = tfa.flash_attention(qf, kf, vf, causal=True, window=window, skip_grid=False)
        og = tfa.flash_attention_grouped(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert torch.equal(out, dense) and torch.equal(flat(og), out)
        assert int(steps) == tfa.planned_grid_steps(B * H, S, window=window)
        ref, _ = tfa.flash_attention_plain(qf, kf, vf, causal=True, window=window)
        if dtype == "bf16":
            torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1 / 64)
        else:
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [10, 4])
def test_gpu_decode_head256_split_edges_match_plain(hopper, G):
    """The decode kernel at D = 256 on f32 and bf16 caches, one kv head
    with recurrentgemma's group of 10 (two 8-row P.V blocks, the second
    ragged) and a group of 4, at lengths W - 1, W, W + 1, 2 W and T of the
    split width on a T = 2 W + 37 cache, a freed slot of exact zeros,
    within 1e-4 of the plain version; one launch a call."""
    D = 256
    W = tfd.split_width(D)
    T = 2 * W + 37
    g = torch.Generator(device=hopper).manual_seed(G)
    nv = torch.tensor([W - 1, W, W + 1, 2 * W, T, 5], dtype=torch.int32, device=hopper)
    act = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.int32, device=hopper)
    B = nv.numel()
    qg = torch.randn(B, 1, G, D, generator=g, device=hopper)
    k = torch.randn(B, T, 1, D, generator=g, device=hopper)
    v = torch.randn(B, T, 1, D, generator=g, device=hopper)
    for kv in ((k, v), (k.bfloat16(), v.bfloat16())):
        before = _build.launches["flash_decode"]
        o = tfd.flash_decode(qg, *kv, nv, act)
        torch.cuda.synchronize()
        assert _build.launches["flash_decode"] == before + 1
        torch.testing.assert_close(o, tfd.flash_decode_plain(qg, *kv, nv, act),
                                   rtol=1e-4, atol=1e-4)
        assert (o[5] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 255])
@pytest.mark.parametrize("N,K,gated,act", [
    (4384, 1024, False, None), (50280, 1024, False, None), (1024, 2048, False, None),
    (256, 2560, False, None), (256000, 2560, False, None), (7680, 2560, True, "gelu")],
    ids=["mamba-in_proj", "mamba-unembed", "mamba-out_proj", "rg-wk", "rg-unembed",
         "rg-gated-gelu"])
def test_gpu_recurrent_gemm_shapes_are_bit_identical(hopper, M, N, K, gated, act):
    """The GEMMs at the recurrent families' shapes (an N that is no
    multiple of 64, the 256000-wide unembedding, the gelu gated half), at
    degree 6 read from a device-vector element: bit for bit their plain
    versions."""
    g = torch.Generator(device=hopper).manual_seed(N + M)
    x = torch.randn(M, K, generator=g, device=hopper)
    pw = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 256)
    e = torch.tensor([8, 6], dtype=torch.int32, device=hopper)[1]
    if gated:
        pg = tprepack(torch.randn(K, N, generator=g, device=hopper) / math.sqrt(K), 256)
        y = taxq.axqmm_gated_packed(x, pw, pg, e, act=act)
        yp = taxq.axqmm_gated_plain(x, pw, pg, e, act=act)
    else:
        y = taxq.axqmm_packed(x, pw, e)
        yp = taxq.axqmm_packed_plain(x, pw, e)
    torch.cuda.synchronize()
    assert torch.equal(y, yp)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "recurrentgemma-2b-smoke"])
def test_gpu_captured_recurrent_engine_tokens_equal_eager(hopper, arch):
    """The recurrent families served captured (the decode step and each
    bucket's prefill from CUDA graphs, the state advanced in place) and
    eagerly: the same greedy tokens and degree history, with the QoS rung
    moving; prompts past the ladder (and the hybrid's window of 32) take
    the exact path; the chunk size asked for is not taken; their kernels
    launched, no plain version on the card."""
    m, params = _smoke_lm(hopper, arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, m.cfg.vocab, int(n)) for n in (5, 40, 9, 3, 30, 12, 70)]
    runs = {}
    before = dict(_build.launches)
    plain_before = dict(_build.plain_cuda_calls)
    for capture in (False, True):
        eng = _capture_engine(m, params, capture, "bf16")
        assert not eng.workload._chunk_ok
        runs[capture] = _serve(eng, prompts)
        if capture:
            assert eng.graphs.graphs[eng._step_key].replays == eng.stats.decode_steps > 0
            assert eng.workload.trace_counts["step"] == 1
            assert eng.workload.trace_counts["prefill_chunk"] == 0
    assert runs[True] == runs[False]
    assert len(set(map(tuple, map(np.atleast_1d, runs[True][1])))) > 1
    names = ("axqmm",) if arch.startswith("mamba") else (
        "axqmm", "axqmm_gated", "flash_decode", "flash_attention")
    for name in names:
        assert _build.launches[name] > before[name], name
    assert _build.plain_cuda_calls == plain_before
