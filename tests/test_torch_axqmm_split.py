"""The axqmm kernels' split-K scheme and word-wide degrade, pinned on the CPU.

``csrc/axqmm.cu`` takes the int32 dot of each quantization block on the
int8 tensor cores; at decode it splits K across blocks at quantization-
block edges (or at exact parts of a block, ``part``), each split writing
its int32 sums per unit to a scratch, and a second kernel adds a block's
units, folds the scaled blocks in order and applies the bias / residual /
gate epilogue.  The CUDA kernels run only on the card, so this file writes
the same scheme in plain torch (``split_axqmm``; not part of the port's
path) and holds it bit for bit to the plain versions (``qmm_packed_ref`` /
``qmm_gated_packed_ref``) at split counts 1, 2, nb and one that does not
divide nb, nb = 43, M 1 / 8 / 255, ragged N, ebits 8 / 6 / 5, and within
the reference's kernel tolerance to the JAX ``axqmm_packed`` /
``axqmm_gated_packed`` in interpret mode.  It checks the plain-torch model
of the kernels' word-wide degrade against ``degrade`` for every byte at
every shift, the split plan (every decode projection of tinyllama-1.1b,
h2o-danube-1.8b and qwen2.5-3b launches at least one block an SM), and
drives the wrappers' launch path on ``meta`` tensors (no card here): the
plan and scratch they hand the kernel, and a quantization block they
refuse before any launch, with no fallback to the plain versions.

Tolerance: bit-identical against the plain versions (int32 block sums are
exact in any order, and the f32 fold keeps the plain version's order);
rtol 1e-5 / atol 1e-4 against JAX (tests/test_torch_kernels.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import axqmm as jaxq
from repro.kernels.qstore import prepack_weight as jprepack
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import (degrade, qmm_gated_packed_ref, qmm_packed_ref,
                                           quantize_block)
from repro_torch.kernels import _build
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels.qstore import PackedQWeight

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4
SMS = 132        # an H100 SXM's streaming multiprocessors


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _packed(w: np.ndarray, block: int):
    jp = jprepack(jnp.asarray(w), block)
    return jp, params_from_numpy(jax.tree.map(np.asarray, {"w": jp}))["w"]


# ---------------------------------------------------------------------------
# the scheme in plain torch
# ---------------------------------------------------------------------------


def degrade_words(w: torch.Tensor, shift: int) -> torch.Tensor:
    """The kernels' word-wide degrade (common.cuh ``Degrade``) of 32-bit
    words holding four int8 codes, in int64 arithmetic modulo 2^32; shift 0
    is the kernels' fast path, which leaves the codes as they are."""
    if shift == 0:
        return w
    m32 = 0xFFFFFFFF
    half4 = (1 << (shift - 1)) * 0x01010101 if shift < 8 else 0
    mask4 = ((0xFF << shift) & 0xFF) * 0x01010101 if shift < 8 else 0
    sign4 = 0x80808080 if shift < 8 else 0
    sgn = w & sign4
    d = (((w & 0x7F7F7F7F) + half4) & mask4) ^ sgn
    t = ((d & 0x7F7F7F7F) + 0x7F7F7F7F) & m32
    z = d & (~t & m32) & 0x80808080
    return (d - (z >> 7) + ((z & sgn) >> 6)) & m32


def _words(q: torch.Tensor) -> torch.Tensor:
    """int8 (..., 4k) -> its little-endian 32-bit words (..., k) as int64."""
    b = q.to(torch.int64) & 0xFF
    b = b.reshape(*q.shape[:-1], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _codes(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_words`."""
    b = torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    b = torch.where(b > 127, b - 256, b)
    return b.reshape(*w.shape[:-1], -1).to(torch.int8)


def degrade_codes(q: torch.Tensor, ebits: int) -> torch.Tensor:
    return _codes(degrade_words(_words(q), min(max(8 - ebits, 0), 8)))


def split_units(x: torch.Tensor, pws, ebits: int, n_split: int, part: int):
    """The split kernel's scratch: int32 sums (G, nb * part, M, N), written
    split by split over the units [s U / S, (s + 1) U / S), and the
    activation scales."""
    M, K = x.shape
    bk = pws[0].block
    nb, units, ub = K // bk, (K // bk) * part, bk // part
    qx = quantize_block(x.to(torch.float32), bk)
    vx = degrade_codes(qx.values, ebits).to(torch.int64)
    scratch = torch.empty((len(pws), units, M, pws[0].n), dtype=torch.int32)
    written = []
    for gi, pw in enumerate(pws):
        vw = degrade_codes(pw.qw, ebits).to(torch.int64)
        for s in range(n_split):
            for u in range(s * units // n_split, (s + 1) * units // n_split):
                k = slice(u * ub, (u + 1) * ub)
                scratch[gi, u] = (vx[:, k] @ vw[:, k].T).to(torch.int32)
                written.append((gi, u))
    assert sorted(written) == [(gi, u) for gi in range(len(pws)) for u in range(units)]
    return scratch, qx.scales


def combine(scratch, sx, pws, part: int, *, bias=None, residual=None, act=None):
    """The combine kernel: a block's parts summed in int32, the blocks
    scaled and folded in order from 0 in f32, then the epilogue."""
    G, units = scratch.shape[:2]
    nb = units // part
    f = []
    for gi in range(G):
        acc = torch.zeros(scratch.shape[2:], dtype=torch.float32)
        for kb in range(nb):
            s = scratch[gi, kb * part:(kb + 1) * part].sum(0, dtype=torch.int32)
            acc = acc + s.to(torch.float32) * (sx[:, kb, None] * pws[gi].scales[None, :, kb])
        f.append(acc)
    if act is not None:
        return act(f[1]) * f[0]
    y = f[0]
    if bias is not None:
        y = y + bias[None, :]
    if residual is not None:
        y = y + residual
    return y


def split_axqmm(x, pws, ebits, n_split, part=1, **epilogue):
    scratch, sx = split_units(x, pws, ebits, n_split, part)
    return combine(scratch, sx, pws, part, **epilogue)


def _pack(rng, K, N, bk):
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    qt = quantize_block(torch.from_numpy(w).T.contiguous(), bk)
    return w, PackedQWeight(qt.values.contiguous(), qt.scales.contiguous())


# ---------------------------------------------------------------------------
# the degrade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ebits", list(range(0, 9)))
def test_word_degrade_matches_degrade_on_every_code(ebits):
    """All 256 codes, in every byte position of a word, at shift 0..8."""
    codes = torch.arange(-128, 128, dtype=torch.int64).to(torch.int8)
    for rot in range(4):
        q = codes.roll(rot).reshape(64, 4)
        got = degrade_codes(q.reshape(-1), ebits).reshape(64, 4)
        if ebits == 8:
            assert torch.equal(got, q)        # the fast path: the codes as they are
        else:
            assert torch.equal(got, degrade(q, ebits)), (ebits, rot)


def test_word_degrade_saturates_at_both_edges():
    """+127 at shift 7 rounds to +128 and clamps to +127; -128 rounds to
    -128 and clamps to -127; a neighbour's byte is untouched."""
    q = torch.tensor([127, -128, 0, 1], dtype=torch.int8)
    assert degrade_codes(q, 1).tolist() == [127, -127, 0, 0]
    assert degrade_codes(q, 7).tolist() == [127, -127, 0, 2]


# ---------------------------------------------------------------------------
# the split scheme against the plain versions (bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 8, 255])
@pytest.mark.parametrize("n_split", [1, 2, 43, 5])
def test_split_scheme_is_the_plain_version_bit_for_bit(M, n_split):
    """nb = 43 (K = 11008 = qwen2.5-3b's down projection, bk 256), ragged
    N = 37, bias and residual; splits 1, 2, nb and 5 (no divisor of 43)."""
    rng = np.random.default_rng(M + n_split)
    K, N, bk = 11008, 37, 256
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    _, pw = _pack(rng, K, N, bk)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32))
    for e in (8, 6, 5):
        want = taxq.axqmm_packed_plain(x, pw, e, bias=b, residual=r)
        got = split_axqmm(x, [pw], e, n_split, bias=b, residual=r)
        assert torch.equal(got, want), (e, float((got - want).abs().max()))


@pytest.mark.parametrize("part", [2, 4])
@pytest.mark.parametrize("n_split", [3, 7, 32])
def test_parts_of_a_block_are_exact(part, n_split):
    """Splits inside quantization blocks (decode of a narrow projection):
    the parts' int32 sums add to the block's, whatever the split edges."""
    rng = np.random.default_rng(part * n_split)
    M, K, N, bk = 8, 2048, 21, 256
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    _, pw = _pack(rng, K, N, bk)
    for e in (8, 5):
        want = qmm_packed_ref(x, pw.qw, pw.scales, e)
        assert torch.equal(split_axqmm(x, [pw], e, n_split, part), want)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("M,n_split", [(1, 8), (8, 3), (255, 1)])
def test_gated_split_scheme_is_the_plain_version_bit_for_bit(act, M, n_split):
    rng = np.random.default_rng(M + n_split + len(act))
    K, N, bk = 2048, 200, 256
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    _, pu = _pack(rng, K, N, bk)
    _, pg = _pack(rng, K, N, bk)
    for e in (8, 6, 5):
        want = qmm_gated_packed_ref(x, pu.qw, pu.scales, pg.qw, pg.scales,
                                    taxq.ACTS[act], e)
        got = split_axqmm(x, [pu, pg], e, n_split, act=taxq.ACTS[act])
        assert torch.equal(got, want), (act, e)


def test_a_slot_gets_the_same_bits_in_any_batch():
    """A row's output depends on that row alone: the same bits at M = 1, 8
    and 255 and at every split count."""
    rng = np.random.default_rng(3)
    K, N, bk = 2560, 64, 256
    x = torch.from_numpy(rng.standard_normal((255, K)).astype(np.float32))
    _, pw = _pack(rng, K, N, bk)
    first = split_axqmm(x[:1], [pw], 6, 1)[0]
    for M, n_split in ((8, 10), (255, 3), (255, 10)):
        assert torch.equal(split_axqmm(x[:M], [pw], 6, n_split)[0], first)


# ---------------------------------------------------------------------------
# against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ebits,n_split", [(8, 2), (6, 5), (5, 43)])
def test_split_scheme_matches_pallas(ebits, n_split):
    rng = np.random.default_rng(10 + ebits)
    M, K, N = 8, 11008, 40
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    jp, tp = _packed(w, 256)
    yj = jaxq.axqmm_packed(jnp.asarray(x), jp, ebits, residual=jnp.asarray(r),
                           interpret=True)
    yt = split_axqmm(_t(x), [tp], ebits, n_split, residual=_t(r))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M,n_split,part", [(1, 16, 2), (8, 3, 1)])
def test_gated_split_scheme_matches_pallas(M, n_split, part):
    rng = np.random.default_rng(20 + M)
    K, N = 2048, 72
    x = rng.standard_normal((M, K)).astype(np.float32)
    wu = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    wg = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    ju, tu = _packed(wu, 256)
    jg, tg = _packed(wg, 256)
    yj = jaxq.axqmm_gated_packed(jnp.asarray(x), ju, jg, 5, act="silu", interpret=True)
    yt = split_axqmm(_t(x), [tu, tg], 5, n_split, part, act=F.silu)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _projections(name):
    """(N, K, gated) of every GEMM of one decode step of ``name``."""
    c = get_config(name)
    d, qd, kvd = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [(qd, d, False), (kvd, d, False), (d, qd, False), (d, c.d_ff, False),
            (c.d_ff, d, True), (c.vocab, d, False)]


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "h2o-danube-1.8b", "qwen2.5-3b"])
@pytest.mark.parametrize("M", [1, 8, 16])
def test_every_decode_projection_fills_the_card(name, M):
    """At decode every projection launches at least one block an SM; a
    split plan stays inside the scratch cap and splits at most into the
    units there are."""
    for N, K, gated in _projections(name):
        bk = 256
        p = taxq.plan(M, N, K, bk, gated, SMS)
        assert p.cfg == taxq.DECODE
        assert taxq.blocks(p, M, N, gated) >= SMS, (name, N, K, p)
        assert 1 <= p.n_split <= (K // bk) * p.part
        assert (bk // p.part) % taxq.KERNEL_KC == 0
        assert p.n_split > 1 or p.part == 1
        assert taxq._scratch_bytes(M, N, K // bk * p.part, gated) <= taxq.SCRATCH_MAX_BYTES \
            or p.n_split == 1


def test_prefill_plan_takes_large_tiles_when_they_fill_the_card():
    assert taxq.plan(4096, 11008, 2048, 256, True, SMS) == taxq.Plan(taxq.TILE_LARGE)
    assert taxq.plan(4096, 2048, 11008, 256, False, SMS) == taxq.Plan(taxq.TILE_LARGE)
    p = taxq.plan(255, 256, 2048, 256, False, SMS)    # 16 small tiles: split K
    assert p.cfg == taxq.TILE_SMALL and p.n_split > 1 and p.part == 1
    assert taxq.plan(255, 2560, 6912, 256, False, SMS) == taxq.Plan(taxq.TILE_SMALL)
    # the wgmma tiles step 128 bytes of K: a 64-byte block keeps the 64-row tiles
    assert taxq.plan(4096, 2048, 1024, 64, False, SMS) == taxq.Plan(taxq.TILE_SMALL)


# ---------------------------------------------------------------------------
# the wrappers' launch path (meta tensors: no card here)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on ``meta`` tensors: the sm_90 check
    passes, the card has 132 SMs, the launchers record their calls, every
    scratch handed out is recorded, and the plain versions raise if
    anything falls back to them."""
    calls, scratches = [], []

    def entry(fn):
        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def no_fallback(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    real_scratch = taxq._scratch

    def scratch(*a, **kw):
        s = real_scratch(*a, **kw)
        scratches.append(s)
        return s

    monkeypatch.setattr(_build, "require_sm90", lambda t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda t: SMS)
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(taxq, "_scratch", scratch)
    for name in ("axqmm_packed_plain", "axqmm_gated_plain", "qmm_packed_ref",
                 "qmm_gated_packed_ref"):
        monkeypatch.setattr(taxq, name, no_fallback)
    return calls, scratches


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_pack(N, K, bk):
    return PackedQWeight(_meta(N, K, dtype=torch.int8), _meta(N, K // bk))


@pytest.mark.parametrize("M,N,K", [(8, 2048, 11008), (8, 256, 2048), (8, 151936, 2048),
                                   (255, 2560, 6912), (4096, 2048, 11008)])
def test_axqmm_wrapper_hands_the_kernel_its_plan_and_scratch(fake_card, M, N, K):
    """One launch with (M, N, K, bk, cfg, n_split, part) after the nine
    pointers; a split plan gets an int32 scratch of (1, nb * part, M, N), a
    long prefill on 128-row tiles an int8 one for x and the weight, the
    others none."""
    calls, scratches = fake_card
    bk = 256
    before = dict(_build.launches)
    out = taxq.axqmm_quantized(_meta(M, K, dtype=torch.int8), _meta(M, K // bk),
                               _meta_pack(N, K, bk), 5, residual=_meta(M, N))
    assert out.shape == (M, N) and out.dtype == torch.float32
    p = taxq.plan(M, N, K, bk, False, SMS)
    (fn, args), = calls
    assert fn == "axqmm_launch"
    assert args[9:16] == (M, N, K, bk, *p)
    (s,) = scratches
    if p.n_split > 1:
        assert s.shape == (1, K // bk * p.part, M, N) and s.dtype == torch.int32
    elif p.cfg == taxq.TILE_LARGE and M >= taxq.PREDEGRADE_M:
        assert s.shape == ((M + N) * K,) and s.dtype == torch.int8
    else:
        assert s is None and args[8] is None
    assert _build.launches["axqmm"] == before["axqmm"] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1


def test_gated_wrapper_hands_the_kernel_a_two_plane_scratch(fake_card):
    """A narrow gated projection at decode (1024 columns: 64 tiles) splits
    K, with one plane set for up and one for gate."""
    calls, scratches = fake_card
    M, N, K, bk = 8, 1024, 2560, 256
    out = taxq.axqmm_gated_quantized(_meta(M, K, dtype=torch.int8), _meta(M, K // bk),
                                     _meta_pack(N, K, bk), _meta_pack(N, K, bk), 6,
                                     act="gelu")
    assert out.shape == (M, N)
    p = taxq.plan(M, N, K, bk, True, SMS)
    assert p.n_split > 1
    (fn, args), = calls
    assert fn == "axqmm_gated_launch"
    assert args[9:17] == (M, N, K, bk, 1, *p)
    assert scratches[0].shape == (2, K // bk * p.part, M, N)


@pytest.mark.parametrize("bk", [32, 96])
def test_unsupported_block_raises_without_fallback(fake_card, bk):
    """A quantization block that is no multiple of the kernels' 64-byte
    step raises before any launch, on both wrappers."""
    calls, _ = fake_card
    M, N, K = 8, 64, 384
    before = dict(_build.launches)
    qx, sx = _meta(M, K, dtype=torch.int8), _meta(M, K // bk)
    with pytest.raises(ValueError, match="multiple of 64"):
        taxq.axqmm_quantized(qx, sx, _meta_pack(N, K, bk), 8)
    with pytest.raises(ValueError, match="multiple of 64"):
        taxq.axqmm_gated_quantized(qx, sx, _meta_pack(N, K, bk), _meta_pack(N, K, bk), 8)
    assert calls == []
    assert _build.launches == before
