"""The decode kernels' split-and-combine arithmetic, pinned on the CPU.

``csrc/flash_decode.cu`` cuts each slot's cache into splits of W rows at
absolute positions, walks each split in 32-row tiles with an online
softmax, writes an f32 partial (m, l, acc) per split and merges the
partials in split order; on the int8 cache it degrades the codes, applies
the K scale to the score and the V scale to the probability.  The CUDA
kernel runs only on the card, so this file writes the same scheme in plain
torch (``split_decode``; not part of the port's path) and holds it against
the JAX Pallas ``flash_decode`` / ``flash_decode_quant`` in interpret mode
and against the port's plain versions: lengths on split edges, a cache
capacity that is no multiple of W, free slots, a wrapped ring, ebits 8
and 5.  It also drives the wrappers' launch path on ``meta`` tensors (no
card here): the scratch they hand the kernel, and the head dims they
refuse before any launch, with no fallback to the plain versions.

Tolerance: 1e-5 absolute in f32 (the reference's kernel-vs-jnp tolerance
for the int8 cache, tests/test_torch_kvq.py; the f32 partial sums differ
from one softmax over the whole cache only in rounding order)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro_torch.core.quantization import degrade
from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models.attention import KVCache, QuantKVCache, write_token

torch.set_num_threads(2)

ATOL = 1e-5
NEG_INF = -1e30
BT = 32          # the kernels' tile rows


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the scheme in plain torch
# ---------------------------------------------------------------------------


def _split_partial(q, k, v, t0, t1, ks=None, vs=None):
    """(m, l, acc) of rows [t0, t1) of one (slot, kv head): q (G, D) scaled,
    k/v (T, D) f32, walked in BT-row tiles with the online softmax."""
    G, D = q.shape
    m = torch.full((G,), NEG_INF)
    l = torch.zeros(G)
    acc = torch.zeros(G, D)
    for a in range(t0, t1, BT):
        e = min(a + BT, t1)
        s = q @ k[a:e].T
        if ks is not None:
            s = s * ks[a:e]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new[:, None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = p * vs[a:e] if vs is not None else p
        acc = acc * corr[:, None] + pv @ v[a:e]
        m = m_new
    return m, l, acc


def _combine(parts):
    """Merge the splits' partials in split order."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    O = torch.zeros_like(parts[0][2])
    L = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        O = O + acc * w[:, None]
        L = L + l * w
    return O / torch.clamp(L, min=1e-30)[:, None]


def split_decode(qg, k, v, nvalid, active, W, ks=None, vs=None):
    """qg (B, KVr, G, D); k/v (B, T, KVr, D) f32 rows (the degraded int8
    codes as f32 with their scales ks/vs (B, T, KVr)); -> (B, KVr, G, D)."""
    B, KVr, G, D = qg.shape
    T = k.shape[1]
    q = qg.to(torch.float32) * (1.0 / math.sqrt(D))
    out = torch.zeros(B, KVr, G, D)
    for b in range(B):
        nv = min(max(int(nvalid[b]), 0), T) if int(active[b]) else 0
        for h in range(KVr):
            parts = [_split_partial(q[b, h], k[b, :, h], v[b, :, h], s * W,
                                    min((s + 1) * W, nv),
                                    None if ks is None else ks[b, :, h],
                                    None if vs is None else vs[b, :, h])
                     for s in range(-(-nv // W))]
            if len(parts) == 1:
                m, l, acc = parts[0]
                out[b, h] = acc / torch.clamp(l, min=1e-30)[:, None]
            elif parts:
                out[b, h] = _combine(parts)
    return out


def split_decode_quant(qg, k, ks, v, vs, nvalid, active, W, ebits):
    kf = degrade(k, ebits).to(torch.float32)
    vf = degrade(v, ebits).to(torch.float32)
    return split_decode(qg, kf, vf, nvalid, active, W, ks, vs)


# ---------------------------------------------------------------------------
# the scheme against Pallas (interpret) and the port's plain versions
# ---------------------------------------------------------------------------


def _edge_case(W):
    """Lengths W - 1, W, W + 1, 2 W, T on a cache of T = 2 W + 37 rows (no
    multiple of W or of the reference's 128-row tile), a freed slot."""
    T = 2 * W + 37
    nvalid = np.array([W - 1, W, W + 1, 2 * W, T, 5], np.int32)
    active = np.array([1, 1, 1, 1, 1, 0], np.int32)
    return T, nvalid, active


@pytest.mark.parametrize("W,D,G", [(32, 16, 4), (64, 80, 4), (64, 128, 8), (128, 64, 1)])
def test_split_scheme_matches_pallas_and_plain(W, D, G):
    rng = np.random.default_rng(W + D + G)
    T, nvalid, active = _edge_case(W)
    B, KVr = len(nvalid), 2
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    os_ = split_decode(*map(_t, (qg, k, v, nvalid, active)), W)
    oj = jfd.flash_decode(*map(jnp.asarray, (qg, k, v, nvalid, active)), interpret=True)
    op = tfd.flash_decode_plain(*map(_t, (qg, k, v, nvalid, active)))
    np.testing.assert_allclose(os_.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(os_.numpy(), op.numpy(), rtol=0, atol=ATOL)
    assert (os_[5] == 0).all()


@pytest.mark.parametrize("ebits", [8, 5])
@pytest.mark.parametrize("W,D,G", [(32, 32, 8), (64, 128, 4)])
def test_split_scheme_quant_matches_pallas_and_plain(W, D, G, ebits):
    """The int8 cache: codes degraded at ``ebits``, the K scale on the
    score and the V scale on the probability."""
    rng = np.random.default_rng(10 * W + D + ebits)
    T, nvalid, active = _edge_case(W)
    B, KVr = len(nvalid), 2
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    args = (qg, k, ks, v, vs, nvalid, active)
    e = torch.tensor([8, ebits], dtype=torch.int32)[1]
    os_ = split_decode_quant(*map(_t, args), W, e)
    oj = jfd.flash_decode_quant(*map(jnp.asarray, args), jnp.asarray([ebits], jnp.int32),
                                interpret=True)
    op = tfd.flash_decode_quant_plain(*map(_t, args), e)
    np.testing.assert_allclose(os_.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(os_.numpy(), op.numpy(), rtol=0, atol=ATOL)
    assert (os_[5] == 0).all()


def _ring(B, T, KVr, D, L, rng, quant):
    """A ring cache of T rows after L > T tokens written through
    ``write_token`` (window T), and the L tokens' K/V."""
    kt = torch.from_numpy(rng.standard_normal((L, B, 1, KVr, D)).astype(np.float32))
    vt = torch.from_numpy(rng.standard_normal((L, B, 1, KVr, D)).astype(np.float32))
    if quant:
        cache = QuantKVCache(torch.zeros(B, T, KVr, D, dtype=torch.int8),
                             torch.zeros(B, T, KVr, D, dtype=torch.int8),
                             torch.zeros(B, T, KVr), torch.zeros(B, T, KVr),
                             torch.zeros(B, dtype=torch.int32))
    else:
        cache = KVCache(torch.zeros(B, T, KVr, D), torch.zeros(B, T, KVr, D),
                        torch.zeros(B, dtype=torch.int32))
    for p in range(L):
        cache = cache._replace(length=torch.full((B,), p, dtype=torch.int32))
        write_token(cache, kt[p], vt[p], window=T)
    return cache, kt, vt


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_scheme_on_a_wrapped_ring(quant):
    """A ring of T = 100 rows after 137 tokens (every row rewritten, the
    oldest at row 37): the scheme at W = 32 over the ring equals Pallas
    and the plain version on the same cache, and (f32 cache) one softmax
    over the last T tokens in order."""
    rng = np.random.default_rng(137 + quant)
    B, T, KVr, G, D, L, W = 3, 100, 2, 4, 16, 137, 32
    cache, kt, vt = _ring(B, T, KVr, D, L, rng, quant)
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    nvalid = np.array([T, T, W + 1], np.int32)
    active = np.array([1, 1, 1], np.int32)
    if quant:
        args = (qg, cache.k, cache.ks, cache.v, cache.vs, nvalid, active)
        os_ = split_decode_quant(*map(_t, args), W, 5)
        oj = jfd.flash_decode_quant(*map(jnp.asarray, map(np.asarray, args)),
                                    jnp.asarray([5], jnp.int32), interpret=True)
        op = tfd.flash_decode_quant_plain(*map(_t, args), 5)
    else:
        args = (qg, cache.k, cache.v, nvalid, active)
        os_ = split_decode(*map(_t, args), W)
        oj = jfd.flash_decode(*map(jnp.asarray, map(np.asarray, args)), interpret=True)
        op = tfd.flash_decode_plain(*map(_t, args))
        last = lambda x: x[L - T:, :, 0].transpose(0, 1)          # (B, T, KVr, D)
        lin = tfd.flash_decode_plain(_t(qg), last(kt), last(vt), _t(nvalid[:2].tolist() + [T]),
                                     _t(active))
        np.testing.assert_allclose(os_[:2].numpy(), lin[:2].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(os_.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(os_.numpy(), op.numpy(), rtol=0, atol=ATOL)


def test_split_scheme_is_a_function_of_the_slot_alone():
    """What the kernel's absolute split positions buy: a slot's result is
    bit for bit the same in a cache of another capacity and in a batch of
    another size, and the same rows at other positions past the length
    change nothing."""
    rng = np.random.default_rng(7)
    W, KVr, G, D = 32, 2, 4, 16
    q = _t(rng.standard_normal((1, KVr, G, D)).astype(np.float32))
    rows = rng.standard_normal((2, 1, 150, KVr, D)).astype(np.float32)
    nv, act = _t(np.array([97], np.int32)), _t(np.array([1], np.int32))
    one = split_decode(q, _t(rows[0]), _t(rows[1]), nv, act, W)
    short = split_decode(q, _t(rows[0][:, :100]), _t(rows[1][:, :100]), nv, act, W)
    junk = rows.copy()
    junk[:, :, 97:] = rng.standard_normal(junk[:, :, 97:].shape)
    other = split_decode(q, _t(junk[0]), _t(junk[1]), nv, act, W)
    kb = np.concatenate([rng.standard_normal((2, 150, KVr, D)).astype(np.float32), rows[0]])
    vb = np.concatenate([rng.standard_normal((2, 150, KVr, D)).astype(np.float32), rows[1]])
    qb = torch.cat([_t(rng.standard_normal((2, KVr, G, D)).astype(np.float32)), q])
    batch = split_decode(qb, _t(kb), _t(vb), _t(np.array([150, 3, 97], np.int32)),
                         _t(np.array([1, 1, 1], np.int32)), W)
    for o in (short, other, batch[2:]):
        assert torch.equal(o, one)


# ---------------------------------------------------------------------------
# the wrappers' launch path (meta tensors: no card here)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on ``meta`` tensors: the sm_90 check
    passes, the split width is 128, the launchers record their calls, and
    the plain versions raise if anything falls back to them."""
    calls = []

    def entry(fn):
        if fn == "flash_decode_split_width":
            return lambda D: 128

        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def no_fallback(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    monkeypatch.setattr(_build, "require_sm90", lambda t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(tfd, "flash_decode_plain", no_fallback)
    monkeypatch.setattr(tfd, "flash_decode_quant_plain", no_fallback)
    monkeypatch.setattr(tfd, "_decode_plain", no_fallback)
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_wrappers_hand_the_kernel_split_scratch(fake_card, quant):
    """qwen's decode shape (B 8, T 4096, KVr 2, G 8, D 128) reaches the C
    launcher once with its shape and an f32 partial scratch; one launch is
    counted."""
    B, T, KVr, G, D = 8, 4096, 2, 8, 128
    before = dict(_build.launches)
    q, n = _meta(B, KVr, G, D), _meta(B, dtype=torch.int32)
    if quant:
        out = tfd.flash_decode_quant(q, _meta(B, T, KVr, D, dtype=torch.int8), _meta(B, T, KVr),
                                     _meta(B, T, KVr, D, dtype=torch.int8), _meta(B, T, KVr),
                                     n, n, 5)
        name, shape = "flash_decode_quant", (B, T, KVr, G, D)
    else:
        kv = _meta(B, T, KVr, D, dtype=torch.bfloat16)
        out = tfd.flash_decode(q, kv, kv, n, n)
        name, shape = "flash_decode", (B, T, KVr, G, D, 1)
    assert out.shape == (B, KVr, G, D) and out.dtype == torch.float32
    (fn, args), = fake_card
    assert fn == f"{name}_launch"
    first = 10 if quant else 7                    # after the pointers
    assert args[first:first + len(shape)] == shape
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("T,n_split", [(127, 1), (128, 1), (129, 2), (1000, 8), (4096, 32)])
def test_split_scratch_holds_every_split(fake_card, T, n_split):
    """The partial scratch holds ceil(T / W) splits of G rows of D + 4
    floats (acc, m, l and two pad floats: 16-byte rows), at W = 128."""
    part = tfd._split_scratch(3, 2, 4, 80, T, torch.device("meta"))
    assert part.shape == (3, 2, n_split, 4, 84) and part.dtype == torch.float32
    assert fake_card == []


def test_split_width_is_asked_once_per_library_and_head_dim(monkeypatch):
    """The wrappers read the split width of the loaded library once per head
    dim (no C call on every decode step), and read it again from a library
    swapped in by the tuning tools, whose width differs."""
    asked = []

    class Width:
        __hash__ = None                       # as a ctypes entry point

        def __init__(self, W):
            self.W = W

        def __call__(self, D):
            asked.append((self.W, D))
            return self.W

    library = Width

    lib = library(128)
    monkeypatch.setattr(_build, "entry", lambda fn: lib)
    assert [tfd.split_width(D) for D in (80, 80, 128, 80)] == [128] * 4
    assert asked == [(128, 80), (128, 128)]
    lib = library(64)
    assert tfd.split_width(80) == 64 and asked[-1] == (64, 80)


@pytest.mark.parametrize("bad", [48, 96, 512])
def test_unbuilt_decode_head_dim_raises_without_fallback(fake_card, bad):
    """A head dim the decode kernels were not instantiated for raises
    before any launch, on both wrappers, and never runs a plain version."""
    before = dict(_build.launches)
    B, T, KVr, G = 2, 64, 2, 4
    q, n = _meta(B, KVr, G, bad), _meta(B, dtype=torch.int32)
    kv = _meta(B, T, KVr, bad, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode(q, kv, kv, n, n)
    k8, s8 = _meta(B, T, KVr, bad, dtype=torch.int8), _meta(B, T, KVr)
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode_quant(q, k8, s8, k8, s8, n, n, 8)
    assert fake_card == []
    assert _build.launches == before
