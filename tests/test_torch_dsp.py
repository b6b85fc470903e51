"""Port parity for the PR-multiplier arithmetic and the DSP cores: the
port's ``core.encodings`` / ``core.axmult`` / ``core.error_analysis``, the
plain version of the ``pr_multiply`` kernel and ``kernels.dsp`` /
``dispatch.fir`` / ``conv2d`` / ``fir_approx``, each against its JAX twin
on the same numpy-seeded inputs.  The JAX side runs as its own tests run
it: the Pallas ``pr_multiply`` in interpret mode, and the ``xla`` route of
``dispatch.fir`` / ``conv2d``.

Integer results are held bit-identical (``assert_array_equal``) throughout;
``pow2_snap`` and ``axfpu_multiply`` compare floats exactly too (their
outputs are powers of two / bit patterns).  The one tolerance is the
``fir_approx`` gradient, 1e-5 (an f32 einsum summed in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axmult as jax_axmult
from repro.core import encodings as jenc
from repro.core import error_analysis as jerr
from repro.kernels import dispatch as jdispatch
from repro.kernels import dsp as jdsp
from repro.kernels.axmult_elem import pr_multiply as jpr_multiply
from repro_torch.core import axmult as tax
from repro_torch.core import encodings as tenc
from repro_torch.core import error_analysis as terr
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import dsp as tdsp
from repro_torch.kernels.axmult_elem import pr_multiply, pr_multiply_plain

torch.set_num_threads(2)

N = 16


@pytest.fixture(autouse=True)
def _backends():
    prev = jdispatch._override
    jdispatch.set_backend("xla")
    yield
    jdispatch.set_backend(prev)
    tdispatch.set_backend(None)


def _ops(seed, size=3001, n=N):
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (n - 1)), 1 << (n - 1)
    return (rng.integers(lo, hi, size).astype(np.int32),
            rng.integers(lo, hi, size).astype(np.int32))


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


# ---------------------------------------------------------------------------
# core.encodings / core.axmult against the reference
# ---------------------------------------------------------------------------


def test_bit_helpers_match_reference():
    a, _ = _ops(0)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    _eq(tenc.unsigned_view(ta, N), jenc.unsigned_view(ja, N))
    for i in (0, 5, 15):
        _eq(tenc.bit(ta, i, N), jenc.bit(ja, i, N))
    u = np.array(jenc.unsigned_view(ja, N))
    _eq(tenc.to_signed(torch.from_numpy(u), N), jenc.to_signed(jnp.asarray(u), N))


def test_booth_digits_and_recombine_match_reference():
    a, _ = _ops(1)
    td = tenc.booth_digits(torch.from_numpy(a), N)
    jd = jenc.booth_digits(jnp.asarray(a), N)
    _eq(td, jd)
    _eq(tenc.recombine_radix4(td), jenc.recombine_radix4(jd))
    _eq(tenc.recombine_radix4(td), a)


@pytest.mark.parametrize("p", range(0, 9))
def test_perforate_operand_matches_reference(p):
    _, b = _ops(2 + p)
    _eq(tenc.perforate_operand(torch.from_numpy(b), N, p),
        jenc.perforate_operand(jnp.asarray(b), N, p))
    _eq(tenc.np_perforate_operand(b, N, p), jenc.np_perforate_operand(b, N, p))


@pytest.mark.parametrize("r", [0, 1, 2, 5, 8, 12, 16])
def test_round_operand_matches_reference(r):
    a, _ = _ops(20 + r)
    _eq(tenc.round_operand(torch.from_numpy(a), r), jenc.round_operand(jnp.asarray(a), r))
    _eq(tenc.np_round_operand(a, r), jenc.np_round_operand(a, r))


@pytest.mark.parametrize("k", [4, 6, 8, 10, 12, 14])
def test_rad_encoding_matches_reference(k):
    _, b = _ops(40 + k)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    ty0 = tenc.highradix_digit(tb, N, k)
    jy0 = jenc.highradix_digit(jb, N, k)
    _eq(ty0, jy0)
    _eq(tenc.approx_highradix_digit(ty0, k), jenc.approx_highradix_digit(jy0, k))
    _eq(tenc.rad_encode(tb, N, k), jenc.rad_encode(jb, N, k))
    _eq(tenc.np_rad_encode(b, N, k), jenc.np_rad_encode(b, N, k))
    _eq(tax.mult_rad(torch.from_numpy(b[::-1].copy()), tb, N, k),
        jax_axmult.mult_rad(jnp.asarray(b[::-1].copy()), jb, N, k))


def test_dlsb_multipliers_match_reference():
    n = 8
    rng = np.random.default_rng(5)
    a, b = (rng.integers(-(1 << (n - 1)), 1 << (n - 1), 500).astype(np.int32)
            for _ in range(2))
    ap, bp = (rng.integers(0, 2, 500).astype(np.int32) for _ in range(2))
    T = [torch.from_numpy(x) for x in (a, ap, b, bp)]
    J = [jnp.asarray(x) for x in (a, ap, b, bp)]
    _eq(tenc.dlsb_value(T[0], T[1]), jenc.dlsb_value(J[0], J[1]))
    for tt, jj in zip(tenc.dlsb_encode_sophisticated(T[0], T[1], n),
                      jenc.dlsb_encode_sophisticated(J[0], J[1], n)):
        _eq(tt, jj)
    _eq(tenc.mult_dlsb_straightforward(*T, n), jenc.mult_dlsb_straightforward(*J, n))
    _eq(tenc.mult_dlsb_sophisticated(*T, n), jenc.mult_dlsb_sophisticated(*J, n))
    _eq(tax.mult_dlsb(*T, n), jax_axmult.mult_dlsb(*J, n))
    _eq(tenc.np_booth_digits(b, n), jenc.np_booth_digits(b, n))


def test_pow2_snap_matches_reference():
    x = np.random.default_rng(6).standard_normal(2000).astype(np.float32) * 10
    x[::97] = 0.0
    _eq(tenc.pow2_snap(torch.from_numpy(x)), jenc.pow2_snap(jnp.asarray(x)))


def test_pow2_snap_exact_at_the_half_exponents():
    """Every f32 within 3000 ulps of 2^(k+1/2), k in -30..7, both signs:
    the snap is the nearest power of two in the log domain, decided in f64
    (a rounded f32 ``log2`` lands on either side within an ulp of the
    boundary, differently on each device).  The reference's
    ``round(log2 |x|)`` exponent agrees farther than 16 ulps from it."""
    off = np.arange(-3000, 3000, dtype=np.int32)
    for k in range(-30, 8):
        x = (np.float32(2.0 ** (k + 0.5)).view(np.int32) + off).view(np.float32)
        x = np.concatenate([x, -x])
        got = tenc.pow2_snap(torch.from_numpy(x)).numpy()
        m, e = np.frexp(np.abs(x).astype(np.float64))
        want = np.sign(x) * np.exp2(np.where(m > 2 ** -0.5, e, e - 1))
        np.testing.assert_array_equal(got, want.astype(np.float32))
        ref_e = np.asarray(jnp.round(jnp.log2(jnp.abs(jnp.asarray(x)))))
        far = np.abs(np.concatenate([off, off])) > 16
        np.testing.assert_array_equal(np.log2(np.abs(got[far]).astype(np.float64)), ref_e[far])


@pytest.mark.parametrize("p,r", [(0, 0), (1, 2), (2, 6), (4, 8), (8, 16)])
def test_fixed_and_dynamic_pr_multipliers_match_reference(p, r):
    a, b = _ops(60 + p + r)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _eq(tax.mult_exact(ta, tb), jax_axmult.mult_exact(ja, jb))
    _eq(tax.mult_pr(ta, tb, N, p, r), jax_axmult.mult_pr(ja, jb, N, p, r))
    pt, rt = torch.tensor(p, dtype=torch.int32), torch.tensor(r, dtype=torch.int32)
    pj, rj = jnp.int32(p), jnp.int32(r)
    _eq(tax.perforate_dynamic(tb, N, pt), jax_axmult.perforate_dynamic(jb, N, pj))
    _eq(tax.round_dynamic(ta, rt), jax_axmult.round_dynamic(ja, rj))
    _eq(tax.pr_multiply_dynamic(ta, tb, N, pt, rt),
        jax_axmult.pr_multiply_dynamic(ja, jb, N, pj, rj))
    _eq(tax.np_mult_pr(a, b, N, p, r), jax_axmult.np_mult_pr(a, b, N, p, r))


@pytest.mark.parametrize("k,p,r", [(4, 0, 2), (6, 0, 4), (8, 0, 0)])
def test_mult_roup_matches_reference(k, p, r):
    a, b = _ops(70 + k)
    _eq(tax.mult_roup(torch.from_numpy(a), torch.from_numpy(b), N, k, p, r),
        jax_axmult.mult_roup(jnp.asarray(a), jnp.asarray(b), N, k, p, r))
    _eq(tax.np_mult_roup(a, b, N, k, 1, r), jax_axmult.np_mult_roup(a, b, N, k, 1, r))


def test_mult_roup_perforation_overflows_an_int32_lane_in_both():
    """ROUP's perforation perforates the radix-4 part at width 2n: its mask
    2^32 - 1 fits no int32 lane, and both packages refuse it."""
    a, b = _ops(80, size=16)
    with pytest.raises(OverflowError):
        jax_axmult.mult_roup(jnp.asarray(a), jnp.asarray(b), N, 4, 1, 2)
    with pytest.raises(OverflowError):
        tax.mult_roup(torch.from_numpy(a), torch.from_numpy(b), N, 4, 1, 2)


@pytest.mark.parametrize("fmt", ["bf16", "fp16"])
@pytest.mark.parametrize("p,r", [(0, 0), (1, 2), (2, 4)])
def test_axfpu_multiply_matches_reference(fmt, p, r):
    rng = np.random.default_rng(90 + p + r)
    a = (rng.standard_normal(1000) * 4).astype(np.float32)
    b = (rng.standard_normal(1000) * 4).astype(np.float32)
    a[:4] = [0.0, 1e-30, 6e4, -3.0]
    jo = jax_axmult.axfpu_multiply(jnp.asarray(a), jnp.asarray(b), fmt, p, r)
    to = tax.axfpu_multiply(torch.from_numpy(a), torch.from_numpy(b), fmt, p, r)
    np.testing.assert_array_equal(to.to(torch.float32).numpy(),
                                  np.asarray(jo.astype(jnp.float32)))
    with pytest.raises(ValueError):
        tax.axfpu_multiply(torch.from_numpy(a), torch.from_numpy(b), "fp32")


def test_np_axfpu_and_family_configs_match_reference():
    rng = np.random.default_rng(7)
    a = (rng.standard_normal(1000) * 4).astype(np.float32)
    b = (rng.standard_normal(1000) * 4).astype(np.float32)
    _eq(tax.np_axfpu_multiply(a, b, 2, 4), jax_axmult.np_axfpu_multiply(a, b, 2, 4))
    ta, ja = tax.family_configs(N), jax_axmult.family_configs(N)
    assert [(n, m) for n, _, m in ta] == [(n, m) for n, _, m in ja]
    x, y = _ops(8, size=400)
    for (_, tf, _), (_, jf, _) in zip(ta, ja):
        _eq(tf(x.astype(np.int64), y.astype(np.int64)),
            jf(x.astype(np.int64), y.astype(np.int64)))


def test_error_analysis_copy_matches_reference():
    rng = np.random.default_rng(9)
    ref = rng.standard_normal((4, 64))
    x = ref + 0.01 * rng.standard_normal((4, 64))
    for name in ("mse", "snr_db", "psnr_db", "ssim"):
        assert getattr(terr, name)(ref, x) == getattr(jerr, name)(ref, x), name
    assert terr.psnr_db(ref, ref) == jerr.psnr_db(ref, ref)
    f = lambda a, b: tax.np_mult_pr(a, b, 8, 1, 2)
    g = lambda a, b: tax.np_axfpu_multiply(a, b, 1, 2)
    for tr, jr in ((terr.evaluate_exhaustive(f, 8), jerr.evaluate_exhaustive(f, 8)),
                   (terr.evaluate_sampled(f, 8, num=4096), jerr.evaluate_sampled(f, 8, num=4096)),
                   (terr.rad_operand_marginal(12, 6), jerr.rad_operand_marginal(12, 6)),
                   (terr.evaluate_float(g, num=2048), jerr.evaluate_float(g, num=2048))):
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        assert tr.row() == jr.row()


# ---------------------------------------------------------------------------
# the pr_multiply kernel's plain version
# ---------------------------------------------------------------------------


def test_pr_multiply_plain_matches_pallas_for_every_knob():
    """p in 0..8, r in 0..16 at a ragged size: the plain version against
    the Pallas kernel (interpret mode, zero-padded to its block) and the
    reference's jnp mirror.  The wrapper on CPU tensors is the plain
    version."""
    a, b = _ops(10, size=2048 + 77)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for p in range(9):
        for r in range(17):
            want = jdsp.pr_product(ja, jb, p, r, backend="pallas", interpret=True)
            _eq(jdsp.pr_multiply_ref(ja, jb, p, r), want)
            _eq(pr_multiply_plain(ta, tb, (p, r)), want)
            _eq(pr_multiply(ta, tb, torch.tensor([p, r], dtype=torch.int32)), want)


def test_pr_multiply_plain_matches_pallas_unpadded_block():
    """Aligned to the Pallas block (no padding), N-D operands."""
    a, b = _ops(11, size=2 * 2048)
    a, b = a.reshape(4, 2, 512), b.reshape(4, 2, 512)
    want = jpr_multiply(jnp.asarray(a), jnp.asarray(b), 2, 6, interpret=True)
    got = tdsp.pr_multiply_ref(torch.from_numpy(a), torch.from_numpy(b), (2, 6))
    assert got.shape == (4, 2, 512)
    _eq(got, want)


@pytest.mark.parametrize("degree", [None, 0, 1, 2, 3, 4, 5, 6, 7, 8])
def test_degree_to_pr_matches_reference(degree):
    pj, rj = jdsp.degree_to_pr(None if degree is None else jnp.int32(degree))
    pr = tdsp.degree_to_pr(None if degree is None else torch.tensor(degree, dtype=torch.int32))
    assert pr.dtype == torch.int32 and tuple(pr.shape) == (2,)
    assert pr.tolist() == [int(pj), int(rj)]


def test_degree_to_pr_reads_a_vector_element_in_place():
    """The engine passes one element of its device degree vector: a view,
    consumed by device ops (no host read)."""
    vec = torch.tensor([8, 6, 4], dtype=torch.int32)
    assert tdsp.degree_to_pr(tdispatch.site_degree(vec, 2)).tolist() == [2, 8]
    vec[2] = 6                                     # a rung move, in place
    assert tdsp.degree_to_pr(tdispatch.site_degree(vec, 2)).tolist() == [1, 4]


# ---------------------------------------------------------------------------
# DSP cores and routers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,r", [(0, 0), (1, 4), (2, 8), (3, 8)])
def test_fir_valid_matches_reference(p, r):
    rng = np.random.default_rng(12 + p)
    sig = rng.integers(-2**14, 2**14, 700).astype(np.int32)
    taps = rng.integers(-2**13, 2**13, 12).astype(np.int32)
    want = jdispatch.fir(sig, taps, p=p, r=r)
    got = tdispatch.fir(torch.from_numpy(sig), torch.from_numpy(taps), p=p, r=r)
    assert tdispatch.last_route["fir"] == "torch"
    assert got.dtype == np.int64
    _eq(got, want)


@pytest.mark.parametrize("degree", [None, 8, 6, 4])
def test_fir_frames_matches_reference(degree):
    rng = np.random.default_rng(13)
    B, L, T, q = 3, 64, 8, 12
    frames = rng.integers(-(1 << q), (1 << q) + 1, (B, L)).astype(np.int32)
    tail = rng.integers(-(1 << q), (1 << q) + 1, (B, T - 1)).astype(np.int32)
    taps = tdsp.quantize_weights(np.hanning(T + 2)[1:-1], q)
    _eq(taps, jdsp.quantize_weights(np.hanning(T + 2)[1:-1], q))
    jd = None if degree is None else jnp.int32(degree)
    td = None if degree is None else torch.tensor(degree, dtype=torch.int32)
    yj, tj = jdispatch.fir(jnp.asarray(frames), jnp.asarray(taps), tail=jnp.asarray(tail),
                           degree=jd, shift=q)
    yt, tt = tdispatch.fir(torch.from_numpy(frames), torch.from_numpy(taps),
                           tail=torch.from_numpy(tail), degree=td, shift=q)
    _eq(yt, yj)
    _eq(tt, tj)


@pytest.mark.parametrize("pad", ["zero", "edge"])
@pytest.mark.parametrize("ksize", [1, 3, 5])
def test_conv2d_matches_reference(pad, ksize):
    rng = np.random.default_rng(14 + ksize)
    img = rng.integers(-2**11, 2**11, (2, 16, 12)).astype(np.int32)
    kern = tdsp.quantize_weights(rng.uniform(0.1, 1.0, (ksize, ksize)), 8)
    for p, r in ((0, 0), (1, 2), (2, 6)):
        want = jdispatch.conv2d(jnp.asarray(img), jnp.asarray(kern), p=p, r=r,
                                shift=8, pad=pad)
        got = tdispatch.conv2d(torch.from_numpy(img), torch.from_numpy(kern), p=p, r=r,
                               shift=8, pad=pad)
        assert tdispatch.last_route["conv2d"] == "torch"
        _eq(got, want)


def test_edge_padding_matches_jnp_pad_edge():
    img = np.arange(2 * 5 * 4, dtype=np.int32).reshape(2, 5, 4) - 17
    kern = np.zeros((5, 3), np.int32)
    H, W = img.shape[1:]
    ext = np.asarray(jnp.pad(jnp.asarray(img), ((0, 0), (2, 2), (1, 1)), mode="edge"))
    for dy in range(5):
        for dx in range(3):
            k = kern.copy()
            k[dy, dx] = 1                         # picks one shifted plane
            got = tdsp.conv2d_pr(torch.from_numpy(img), torch.from_numpy(k), (0, 0),
                                 pad="edge")
            _eq(got, ext[:, dy:dy + H, dx:dx + W])


def test_accumulation_wraps_in_int32_like_the_reference():
    """Past the l1 contract the reference's int32 sum wraps; the port sums
    with dtype=int32 (a plain torch.sum would widen to int64) and shifts the
    wrapped value arithmetically, bit for bit."""
    frames = np.full((1, 16), 2**15 - 1, np.int32)
    taps = np.full(8, 2**15 - 1, np.int32)          # l1 = 8 * 32767 >> 2**12
    tail = np.full((1, 7), 2**15 - 1, np.int32)
    yj, _ = jdsp.fir_frames(jnp.asarray(frames), jnp.asarray(tail), jnp.asarray(taps),
                            0, 0, shift=12)
    yt, _ = tdsp.fir_frames(torch.from_numpy(frames), torch.from_numpy(tail),
                            torch.from_numpy(taps), (0, 0), shift=12)
    wide = (8 * (2**15 - 1) ** 2) >> 12
    assert int(np.asarray(yj)[0, 0]) != wide        # the reference did wrap
    _eq(yt, yj)
    img = np.full((1, 4, 4), 2**15 - 1, np.int32)
    kern = np.full((3, 3), 2**15 - 1, np.int32)
    _eq(tdsp.conv2d_pr(torch.from_numpy(img), torch.from_numpy(kern), (0, 0), shift=3,
                       pad="edge"),
        jdsp.conv2d_pr(jnp.asarray(img), jnp.asarray(kern), 0, 0, shift=3, pad="edge"))


def test_fir_degree_and_raw_knobs_exclusive():
    sig = torch.ones(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        tdispatch.fir(sig, torch.ones(4, dtype=torch.int32), degree=6, p=1)


def test_streaming_fir_matches_whole_signal():
    """Frame-by-frame filtering with a carried tail is bit-identical to
    filtering the concatenated signal in one call (and to the reference)."""
    from repro_torch.serve.stream import StreamConfig, make_clip

    cfg = StreamConfig()
    taps = torch.from_numpy(tdsp.quantize_weights(np.hanning(cfg.taps + 2)[1:-1], cfg.q))
    clip = torch.from_numpy(make_clip(4, cfg.frame, q=cfg.q, seed=5))
    tail0 = torch.zeros((1, cfg.taps - 1), dtype=torch.int32)
    y_whole, _ = tdispatch.fir(clip.reshape(1, -1), taps, tail=tail0, p=1, r=4, shift=cfg.q)
    tail, ys = tail0, []
    for f in clip:
        y, tail = tdispatch.fir(f[None], taps, tail=tail, p=1, r=4, shift=cfg.q)
        ys.append(y)
    _eq(torch.cat(ys, dim=1), y_whole)
    yj, _ = jdispatch.fir(jnp.asarray(clip.numpy().reshape(1, -1)), jnp.asarray(taps.numpy()),
                          tail=jnp.zeros((1, cfg.taps - 1), jnp.int32), p=1, r=4, shift=cfg.q)
    _eq(y_whole, yj)


@pytest.mark.parametrize("degree", [None, 6, 4])
def test_fir_approx_forward_and_grad_match_reference(degree):
    """Forward bit-identical to the reference's; the gradient (the exact
    correlation, straight through the PR datapath) within 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.9, 0.9, (2, 64)).astype(np.float32)
    taps = (np.hanning(6) / np.hanning(6).sum()).astype(np.float32)

    def jloss(x, t):
        return jnp.sum(jnp.sin(jdispatch.fir_approx(x, t, degree=degree)))

    yj = jdispatch.fir_approx(jnp.asarray(x), jnp.asarray(taps), degree=degree)
    gxj, gtj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(taps))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(taps).requires_grad_()
    yt = tdispatch.fir_approx(tx, tt, degree=degree)
    _eq(yt.detach(), yj)
    torch.sum(torch.sin(yt)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gxj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gtj), rtol=0, atol=1e-5)
    if degree == 4:
        exact = tdispatch._fir_exact(tx.detach(), tt.detach())
        assert float((yt.detach() - exact).abs().max()) > 0
