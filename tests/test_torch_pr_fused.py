"""The stream path's product-sum kernels, ``pr_fir`` and ``pr_conv2d``
(``kernels/axmult_elem.py``), on the CPU.

* Their plain versions against the JAX reference's ``dsp.fir_frames`` /
  ``dsp.conv2d_pr``, on its ``xla`` route and on its Pallas route in
  interpret mode, on numpy-seeded inputs: degrees None and 8..0, raw (p, r)
  (1, 4), (2, 8), (3, 8); T 1, 2, 8, 32 with frames shorter than the
  carried tail; kernels 1x1, 3x3, 5x5, 3x5 and even 2x4 under zero and
  edge padding; sums that wrap in int32.
* A plain-torch model of the kernels' factored scheme — each weight
  rounded once, each sample perforated once as a tile and its halo are
  loaded, a wrapping uint32 sum per output, the arithmetic shift — equal to
  the materialised route bit for bit.  That is the kernels' correctness
  argument (products and sum wrap modulo 2**32, so the order of the sum
  cannot change a bit), under test here.
* The degree read in place from one element of a device vector, mapped
  as ``degree_to_pr`` maps it, and the wrappers' launch path on ``meta``
  tensors (no card here): one launch a call, the degree's address handed
  to the kernel, the stream step's three launches, sizes past the limits
  refused, no fallback to a plain version.

Every comparison is exact (integer bit math has no tolerance)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dsp as jdsp
from repro_torch.kernels import _build
from repro_torch.kernels import axmult_elem as tpr
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import dsp as tdsp

torch.set_num_threads(2)

#: (kind, value): the ladder's degrees (None = exact) and raw (p, r) pairs
KNOBS = ([("degree", None)] + [("degree", e) for e in range(8, -1, -1)]
         + [("pr", pr) for pr in ((1, 4), (2, 8), (3, 8))])
KNOB_IDS = [f"{k}={v}" for k, v in KNOBS]

#: (B, L, T): T 1, 2, 8, 32, two with frames shorter than the tail
FIR_SHAPES = [(3, 17, 1), (2, 9, 2), (3, 64, 8), (2, 3, 8), (2, 40, 32), (1, 20, 32)]
#: (kh, kw, pad)
CONV_CASES = [(k[0], k[1], pad) for k in ((1, 1), (3, 3), (5, 5), (3, 5), (2, 4))
              for pad in ("zero", "edge")]


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _jax_pr(kind, value):
    """The reference's (p, r) for a knob."""
    if kind == "pr":
        return jnp.int32(value[0]), jnp.int32(value[1])
    return jdsp.degree_to_pr(None if value is None else jnp.int32(value))


def _torch_knob(kind, value):
    """The port's knob keywords: ``pr=`` a pair, or ``degree=`` a device
    (here CPU) int32 or None."""
    if kind == "pr":
        return {"pr": value}
    return {"degree": None if value is None else torch.tensor(value, dtype=torch.int32)}


def _fir_inputs(B, L, T, seed, q=12):
    rng = np.random.default_rng(seed)
    frames = rng.integers(-(1 << q), (1 << q) + 1, (B, L)).astype(np.int32)
    tail = rng.integers(-(1 << q), (1 << q) + 1, (B, T - 1)).astype(np.int32)
    taps = tdsp.quantize_weights(rng.uniform(-1.0, 1.0, T), q)
    return frames, tail, taps


def _conv_inputs(kh, kw, seed, shape=(2, 11, 13)):
    rng = np.random.default_rng(seed)
    img = rng.integers(-2**11, 2**11, shape).astype(np.int32)
    kern = tdsp.quantize_weights(rng.uniform(-1.0, 1.0, (kh, kw)), 8)
    return img, kern


# ---------------------------------------------------------------------------
# plain versions against the reference (xla route and Pallas interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,value", KNOBS, ids=KNOB_IDS)
@pytest.mark.parametrize("B,L,T", FIR_SHAPES)
def test_pr_fir_plain_matches_reference(B, L, T, kind, value):
    frames, tail, taps = _fir_inputs(B, L, T, seed=100 + 7 * T + L)
    p, r = _jax_pr(kind, value)
    yt, tt = tpr.pr_fir_plain(torch.from_numpy(frames), torch.from_numpy(tail),
                              torch.from_numpy(taps), shift=12, **_torch_knob(kind, value))
    assert yt.shape == (B, L) and tt.shape == (B, T - 1) and yt.dtype == torch.int32
    for backend in ("xla", "pallas"):
        yj, tj = jdsp.fir_frames(jnp.asarray(frames), jnp.asarray(tail), jnp.asarray(taps),
                                 p, r, shift=12, backend=backend, interpret=True)
        _eq(yt, yj)
        _eq(tt, tj)


@pytest.mark.parametrize("kind,value", KNOBS, ids=KNOB_IDS)
@pytest.mark.parametrize("kh,kw,pad", CONV_CASES)
def test_pr_conv2d_plain_matches_reference(kh, kw, pad, kind, value):
    img, kern = _conv_inputs(kh, kw, seed=200 + 10 * kh + kw)
    p, r = _jax_pr(kind, value)
    got = tpr.pr_conv2d_plain(torch.from_numpy(img), torch.from_numpy(kern), shift=8,
                              pad=pad, **_torch_knob(kind, value))
    assert got.shape == img.shape and got.dtype == torch.int32
    for backend in ("xla", "pallas"):
        want = jdsp.conv2d_pr(jnp.asarray(img), jnp.asarray(kern), p, r, shift=8, pad=pad,
                              backend=backend, interpret=True)
        _eq(got, want)


@pytest.mark.parametrize("kind,value", [("degree", 8), ("degree", 5), ("pr", (3, 8))])
def test_product_sums_wrap_in_int32_like_the_reference(kind, value):
    """Operands far past the l1 contract: the int32 sums wrap (the int64
    sum differs), in the reference and in both plain versions alike."""
    big = 2**15 - 1
    frames = np.full((2, 12), big, np.int32)
    frames[1] = -big
    tail = np.full((2, 9), big, np.int32)
    taps = np.full(10, big, np.int32)
    p, r = _jax_pr(kind, value)
    yt, _ = tpr.pr_fir_plain(torch.from_numpy(frames), torch.from_numpy(tail),
                             torch.from_numpy(taps), shift=3, **_torch_knob(kind, value))
    yj, _ = jdsp.fir_frames(jnp.asarray(frames), jnp.asarray(tail), jnp.asarray(taps), p, r,
                            shift=3, backend="pallas", interpret=True)
    _eq(yt, yj)
    assert int(yt[0, 0]) != (10 * big * big) >> 3          # the sum did wrap
    img = np.full((1, 6, 7), big, np.int32)
    kern = np.full((3, 3), big, np.int32)
    got = tpr.pr_conv2d_plain(torch.from_numpy(img), torch.from_numpy(kern), shift=3,
                              pad="edge", **_torch_knob(kind, value))
    _eq(got, jdsp.conv2d_pr(jnp.asarray(img), jnp.asarray(kern), p, r, shift=3, pad="edge",
                            backend="pallas", interpret=True))


# ---------------------------------------------------------------------------
# the kernels' factored scheme, modelled in plain numpy
# ---------------------------------------------------------------------------


def _model_knobs(kind, value):
    """(p, r) as the kernels derive them from their knob operand."""
    if kind == "pr":
        return value
    if value is None:
        return 0, 0
    d = max(8 - value, 0)
    return d // 2, 2 * d


def _round_r(w, r):
    """round_r of each weight, as ``csrc/axmult_elem.cu`` writes it (uint32)."""
    w = w.astype(np.int64)
    if r <= 0:
        return (w & 0xFFFFFFFF).astype(np.uint32)
    rbit = (w >> (r - 1)) & 1
    return ((((w >> r) + rbit) << r) & 0xFFFFFFFF).astype(np.uint32)


def _perforate_p(x, p, n=16):
    """perforate_p of each sample, as ``csrc/axmult_elem.cu`` writes it."""
    x = x.astype(np.int64) & 0xFFFFFFFF
    if p <= 0:
        return x.astype(np.uint32)
    two_p = (1 << (2 * min(p, 16))) & 0xFFFFFFFF
    u = x & ((1 << n) - 1)
    low = u & ((two_p - 1) & 0xFFFFFFFF)
    cbit = (u >> max(2 * min(p, 16) - 1, 0)) & 1
    return ((x - low + cbit * two_p) & 0xFFFFFFFF).astype(np.uint32)


def _sar(acc, shift):
    return acc.view(np.int32) >> shift


def fir_factored(frames, tail, taps, p, r, shift, tile):
    """The pr_fir kernel's scheme: a block per (row, tile of ``tile``
    outputs) loads ext over the tile and its T-1 halo, perforating each
    sample once; the taps are rounded once; each output sums in wrapping
    uint32; the tile holding the row's end writes the raw new tail."""
    B, L = frames.shape
    T = taps.shape[0]
    H = T - 1
    ws = _round_r(taps, r)
    y = np.zeros((B, L), np.int32)
    new_tail = np.zeros((B, H), np.int32)
    for b in range(B):
        for j0 in range(0, L, tile):
            span = min(tile, L - j0) + H
            raw = np.array([tail[b, pos] if pos < H else frames[b, pos - H]
                            for pos in range(j0, j0 + span)], np.int32)
            xs = _perforate_p(raw, p)                          # shared memory
            if j0 + tile >= L:
                for i, pos in enumerate(range(j0, j0 + span)):
                    if pos >= L:
                        new_tail[b, pos - L] = raw[i]
            for t in range(min(tile, L - j0)):
                acc = np.sum(ws * xs[t:t + T], dtype=np.uint32)   # wraps mod 2**32
                y[b, j0 + t] = _sar(np.asarray(acc, np.uint32), shift)
    return y, new_tail


def conv_factored(img, kern, p, r, shift, pad, tile):
    """The pr_conv2d kernel's scheme: a block per (image, tile x tile
    outputs) loads the tile and its (kh-1, kw-1) halo, clamping (edge) or
    zeroing (zero) outside the image, perforating each pixel once; the
    weights are rounded once; wrapping uint32 sums, the arithmetic shift."""
    B, H, W = img.shape
    kh, kw = kern.shape
    ph, pw = kh // 2, kw // 2
    ws = _round_r(kern, r)
    out = np.zeros_like(img)
    for b in range(B):
        for y0 in range(0, H, tile):
            for x0 in range(0, W, tile):
                xs = np.zeros((tile + kh - 1, tile + kw - 1), np.uint32)
                for rr in range(tile + kh - 1):
                    for cc in range(tile + kw - 1):
                        yy, xx = y0 + rr - ph, x0 + cc - pw
                        if pad == "edge":
                            v = img[b, min(max(yy, 0), H - 1), min(max(xx, 0), W - 1)]
                        elif 0 <= yy < H and 0 <= xx < W:
                            v = img[b, yy, xx]
                        else:
                            v = 0
                        xs[rr, cc] = _perforate_p(np.array([v], np.int32), p)[0]
                for ty in range(min(tile, H - y0)):
                    for tx in range(min(tile, W - x0)):
                        acc = np.sum(ws * xs[ty:ty + kh, tx:tx + kw], dtype=np.uint32)
                        out[b, y0 + ty, x0 + tx] = _sar(np.asarray(acc, np.uint32), shift)
    return out


@pytest.mark.parametrize("kind,value", [("degree", None), ("degree", 7), ("degree", 4),
                                        ("degree", 0), ("pr", (3, 8))])
@pytest.mark.parametrize("B,L,T,tile", [(2, 21, 8, 8), (2, 3, 8, 4), (1, 40, 32, 16),
                                        (2, 9, 1, 4)])
def test_fir_factored_scheme_equals_the_materialised_route(B, L, T, tile, kind, value):
    frames, tail, taps = _fir_inputs(B, L, T, seed=300 + T + L)
    p, r = _model_knobs(kind, value)
    y, new_tail = fir_factored(frames, tail, taps, p, r, 12, tile)
    yt, tt = tpr.pr_fir_plain(torch.from_numpy(frames), torch.from_numpy(tail),
                              torch.from_numpy(taps), shift=12, **_torch_knob(kind, value))
    _eq(yt, y)
    _eq(tt, new_tail)


@pytest.mark.parametrize("kind,value", [("degree", None), ("degree", 6), ("degree", 0),
                                        ("pr", (2, 8))])
@pytest.mark.parametrize("kh,kw,pad", [(3, 3, "edge"), (5, 5, "zero"), (2, 4, "edge"),
                                       (1, 1, "zero")])
def test_conv_factored_scheme_equals_the_materialised_route(kh, kw, pad, kind, value):
    img, kern = _conv_inputs(kh, kw, seed=400 + kh * kw, shape=(2, 9, 11))
    p, r = _model_knobs(kind, value)
    got = conv_factored(img, kern, p, r, 8, pad, tile=4)
    _eq(tpr.pr_conv2d_plain(torch.from_numpy(img), torch.from_numpy(kern), shift=8, pad=pad,
                            **_torch_knob(kind, value)), got)


def test_factored_sum_wraps_like_the_materialised_route():
    """The wrapping case through the model: the uint32 sum, taken in
    another order than the planes' sum, gives the same bits."""
    big = 2**15 - 1
    frames = np.full((1, 12), big, np.int32)
    tail = np.full((1, 9), -big, np.int32)
    taps = np.full(10, big, np.int32)
    y, _ = fir_factored(frames, tail, taps, 1, 4, 3, tile=5)
    yt, _ = tpr.pr_fir_plain(torch.from_numpy(frames), torch.from_numpy(tail),
                             torch.from_numpy(taps), (1, 4), shift=3)
    _eq(yt, y)


# ---------------------------------------------------------------------------
# the degree operand
# ---------------------------------------------------------------------------


def test_degree_is_read_in_place_from_a_vector_element():
    """One element of the engine's degree vector drives both product-sums
    as ``degree_to_pr`` maps it; a rung move written into the vector in
    place is what the next call sees."""
    frames, tail, taps = (torch.from_numpy(a) for a in _fir_inputs(2, 30, 8, seed=7))
    img, kern = (torch.from_numpy(a) for a in _conv_inputs(3, 3, seed=8))
    vec = torch.tensor([8, 6, 4], dtype=torch.int32)
    site = tdispatch.site_degree(vec, 2)
    for e, pr in ((4, (2, 8)), (6, (1, 4)), (8, (0, 0)), (0, (4, 16))):
        vec[2] = e
        assert tdsp.degree_to_pr(site).tolist() == list(pr)
        _eq(tpr.pr_fir(frames, tail, taps, degree=site, shift=12)[0],
            tpr.pr_fir_plain(frames, tail, taps, pr, shift=12)[0])
        _eq(tpr.pr_conv2d(img, kern, degree=site, shift=8, pad="edge"),
            tpr.pr_conv2d_plain(img, kern, pr, shift=8, pad="edge"))


def test_limits_match_the_kernel_source():
    """The wrappers refuse what the kernels' shared memory cannot hold:
    the same numbers as ``csrc/axmult_elem.cu``."""
    src = (_build.CSRC / "axmult_elem.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("FIR_MAX_TAPS") == tpr.FIR_MAX_TAPS >= 64
    assert const("CONV_MAX_K") == tpr.CONV_MAX_K >= 7
    assert const("MAX_GRID_YZ") == tpr.MAX_BATCH


#: ptxas -v lines of axmult_elem.cu as nvcc 12.8 prints them for sm_90a
PTXAS_PR = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__02783700_14_axmult_elem_cu_f2c123209pr_kernelILb0EEEvPKiS2_PiS2_xi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__02783700_14_axmult_elem_cu_f2c123209pr_kernelILb1EEEvPKiS2_PiS2_xi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 25 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__02783700_14_axmult_elem_cu_f2c1232019launch_floor_kernelEv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 4 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__02783700_14_axmult_elem_cu_f2c1232016pr_conv2d_kernelEPKiS1_PiS1_iiiiiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 4868 bytes smem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__02783700_14_axmult_elem_cu_f2c1232013pr_fir_kernelEPKiS1_S1_PiS2_S1_iiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 3068 bytes smem
"""


def test_pr_instance_names_every_axmult_elem_kernel():
    """The names chip_smoke.py's phase-1 spill gate counts, with registers
    and static shared memory; other kernels' names are not taken."""
    rows = _build.kernel_resources(PTXAS_PR.splitlines())
    assert [(_build.pr_instance(r["function"]), r["registers"], r["spill_stores"], r["smem"])
            for r in rows] == [("pr_kernel<scalar>", 22, 0, 0), ("pr_kernel<vec>", 25, 0, 0),
                               ("launch_floor_kernel", 4, 0, 0),
                               ("pr_conv2d_kernel", 32, 0, 4868), ("pr_fir_kernel", 32, 0, 3068)]
    assert _build.pr_instance("_ZN12_GLOBAL__N_113decode_kernelI8Int8RowsEEvT_") is None


# ---------------------------------------------------------------------------
# the wrappers' launch path (meta tensors: no card here)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on ``meta`` tensors: the sm_90 check
    passes, the launchers record their calls, the routers take the kernel
    route, and the plain versions raise if anything falls back to them."""
    calls = []

    def entry(fn):
        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def no_fallback(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    monkeypatch.setattr(_build, "require_sm90", lambda t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(tdispatch, "resolved_backend", lambda device=None: "cuda")
    for name in ("pr_fir_plain", "pr_conv2d_plain", "pr_multiply_plain"):
        monkeypatch.setattr(tpr, name, no_fallback)
        monkeypatch.setattr(tdsp, name, no_fallback)
    return calls


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_launch_once_with_the_degree_itself(fake_card):
    """One launch a call, counted once; a degree goes to the kernel as
    itself (is_degree 1, read at its address), a pair as the (p, r)
    operand."""
    calls = fake_card
    before = dict(_build.launches)
    deg = _meta(3)[1]
    y, nt = tpr.pr_fir(_meta(64, 256), _meta(64, 7), _meta(8), degree=deg, shift=12)
    assert y.shape == (64, 256) and nt.shape == (64, 7)
    out = tpr.pr_conv2d(_meta(64, 16, 16), _meta(3, 3), (1, 4), shift=8, pad="edge")
    assert out.shape == (64, 16, 16)
    (f1, a1), (f2, a2) = calls
    assert f1 == "pr_fir_launch" and a1[6:12] == (1, 64, 256, 8, 16, 12)
    assert f2 == "pr_conv2d_launch" and a2[4:13] == (0, 64, 16, 16, 3, 3, 1, 16, 8)
    assert _build.launches["pr_fir"] == before["pr_fir"] + 1
    assert _build.launches["pr_conv2d"] == before["pr_conv2d"] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 2


def test_stream_step_launches_one_fir_and_two_convs(fake_card):
    """The stream tick through the routers: pr_fir once, pr_conv2d twice,
    pr_multiply never, each stage reading its own element of the degree
    vector (nothing mapped to (p, r) around the launches)."""
    from repro_torch.serve.stream import StreamAdapter, StreamConfig, StreamState

    calls = fake_card
    cfg = StreamConfig()
    ad = StreamAdapter(cfg, device="cpu")
    ad.device = torch.device("meta")
    params = ad.prepack({"taps": np.ones(cfg.taps, np.int32), "kern": np.ones((3, 3), np.int32),
                         "gain": np.ones((1, 1), np.int32)})
    B = 4
    state = StreamState(length=_meta(B), tail=_meta(1, B, cfg.taps - 1))
    feed = torch.zeros((B, cfg.frame), dtype=torch.int32)
    before = dict(_build.launches)
    out, new_state = ad.step(params, state, feed, _meta(B, dtype=torch.bool), None,
                             _meta(3))
    assert out.shape == (B, cfg.frame) and new_state.tail.shape == (1, B, cfg.taps - 1)
    assert [fn for fn, _ in calls] == ["pr_fir_launch", "pr_conv2d_launch",
                                       "pr_conv2d_launch"]
    assert [args[6] if fn == "pr_fir_launch" else args[4] for fn, args in calls] == [1, 1, 1]
    delta = {k: _build.launches[k] - before[k] for k in before}
    assert delta == {**dict.fromkeys(before, 0), "pr_fir": 1, "pr_conv2d": 2}


@pytest.mark.parametrize("case", ["taps", "kernel", "dtype", "contiguous", "tail",
                                  "knobs", "shift", "batch"])
def test_sizes_and_operands_past_the_limits_raise(fake_card, case):
    """Nothing launches and nothing falls back: too many taps or kernel
    rows (the message names the limit), int64 operands, a strided view, a
    tail of the wrong length, both knobs at once, a shift past 31, more
    rows than a grid dimension holds."""
    calls = fake_card
    fr, tl, tp = _meta(4, 32), _meta(4, 7), _meta(8)
    img, k = _meta(2, 16, 16), _meta(3, 3)
    bad = {
        "taps": (lambda: tpr.pr_fir(fr, _meta(4, 256), _meta(257)), "256 taps"),
        "kernel": (lambda: tpr.pr_conv2d(img, _meta(17, 3)), "1..16"),
        "dtype": (lambda: tpr.pr_fir(fr.long(), tl, tp), "dtype"),
        "contiguous": (lambda: tpr.pr_conv2d(_meta(2, 16, 32)[:, :, ::2], k), "contiguous"),
        "tail": (lambda: tpr.pr_fir(fr, _meta(4, 6), tp), "shape"),
        "knobs": (lambda: tpr.pr_conv2d(img, k, (1, 2), degree=6), "either"),
        "shift": (lambda: tpr.pr_fir(fr, tl, tp, shift=32), "shift"),
        "batch": (lambda: tpr.pr_conv2d(_meta(65536, 1, 1), k), "65535"),
    }
    fn, match = bad[case]
    before = dict(_build.launches)
    with pytest.raises(ValueError, match=match):
        fn()
    assert calls == [] and _build.launches == before
