"""Streaming DSP/vision workload on the generic serve core (the port of
``repro.serve.stream``).

The dissertation's second half accelerates classical DSP — FIR filtering
and 2D convolution on the PR approximate multiplier (Ch. 7) — and this
module serves that pipeline through the same machinery the LM workload
uses: slot lifecycle, continuous batching, the QoS degree ladder, metrics.
A request is a short clip of fixed-length sample frames; every engine tick
pushes one frame per slot through

    FIR (approx, ``dispatch.fir``)  ->  reshape to a tile  ->
    3x3 blur conv (approx, ``dispatch.conv2d``)  ->  1x1 gain conv

with the three stages as degree *sites* (``fir`` / ``conv2d`` / ``gain``),
each taking its own element of the device degree vector, which the kernel
reads in place: one ``pr_fir`` and two ``pr_conv2d`` launches a tick, each
a whole stage's product-sum.

Fixed-point contract: samples are Q-``cfg.q`` int32 (|x| <= 2**q); FIR
taps and conv kernels are quantized with ``dsp.quantize_weights`` so their
l1 norm bounds the int32 accumulator, and each stage shifts back to the
sample Q format — the whole pipeline is integer arithmetic, and the kernel
and plain routes are bit-identical (to each other and to the reference).

Per-slot stream state is a NamedTuple on the ``models/cache_ops.py``
layout (``length`` (B,) at axis 0, other fields batch at axis 1), so the
generic ``cache_reset_slot`` / ``cache_mask_update`` helpers give this
workload the reuse-after-free bit-identity guarantee the LM caches have.

Plans calibrate on application-level quality — PSNR against the
exact-arithmetic pipeline (``core.error_analysis.psnr_db``) through
:func:`psnr_metric` — and the quality tap samples the same per-frame PSNR
live.  Under guards the engine runs the generic guarded step
(``ServableModel.guarded_step``): an activation fault flips the frame's
high magnitude bit, and a frame outside ``guard_limit`` (the range the
clean pipeline never leaves) quarantines its slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.approx import ApproxPolicy
from repro_torch.core.error_analysis import psnr_db
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels import dsp
from repro_torch.models.cache_ops import cache_mask_update, cache_reset_slot
from repro_torch.serve import engine as _engine
from repro_torch.serve.servable import ServableModel

#: 1 / ln 10 rounded to f32, the factor of the reference's log10
_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))

#: PSNR-flavored histogram buckets (dB) for the stream quality tap
PSNR_BUCKETS = (10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 45.0, 50.0,
                60.0, 70.0, 80.0, 100.0, 150.0)


@dataclass(frozen=True)
class StreamConfig:
    """Arch-config analogue for the stream pipeline: ``name``,
    ``n_layers`` and ``site_names`` as the degree machinery reads them, and
    the autotuner's cost-model override (``site_macs``)."""

    name: str = "dsp-stream-v1"
    frame: int = 256              # samples per frame (== tile H*W)
    taps: int = 8                 # FIR order
    tile: tuple = (16, 16)        # (H, W) the frame reshapes to
    q: int = 12                   # sample Q format (|x| <= 2**q)
    n_layers: int = 2             # degree sites = n_layers + 1: fir, conv, gain

    def __post_init__(self):
        H, W = self.tile
        if H * W != self.frame:
            raise ValueError(f"tile {self.tile} does not hold frame="
                             f"{self.frame} samples")

    def site_macs(self) -> list:
        """Per-frame MAC counts per plan site (autotune cost weights):
        T per FIR output sample, 9 per blur pixel, 1 per gain pixel."""
        return [float(self.taps * self.frame), float(9 * self.frame),
                float(self.frame)]

    def site_names(self) -> list:
        return ["fir", "conv2d", "gain"]


class StreamState(NamedTuple):
    """Per-slot stream state (cache_ops layout).

    ``length``: (B,) int32 — frames processed per slot (axis 0 = batch).
    ``tail``:   (1, B, T-1) int32 — FIR history carried across frames
                (leading stack axis, batch at axis 1), so frame-by-frame
                filtering is bit-identical to one whole-signal pass.
    """

    length: torch.Tensor
    tail: torch.Tensor


def default_params(cfg: StreamConfig) -> dict:
    """Deterministic reference weights (host numpy): a Hann low-pass FIR,
    the classic 1-2-1 Gaussian blur, and a 0.9 output gain — all quantized
    to l1-safe int32 (``dsp.quantize_weights``)."""
    win = np.hanning(cfg.taps + 2)[1:-1]
    gauss = np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]])
    return {
        "taps": dsp.quantize_weights(win, cfg.q),           # l1 <= 2**q
        "kern": dsp.quantize_weights(gauss, 8),             # l1 <= 256
        "gain": np.array([[int(round(0.9 * (1 << cfg.q)))]], np.int32),
    }


def psnr_metric(ref, out) -> float:
    """Calibration error metric: negated PSNR (the error axis is minimized,
    so quality metrics enter negated).  Monotone in MSE and finite even for
    bit-identical outputs (psnr_db floors the MSE)."""
    return -psnr_db(ref, out)


psnr_metric.metric_name = "neg_psnr_db"


class StreamAdapter(ServableModel):
    """ServableModel serving the approximate FIR + conv2d pipeline
    frame-by-frame on ``device`` (the card unless the caller asks for the
    CPU).  Payloads are (F, frame) int32 clips; every step emits one
    processed frame per active slot."""

    unit = "frames"
    admit_span = "admit"
    step_span = "stream"
    payload_arg = "payload_frames"
    budget_arg = "max_frames"
    first_event = "first_frame"
    admit_site = None             # admission is a slot reset, no fused math
    step_sites = ("fir", "conv2d")

    def __init__(self, cfg: Optional[StreamConfig] = None, *, device="cuda"):
        self.cfg = cfg or StreamConfig()
        self.device = resolve_device(device)
        # plan machinery hook: build_plan stamps the policy's default block;
        # the pipeline is already integer arithmetic, so the default spec is
        # just a carrier
        self.policy = ApproxPolicy()
        # clean pipeline range bound: l1-safe taps/kern quantization and the
        # <1 gain keep |frame| <= 2**q end-to-end; the guarded step holds it
        self.guard_limit = float(2 << self.cfg.q)

    # ---- weights / slot state ----------------------------------------

    def init_params(self) -> dict:
        return self.prepack(default_params(self.cfg))

    def prepack(self, params) -> dict:
        """Weights as int32 tensors on the adapter's device (host arrays are
        copied once here, never per tick)."""
        return {k: torch.as_tensor(v).to(device=self.device, dtype=torch.int32)
                for k, v in params.items()}

    def init_state(self, *, batch: int, max_len: int = 0) -> StreamState:
        T = self.cfg.taps
        return StreamState(
            length=torch.zeros((batch,), dtype=torch.int32, device=self.device),
            tail=torch.zeros((1, batch, T - 1), dtype=torch.int32, device=self.device))

    def init_feed(self, slots: int):
        return np.zeros((slots, self.cfg.frame), np.int32)

    def reset_slot(self, state, slot):
        return cache_reset_slot(state, slot)

    # ---- request validation ------------------------------------------

    def validate(self, frames):
        frames = np.asarray(frames, np.int32)
        if frames.ndim == 1:
            frames = frames[None, :]
        if frames.ndim != 2 or frames.shape[1] != self.cfg.frame:
            raise ValueError(
                f"stream payload must be (F, {self.cfg.frame}) frames, got "
                f"shape {frames.shape}")
        if frames.shape[0] == 0:
            raise ValueError("empty clip")
        lim = 1 << self.cfg.q
        if np.abs(frames).max(initial=0) > lim:
            raise ValueError(
                f"samples exceed the Q{self.cfg.q} range (|x| <= {lim})")
        return frames

    def payload_units(self, frames) -> int:
        return int(frames.shape[0])

    def default_budget(self, frames) -> int:
        return int(frames.shape[0])

    # ---- compute edges ------------------------------------------------

    def admit(self, params, state, feed, slot, req, degree):
        """Admission is pure slot surgery: rewind the state region in place
        (zero FIR history — the reuse-after-free guarantee) and stage the
        clip's first frame in the feed.  No fused ingest math, so 0 units."""
        state = self.reset_slot(state, slot)
        req.cursor = 1
        feed[slot] = req.payload[0]
        return state, 0

    def step(self, params, state, feed, active, generator, degree):
        """ONE pipeline step over all slots: FIR -> blur -> gain, each stage
        at its own element of the device degree vector.  Advances ``state``
        in place and returns it with the frames; reads nothing on the
        host, so the serve engine replays it from a CUDA graph."""
        cfg = self.cfg
        H, W = cfg.tile
        feed = torch.as_tensor(feed).to(device=self.device, dtype=torch.int32)
        B = feed.shape[0]
        y, new_tail = kdispatch.fir(
            feed, params["taps"], tail=state.tail[0],
            degree=kdispatch.site_degree(degree, 0), shift=cfg.q)
        img = y.reshape(B, H, W)
        img = kdispatch.conv2d(img, params["kern"],
                               degree=kdispatch.site_degree(degree, 1),
                               shift=8, pad="edge")
        img = kdispatch.conv2d(img, params["gain"],
                               degree=kdispatch.site_degree(degree, 2),
                               shift=cfg.q)
        out = img.reshape(B, cfg.frame)
        # the state advances in place (one address per field, as a step
        # replayed from a CUDA graph needs): every slot's FIR history, the
        # active slots' lengths
        state.tail.copy_(new_tail[None])
        advanced = StreamState(length=state.length + 1, tail=state.tail)
        return out, cache_mask_update(state, advanced, active, into=state)

    def harvest(self, req, feed, slot, emission):
        req.out.append(np.asarray(emission, np.int32))
        if req.cursor < len(req.payload):
            feed[slot] = req.payload[req.cursor]
            req.cursor += 1
            return True, False, {}
        return True, True, {}

    # ---- calibration / quality ---------------------------------------

    def forward(self, params, batch, degree=None):
        """Whole-clip forward (the calibration probe surface):
        ``batch["frames"]`` (B, F, frame) int32 -> (B, F, frame) f32 in
        sample units, by a Python loop over frames through the exact
        per-frame step, so calibration measures the arithmetic serving
        executes; ``degree=None`` is the exact pipeline."""
        frames = torch.as_tensor(batch["frames"]).to(self.device, torch.int32)
        B, F, _ = frames.shape
        active = torch.ones((B,), dtype=torch.bool, device=self.device)
        state = StreamState(
            length=torch.zeros((B,), dtype=torch.int32, device=self.device),
            tail=torch.zeros((1, B, self.cfg.taps - 1), dtype=torch.int32,
                             device=self.device))
        outs = []
        for f in range(F):
            out, state = self.step(params, state, frames[:, f], active, None, degree)
            outs.append(out)
        return torch.stack(outs, dim=1).to(torch.float32) / (1 << self.cfg.q), {}

    def exact_model(self):
        return self

    def quality_tap(self, *, every, registry, tracer):
        """Live per-frame PSNR vs the exact-arithmetic pipeline, bucketed in
        dB (the stream analogue of the LM logit-RMS tap).  The step advances
        its state in place, so the probe's two steps run on copies of the
        live state, which stays as it was."""
        from repro_torch.obs.quality import QualityTap

        peak2 = float(1 << self.cfg.q) ** 2          # exact in f32

        def probe(p, state, feed, active, deg, exact_deg):
            copy = lambda: StreamState(*(t.clone() for t in state))
            approx, _ = self.step(p, copy(), feed, active, None, deg)
            exact, _ = self.step(p, copy(), feed, active, None, exact_deg)
            w = active.to(torch.float32)[:, None]
            n = torch.clamp(w.sum() * approx.shape[-1], min=1.0)
            err = (((approx - exact).to(torch.float32) ** 2) * w).sum() / n
            # log10 as jnp.log10 computes it: log(x) * f32(1 / ln 10)
            return 10.0 * (torch.log(peak2 / torch.clamp(err, min=peak2 * 1e-18))
                           * _INV_LN10)

        return QualityTap(probe=probe, every=every, registry=registry,
                          tracer=tracer, metric_name="psnr_db",
                          buckets=PSNR_BUCKETS)


class StreamServeEngine(_engine.ServeCore):
    """Stream-workload engine facade: ``ServeCore`` over a
    :class:`StreamAdapter` (on ``device`` unless one is given), with
    clip-flavored ``submit``."""

    def __init__(self, adapter: Optional[StreamAdapter] = None, params=None,
                 *, slots: int = 4, device="cuda", **kw):
        adapter = adapter or StreamAdapter(device=device)
        params = adapter.init_params() if params is None else params
        kw.setdefault("max_len", 0)
        super().__init__(adapter, params, slots=slots, **kw)

    def submit(self, frames, max_frames: Optional[int] = None, **kw):
        """Enqueue one clip; processed frames accumulate in
        ``request.out`` as (frame,) int32 arrays.  ``kw``: ``deadline_ms`` /
        ``ttft_deadline_ms`` (``ServeCore.submit``)."""
        return super().submit(frames, max_frames, **kw)


def make_clip(n_frames: int, frame: int, q: int = 12, seed: int = 0,
              kind: str = "chirp") -> np.ndarray:
    """Deterministic synthetic test clip (benchmarks/examples): a noisy
    chirp ("chirp") or uniform noise ("noise"), Q-``q`` int32 (F, frame)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * frame, dtype=np.float64)
    if kind == "chirp":
        sig = 0.7 * np.sin(2 * np.pi * t * (0.002 + 1e-7 * t))
        sig = sig + 0.05 * rng.standard_normal(t.size)
    else:
        sig = rng.uniform(-0.9, 0.9, t.size)
    q12 = np.clip(np.round(sig * (1 << q)), -(1 << q), (1 << q))
    return q12.astype(np.int32).reshape(n_frames, frame)
