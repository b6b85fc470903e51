#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with the card (H100)
    python3 chip_smoke.py --rehearse   # the same phases on the CPU with the
                                       # plain versions, at smoke size

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernel build
     (nvcc for sm_90a from kernels/csrc, with the -Xptxas -v lines, and one
     line of each flash_attention, flash_decode, axqmm and axmult_elem
     instantiation's registers, spills and shared memory: none may spill);
  2. each hand-written kernel against its plain PyTorch version on the same
     seeded inputs at the serving paths' full-width shapes (tinyllama-1.1b,
     h2o-danube-1.8b and qwen2.5-3b for the LM kernels, with head_dim 128
     in both attention bodies and the GEMM's bias epilogue; the stream
     tick's stages and the Ch. 7 bench layouts for the PR kernels, each
     product-sum row also bit-identical to the old route (the planes
     through the elementwise pr_multiply, then torch.sum), beside one
     empty launch by graph replay; a
     decode row with lengths at the decode kernels' split edges; qwen's
     long-prefill GEMMs at M = 4096; granite-moe-3b-a800m's and
     qwen2-moe-a2.7b's experts on the expert-batched launches at the decode
     capacity and at a 512-token prefill's, qwen2-moe's shared experts,
     granite's unembedding at N = 49155, both decode kernels at groups of
     3 and 1, tri at 24/8 heads; the recurrent families: mamba2-370m's
     fused in_proj at N = 4384 and tied unembedding at N = 50280,
     recurrentgemma-2b's projections, gelu gated half and 256000-wide
     unembedding, flash_attention at head_dim 256 with MQA 10/1 -- band
     at window 2048 over 8192 tokens, tri over 2048 in bf16 and f32 --
     and flash_decode at D = 256, G = 10 on the 2048-row ring, lengths at
     the split edges; the frontend archs: hubert-xlarge's non-causal
     ``dense`` attention at D = 80 (16 heads, 1024 frames, timed beside
     SDPA(is_causal=False)), unembedding (N = 504) and gelu gated half at
     its training rows, internvl2-1b's unembedding at its odd, unpadded N =
     151655, its gated half, ``v_proj/fc1`` (K 1024, bias) at 4 x 1024 image
     rows, ``tri`` at GQA 14/2 (G = 7) over 2048 tokens and both decode
     kernels at G = 7; the tp=2 shard shapes of 3s and 3t: tinyllama's and
     granite's q/kv/wo/down GEMMs, vocab shards and gated half per rank,
     both decode at the kv heads a rank, tri at 16/2 and 12/4, granite's
     expert-batched launches at 20 experts a rank; those of 3u and 3v:
     mamba2-370m's in_proj ``[z_r | x_r | B | C | dt_r]`` at N 2320, out_proj's
     rows K 1024, the vocab shard N 25140; recurrentgemma-2b's N 1280
     projections, wo's rows K 1280, the kv-split wk N 128, down's rows K
     3840, the gated half N 3840, the vocab shard N 128000, decode at G 5 on
     the 2048-row ring, band at 5/1 heads; those of 3w: one data
     coordinate's 4 rows of tinyllama's tp=2 GEMMs and gated half, both
     decode kernels at B 4), with the stated tolerance (the GEMMs
     also bit-identical, and at decode at least one block an SM), timed
     with CUDA events beside its bound and, where one PyTorch call computes
     the same function, that call (the decode kernels, the GEMMs, SDPA and
     torch._int_mm also by CUDA-graph replay, with GB/s or TOP/s);
  3. the serving paths, each with the launch counts set to 0 just before
     it and read just after, random weights from a seeded CUDA generator
     under axq8 with the QoS ladder 8 -> 5, prepacked, served by the
     continuous-batching engine — tinyllama-1.1b:
       3   exact-length admission, bf16 KV cache;
       3b  the int8 KV cache with bucketed, packed admission (warmup runs
           every bucket shape first; no new call shape after it);
       3c  the bf16 cache with bucketed, packed and chunked admission,
           long prompts among short ones;
     the streaming DSP workload at its StreamConfig() widths —
       3d  a backlog of clips (FIR -> 3x3 blur -> gain on the PR
           multiplier: one pr_fir and two pr_conv2d launches a tick, no
           pr_multiply) on 64 slots with the per-site QoS ladder 8 -> 5,
           every frame bit-identical to a second run of the same traffic
           through the plain versions on the card;
     per-layer approximation plans (repro_torch.tune), served through
     ``launch.serve --plan --qos`` with ``--trace-out``, ``--metrics-out``
     and ``--quality-every 8`` —
       3i  tinyllama-1.1b (full width, cut to 4 of its 22 layers: the
           time limit): a plan built on the card by ``build_plan``
           (measured greedy over L + 1 sites, grid (8, 5), a (2, 64)-token
           calibration batch on the launcher's seeded weights), checked
           (validate_for, Pareto order, save/load), served on the bf16 cache
           (the trace's decode_tick spans, qos_rung events with L + 1 degrees,
           the degree gauges, route counters and quality histogram of the
           metrics file held to the engine), a rung pinned through the plan
           against its vector by hand, and the decode tick with the tracer
           and the tap off and on;
       3j  the stream pipeline: a plan on per-frame PSNR, built with the
           kernels and with the plain versions (equal field for field),
           served on 3d's traffic with the PSNR tap, frames bit-identical to
           a plain run;
     the EMUL / POW2_W arithmetic and the resilience layer on tinyllama —
       3k  PR_EMUL (p=1, r=2), RAD_EMUL (k=4), ROUP_EMUL (k=4, p=1, r=1) and
           POW2_W, each uniform, prepacked and captured (cut to 4 of the
           22 layers: the time limit), 8 prompts of
           64-512 tokens: at one decode tick every integer product's int32
           accumulator equal to an exact CPU product of the same int8
           operands (POW2_W: every snapped weight to a CPU snap), no GEMM
           kernel launched (the product is torch._int_mm), the flash
           kernels as predicted; torch._int_mm timed at decode (padded) and
           at M = 255 beside its bound;
       3l  guards, quarantine, scrubbing, deadlines, retries, shedding and
           brownout under seeded fault storms: through ``launch.serve
           --faults ... --brownout``; through ServeCore with a
           VirtualClock on 3's and 3b's engines (two runs of one seed and
           the eager twin with identical recovery traces, the guarded
           clean run's tokens equal to the unguarded run's, a nan / drop /
           spike storm at a fixed degree leaving every request ok with the
           clean tokens); through the stream engine on 3d's traffic; every
           request ends once, the parameters byte-equal to the golden copy
           after the final scrub, no capture after warmup;
     h2o-danube-1.8b (sliding window 4096, head_dim 80) —
       3e  prompts past the window (``band``) on the bf16 ring cache;
       3f  the same on the int8 ring with bucketed admission;
     qwen2.5-3b (head_dim 128, QKV bias, GQA 16/2, vocab 151936; served at
     6 of its 36 layers: the time limit) —
       3g  prompts of a few thousand tokens among short ones, exact-length
           admission on the bf16 cache (``tri`` at D = 128);
       3h  the same on the int8 cache with bucketed, packed admission;
     granite-moe-3b-a800m (40 experts of 512, top-8, GQA 24/8, vocab 49155;
     served at 4 of its 32 layers: the time limit) on phase 3's traffic,
     exact-length admission (MoE's only
     one: capacity couples the rows of a call) —
       3m  the bf16 cache, the experts on one expert-batched gated and one
           down launch a layer;
       3n  the same on the int8 cache;
     the recurrent families, bucketed packed admission (buckets 64-512,
     pack 4; the long prompts past the ladder at their exact length) on
     their state caches, whose bytes must not depend on the prompts —
       3o  mamba2-370m (8 of its 48 layers: the time limit; d_inner 2048, 32
           SSD heads of 64, state 128, chunk 256): 16 prompts of 64-512
           tokens and 2 of 4096-8192;
       3p  recurrentgemma-2b (8 of its 26 layers, two (rec, rec, attn)
           groups and 2 tail blocks: the time limit; MQA 10/1 at head_dim
           256, window 2048: a ring): 3
           prompts of 4096-8192 tokens (band) among 9 of 64-512;
     the VLM's backbone, text-only as the reference serves it —
       3q  internvl2-1b (4 of its 24 layers: the time limit; GQA 14/2, QKV bias,
           vocab 151655) on
           phase 3's traffic: exact-length admission on the bf16 cache
           (captured, its eager twin, a traced tick) and bucketed, packed
           admission;
     the replica fleet on one card —
       3r  tinyllama-1.1b behind a FleetSupervisor of 3 replicas sharing
           one packed weight set, under seeded replica_loss on a
           VirtualClock: every request ends once, ok token streams equal a
           clean single engine's bit for bit, two runs of one seed give one
           recovery trace, the packs held once (peak memory); then
           ``launch.serve --replicas 3 --faults replica_loss=...`` for the
           wall numbers;
     tensor-parallel serving, two ranks on the one card (processes joined
     by an explicit gloo group: NCCL refuses two ranks on one GPU; gloo
     reduces CUDA tensors through its own host copies, and the all-gather
     and the ring's hops are staged through host memory, ``"transport"``
     in the record), each with its shards of the weights (packed on the shard)
     and its heads of the cache, eager —
       3s  tinyllama-1.1b at full width (the served model 4 of its 22
           layers: the time limit; the launcher below the whole model), tp=2, on
           phase 3's traffic: every request ok, the ranks' streams equal,
           each rank's launches as the layer count predicts (5 L + 1
           ``axqmm``, L gated, L decode a tick, at the shard shapes), the
           collectives as
           predicted (the embedding's all-reduce and two a layer, the
           logits' all-gather a tick); cut to 2 layers, the first decode
           step's logits at tp=2 against tp=1 on the same weights (4x the
           noise floor), and under EXACT (f32) the int8 ring within rel
           0.05 of exact tp=2 at most half its bytes; one decode tick's
           collective calls and bytes by kind on each rank equal to the
           dry run's of the same tick on its meta mesh; then ``launch.serve
           --tp 2 --dist-backend gloo`` for the wall numbers;
       3t  granite-moe-3b-a800m at full width, cut to 4 of its 32 layers
           (the script's time limit), tp=2, 20 experts a rank, with
           the exact combine and with the int8-ring combine (the same
           gates), and its 2-layer cut under EXACT (f32): tp=2 against tp=1
           within 1e-4 of the largest logit, the ring combine
           within rel 0.05 at most half the combine's bytes;
       3u  mamba2-370m at full width (2 of its 48 layers: the time limit),
           tp=2 in 3s's spawn of ranks (each rank 16 of the 32 SSD heads:
           in_proj cut by its parts, gnorm's sum of squares all-reduced),
           axq8 with the ladder, bucketed packed admission (buckets 64-512,
           pack 4) of phase 3's prompts and one past the ladder: 3s's gates
           with the family's launches, 2 L + 1 all-reduces a decode step and
           a prefill, each rank's bucketed state equal to the exact-length
           one bit for bit; cut to 2 layers, tp=2 against tp=1 (4x the noise
           floor under axq8, 1e-4 under EXACT f32);
       3v  recurrentgemma-2b at full width (one (rec, rec, attn) group of
           its 26 layers: the time limit), tp=2 in the same spawn (half the RG-LRU channels,
           5 query heads over MQA's one kv head: the kv-split path), a prompt
           past the 2048 window (``band``, the ring) among phase 3's: 3u's
           gates, the k and v gathers an attention block, the prefills by
           schedule; its one-group cut as 3u's;
       3w  tinyllama-1.1b at full width (4 of its 22 layers: the time
           limit) at 2x2 in 5i's spawn of four ranks (each 4 of the 8 slots
           and 16 of the 32 heads), axq8 with the ladder, phase 3's prompts
           on the bf16 cache, then bucketed packed on the int8 cache: every
           request ok, the four ranks' streams equal, each rank's launches
           and collectives as its rows predict (a prefill only on its rows'
           data coordinate; the tokens' all-gather over ``data``), tokens
           equal one rank's up to measured near-ties;
       3x  2 tinyllama-1.1b replicas x tp=2 (4 layers) on the same four
           ranks, disjoint slices, seeded replica_loss on a VirtualClock,
           twice: every request once and ok, tokens equal a clean engine's,
           one recovery trace, the last rescale data=1, model=2, each rank's
           launches as its replicas' steps predict;
     every request must finish and every kernel of the path must have
     launched exactly as the layer (or stage) count predicts, while no
     plain version ran on the card.  Every path serves from CUDA graphs,
     one per call shape of the step, each bucket and the chunk, captured
     when its engine is built (the launch counts rise by each replay's
     recorded launches); 3, 3b, 3e, 3g, 3m, 3n, 3o, 3p and 3d also serve their
     traffic eagerly (``capture=False``) in the same call, with equal tokens or
     frames required, and print the two ticks beside the traced captured
     tick's device time and busy share, the capture seconds and the graph
     pool's bytes;
  4. each LM cut to 2 layers (one prefill and 4 greedy decode steps), on
     the bf16 and on the int8 cache: every kernel call checked against its
     plain version on the model's own inputs, the logits of a kernel run
     against a plain run within the model's measured noise floor, and
     (but for the MoE arch, exact-length only) prompts padded to one
     bucket against their exact-length prefill; mamba2-370m cut to 2
     layers and recurrentgemma-2b to 4 (one group and one tail block) on
     their one cache, the padded prompts' state bit-identical;
  5. training (after the serving paths), the forward on the kernels and the
     backward through the oracles (no TPU kernel has a backward):
       5a  tinyllama-1.1b at full width and depth, axq8 with the QoS ladder
           8 -> 5 moving, batch 8 x seq 1024 from the synthetic pipeline,
           8 train steps: finite loss and grad norm, launches as predicted
           (22 flash_attention, 111 axqmm, 22 axqmm_gated a step), no plain
           version on the card; step time, tokens/s, peak memory and the
           backward oracles' share of the last step (CUDA events); first the
           kernels at the step's shapes (GEMMs at M = 8192, tri at BH = 256,
           S = 1024) against their plain versions; then the same step
           counted on the meta device (dist/hlo_analysis.py): its
           argument_bytes equal to the live step's arguments' bytes, its
           dot FLOPs by dtype, their rate over the measured step beside the
           card's dense peak for each dtype (DOT_PEAKS, the datasheet's),
           again with the forward attention's products (counted f32 by the
           reference's extents) under the dtype the card runs them in, and
           the counted eager peak beside max_memory_allocated;
       5b  the same cut to 2 layers: one step with the kernels against one
           with the plain versions (loss, every gradient, the updated
           parameters; the attention projections' gradients nonzero), and
           30 EXACT steps on one batch dropping the loss by more than 1.0;
       5c  ``launch.train`` at 2 layers with --compress-grads --trace-out
           --metrics-out in child processes: uninterrupted; preempted by
           SIGTERM; resumed from its checkpoint (restored bit for bit) to
           the end, the losses within tolerance of the uninterrupted run's;
       5d  one step each of granite-moe-3b-a800m (2 layers), mamba2-370m (2
           layers), recurrentgemma-2b (one group, past its window:
           ``band`` at head_dim 256), internvl2-1b (2 layers, 1024 image +
           1024 text tokens) and hubert-xlarge (2 layers, non-causal
           ``dense``), kernels against plain;
       5e  internvl2-1b at full width, cut to 6 of its 24 layers (the
           script's time limit), axq8, batch 4 x seq 2048 (1024 image
           + 1024 text tokens), 8 steps: 5a's gates and numbers, launches 33
           / 6 / 6 (tri) a step (123 / 24 / 24 at full depth);
       5f  hubert-xlarge at full width, cut to 12 of its 48 layers (the time limit),
           axq8, batch 8 x 1024 frames, remat none, 8 steps: launches 62 /
           12 / 12 (dense) a step (242 / 48 / 48 at full depth);
     training on a mesh, tinyllama-1.1b at full width, ranks on the one
     card joined by an explicit gloo group as in 3s (each rank its shards
     and its data coordinate's rows; the collectives carry the gradients),
     first phase 2's rows at the training shard shapes (M = 8192: wq N
     1024, wk / wv N 128, wo K 1024 and down K 2816 as f32 partials, the
     vocab shard N 16000, the gated half N 2816, ``tri`` 16/2 over 8 x
     1024; M = 4096 on the full weights: N 2048 / 256 / 32000, K 5632,
     gated N 5632, ``tri`` 32/4 over 4 x 1024; 5k's granite-moe-3b-a800m
     shards at M = 4096: the expert-batched halves at E 20, C 1024, K 1536
     -> N 512 and K 512 -> N 1536, wq N 768, the vocab shard N 24578,
     ``tri`` 12/4 over 4 x 1024) —
       5g  1x2, full depth, axq8 with the ladder 8 -> 5 moving, global batch
           8 x 1024, 3 steps: finite losses equal bit for bit on both ranks,
           the replicated parameters' fingerprints equal, 111 / 22 / 22
           launches a step a rank at the shard shapes, 4 L + 6 all-reduces a
           step, no plain version on the card; step time, tokens/s, each
           rank's peak memory, the collectives' host and wait ms and bytes,
           the oracles' share; the last step's collective calls and bytes by
           kind on each rank equal to the dry run's of the step on its meta
           mesh;
       5h  2x1, full width and depth, 4 x 1024 a rank: 5g's gates, both ranks'
           parameters equal after every step, the gradient all-reduce 4 x
           the parameter count in bytes a step;
       5k  granite-moe-3b-a800m at full width at 1x2 (20 experts and 12 / 4
           heads a rank, the router replicated), remat full, cut to 12 of its
           32 layers (the time limit; the functional AdamW update holds ~32 B
           a parameter),
           axq8 with the ladder moving, 4 x 1024 from the pipeline, 3 steps:
           5g's gates with 8 L + 1 / 0 / 2 L / 2 L / 2 L launches a step a
           rank (axqmm / gated / experts' down / experts' gated / tri) and 6 L
           + 6 all-reduces (the dispatched rows' and gates' cotangents, wo's
           reduction recomputed);
       5l  mamba2-370m at full width at 1x2 (16 SSD heads a rank, in_proj
           cut by its parts), 6 of its 48 layers, axq8 with the ladder, 4 x
           1024 from the pipeline, 3 steps, remat none: 5g's gates with 2 L +
           1 launches a step a rank and 7 L + 6 all-reduces (backward: the
           normed input's dx, gnorm's sum of squares and the B / C columns'
           gradients of in_proj and the conv a layer);
       5m  recurrentgemma-2b at full width at 1x2, cut to 5 of its 26 layers
           (one group and 2 tail blocks: the time limit; its two 655 M-parameter
           embeddings alone hold ~21 GB a rank under the functional AdamW
           update), 5l's settings: 5g's gates with the hybrid's launches, 4 L +
           2 n_attn + 6 all-reduces and 2 n_attn all-gathers a step;
       5i  2 layers, one step at 1x2, 2x1 and 2x2 (four ranks) against the
           one-rank step on the same weights and batch (in each rank's
           process): EXACT f32 within 1e-4 of each leaf's largest entry,
           axq8 within 4x the noise floor (5b's measure), the int8 ring under
           EXACT f32 at 1x2 within rel 0.25 of the exact mesh step's gradient
           (the reference's own ring: 0.165 at this shape) at most half its
           bytes, --compress-grads at 2x1; granite-moe-3b-a800m the same at
           1x2 (axq8: kernels on the mesh vs the plain one-rank step), 2x1
           and 2x2 (against the reference's mesh semantics on one rank:
           capacity and aux per data shard), internvl2-1b and hubert-xlarge
           at 1x2 under EXACT f32, mamba2-370m at 1x2 and 2x1 (EXACT f32 and
           axq8; at 2x1 where its step parts from one rank's, beside the
           one-rank step with its rows swapped), recurrentgemma-2b's one
           group at 1x2, its gradients alone (its one-rank state does not
           fit twice on the card);
       5j  ``launch.train --mesh 1x2 --dist-backend gloo`` at 2 layers:
           uninterrupted, SIGTERM'd (the launcher passes the signal to its
           ranks, which checkpoint at one step), resumed (restored shards
           equal to the saved state, losses within tolerance); then the 1x2
           checkpoint restored at 1x1 bit for bit; the same preempted and
           resumed run for granite-moe-3b-a800m at 2 layers;
  6. one {"kernels": [...]} line and, last, the result line.

``--tp-only`` builds, then runs only phase 2's tp=2 shard rows, 3s, 3t, 3u
and 3v (no result line); ``--train-mesh-only`` builds, then runs only phase
2's training and 2x2 shard rows, 5g-5m, 3w and 3x (no result line);
``--dp-only`` builds, then runs only phase 2's 2x2 shard rows, 3w, 3x and
5i's mamba2-370m 2x1 step (no result line).

With ``--record PATH`` every number also goes to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: published H100 SXM peaks (dense): HBM bytes/s, int8 ops/s, bf16 flops/s,
#: f32 flops/s outside the tensor cores
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

#: the dense peak rate of each dot dtype of the analysis (dist/hlo_analysis.py's
#: names: s32 the int8 products), from NVIDIA's H100 Tensor Core GPU datasheet
#: (SXM5, without sparsity); f32 is the CUDA cores' FP32 rate (TF32 stays off)
DOT_PEAKS = {"s32": (INT8_OPS, "INT8 Tensor Core 1979 TOPS, H100 SXM5 datasheet, dense"),
             "bf16": (BF16_FLOPS, "BF16 Tensor Core 989 TFLOPS, H100 SXM5 datasheet, dense"),
             "f32": (F32_FLOPS, "FP32 67 TFLOPS, H100 SXM5 datasheet")}

#: bytes each timed loop cycles through, to keep repeated inputs out of the
#: 50 MB L2 cache (the serving path meets its weights and caches cold)
ROTATE_BYTES = 256 << 20

SOURCES = {
    "axqmm": ("src/repro_torch/kernels/csrc/axqmm.cu", "src/repro/kernels/axqmm.py:89"),
    "axqmm_gated": ("src/repro_torch/kernels/csrc/axqmm.cu", "src/repro/kernels/axqmm.py:117"),
    # the expert-batched launches of the same kernels (the reference vmaps
    # their Pallas calls over an MoE layer's experts)
    "axqmm_experts": ("src/repro_torch/kernels/csrc/axqmm.cu", "src/repro/kernels/axqmm.py:89"),
    "axqmm_gated_experts": ("src/repro_torch/kernels/csrc/axqmm.cu",
                            "src/repro/kernels/axqmm.py:117"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:78"),
    "flash_decode_quant": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:109"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:117"),
    "pr_multiply": ("src/repro_torch/kernels/csrc/axmult_elem.cu",
                    "src/repro/kernels/axmult_elem.py:28"),
    # the product-sum forms the reference builds around _pr_kernel
    "pr_fir": ("src/repro_torch/kernels/csrc/axmult_elem.cu",
               "src/repro/kernels/axmult_elem.py:28"),
    "pr_conv2d": ("src/repro_torch/kernels/csrc/axmult_elem.cu",
                  "src/repro/kernels/axmult_elem.py:28"),
}

#: the row keys that name a phase-2 shape
SHAPE_KEYS = ("E", "M", "N", "K", "bias", "act", "B", "T", "KVr", "G", "BH", "S", "D", "window",
              "ebits", "dtype", "shape", "L", "H", "W", "kh", "kw", "pad", "shift")


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``ops`` on the card."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """CUDA-event timing of ``fn(i)`` over ``iters`` calls after warm-up;
    on the CPU (rehearsal) nothing is timed."""

    def __init__(self, torch, on_card: bool):
        self.torch = torch
        self.on_card = on_card
        # one warm-up stream for every graph: each new stream would keep a
        # cuBLAS workspace of its own (torch._int_mm) for the rest of the run
        self.side = torch.cuda.Stream() if on_card else None

    def __call__(self, fn, iters: int = 30, warmup: int = 3):
        if not self.on_card:
            fn(0)
            return None
        torch = self.torch
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def graph(self, fn, n: int, reps: int = 5):
        """Device time of one ``fn(i)`` call: ``n`` calls captured in one
        CUDA graph and replayed, so the host's per-call work (the wrapper's
        checks, the ctypes call) is not in the time — for kernels shorter
        than their launch."""
        if not self.on_card:
            fn(0)
            return None
        torch = self.torch
        side = self.side
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(3):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(n):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * n)


def copies(make, nbytes: int, on_card: bool) -> list:
    n = max(1, min(1024, math.ceil(ROTATE_BYTES / max(nbytes, 1)))) if on_card else 1
    return [make() for _ in range(n)]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_axqmm(ctx, M, N, K, residual, degree, bias=False):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

    gen = torch.Generator(device=dev).manual_seed(1000 + M + N + K)
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    bk = resolve_block(K, 256)
    pw = prepack_weight(w, bk)
    res = torch.randn(M, N, generator=gen, device=dev) if residual else None
    b = torch.randn(N, generator=gen, device=dev) if bias else None
    y = A.axqmm_packed(x, pw, degree, bias=b, residual=res)
    yp = A.axqmm_packed_plain(x, pw, degree, bias=b, residual=res)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-5, atol=1e-4))
    require(err == 0.0, f"axqmm M={M} N={N} K={K}: not bit-identical to its plain "
                        f"version (max_abs_err {err})")
    nb = K // bk
    wbytes = N * K + N * nb * 4
    pws = copies(lambda: PackedQWeight(pw.qw.clone(), pw.scales.clone()), wbytes,
                 ctx["on_card"])
    qx, sx = A.quantize_for_axqmm(x, bk)
    row = {"M": M, "N": N, "K": K, "residual": residual, "bias": bias, "max_abs_err": err,
           "tol": "rtol 1e-5, atol 1e-4 (and bit-identical)", "ok": ok}
    gemm_plan(ctx, row, M, N, K, bk, False)
    if ctx["on_card"]:
        kernel = lambda i: A.axqmm_quantized(qx, sx, pws[i % len(pws)], degree, bias=b,
                                             residual=res)
        row["ms"] = timer(kernel)
        row["ms_graph"] = timer.graph(kernel, len(pws))
        row["wrapper_ms"] = timer(lambda i: A.axqmm_packed(x, pws[i % len(pws)],
                                                           degree, bias=b, residual=res))
        row["plain_ms"] = timer(lambda i: A.axqmm_packed_plain(
            x, pws[i % len(pws)], degree, bias=b, residual=res), iters=5, warmup=1)
        # cuBLASLt's int8 GEMM wants M > 16: a decode-sized x is zero-padded;
        # and N a multiple of 8: a ragged N (granite's vocab 49155) gets
        # zero weight rows
        qxl = qx if M > 16 else torch.cat([qx, qx.new_zeros(32 - M, K)])
        Nl = -(-N // 8) * 8
        lib_w = [pw.qw if Nl == N else torch.cat([pw.qw, pw.qw.new_zeros(Nl - N, K)])
                 for pw in pws]
        library = lambda i: torch._int_mm(qxl, lib_w[i % len(lib_w)].t())
        row["library_ms"] = timer(library)
        row["library_ms_graph"] = timer.graph(library, len(pws))
        row["library_call"] = (f"torch._int_mm on ({qxl.shape[0]}, K) x (K, {Nl}) int8 "
                               "(no block scales or degrade)")
    nbytes = (M * K + M * nb * 4 + wbytes + M * N * 4 * (2 if residual else 1)
              + (N * 4 if bias else 0))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * N * K, INT8_OPS)
    gemm_rates(row, 2.0 * M * N * K)
    return row


def gemm_plan(ctx, row, M, N, K, bk, gated, experts=1) -> None:
    """The launch the wrapper plans for this shape (``experts`` of them in
    one expert-batched launch) on this card: tile configuration, splits of
    K, units a block, and the main kernel's blocks an SM (at decode, M <=
    16, at least one an SM)."""
    from repro_torch.kernels import axqmm as A

    sms = ctx["torch"].cuda.get_device_properties(0).multi_processor_count \
        if ctx["on_card"] else 132
    p = A.plan(M, N, K, bk, gated, sms, experts)
    row["plan"] = {"cfg": ("decode", "tile64", "tile128")[p.cfg],
                   "n_split": p.n_split, "part": p.part}
    row["blocks_per_sm"] = A.blocks(p, M, N, gated, experts) / sms
    if M <= A.DECODE_M and ctx["on_card"]:   # the smoke widths cannot fill a card
        require(row["blocks_per_sm"] >= 1, f"axqmm M={M} N={N} K={K}: {p} launches "
                                            f"fewer blocks than the card has SMs")


def gemm_rates(row, ops) -> None:
    """Achieved int8 TOP/s of a GEMM row at its device (graph-replay) time,
    and that time over its bound."""
    if row.get("ms_graph"):
        row["tops_graph"] = ops / (row["ms_graph"] * 1e-3) / 1e12
        row["ms_graph_over_bound"] = row["ms_graph"] / row["bound_ms"]


def check_gated(ctx, M, N, K, degree, act="silu"):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

    gen = torch.Generator(device=dev).manual_seed(2000 + M + N + K)
    x = torch.randn(M, K, generator=gen, device=dev)
    bk = resolve_block(K, 256)
    pu = prepack_weight(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K), bk)
    pg = prepack_weight(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K), bk)
    y = A.axqmm_gated_packed(x, pu, pg, degree, act=act)
    yp = A.axqmm_gated_plain(x, pu, pg, degree, act=act)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-5, atol=1e-4))
    require(err == 0.0, f"axqmm_gated M={M} N={N} K={K} {act}: not bit-identical to its "
                        f"plain version (max_abs_err {err})")
    nb = K // bk
    wbytes = 2 * (N * K + N * nb * 4)
    pairs = copies(lambda: (PackedQWeight(pu.qw.clone(), pu.scales.clone()),
                            PackedQWeight(pg.qw.clone(), pg.scales.clone())),
                   wbytes, ctx["on_card"])
    qx, sx = A.quantize_for_axqmm(x, bk)
    row = {"M": M, "N": N, "K": K, "act": act, "max_abs_err": err,
           "tol": "rtol 1e-5, atol 1e-4 (and bit-identical)", "ok": ok}
    gemm_plan(ctx, row, M, N, K, bk, True)
    if ctx["on_card"]:
        kernel = lambda i: A.axqmm_gated_quantized(qx, sx, *pairs[i % len(pairs)], degree,
                                                   act=act)
        row["ms"] = timer(kernel)
        row["ms_graph"] = timer.graph(kernel, len(pairs))
        row["wrapper_ms"] = timer(lambda i: A.axqmm_gated_packed(
            x, *pairs[i % len(pairs)], degree, act=act))
        row["plain_ms"] = timer(lambda i: A.axqmm_gated_plain(
            x, *pairs[i % len(pairs)], degree, act=act), iters=5, warmup=1)
        # no one PyTorch call computes the gated product: `library_*` is
        # null; torch._int_mm of x on both weights is kept beside it
        qxl = qx if M > 16 else torch.cat([qx, qx.new_zeros(32 - M, K)])
        two = lambda i: (torch._int_mm(qxl, pairs[i % len(pairs)][0].qw.t()),
                         torch._int_mm(qxl, pairs[i % len(pairs)][1].qw.t()))
        row["int_mm_pair_ms_graph"] = timer.graph(two, len(pairs))
        row["library_ms"] = None
        row["library_ms_graph"] = None
    nbytes = M * K + M * nb * 4 + wbytes + M * N * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * M * N * K, INT8_OPS)
    gemm_rates(row, 4.0 * M * N * K)
    return row


def check_experts(ctx, E, C, N, K, degree, gated):
    """An expert-batched GEMM row (E experts of C capacity rows, K -> N;
    ``gated``: the fused up/gate half, else the down projection): the
    launch bit-identical to its plain version (and so each expert to the
    2-D launch on its slice), with every expert's last capacity row empty,
    as a decode tick leaves most of them.  Timed eagerly (``ms``, on the
    quantized x; ``wrapper_ms`` with the quantization) and by graph replay
    (``ms_graph``); beside it the E torch._int_mm calls of each weight
    (rows padded to 32), replayed from one graph (``int_mm_loop_ms_graph``:
    PyTorch has no batched int8 product), which is the down row's
    ``library_ms`` as the 2-D GEMM row's is one torch._int_mm."""
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

    name = "axqmm_gated_experts" if gated else "axqmm_experts"
    gen = torch.Generator(device=dev).manual_seed(6000 + E + C + N + K)
    x = torch.randn(E, C, K, generator=gen, device=dev)
    x[:, -1] = 0.0
    bk = resolve_block(K, 256)
    packs = [prepack_weight(torch.randn(E, K, N, generator=gen, device=dev) / math.sqrt(K), bk)
             for _ in range(2 if gated else 1)]
    kernel_of = A.axqmm_gated_experts_quantized if gated else A.axqmm_experts_quantized
    wrapper_of = A.axqmm_gated_experts_packed if gated else A.axqmm_experts_packed
    plain_of = A.axqmm_gated_experts_plain if gated else A.axqmm_experts_plain
    y = wrapper_of(x, *packs, degree)
    yp = plain_of(x, *packs, degree)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-5, atol=1e-4))
    require(err == 0.0, f"{name} E={E} C={C} N={N} K={K}: not bit-identical to its plain "
                        f"version (max_abs_err {err})")
    nb = K // bk
    wbytes = len(packs) * E * (N * K + N * nb * 4)
    sets = copies(lambda: [PackedQWeight(pw.qw.clone(), pw.scales.clone()) for pw in packs],
                  wbytes, ctx["on_card"])
    qx, sx = A.quantize_for_axqmm(x, bk)
    row = {"E": E, "M": C, "N": N, "K": K, "max_abs_err": err,
           "tol": "rtol 1e-5, atol 1e-4 (and bit-identical)", "ok": ok}
    gemm_plan(ctx, row, C, N, K, bk, gated, E)
    if ctx["on_card"]:
        kernel = lambda i: kernel_of(qx, sx, *sets[i % len(sets)], degree)
        row["ms"] = timer(kernel)
        row["ms_graph"] = timer.graph(kernel, len(sets))
        row["wrapper_ms"] = timer(lambda i: wrapper_of(x, *sets[i % len(sets)], degree))
        row["plain_ms"] = timer(lambda i: plain_of(x, *sets[i % len(sets)], degree), iters=3,
                                warmup=1)
        qxl = qx if C > 16 else torch.cat([qx, qx.new_zeros(E, 32 - C, K)], dim=1)
        loop = lambda i: [torch._int_mm(qxl[e], pw.qw[e].t())
                          for pw in sets[i % len(sets)] for e in range(E)]
        row["int_mm_loop_ms_graph"] = timer.graph(loop, len(sets))
        row["library_ms"] = None if gated else row["int_mm_loop_ms_graph"]
        row["library_ms_graph"] = row["library_ms"]
        row["library_call"] = (f"{len(packs) * E} torch._int_mm calls on ({qxl.shape[1]}, K) x "
                               "(K, N) int8 from one graph (no block scales or degrade)")
    nbytes = E * (C * K + C * nb * 4 + C * N * 4) + wbytes
    ops = 2.0 * len(packs) * E * C * N * K
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, INT8_OPS)
    gemm_rates(row, ops)
    return row


def check_decode(ctx, B, KVr, G, D, T, nvalid, active):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as FD

    gen = torch.Generator(device=dev).manual_seed(3000 + T)
    qg = torch.randn(B, KVr, G, D, generator=gen, device=dev)
    k = torch.randn(B, T, KVr, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, KVr, D, generator=gen, device=dev).to(torch.bfloat16)
    nv = torch.tensor(nvalid, dtype=torch.int32, device=dev)
    act = torch.tensor(active, dtype=torch.int32, device=dev)
    y = FD.flash_decode(qg, k, v, nv, act)
    yp = FD.flash_decode_plain(qg, k, v, nv, act)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=1e-4, atol=1e-4))
    free_zero = bool((y[[i for i, a in enumerate(active) if not a]] == 0).all())
    require(free_zero, "flash_decode: a free slot's output is not exactly zero")
    kv_bytes = 2 * k.numel() * 2
    caches = copies(lambda: (k.clone(), v.clone()), kv_bytes, ctx["on_card"])
    row = {"B": B, "KVr": KVr, "G": G, "D": D, "T": T, "nvalid": nvalid,
           "active": active, "max_abs_err": err, "tol": "rtol 1e-4, atol 1e-4",
           "ok": ok}
    live = sum(n for n, a in zip(nvalid, active) if a)
    nbytes = live * KVr * D * 2 * 2 + 2 * B * KVr * G * D * 4 + 2 * B * 4
    # the kernel's arithmetic is f32 on the CUDA cores
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * live * KVr * G * D, F32_FLOPS)
    if ctx["on_card"]:
        kernel = lambda i: FD.flash_decode(qg, *caches[i % len(caches)], nv, act)
        q4 = qg.reshape(B, KVr * G, 1, D).to(torch.bfloat16)
        mask = (torch.arange(T, device=dev)[None, :] < nv[:, None])[:, None, None, :]
        library = lambda i: F.scaled_dot_product_attention(
            q4, caches[i % len(caches)][0].transpose(1, 2),
            caches[i % len(caches)][1].transpose(1, 2), attn_mask=mask, enable_gqa=True)
        decode_times(ctx, row, kernel, library, nbytes, len(caches))
        row["plain_ms"] = timer(lambda i: FD.flash_decode_plain(
            qg, *caches[i % len(caches)], nv, act), iters=10)
        row["library_call"] = "F.scaled_dot_product_attention(enable_gqa, length mask)"
    return row


def decode_times(ctx, row, kernel, library, nbytes, n_copies) -> None:
    """A decode row's times: ``ms`` (and, where there is one, the library
    call's ``library_ms``) by eager calls, as the serving path makes them,
    the wrapper's host work included; ``ms_graph`` / ``library_ms_graph``
    by CUDA-graph replay of one call on each rotated copy of the cache, the
    device time alone; the achieved GB/s of the bound's bytes and
    ms_graph / bound_ms."""
    timer = ctx["timer"]
    row["ms"] = timer(kernel)
    row["ms_graph"] = timer.graph(kernel, n_copies)
    row["library_ms"] = timer(library) if library else None
    row["library_ms_graph"] = timer.graph(library, n_copies) if library else None
    row["gb_per_s"] = nbytes / (row["ms_graph"] * 1e-3) / 1e9
    row["ms_graph_over_bound"] = row["ms_graph"] / row["bound_ms"]


def check_decode_quant(ctx, B, KVr, G, D, T, nvalid, active, ebits):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.attention import _q8

    gen = torch.Generator(device=dev).manual_seed(5000 + T + ebits)
    qg = torch.randn(B, KVr, G, D, generator=gen, device=dev)
    k, ks = _q8(torch.randn(B, T, KVr, D, generator=gen, device=dev))
    v, vs = _q8(torch.randn(B, T, KVr, D, generator=gen, device=dev))
    nv = torch.tensor(nvalid, dtype=torch.int32, device=dev)
    act = torch.tensor(active, dtype=torch.int32, device=dev)
    # the degree as the serving path passes it: one element of a device vector
    e = torch.tensor([8, ebits], dtype=torch.int32, device=dev)[1]
    y = FD.flash_decode_quant(qg, k, ks, v, vs, nv, act, e)
    yp = FD.flash_decode_quant_plain(qg, k, ks, v, vs, nv, act, e)
    ctx["sync"]()
    err = float((y - yp).abs().max())
    ok = bool(torch.allclose(y, yp, rtol=0, atol=1e-5))
    free_zero = bool((y[[i for i, a in enumerate(active) if not a]] == 0).all())
    require(free_zero, "flash_decode_quant: a free slot's output is not exactly zero")
    cache_bytes = 2 * (k.numel() + ks.numel() * 4)
    caches = copies(lambda: (k.clone(), ks.clone(), v.clone(), vs.clone()), cache_bytes,
                    ctx["on_card"])
    row = {"B": B, "KVr": KVr, "G": G, "D": D, "T": T, "ebits": ebits, "nvalid": nvalid,
           "active": active, "max_abs_err": err, "tol": "atol 1e-5", "ok": ok}
    live = sum(n for n, a in zip(nvalid, active) if a)
    nbytes = (live * KVr * (D + 4) * 2 + 2 * B * KVr * G * D * 4 + 2 * B * 4 + 4)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * live * KVr * G * D, F32_FLOPS)
    if ctx["on_card"]:
        decode_times(ctx, row, lambda i: FD.flash_decode_quant(
            qg, *caches[i % len(caches)], nv, act, e), None, nbytes, len(caches))
        row["plain_ms"] = timer(lambda i: FD.flash_decode_quant_plain(
            qg, *caches[i % len(caches)], nv, act, e), iters=10)
        row["library_call"] = ("none: no single PyTorch call computes the degrade, "
                               "the dequantization and the attention")
    return row


#: flash_attention against its f64 plain version: (rtol, atol, stated) by
#: dtype — one bf16 ulp at |o| < 4 for the tensor-core body, the f32
#: tolerance of tests/test_torch_gpu.py for the CUDA-core body
FLASH_TOLS = {"bfloat16": (0.0, 1 / 64, "atol 1/64 (one bf16 ulp at |o| < 4)"),
              "float32": (1e-5, 1e-4, "rtol 1e-5, atol 1e-4")}


def flash_tol(dt):
    return FLASH_TOLS[str(dt).removeprefix("torch.")]


def check_prefill(ctx, BH, S, D, H, KVr, dtype=None):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dt = dtype or ctx["dtype"]
    gen = torch.Generator(device=dev).manual_seed(4000 + S)
    q = torch.randn(BH, S, D, generator=gen, device=dev).to(dt)
    k = torch.randn(BH, S, D, generator=gen, device=dev).to(dt)
    v = torch.randn(BH, S, D, generator=gen, device=dev).to(dt)
    y, steps = FA.flash_attention(q, k, v, causal=True, return_steps=True)
    yd, steps_d = FA.flash_attention(q, k, v, causal=True, skip_grid=False,
                                     return_steps=True)
    yp, steps_p = FA.flash_attention_plain(q, k, v, causal=True)
    ctx["sync"]()
    steps, steps_d = int(steps), int(steps_d)
    planned = FA.planned_grid_steps(BH, S)
    planned_d = FA.planned_grid_steps(BH, S, skip_grid=False)
    require(steps == planned == steps_p,
            f"flash_attention steps {steps} (plain {steps_p}) != planned {planned}")
    require(steps_d == planned_d, f"dense steps {steps_d} != planned {planned_d}")
    require(bool(torch.equal(y, yd)), "tri and dense schedules are not bit-identical")
    err = float((y.float() - yp.float()).abs().max())
    rtol, atol, tol = flash_tol(dt)
    ok = bool(torch.allclose(y.float(), yp.float(), rtol=rtol, atol=atol))
    # the grouped (model-layout) entry vs the (BH, S, D) entry on repeated K/V
    B = BH // H
    q4 = q.reshape(B, H, S, D).transpose(1, 2).contiguous()
    kg = k.reshape(B, H, S, D)[:, ::H // KVr].transpose(1, 2).contiguous()
    vg = v.reshape(B, H, S, D)[:, ::H // KVr].transpose(1, 2).contiguous()
    rep = lambda t: t.repeat_interleave(H // KVr, dim=2).transpose(1, 2).reshape(BH, S, D)
    yg = FA.flash_attention_grouped(q4, kg, vg, causal=True)
    yf = FA.flash_attention(q, rep(kg), rep(vg), causal=True)
    require(bool(torch.equal(yg.transpose(1, 2).reshape(BH, S, D), yf)),
            "grouped and flat flash_attention entries disagree")
    row = {"BH": BH, "S": S, "D": D, "dtype": str(dt), "steps": steps,
           "planned_steps": planned, "dense_steps": steps_d,
           "max_abs_err": err, "tol": tol, "ok": ok}
    per = 4 * BH * S * D * q.element_size()
    qkv = copies(lambda: (q.clone(), k.clone(), v.clone()), per, ctx["on_card"])
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: FA.flash_attention(*qkv[i % len(qkv)], causal=True))
        row["plain_ms"] = timer(lambda i: FA.flash_attention_plain(
            *qkv[i % len(qkv)], causal=True), iters=10)
        row["library_ms"] = timer(lambda i: F.scaled_dot_product_attention(
            *(t[None] for t in qkv[i % len(qkv)]), is_causal=True))
        row["library_call"] = "F.scaled_dot_product_attention(is_causal=True)"
    flops = 4.0 * BH * D * S * (S + 1) / 2
    peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
    row["bound_ms"], row["bound_by"] = bound(per, flops, peak)
    attention_rates(row, flops)
    return row


def attention_rates(row, flops) -> None:
    """Achieved TFLOP/s of a timed attention row (the kept (row, col)
    pairs x 4 D over its time) and its time over one SDPA call's."""
    if row.get("ms"):
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        if row.get("library_ms"):
            row["ms_over_library"] = row["ms"] / row["library_ms"]


def check_band(ctx, B, H, KVr, D, S, W):
    """The ``band`` schedule at the sliding-window arch's shapes: grouped
    (B, S, H, D) queries over (B, S, KVr, D) keys/values, window ``W``.  The
    in-kernel step count must equal ``planned_grid_steps``, ``band`` must
    equal ``dense`` under the same window bit for bit, and the grouped
    entry the flat one on repeated K/V."""
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dt = ctx["dtype"]
    G, BH = H // KVr, B * H
    gen = torch.Generator(device=dev).manual_seed(4500 + S)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, KVr, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, KVr, D, generator=gen, device=dev).to(dt)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    qf, kf, vf = flat(q), flat(k.repeat_interleave(G, 2)), flat(v.repeat_interleave(G, 2))
    y, steps = FA.flash_attention(qf, kf, vf, causal=True, window=W, return_steps=True)
    yd, steps_d = FA.flash_attention(qf, kf, vf, causal=True, window=W, skip_grid=False,
                                     return_steps=True)
    yg = FA.flash_attention_grouped(q, k, v, causal=True, window=W)
    yp, steps_p = FA.flash_attention_plain(qf, kf, vf, causal=True, window=W)
    ctx["sync"]()
    steps, steps_d = int(steps), int(steps_d)
    planned = FA.planned_grid_steps(BH, S, window=W)
    planned_d = FA.planned_grid_steps(BH, S, window=W, skip_grid=False)
    require(steps == planned == steps_p,
            f"band steps {steps} (plain {steps_p}) != planned {planned}")
    require(steps_d == planned_d, f"dense steps {steps_d} != planned {planned_d}")
    require(bool(torch.equal(y, yd)), "band and dense (same window) are not bit-identical")
    require(bool(torch.equal(flat(yg), y)), "grouped and flat band entries disagree")
    err = float((y.float() - yp.float()).abs().max())
    rtol, atol, tol = flash_tol(dt)
    ok = bool(torch.allclose(y.float(), yp.float(), rtol=rtol, atol=atol))
    _, blk, n, band, _ = FA._plan(S, True, W, 128, 128, True)
    row = {"BH": BH, "S": S, "D": D, "window": W, "grouped": f"{H}/{KVr}",
           "schedule": "band", "dtype": str(dt), "blk": blk, "band": band,
           "steps": steps, "planned_steps": planned, "dense_steps": steps_d,
           "max_abs_err": err, "tol": tol, "ok": ok}
    per = 2 * B * S * (H + KVr) * D * q.element_size()
    qkv = copies(lambda: (q.clone(), k.clone(), v.clone()), per, ctx["on_card"])
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: FA.flash_attention_grouped(*qkv[i % len(qkv)],
                                                               causal=True, window=W),
                          iters=10, warmup=2)
        row["plain_ms"] = timer(lambda i: FA.flash_attention_plain(
            qf, kf, vf, causal=True, window=W), iters=2, warmup=1)
        ii = torch.arange(S, device=dev)
        mask = (ii[None, :] <= ii[:, None]) & (ii[None, :] > ii[:, None] - W)
        row["library_ms"] = timer(lambda i: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in qkv[i % len(qkv)]), attn_mask=mask,
            enable_gqa=True), iters=10, warmup=2)
        row["library_call"] = ("F.scaled_dot_product_attention(causal-and-window bool "
                               "mask, enable_gqa=True)")
    # the (row, col) pairs the mask keeps: min(r + 1, W) for row r
    pairs = sum(min(r + 1, W) for r in range(S))
    row["bound_ms"], row["bound_by"] = bound(per, 4.0 * B * H * D * pairs, BF16_FLOPS)
    row["scheduled_flops"] = 4.0 * BH * n * band * blk * blk * D
    attention_rates(row, 4.0 * B * H * D * pairs)
    return row


#: the PR product's knobs in phase 2: the (p, r) of these degrees (read from
#: a device vector element, as the stream engine passes them) and raw (p, r)
#: pairs as benchmarks/bench_dsp.py sweeps them
PR_DEGREES = (8, 7, 6, 5, 4, 0)
PR_RAW = ((1, 4), (2, 8), (3, 8))


def check_pr_multiply(ctx, shape, what):
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import numpy as np

    from repro_torch.kernels import axmult_elem as PR
    from repro_torch.kernels import dsp

    numel = math.prod(shape)
    rng = np.random.default_rng(6000 + len(shape) + numel % 997)
    a, b = (torch.from_numpy(rng.integers(-2**15, 2**15, shape, dtype=np.int32)).to(dev)
            for _ in range(2))
    degrees = torch.tensor(PR_DEGREES, dtype=torch.int32, device=dev)
    knobs = [dsp.degree_to_pr(degrees[i]) for i in range(len(PR_DEGREES))] + list(PR_RAW)
    err = 0
    for pr in knobs:
        y = PR.pr_multiply(a, b, pr)
        yp = PR.pr_multiply_plain(a, b, pr)
        ctx["sync"]()
        err = max(err, int((y.to(torch.int64) - yp.to(torch.int64)).abs().max()))
    row = {"shape": list(shape), "what": what, "numel": numel,
           "knobs": [f"degree {e}" for e in PR_DEGREES] + [f"(p, r) = {k}" for k in PR_RAW],
           "max_abs_err": err, "tol": "exact (0)", "ok": err == 0}
    # timed at degree 5's (1, 6): ``ms`` the kernel alone (CUDA-graph replay
    # of launches on rotating inputs), ``wrapper_ms`` the eager wrapper call
    pr5 = knobs[PR_DEGREES.index(5)]
    ops = copies(lambda: (a.clone(), b.clone()), 8 * numel, ctx["on_card"])
    if ctx["on_card"]:
        row["ms"] = timer.graph(lambda i: PR.pr_multiply(*ops[i % len(ops)], pr5),
                                max(len(ops), 20))
        row["wrapper_ms"] = timer(lambda i: PR.pr_multiply(*ops[i % len(ops)], pr5))
        row["plain_ms"] = timer(lambda i: PR.pr_multiply_plain(*ops[i % len(ops)], pr5),
                                iters=10)
        row["library_ms"] = None
        row["library_call"] = "none: no PyTorch call computes a PR product"
        row["launch_floor_ms"] = launch_floor(ctx)
    # two int32 reads and one int32 write per element
    row["bound_ms"], row["bound_by"] = bound(12 * numel, 0, INT8_OPS)
    return row


def launch_floor(ctx):
    """Device time of one empty kernel launch by CUDA-graph replay (ms): the
    floor under any launch, beside every PR row (their byte bounds are far
    below it at the stream shapes)."""
    if not ctx["on_card"]:
        return None
    torch = ctx["torch"]
    from repro_torch.kernels import _build

    fn = _build.entry("launch_floor_launch")
    return ctx["timer"].graph(
        lambda i: _build.check(fn(torch.cuda.current_stream().cuda_stream), "launch_floor"), 64)


def fir_bytes(B, L, T) -> int:
    """pr_fir's bytes: frames, tail and taps read once; y and the new tail
    written once (int32)."""
    return 4 * (2 * B * L + 2 * B * (T - 1) + T)


def conv_bytes(B, H, W, kh, kw) -> int:
    """pr_conv2d's bytes: the image and the weights read once, the output
    written once (int32)."""
    return 4 * (2 * B * H * W + kh * kw)


def _pr_knobs(ctx) -> list:
    """The fused wrappers' keywords for each phase-2 knob: the degrees as
    elements of a device vector (the stream engine's operand) and the raw
    pairs."""
    torch = ctx["torch"]
    degrees = torch.tensor(PR_DEGREES, dtype=torch.int32, device=ctx["dev"])
    return ([{"degree": degrees[i]} for i in range(len(PR_DEGREES))]
            + [{"pr": k} for k in PR_RAW])


def _old_pr(pr=None, degree=None):
    """The old route's (p, r): a degree mapped by ``degree_to_pr``, as the
    stages did on every call before the fused kernels."""
    from repro_torch.kernels import dsp

    return pr if pr is not None else dsp.degree_to_pr(degree)


def _fir_old_route(frames, tail, taps, shift, **knob):
    """The stage as served before the fused kernels: the reference's
    planes through the elementwise pr_multiply kernel, then torch.sum."""
    import torch

    from repro_torch.kernels import axmult_elem as PR

    a, win, ext = PR.fir_planes(frames, tail, taps)
    prod = PR.pr_multiply(a.expand(win.shape).contiguous(), win.contiguous(), _old_pr(**knob))
    return torch.sum(prod, dim=0, dtype=torch.int32) >> shift, ext[:, frames.shape[1]:]


def _conv_old_route(img, kern, shift, pad, **knob):
    import torch

    from repro_torch.kernels import axmult_elem as PR

    a, patches = PR.conv_planes(img, kern, pad)
    prod = PR.pr_multiply(a.expand(patches.shape).contiguous(), patches.contiguous(),
                          _old_pr(**knob))
    return torch.sum(prod, dim=0, dtype=torch.int32) >> shift


def _diff(x, y) -> int:
    import torch

    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def _pr_sum_row(ctx, row, kernel, plain, old, rotate, nbytes, ops):
    """Check one product-sum row at every knob (bit-exact against the plain
    version and against the old route) and time it at degree 5: ``ms``
    the kernel alone by CUDA-graph replay over rotating inputs,
    ``wrapper_ms`` the eager call, ``plain_ms`` the plain version eagerly,
    ``old_route_ms`` the pr_multiply route by graph replay (its degree
    mapping included), ``launch_floor_ms`` one empty launch."""
    timer = ctx["timer"]
    knobs = _pr_knobs(ctx)
    err_plain = err_old = 0
    for kw in knobs:
        got = kernel(0, **kw)
        want = plain(0, **kw)
        before = old(0, **kw)
        ctx["sync"]()
        got, want, before = ((t,) if not isinstance(t, tuple) else t
                             for t in (got, want, before))
        err_plain = max([err_plain] + [_diff(g, w) for g, w in zip(got, want)])
        err_old = max([err_old] + [_diff(g, w) for g, w in zip(got, before)])
    row.update(knobs=[f"degree {e}" for e in PR_DEGREES] + [f"(p, r) = {k}" for k in PR_RAW],
               max_abs_err=max(err_plain, err_old), max_abs_err_plain=err_plain,
               max_abs_err_old_route=err_old, tol="exact (0), plain version and old route",
               ok=err_plain == 0 and err_old == 0)
    kw5 = knobs[PR_DEGREES.index(5)]
    if ctx["on_card"]:
        n = max(rotate, 20)
        row["ms"] = timer.graph(lambda i: kernel(i, **kw5), n)
        row["wrapper_ms"] = timer(lambda i: kernel(i, **kw5))
        row["plain_ms"] = timer(lambda i: plain(i, **kw5), iters=10)
        row["old_route_ms"] = timer.graph(lambda i: old(i, **kw5), n)
        row["launch_floor_ms"] = launch_floor(ctx)
        row["library_ms"] = None
        row["library_call"] = "none: no PyTorch call computes a PR product"
    # int32 multiply-adds counted at the table's f32 CUDA-core rate (Hopper
    # issues int32 multiply-adds at half of it: the looser bound)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, F32_FLOPS)
    return row


def check_pr_fir(ctx, B, L, T, shift, what):
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.kernels import axmult_elem as PR
    from repro_torch.kernels import dsp

    rng = np.random.default_rng(7000 + B + L + T)
    q = 12
    frames = torch.from_numpy(rng.integers(-(1 << q), (1 << q) + 1, (B, L), dtype=np.int32))
    tail = torch.from_numpy(rng.integers(-(1 << q), (1 << q) + 1, (B, T - 1), dtype=np.int32))
    taps = torch.from_numpy(dsp.quantize_weights(rng.uniform(-1.0, 1.0, T), shift)).to(dev)
    nbytes = fir_bytes(B, L, T)
    ops = copies(lambda: (frames.to(dev), tail.to(dev)), nbytes, ctx["on_card"])

    def kernel(i, **kw):
        return PR.pr_fir(*ops[i % len(ops)], taps, shift=shift, **kw)

    def plain(i, **kw):
        return PR.pr_fir_plain(*ops[i % len(ops)], taps, shift=shift, **kw)

    def old(i, **kw):
        return _fir_old_route(*ops[i % len(ops)], taps, shift, **kw)

    row = {"B": B, "L": L, "T": T, "shift": shift, "what": what}
    return _pr_sum_row(ctx, row, kernel, plain, old, len(ops), nbytes, 2 * T * B * L)


def check_pr_conv2d(ctx, B, H, W, kh, kw, pad, shift, what):
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.kernels import axmult_elem as PR
    from repro_torch.kernels import dsp

    rng = np.random.default_rng(8000 + B + H + W + kh * kw)
    img = torch.from_numpy(rng.integers(-(1 << 12), (1 << 12) + 1, (B, H, W), dtype=np.int32))
    kern = torch.from_numpy(dsp.quantize_weights(rng.uniform(-1.0, 1.0, (kh, kw)), shift))
    kern = kern.to(dev)
    nbytes = conv_bytes(B, H, W, kh, kw)
    ops = copies(lambda: img.to(dev), nbytes, ctx["on_card"])

    def kernel(i, **kw_):
        return PR.pr_conv2d(ops[i % len(ops)], kern, shift=shift, pad=pad, **kw_)

    def plain(i, **kw_):
        return PR.pr_conv2d_plain(ops[i % len(ops)], kern, shift=shift, pad=pad, **kw_)

    def old(i, **kw_):
        return _conv_old_route(ops[i % len(ops)], kern, shift, pad, **kw_)

    row = {"B": B, "H": H, "W": W, "kh": kh, "kw": kw, "pad": pad, "shift": shift,
           "what": what}
    return _pr_sum_row(ctx, row, kernel, plain, old, len(ops), nbytes, 2 * kh * kw * B * H * W)


def decode_lengths(T: int, slots: int):
    """(nvalid, active) of a phase-2 decode row: mixed lengths up to a full
    cache of T, one freed slot."""
    nvalid = [T, (7 * T) // 10, T // 2 + 1, T // 16, 1, (3 * T) // 10, (9 * T) // 10, T // 8]
    return nvalid[:slots], [1, 1, 1, 1, 1, 0, 1, 1][:slots]


def split_edge_lengths(W: int, T: int, slots: int):
    """(nvalid, active) of the split-edge decode row: lengths one past, at
    and one short of the decode kernels' split width W, two splits, two
    splits and one row, one row and T - 1; the slot at T is freed."""
    nvalid = [W + 1, W, W - 1, 2 * W, 2 * W + 1, T, 1, T - 1]
    return [min(n, T) for n in nvalid[:slots]], [1, 1, 1, 1, 1, 0, 1, 1][:slots]


def decode_split_width(ctx, D: int) -> int:
    """The decode kernels' split width at head dim D (32 in the CPU
    rehearsal, which builds nothing: the smoke caches hold 64 rows)."""
    from repro_torch.kernels import flash_decode as FD

    return FD.split_width(D) if ctx["on_card"] else 32


def phase_kernels(ctx, cfg):
    """Phase 2: every kernel against its plain version."""
    torch = ctx["torch"]
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_decode_quant": [],
            "flash_attention": [], "pr_multiply": [], "pr_fir": [], "pr_conv2d": []}
    for M in (slots, prompt):
        for N, K, res in ((qd, d, False), (kvd, d, False), (d, qd, True),
                          (d, dff, True)):
            rows["axqmm"].append(check_axqmm(ctx, M, N, K, res, deg))
    rows["axqmm"].append(check_axqmm(ctx, slots, V, d, False, deg))
    for M in (slots, prompt):
        rows["axqmm_gated"].append(check_gated(ctx, M, dff, d, deg))
    G, D, T = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, ctx["max_len"]
    nvalid, active = decode_lengths(T, slots)
    rows["flash_decode"].append(check_decode(ctx, slots, cfg.n_kv_heads, G, D, T,
                                             nvalid, active))
    for e in (8, 5):
        rows["flash_decode_quant"].append(check_decode_quant(
            ctx, slots, cfg.n_kv_heads, G, D, T, nvalid, active, e))
    Tr = T - 3 * T // 128                      # ragged: 1000 at T = 1024
    rows["flash_decode_quant"].append(check_decode_quant(
        ctx, slots, cfg.n_kv_heads, G, D, Tr, [min(n, Tr) for n in nvalid], active, 6))
    edge, edge_active = split_edge_lengths(decode_split_width(ctx, D), T, slots)
    rows["flash_decode"].append(check_decode(ctx, slots, cfg.n_kv_heads, G, D, T, edge,
                                             edge_active))
    rows["flash_decode_quant"].append(check_decode_quant(
        ctx, slots, cfg.n_kv_heads, G, D, T, edge, edge_active, 5))
    rows["flash_attention"].append(check_prefill(ctx, cfg.n_heads, prompt, D,
                                                 cfg.n_heads, cfg.n_kv_heads))
    # bucketed prefill shapes: four packed rows at half the cache, one at all of it
    for BH, S in ((4 * cfg.n_heads, T // 2), (cfg.n_heads, T)):
        rows["flash_attention"].append(check_prefill(ctx, BH, S, D, cfg.n_heads,
                                                     cfg.n_kv_heads))
    for shape, what in ctx["pr_shapes"]:
        rows["pr_multiply"].append(check_pr_multiply(ctx, shape, what))
    for shape, what in ctx["fir_shapes"]:
        rows["pr_fir"].append(check_pr_fir(ctx, *shape, what))
    for shape, what in ctx["conv_shapes"]:
        rows["pr_conv2d"].append(check_pr_conv2d(ctx, *shape, what))
    report_rows(rows)
    return rows


def flash_resources(ctx) -> list:
    """Registers, spill bytes and shared memory of every flash_attention
    instantiation (ptxas -v of this build; the dynamic shared memory at the
    reference's 128-row block from the C launcher).  Every one must run
    with 0 bytes spilled."""
    from repro_torch.kernels import _build

    smem_of = _build.entry("flash_attention_smem_bytes")
    out = []
    for r in _build.kernel_resources(_build.ptxas_log.get("flash_attention", [])):
        inst = _build.flash_instance(r["function"])
        if inst is None:
            continue
        body, dtype, D = inst
        out.append({"instance": f"flash_{body}_kernel<{dtype}, D={D}>", "D": D,
                    "registers": r["registers"], "spill_stores": r["spill_stores"],
                    "spill_loads": r["spill_loads"], "static_smem": r["smem"],
                    "dynamic_smem_blk128": smem_of(D, 128, 1 if dtype == "bf16" else 0)})
    say("flash_attention instantiations: " + "; ".join(
        f"{r['instance']} {r['registers']} regs, spill {r['spill_stores']}/"
        f"{r['spill_loads']} B, smem {r['static_smem']} B static + "
        f"{r['dynamic_smem_blk128']} B dynamic" for r in out))
    require(len(out) == 12, f"expected 12 flash_attention instantiations (D 16, 32, 64, 80, "
                            f"128, 256 in each body), ptxas shows {len(out)}")
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in out),
            "a flash_attention instantiation spills registers")
    return out


def decode_resources(ctx) -> list:
    """Registers, spill bytes and shared memory of every decode_kernel
    instantiation and of its combine_kernel (ptxas -v of this build; the
    split kernel's dynamic shared memory from the C launcher).  Every one
    must run with 0 bytes spilled."""
    from repro_torch.kernels import _build

    smem_of = _build.entry("flash_decode_smem_bytes")
    kinds = {"f32": 0, "bf16": 1, "int8": 2}
    out = []
    for r in _build.kernel_resources(_build.ptxas_log.get("flash_decode", [])):
        inst = _build.decode_instance(r["function"])
        if inst is None:
            continue
        _, cache, D, gq = inst
        name = (f"decode_kernel<{cache}, D={D}, GQ={gq}>" if cache
                else f"combine_kernel<D={D}>")
        out.append({"instance": name, "D": D, "registers": r["registers"],
                    "spill_stores": r["spill_stores"], "spill_loads": r["spill_loads"],
                    "static_smem": r["smem"],
                    "dynamic_smem": smem_of(D, kinds[cache], gq) if cache else 0})
    say("decode instantiations: " + "; ".join(
        f"{r['instance']} {r['registers']} regs, spill {r['spill_stores']}/"
        f"{r['spill_loads']} B, smem {r['static_smem']} B static + "
        f"{r['dynamic_smem']} B dynamic" for r in out))
    require(len(out) == 38, f"expected 38 decode instantiations (decode_kernel at D 16, 32, "
                            f"64, 80, 128 on the f32, bf16 and int8 caches with 4- and 8-row "
                            f"P.V blocks, at D 256 on the f32 and bf16 caches with 8-row "
                            f"blocks; combine_kernel at each D), ptxas shows {len(out)}")
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in out),
            "a decode instantiation spills registers")
    return out


def axqmm_resources(ctx) -> list:
    """Registers, spill bytes and shared memory of every axqmm.cu
    instantiation (ptxas -v of this build): axq_decode_kernel at (8 or 16
    slots, gated or not, 64- or 256-byte steps), axq_tile_kernel (64-row
    tiles) and axq_wgmma_kernel (128-row tiles), gated or not,
    axq_combine_kernel and the pre-pass axq_degrade_kernel.  Every one must
    run with 0 bytes spilled."""
    from repro_torch.kernels import _build

    out = []
    for r in _build.kernel_resources(_build.ptxas_log.get("axqmm", [])):
        inst = _build.axqmm_instance(r["function"])
        if inst is None:
            continue
        kernel, targs = inst
        out.append({"instance": f"axq_{kernel}_kernel<{', '.join(map(str, targs))}>",
                    "registers": r["registers"], "spill_stores": r["spill_stores"],
                    "spill_loads": r["spill_loads"], "static_smem": r["smem"]})
    say("axqmm instantiations: " + "; ".join(
        f"{r['instance']} {r['registers']} regs, spill {r['spill_stores']}/"
        f"{r['spill_loads']} B, smem {r['static_smem']} B static" for r in out))
    require(len(out) == 15, f"expected 15 axqmm instantiations (axq_decode_kernel x 8, "
                            f"axq_tile_kernel x 2, axq_wgmma_kernel x 2, axq_combine_kernel "
                            f"x 2, axq_degrade_kernel), ptxas shows {len(out)}")
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in out),
            "an axqmm instantiation spills registers")
    return out


def pr_resources(ctx) -> list:
    """Registers, spill bytes and shared memory of every axmult_elem.cu
    kernel (ptxas -v of this build): pr_kernel with and without 16-byte
    lanes, pr_fir_kernel, pr_conv2d_kernel and the empty
    launch_floor_kernel.  Every one must run with 0 bytes spilled."""
    from repro_torch.kernels import _build

    out = []
    for r in _build.kernel_resources(_build.ptxas_log.get("axmult_elem", [])):
        inst = _build.pr_instance(r["function"])
        if inst is None:
            continue
        out.append({"instance": inst, "registers": r["registers"],
                    "spill_stores": r["spill_stores"], "spill_loads": r["spill_loads"],
                    "static_smem": r["smem"]})
    say("axmult_elem kernels: " + "; ".join(
        f"{r['instance']} {r['registers']} regs, spill {r['spill_stores']}/"
        f"{r['spill_loads']} B, smem {r['static_smem']} B static" for r in out))
    names = sorted(r["instance"] for r in out)
    require(names == ["launch_floor_kernel", "pr_conv2d_kernel", "pr_fir_kernel",
                      "pr_kernel<scalar>", "pr_kernel<vec>"],
            f"expected 5 axmult_elem kernels (pr_kernel x 2, pr_fir_kernel, pr_conv2d_kernel, "
            f"launch_floor_kernel), ptxas shows {names}")
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in out),
            "an axmult_elem kernel spills registers")
    return out


def report_rows(rows, tag: str = "") -> None:
    for name, rs in rows.items():
        for r in rs:
            shape = {k: r[k] for k in r if k in SHAPE_KEYS}
            rates = ""
            if "tflops" in r:
                rates = (f" tflops={r['tflops']:.4g} "
                         f"ms/library={r.get('ms_over_library', float('nan')):.3g}")
            if "gb_per_s" in r:
                rates = (f" GB/s={r['gb_per_s']:.4g} ms_graph/bound="
                         f"{r['ms_graph_over_bound']:.3g} kernel_ms_graph={r['ms_graph']} "
                         f"library_ms_graph={r['library_ms_graph']}")
            if "plan" in r:
                rates = (f" plan={r['plan']} blocks/SM={r['blocks_per_sm']:.3g}"
                         f" kernel_ms_graph={r.get('ms_graph')} "
                         f"library_ms_graph={r.get('library_ms_graph')}")
                if "tops_graph" in r:
                    rates += (f" TOP/s={r['tops_graph']:.4g} ms_graph/bound="
                              f"{r['ms_graph_over_bound']:.3g}")
            if "launch_floor_ms" in r:
                rates = (f" wrapper_ms={r.get('wrapper_ms')} old_route_ms="
                         f"{r.get('old_route_ms')} launch_floor_ms={r['launch_floor_ms']}")
            say(f"{tag}{name} {shape}: max_err={r['max_abs_err']:.3g} ({r['tol']}) "
                f"kernel_ms={r.get('ms')} plain_ms={r.get('plain_ms')} "
                f"library_ms={r.get('library_ms')} bound_ms={r['bound_ms']:.4g} "
                f"({r['bound_by']}){rates}")
            require(r["ok"], f"{tag}{name} {shape} disagrees with its plain version: "
                             f"max_abs_err {r['max_abs_err']}")


def phase_kernels_swa(ctx, cfg):
    """Phase 2, sliding-window rows: every kernel of the window arch's path
    at its full-width shapes (h2o-danube-1.8b: d_model 2560, 32/8 heads,
    head_dim 80, d_ff 6912, window 4096; a full ring at decode)."""
    torch = ctx["torch"]
    d, dff, V, W = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.swa_window
    D, H, KVr = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_decode_quant": [],
            "flash_attention": []}
    for M in (slots, prompt):
        for N, K, res in ((H * D, d, False), (KVr * D, d, False), (d, H * D, True),
                          (d, dff, True)):
            rows["axqmm"].append(check_axqmm(ctx, M, N, K, res, deg))
    rows["axqmm"].append(check_axqmm(ctx, slots, V, d, False, deg))
    for M in (slots, prompt):
        rows["axqmm_gated"].append(check_gated(ctx, M, dff, d, deg))
    T = min(ctx["swa_max_len"], W)                   # the ring
    nvalid = [T] * slots                            # every slot has wrapped
    active = [1] * slots
    active[slots // 2 + 1] = 0                      # one freed slot
    rows["flash_decode"].append(check_decode(ctx, slots, KVr, H // KVr, D, T, nvalid,
                                             active))
    for e in (8, 5):
        rows["flash_decode_quant"].append(check_decode_quant(
            ctx, slots, KVr, H // KVr, D, T, nvalid, active, e))
    for S in ctx["swa_band_lens"]:
        rows["flash_attention"].append(check_band(ctx, 1, H, KVr, D, S, W))
    # the largest bucket (S = T <= window: the tri schedule)
    rows["flash_attention"].append(check_prefill(ctx, H, T, D, H, KVr))
    report_rows(rows, f"{cfg.name}: ")
    return rows


def phase_kernels_head128(ctx, cfg, nemo_cfg):
    """Phase 2, head_dim 128 rows: qwen2.5-3b's kernels at its full-width
    shapes (d_model 2048, 16/2 heads, d_ff 11008, vocab 151936, QKV bias:
    the GEMM's bias epilogue; the gated and down projections of a
    4096-token prefill call), ``tri`` at D = 128 in both bodies, a ``band``
    row at D = 128 (no registered arch runs it; it holds the template), and
    both decode kernels at qwen's and mistral-nemo-12b's grouping (KVr 2,
    G 8 and KVr 8, G 4) on a T = 4096 cache."""
    torch = ctx["torch"]
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    D, H, KVr = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_decode_quant": [],
            "flash_attention": []}
    rows["axqmm"].append(check_axqmm(ctx, prompt, H * D, d, False, deg, bias=True))
    # a long prompt's prefill call: the down projection, then (last: the
    # summary's lead row) the unembedding at decode
    rows["axqmm"].append(check_axqmm(ctx, ctx["long_prefill_m"], d, dff, True, deg))
    rows["axqmm"].append(check_axqmm(ctx, slots, V, d, False, deg))
    rows["axqmm_gated"].append(check_gated(ctx, prompt, dff, d, deg))
    rows["axqmm_gated"].append(check_gated(ctx, ctx["long_prefill_m"], dff, d, deg))
    T = ctx["qwen_max_len"]
    nvalid, active = decode_lengths(T, slots)
    for c in (cfg, nemo_cfg):
        G = c.n_heads // c.n_kv_heads
        rows["flash_decode"].append(check_decode(ctx, slots, c.n_kv_heads, G, c.head_dim, T,
                                                 nvalid, active))
        rows["flash_decode_quant"].append(check_decode_quant(
            ctx, slots, c.n_kv_heads, G, c.head_dim, T, nvalid, active,
            5 if c is cfg else 8))
    long_s, short_s = ctx["h128_tri_lens"]
    for dt in (torch.bfloat16, torch.float32):
        rows["flash_attention"].append(check_prefill(ctx, H, long_s, D, H, KVr, dtype=dt))
    rows["flash_attention"].append(check_prefill(ctx, H, short_s, D, H, KVr))
    S, W = ctx["h128_band"]
    rows["flash_attention"].append(check_band(ctx, 1, H, KVr, D, S, W))
    report_rows(rows, f"{cfg.name} (head_dim {D}): ")
    return rows


def phase_kernels_moe(ctx, cfg, q_cfg):
    """Phase 2, MoE rows: granite-moe-3b-a800m's kernels at its full-width
    shapes (40 experts of d_expert 512 over d_model 1536; GQA 24/8 at
    head_dim 64; vocab 49155, the first N on the card that is no multiple
    of 16) and qwen2-moe-a2.7b's expert shapes (60 experts of 1408 over
    2048, K 1408 taking bk 128; its shared experts' 5632-wide gated half;
    MHA 16/16 at head_dim 128): the expert-batched launches at the decode
    capacity of ``slots`` slots and of a ``moe_prefill_len``-token
    prefill, the unembedding at M = slots and ``prefill_m``, both decode
    kernels at groups of 3 and 1 (padded to 4 in the kernel), and tri
    prefill attention at granite's heads."""
    torch = ctx["torch"]
    from repro_torch.models.moe import capacity

    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm_experts": [], "axqmm_gated_experts": [], "axqmm": [], "axqmm_gated": [],
            "flash_decode": [], "flash_decode_quant": [], "flash_attention": []}
    for c in (cfg, q_cfg):
        E, d, f = c.moe.n_experts, c.d_model, c.moe.d_expert
        for C in (capacity(c, slots), capacity(c, ctx["moe_prefill_len"])):
            rows["axqmm_gated_experts"].append(check_experts(ctx, E, C, f, d, deg, True))
            rows["axqmm_experts"].append(check_experts(ctx, E, C, d, f, deg, False))
    fs = q_cfg.moe.n_shared * q_cfg.moe.d_shared
    for M in (slots, prompt):
        rows["axqmm_gated"].append(check_gated(ctx, M, fs, q_cfg.d_model, deg))
        rows["axqmm"].append(check_axqmm(ctx, M, cfg.vocab, cfg.d_model, False, deg))
    T = ctx["max_len"]
    nvalid, active = decode_lengths(T, slots)
    for c in (cfg, q_cfg):
        G = c.n_heads // c.n_kv_heads
        rows["flash_decode"].append(check_decode(ctx, slots, c.n_kv_heads, G, c.head_dim, T,
                                                 nvalid, active))
        rows["flash_decode_quant"].append(check_decode_quant(
            ctx, slots, c.n_kv_heads, G, c.head_dim, T, nvalid, active, 5))
    rows["flash_attention"].append(check_prefill(ctx, cfg.n_heads, ctx["moe_prefill_len"],
                                                 cfg.head_dim, cfg.n_heads, cfg.n_kv_heads))
    report_rows(rows, f"{cfg.name} / {q_cfg.name} (MoE): ")
    return rows


def phase_kernels_recurrent(ctx, ssm_cfg, rg_cfg):
    """Phase 2, the recurrent families' rows: mamba2-370m's GEMMs (the
    fused in_proj at N = 2 d_inner + 2 d_state + heads = 4384, no multiple
    of 64; out_proj K 2048 with the residual; the tied unembedding at N =
    50280) and recurrentgemma-2b's (the rec block's 2560-square
    projections, the MQA k projection at N = 256, the gelu gated half at N
    7680, the down projection K 7680 with the residual, the unembedding at
    N = 256000), each at decode and at a prefill of ``prefill_m`` rows;
    ``flash_attention`` at head_dim 256 (MQA 10/1): ``band`` at window 2048
    over the longest prompt, ``tri`` at one window's length in bf16 and in
    f32; ``flash_decode`` at B 8, KVr 1, G 10 on the 2048-row ring, lengths
    at the split edges and a full ring with one free slot."""
    torch = ctx["torch"]
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, prompt = ctx["slots"], ctx["prefill_m"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_attention": []}
    d = ssm_cfg.d_model
    s = ssm_cfg.ssm
    d_in = s.expand * d
    n_in = 2 * d_in + 2 * s.d_state + d_in // s.headdim
    for M in (slots, prompt):
        rows["axqmm"].append(check_axqmm(ctx, M, n_in, d, False, deg))
        rows["axqmm"].append(check_axqmm(ctx, M, d, d_in, True, deg))
    rows["axqmm"].append(check_axqmm(ctx, slots, ssm_cfg.vocab, d, False, deg))
    d, D, H, KVr = rg_cfg.d_model, rg_cfg.head_dim, rg_cfg.n_heads, rg_cfg.n_kv_heads
    for M in (slots, prompt):
        rows["axqmm"].append(check_axqmm(ctx, M, d, d, True, deg))
        rows["axqmm"].append(check_axqmm(ctx, M, KVr * D, d, False, deg))
        rows["axqmm"].append(check_axqmm(ctx, M, d, rg_cfg.d_ff, True, deg))
        rows["axqmm_gated"].append(check_gated(ctx, M, rg_cfg.d_ff, d, deg, act=rg_cfg.act))
    # last: the summary's lead row, the largest decode GEMM of the slice
    rows["axqmm"].append(check_axqmm(ctx, slots, rg_cfg.vocab, d, False, deg))
    W = rg_cfg.local_window
    T = min(W, ctx["rg_max_len"])
    edge, edge_active = split_edge_lengths(decode_split_width(ctx, D), T, slots)
    rows["flash_decode"].append(check_decode(ctx, slots, KVr, H // KVr, D, T, edge,
                                             edge_active))
    full = [1] * slots
    full[slots // 2] = 0
    rows["flash_decode"].append(check_decode(ctx, slots, KVr, H // KVr, D, T, [T] * slots,
                                             full))
    rows["flash_attention"].append(check_band(ctx, 1, H, KVr, D, ctx["rg_band_len"], W))
    for dt in (torch.bfloat16, torch.float32):
        rows["flash_attention"].append(check_prefill(ctx, H, T, D, H, KVr, dtype=dt))
    report_rows(rows, f"{ssm_cfg.name} / {rg_cfg.name} (recurrent): ")
    return rows


def check_dense(ctx, B, H, KVr, D, S, dtype=None):
    """Non-causal ``dense`` attention (the audio encoder's): grouped (B, S,
    H, D) queries over (B, S, KVr, D) keys/values, every (q block, kv
    block) pair.  The in-kernel step count must equal
    ``planned_grid_steps(causal=False)`` and the grouped entry the flat
    one on repeated K/V bit for bit; timed beside SDPA(is_causal=False).
    The bound counts 4 BH D S^2 flops: every (row, col) pair is kept."""
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dt = dtype or ctx["dtype"]
    G, BH = H // KVr, B * H
    gen = torch.Generator(device=dev).manual_seed(4700 + S + D)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, KVr, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, KVr, D, generator=gen, device=dev).to(dt)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    qf, kf, vf = flat(q), flat(k.repeat_interleave(G, 2)), flat(v.repeat_interleave(G, 2))
    y, steps = FA.flash_attention(qf, kf, vf, causal=False, return_steps=True)
    yg = FA.flash_attention_grouped(q, k, v, causal=False)
    yp, steps_p = FA.flash_attention_plain(qf, kf, vf, causal=False)
    ctx["sync"]()
    steps = int(steps)
    planned = FA.planned_grid_steps(BH, S, causal=False)
    require(steps == planned == steps_p,
            f"dense steps {steps} (plain {steps_p}) != planned {planned}")
    require(bool(torch.equal(flat(yg), y)), "grouped and flat dense entries disagree")
    err = float((y.float() - yp.float()).abs().max())
    rtol, atol, tol = flash_tol(dt)
    ok = bool(torch.allclose(y.float(), yp.float(), rtol=rtol, atol=atol))
    row = {"BH": BH, "S": S, "D": D, "grouped": f"{H}/{KVr}", "schedule": "dense",
           "causal": False, "dtype": str(dt), "steps": steps, "planned_steps": planned,
           "max_abs_err": err, "tol": tol, "ok": ok}
    per = 2 * B * S * (H + KVr) * D * q.element_size()
    qkv = copies(lambda: (q.clone(), k.clone(), v.clone()), per, ctx["on_card"])
    if ctx["on_card"]:
        row["ms"] = timer(lambda i: FA.flash_attention_grouped(*qkv[i % len(qkv)],
                                                               causal=False))
        row["plain_ms"] = timer(lambda i: FA.flash_attention_plain(qf, kf, vf, causal=False),
                                iters=3, warmup=1)
        row["library_ms"] = timer(lambda i: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in qkv[i % len(qkv)]), is_causal=False,
            enable_gqa=G > 1))
        row["library_call"] = "F.scaled_dot_product_attention(is_causal=False)"
    flops = 4.0 * BH * D * S * S
    peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
    row["bound_ms"], row["bound_by"] = bound(per, flops, peak)
    attention_rates(row, flops)
    return row


def phase_kernels_frontends(ctx, vlm_cfg, audio_cfg):
    """Phase 2, the frontend archs' rows: internvl2-1b's unembedding at its
    odd, unpadded N = 151655 (the GEMMs' unpaired-store path), its gated
    half (N 4864, K 896) at decode, ``v_proj/fc1`` (K 1024 -> N 896, with
    bias) at the training step's 4 x 1024 image rows, ``tri`` at GQA 14/2
    (G = 7, the first odd group) over 2048 tokens and both decode kernels
    at G = 7, D = 64; hubert-xlarge's non-causal ``dense`` attention at
    head_dim 80 (16 heads, 1024 frames, batch 8: the card's first
    non-causal run), its unembedding (N 504, K 1280) and gelu gated half
    (N 5120, K 1280) at the training step's 8 x 1024 rows."""
    torch = ctx["torch"]
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots = ctx["slots"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_decode_quant": [],
            "flash_attention": []}
    c, a = vlm_cfg, audio_cfg
    vb, vs = ctx["vlm_train_shape"]
    ab, as_ = ctx["audio_train_shape"]
    rows["axqmm"].append(check_axqmm(ctx, vb * c.frontend_tokens, c.d_model,
                                     c.frontend_dim, False, deg, bias=True))
    rows["axqmm"].append(check_axqmm(ctx, ab * as_, a.vocab, a.d_model, False, deg))
    rows["axqmm"].append(check_axqmm(ctx, slots, c.vocab, c.d_model, False, deg))
    rows["axqmm_gated"].append(check_gated(ctx, slots, c.d_ff, c.d_model, deg))
    rows["axqmm_gated"].append(check_gated(ctx, ab * as_, a.d_ff, a.d_model, deg, act=a.act))
    G, D, T = c.n_heads // c.n_kv_heads, c.head_dim, ctx["max_len"]
    nvalid, active = decode_lengths(T, slots)
    rows["flash_decode"].append(check_decode(ctx, slots, c.n_kv_heads, G, D, T, nvalid,
                                             active))
    rows["flash_decode_quant"].append(check_decode_quant(ctx, slots, c.n_kv_heads, G, D, T,
                                                         nvalid, active, 5))
    rows["flash_attention"].append(check_dense(ctx, ab, a.n_heads, a.n_kv_heads, a.head_dim,
                                               as_))
    rows["flash_attention"].append(check_prefill(ctx, vb * c.n_heads, vs, D, c.n_heads,
                                                 c.n_kv_heads))
    report_rows(rows, f"{c.name} / {a.name} (frontends): ")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def packed_bytes(params) -> int:
    """Bytes of every packed weight (int8 values + f32 scales): what one
    decode step must read from device memory at the least."""
    from repro_torch.kernels.qstore import PackedQWeight

    if isinstance(params, PackedQWeight):
        return params.qw.numel() + params.scales.numel() * 4
    if isinstance(params, dict):
        return sum(packed_bytes(v) for v in params.values())
    return 0


def seed_biases(ctx, params, seed: int) -> None:
    """Fill the QKV bias leaves (zeros at init, as in the reference) with
    seeded N(0, 0.5^2) values in place, so that the GEMMs' bias epilogue adds
    something on the paths that carry one."""
    torch = ctx["torch"]
    gen = torch.Generator(device=ctx["dev"]).manual_seed(seed)
    layers = params.get("layers", {})
    for key in ("wq", "wk", "wv"):
        b = layers.get(key, {}).get("b")
        if b is not None:
            b.copy_(0.5 * torch.randn(b.shape, generator=gen, device=b.device))


def serving_model(ctx, cfg):
    """The serving paths' model: axq8 with a dynamic degree, random weights
    (and QKV biases, where the arch has them) from a seeded generator on the
    device, prepacked."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model

    model = build_model(cfg, policy_from_flag("axq8", dynamic=True), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.prepack(model.init(generator=gen))   # rebind: the f32 copies go
    seed_biases(ctx, params, 0)
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    return model, params


def make_engine(ctx, model, params, *, max_len, quant=False, admission=None, capture=None,
                qos=True, **resil_kw):
    """A QoS-driven engine (ladder ebits 8 -> 5; without ``qos`` a fixed
    degree) over the shared weights; ``quant`` picks the int8 KV cache (as
    REPRO_KV_INT8=1 does); ``capture`` as ``ServeCore`` takes it (None:
    CUDA graphs on the card); ``resil_kw`` the resilience keywords."""
    import os

    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.lm import ServeEngine

    ladder = QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)], low_water=0.25,
                           high_water=0.75, cooldown_steps=8) if qos else None
    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if quant else "0"
    try:
        eng = ServeEngine(model, params, slots=ctx["slots"], max_len=max_len, qos=ladder,
                          prepack=False, seed=0, admission=admission, capture=capture,
                          **resil_kw)
    finally:
        if prev is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = prev
    return eng


def drive(ctx, eng, prompts, new_tokens):
    """Serve ``prompts`` to completion with every launch count set to 0 just
    before and read just after.  Returns the requests and what was seen."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build

    ctx["sync"]()
    _build.reset_counts()
    if ctx["on_card"]:
        torch.cuda.reset_peak_memory_stats()
    st = eng.stats
    t0 = time.time()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    decode_ticks, interleaved, ticks = [], 0, 0
    max_ticks = 8 * len(prompts) * new_tokens
    while eng.queue or any(r is not None for r in eng.slot_req):
        require(ticks < max_ticks, f"the engine did not drain within {max_ticks} ticks")
        before = (st.admitted, int(st.c_chunk_calls.value), st.decode_steps)
        t = time.time()
        eng.tick()                           # a decode tick ends in a device->host read
        dt = time.time() - t
        ticks += 1
        admitted, chunks, steps = (st.admitted != before[0],
                                   int(st.c_chunk_calls.value) != before[1],
                                   st.decode_steps != before[2])
        if steps and not admitted and not chunks:
            decode_ticks.append(dt)
        interleaved += steps and chunks
    ctx["sync"]()
    wall = time.time() - t0
    require(all(r.done for r in reqs), f"{sum(not r.done for r in reqs)} requests unfinished")
    require(all(len(r.out_tokens) == new_tokens for r in reqs),
            "a request finished without all its tokens")
    seen = {"wall_s": wall, "ticks": ticks, "decode_ticks": decode_ticks,
            "interleaved_ticks": interleaved, "launches": dict(_build.launches),
            "flash_schedules": dict(_build.flash_schedules),
            "plain": dict(_build.plain_cuda_calls),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if ctx["on_card"] else None)}
    return reqs, seen


def check_launches(ctx, label, seen, expect):
    """Every kernel launched exactly as predicted (and those of the path at
    least once), no plain version on the card."""
    launches, plain = seen["launches"], seen["plain"]
    say(f"{label} launches {launches} (expected {expect}); plain versions on the "
        f"card {plain}")
    if not ctx["on_card"]:
        return
    for name in launches:
        want = expect.get(name, 0)   # a kernel the prediction does not name: none
        require(launches[name] == want,
                f"{label}: kernel {name}: {launches[name]} launches, expected {want}")
        require(plain[name] == 0, f"{label}: the plain version of {name} ran on the card")
    for name, n in expect.items():
        require(n == 0 or launches[name] > 0, f"{label}: kernel {name} never launched")


def graph_summary(eng) -> dict:
    """The engine's CUDA graphs: call shapes captured, capture seconds,
    device bytes the captures reserved (the graphs' shared pool) and each
    shape's replays; None for an eager engine."""
    if eng.graphs is None:
        return None
    s = eng.graphs.summary()
    return {"graphs": s["graphs"], "capture_s": s["capture_s"], "pool_bytes": s["pool_bytes"],
            "replays": {k: v["replays"] for k, v in s["shapes"].items()}}


def eager_twin(ctx, label, make, prompts, new_tokens, reqs, eng):
    """The same traffic through ``make(capture=False)``, an eager engine on
    the card: its tokens and degree history must equal the captured
    engine's.  Returns its decode tick and tokens/s."""
    twin = make(capture=False)
    treqs, tseen = drive(ctx, twin, prompts, new_tokens)
    same = [r.out_tokens for r in reqs] == [r.out_tokens for r in treqs]
    require(same, f"{label}: the captured engine's tokens differ from the eager engine's")
    require([d for _, d in eng.stats.degree_history] ==
            [d for _, d in twin.stats.degree_history],
            f"{label}: the eager engine walked other rungs")
    dts = tseen["decode_ticks"]
    out = {"decode_tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
           "gen_tok_per_s": sum(len(r.out_tokens) for r in treqs) / tseen["wall_s"],
           "wall_s": tseen["wall_s"], "tokens_equal": same}
    del twin
    return out


def replay_times(ctx, eng, n=16) -> dict:
    """Untraced medians over ``n`` replays of ``eng``'s step graph (staging
    done once before): how long the graph launch call holds the host, and
    a replay's wall time to the device's end.  Run last on a drained
    engine, every slot free: a replay then writes each slot's cache row at
    its length, which no request reads."""
    import numpy as np

    torch = ctx["torch"]
    g, key = eng.graphs, eng._step_key
    g.stage(key, {"feed": eng._feed, "active": np.zeros(eng.slots, bool)})
    torch.cuda.synchronize()
    launch, wall = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        g.replay(key)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    return {"replays": n, "launch_ms": 1e3 * float(np.median(launch)),
            "replay_wall_ms": 1e3 * float(np.median(wall))}


def capture_line(label, out) -> None:
    """Print one path's captured-vs-eager line."""
    g, e, prof = out["graphs"], out.get("eager"), out.get("profile")
    say(f"{label} captured vs eager: decode tick {out['decode_tick_ms_mean']:.4f} ms "
        f"captured, {e['decode_tick_ms_mean'] if e else None} ms eager; tokens/s "
        f"{out['gen_tok_per_s']:.2f} vs {e['gen_tok_per_s'] if e else None}; traced tick "
        f"device time {prof['device_us_per_tick'] if prof else None} us, busy share "
        f"{prof['device_busy_share'] if prof else None}, graph launch call "
        f"{prof['graph_launch_us_per_tick'] if prof else None} us; {g['graphs']} graphs "
        f"captured in "
        f"{g['capture_s']:.3f} s, pool {g['pool_bytes']} bytes; peak memory "
        f"{out.get('max_memory_allocated')}; tokens equal to the eager run: "
        f"{e['tokens_equal'] if e else None}; untraced replay: launch call "
        f"{out['replay']['launch_ms']:.4f} ms, replay {out['replay']['replay_wall_ms']:.4f} ms")


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache)


def serve_summary(ctx, label, eng, reqs, seen, tick_bound_ms):
    from repro_torch.serve.metrics import summarize

    s = summarize(reqs, eng.stats, wall_s=seen["wall_s"])
    rungs = sorted({e for _, e in eng.stats.degree_history})
    dts = seen["decode_ticks"]
    out = {
        "requests": len(reqs), "wall_s": seen["wall_s"],
        "generated_tokens": s["generated_tokens"],
        "gen_tok_per_s": s["generated_tokens"] / seen["wall_s"],
        "ticks": seen["ticks"], "decode_steps": eng.stats.decode_steps,
        "prefill_calls": eng.stats.prefill_calls,
        "decode_tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
        "decode_ticks_timed": len(dts), "decode_tick_bound_ms": tick_bound_ms,
        "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p95_ms": s["ttft_p95_ms"],
        "tpot_p50_ms": s["tpot_p50_ms"], "degree_rungs_visited": rungs,
        "degree_at_first_token": s.get("degree_at_first_token"),
        "launches": seen["launches"], "flash_schedules": seen["flash_schedules"],
        "max_memory_allocated": seen["max_memory_allocated"],
        "cache": type(eng.cache).__name__, "cache_bytes": cache_bytes(eng.cache),
        "graphs": graph_summary(eng),
    }
    say(f"{label}: {len(reqs)} requests, {out['generated_tokens']} tokens in "
        f"{seen['wall_s']:.3f} s ({out['gen_tok_per_s']:.1f} tok/s); decode tick "
        f"{out['decode_tick_ms_mean']:.3f} ms over {len(dts)} ticks vs bound "
        f"{tick_bound_ms:.4f} ms; TTFT p50 {s['ttft_p50_ms']} ms p95 {s['ttft_p95_ms']} ms; "
        f"max_memory_allocated {out['max_memory_allocated']}; {out['cache']} "
        f"{out['cache_bytes']} bytes; rungs {rungs}")
    return out


def phase_serve(ctx, cfg, model, params):
    """Phase 3: exact-length admission on the bf16 cache."""
    import numpy as np

    wbytes = packed_bytes(params)
    rng = np.random.default_rng(0)
    lo, hi = ctx["prompt_range"]
    warm = make_engine(ctx, model, params, max_len=ctx["max_len"])   # library loads, allocator
    warm.submit(rng.integers(0, cfg.vocab, lo), 2)
    warm.run_until_drained()
    del warm
    make = lambda **kw: make_engine(ctx, model, params, max_len=ctx["max_len"], **kw)
    eng = make()
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
               for _ in range(ctx["requests"])]
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"phase 3: the QoS degree never moved: {rungs}")
    steps, prefills, L = eng.stats.decode_steps, eng.stats.prefill_calls, cfg.n_layers
    check_launches(ctx, "phase 3", seen, {
        "axqmm": (5 * L + 1) * (steps + prefills), "axqmm_gated": L * (steps + prefills),
        "flash_decode": L * steps, "flash_decode_quant": 0, "flash_attention": L * prefills,
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    out = serve_summary(ctx, "phase 3 (exact admission, bf16 cache)", eng, reqs, seen,
                        wbytes / HBM_BPS * 1e3)
    out.update(arch=cfg.name, new_tokens=ctx["new_tokens"], prompt_range=[lo, hi],
               slots=ctx["slots"], max_len=ctx["max_len"], packed_weight_bytes=wbytes)
    if ctx["on_card"]:
        out["eager"] = eager_twin(ctx, "phase 3", make, prompts, ctx["new_tokens"], reqs, eng)
        out["profile"] = _profile_lm_ticks(ctx, eng, prompts, ctx["profile_ticks"])
        out["replay"] = replay_times(ctx, eng)
        capture_line("phase 3", out)
    return out, prompts


def phase_serve_int8(ctx, cfg, model, params, prompts):
    """Phase 3b: the int8 KV cache with bucketed, packed admission (this
    slice's main path), on phase 3's traffic."""
    from repro_torch.models.transformer import init_lm_cache
    from repro_torch.serve.admission import AdmissionConfig

    make = lambda **kw: make_engine(ctx, model, params, max_len=ctx["max_len"], quant=True,
                                    admission=AdmissionConfig(pack=4), **kw)
    t = time.time()
    eng = make()
    ctx["sync"]()
    warmup_s = time.time() - t
    wl = eng.workload
    shapes = dict(wl.trace_counts)
    require(shapes["prefill_batch"] == len(wl.admission.buckets) and shapes["step"] == 1,
            f"phase 3b: warmup ran {shapes}, expected {len(wl.admission.buckets)} bucket "
            "shapes and one step shape")
    if ctx["on_card"]:
        require(eng.graphs is not None and len(eng.graphs.graphs) == sum(shapes.values()),
                f"phase 3b: {0 if eng.graphs is None else len(eng.graphs.graphs)} graphs "
                f"for the warmed call shapes {shapes}")
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    require(wl.trace_counts == shapes,
            f"phase 3b: a request met a new call shape: {wl.trace_counts} vs {shapes}")
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"phase 3b: the QoS degree never moved: {rungs}")
    steps, calls, L = eng.stats.decode_steps, eng.stats.prefill_calls, cfg.n_layers
    check_launches(ctx, "phase 3b", seen, {
        "axqmm": (5 * L + 1) * steps + 5 * L * calls, "axqmm_gated": L * (steps + calls),
        "flash_decode": 0, "flash_decode_quant": L * steps, "flash_attention": L * calls,
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    out = serve_summary(ctx, "phase 3b (int8 cache, buckets, pack 4)", eng, reqs, seen,
                        packed_bytes(params) / HBM_BPS * 1e3)
    bf16 = init_lm_cache(cfg, 1, ctx["slots"], ctx["max_len"], device="meta")
    out.update(bf16_cache_bytes=cache_bytes(bf16), warmup_s=warmup_s,
               buckets=list(wl.admission.buckets), pack=wl.admission.pack,
               call_shapes=shapes, packed_rows=int(eng.stats.c_packed_rows.value),
               bucket_flushes={k[0]: int(c.value) for k, c in
                               eng.stats.c_admit_bucket.children.items()})
    say(f"phase 3b: warmup {warmup_s:.2f} s over {shapes}; int8 cache "
        f"{out['cache_bytes']} bytes vs {out['bf16_cache_bytes']} for bf16; "
        f"{calls} bucketed calls {out['bucket_flushes']}, {out['packed_rows']} packed rows")
    if ctx["on_card"]:
        out["eager"] = eager_twin(ctx, "phase 3b", make, prompts, ctx["new_tokens"], reqs, eng)
        out["profile"] = _profile_lm_ticks(ctx, eng, prompts, ctx["profile_ticks"])
        out["replay"] = replay_times(ctx, eng)
        capture_line("phase 3b", out)
    return out


def phase_serve_chunked(ctx, cfg, model, params):
    """Phase 3c: the bf16 cache with bucketed, packed and chunked admission:
    long prompts among short ones."""
    import numpy as np

    from repro_torch.serve.admission import AdmissionConfig

    rng = np.random.default_rng(3)
    (llo, lhi), (slo, shi) = ctx["long_range"], ctx["short_range"]
    n_long, n_short = ctx["n_long"], ctx["n_short"]
    long_at = set(rng.choice(n_long + n_short, n_long, replace=False).tolist())
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(llo, lhi + 1)) if i in long_at
                            else int(rng.integers(slo, shi + 1)))
               for i in range(n_long + n_short)]
    eng = make_engine(ctx, model, params, max_len=ctx["max_len_chunked"],
                      admission=AdmissionConfig(pack=4, chunk_tokens=ctx["chunk_tokens"]))
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    st, L = eng.stats, cfg.n_layers
    steps, chunks = st.decode_steps, int(st.c_chunk_calls.value)
    flushes = sum(int(c.value) for c in st.c_admit_bucket.children.values())
    require(chunks >= n_long, f"phase 3c: {chunks} chunk calls for {n_long} long prompts")
    require(seen["interleaved_ticks"] > 0, "phase 3c: no chunk call shared a tick with decode")
    check_launches(ctx, "phase 3c", seen, {
        "axqmm": (5 * L + 1) * steps + 5 * L * (flushes + chunks),
        "axqmm_gated": L * (steps + flushes + chunks), "flash_decode": L * steps,
        "flash_decode_quant": 0, "flash_attention": L * flushes, "pr_multiply": 0,
        "pr_fir": 0, "pr_conv2d": 0})
    out = serve_summary(ctx, "phase 3c (bf16 cache, buckets, pack 4, chunks)", eng, reqs,
                        seen, packed_bytes(params) / HBM_BPS * 1e3)
    short = [r.ttft * 1e3 for i, r in enumerate(reqs) if i not in long_at]
    long_ = [r.ttft * 1e3 for i, r in enumerate(reqs) if i in long_at]
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None
    out.update(chunk_tokens=ctx["chunk_tokens"], chunk_calls=chunks, bucket_flushes=flushes,
               interleaved_ticks=seen["interleaved_ticks"], long_prompts=n_long,
               short_prompts=n_short, prompt_lens=[int(p.size) for p in prompts],
               short_ttft_p50_ms=pct(short, 50), short_ttft_p95_ms=pct(short, 95),
               long_ttft_p50_ms=pct(long_, 50), max_len=ctx["max_len_chunked"])
    say(f"phase 3c: {chunks} chunk calls, {flushes} bucketed calls, "
        f"{seen['interleaved_ticks']} ticks with both a chunk call and a decode step; "
        f"short-request TTFT p50 {out['short_ttft_p50_ms']} ms p95 "
        f"{out['short_ttft_p95_ms']} ms; long-request TTFT p50 {out['long_ttft_p50_ms']} ms")
    return out


def phase_serve_vlm(ctx, tag, cfg, model, params, prompts):
    """Phase 3q: internvl2-1b (the VLM's Qwen2-0.5B backbone: 24 layers,
    GQA 14/2 — G = 7 in ``tri`` and both decode kernels — QKV bias, vocab
    151655, an odd N the GEMMs store unpaired) at full width on phase 3's
    text-only traffic, as the reference serves it: exact-length admission
    on the bf16 cache (captured, with its eager twin, a traced tick and
    the replay times, as 3g reports), then bucketed packed admission on the
    same cache (no chunks: the frontend archs take none)."""
    from repro_torch.serve.admission import AdmissionConfig

    label = f"phase {tag}"
    require(not ctx["on_card"] or (cfg.vocab % 2 == 1 and cfg.padded(1).vocab == cfg.vocab),
            f"{label}: vocab {cfg.vocab} is not the odd, unpadded N this path holds")
    wbytes = packed_bytes(params)
    make = lambda **kw: make_engine(ctx, model, params, max_len=ctx["max_len"], **kw)
    warm = make()
    warm.submit(prompts[0][:16], 2)
    warm.run_until_drained()
    del warm
    eng = make()
    require(not eng.workload._chunk_ok, f"{label}: chunked admission offered to a VLM")
    reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"{label}: the QoS degree never moved: {rungs}")
    steps, n, L = eng.stats.decode_steps, eng.stats.prefill_calls, cfg.n_layers
    check_launches(ctx, label, seen, {
        "axqmm": (5 * L + 1) * (steps + n), "axqmm_gated": L * (steps + n),
        "flash_decode": L * steps, "flash_decode_quant": 0, "flash_attention": L * n,
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    require(not ctx["on_card"] or seen["flash_schedules"] == {"dense": 0, "tri": L * n,
                                                               "band": 0},
            f"{label}: flash_attention by schedule {seen['flash_schedules']}")
    out = serve_summary(ctx, f"{label} ({cfg.name}, exact admission, bf16 cache)", eng, reqs,
                        seen, wbytes / HBM_BPS * 1e3)
    out.update(arch=cfg.name, new_tokens=ctx["new_tokens"], slots=ctx["slots"],
               max_len=ctx["max_len"], packed_weight_bytes=wbytes)
    if ctx["on_card"]:
        out["eager"] = eager_twin(ctx, label, make, prompts, ctx["new_tokens"], reqs, eng)
    out["profile"] = prof = _profile_lm_ticks(ctx, eng, prompts, ctx["profile_ticks"])
    if ctx["on_card"]:
        out["replay"] = replay_times(ctx, eng)
        capture_line(label, out)
    say(f"{label}: profiled {prof['ticks']} steady decode ticks: "
        f"{prof['tick_wall_ms']:.4f} ms wall per tick, {prof['device_us_per_tick']:.2f} us "
        f"of device kernel time per tick (busy share {prof['device_busy_share']}); largest: "
        + "; ".join(f"{r['name'][:60]} x{r['calls']} {r['device_us']:.1f} us "
                    f"({r['share']:.4f})" for r in prof["top_kernels"]))
    del eng
    beng = make(admission=AdmissionConfig(pack=4))
    shapes = dict(beng.workload.trace_counts)
    breqs, bseen = drive(ctx, beng, prompts, ctx["new_tokens"])
    require(beng.workload.trace_counts == shapes,
            f"{label} (buckets): a request met a new call shape: "
            f"{beng.workload.trace_counts} vs {shapes}")
    steps, calls = beng.stats.decode_steps, beng.stats.prefill_calls
    check_launches(ctx, f"{label} (buckets)", bseen, {
        "axqmm": (5 * L + 1) * steps + 5 * L * calls, "axqmm_gated": L * (steps + calls),
        "flash_decode": L * steps, "flash_decode_quant": 0, "flash_attention": L * calls,
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    out["buckets"] = serve_summary(ctx, f"{label} ({cfg.name}, buckets, pack 4, bf16 cache)",
                                   beng, breqs, bseen, wbytes / HBM_BPS * 1e3)
    out["buckets"].update(call_shapes=shapes, buckets=list(beng.workload.admission.buckets),
                          packed_rows=int(beng.stats.c_packed_rows.value))
    out["launches"] = sum_launches([seen["launches"], bseen["launches"]])
    out["flash_schedules"] = {k: seen["flash_schedules"].get(k, 0)
                              + bseen["flash_schedules"].get(k, 0)
                              for k in ("dense", "tri", "band")}
    return out


def _fleet_policy():
    """The fleet's and its engines' serving policy: no deadlines, no
    queue caps, no backoff (the reference's fleet tests' policy)."""
    from repro_torch.resil import ServePolicy

    return ServePolicy(deadline_ms=None, ttft_deadline_ms=None, max_queue=None,
                       max_queue_age_ms=None, backoff_ms=0.0)


def _fleet_run(ctx, model, params, prompts, new_tokens, *, seed):
    """``prompts`` through a FleetSupervisor of ``fleet_replicas``
    captured engines on the one device (a fixed degree, exact-length
    admission, the bf16 cache), every replica over the one packed weight
    set, under seeded ``replica_loss`` draws at ``fleet_loss`` a tick, on
    a VirtualClock; launch counts set to 0 just before the traffic and
    read just after."""
    torch = ctx["torch"]
    from repro_torch.dist.fleet import FleetSupervisor
    from repro_torch.kernels import _build
    from repro_torch.resil import FaultPlan, FaultSpec, VirtualClock

    clock = VirtualClock()
    policy = _fleet_policy()
    plan = FaultPlan(FaultSpec(replica_loss=ctx["fleet_loss"]), seed=seed)
    build = lambda device, rid: make_engine(ctx, model, params, max_len=ctx["max_len"],
                                            qos=False, clock=clock, policy=policy)
    sup = FleetSupervisor(build, ctx["fleet_replicas"], clock=clock, faults=plan,
                          policy=policy, rescale_ms=5.0, device=ctx["dev"])
    ctx["sync"]()
    _build.reset_counts()
    if ctx["on_card"]:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    reqs = [sup.submit(p, new_tokens) for p in prompts]
    done = sup.run_until_drained(max_ticks=8 * len(prompts) * new_tokens)
    ctx["sync"]()
    seen = {"wall_s": time.time() - t0, "launches": dict(_build.launches),
            "plain": dict(_build.plain_cuda_calls),
            "flash_schedules": dict(_build.flash_schedules),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if ctx["on_card"] else None)}
    return sup, plan, reqs, done, seen


def phase_fleet(ctx, tag, cfg, model, params, prompts):
    """Phase 3r: tinyllama-1.1b at full width behind a FleetSupervisor of 3
    replicas on the one card, under seeded ``replica_loss``.  Gates: every
    request ends exactly once; the ok token streams equal a clean
    single-engine run's on the card bit for bit; two runs of one seed give
    one recovery trace; the packs are held once (every replica serves the
    same tensors, and the fleet's peak memory over the single engine's is
    less than the packs' bytes); launches as the engines' steps and
    prefills predict, no plain version.  Then ``launch.serve --replicas 3
    --faults replica_loss=...`` for the wall numbers."""
    torch = ctx["torch"]
    label = f"phase {tag}"
    new_tokens, L = ctx["new_tokens"], cfg.n_layers
    wbytes = packed_bytes(params)
    # the clean reference: one engine, the same fixed degree, no fault
    clean = make_engine(ctx, model, params, max_len=ctx["max_len"], qos=False,
                        policy=_fleet_policy())
    creqs, cseen = drive(ctx, clean, prompts, new_tokens)
    ref = {r.rid: list(r.out_tokens) for r in creqs}
    single_peak = cseen["max_memory_allocated"]
    single_extra = cache_bytes(clean.cache) + (graph_summary(clean) or {}).get("pool_bytes", 0)
    del clean
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    runs = []
    for _ in range(2):
        sup, plan, reqs, done, seen = _fleet_run(ctx, model, params, prompts, new_tokens,
                                                 seed=ctx["fleet_seed"])
        rids = sorted(r.rid for r in done)
        require(rids == sorted(r.rid for r in reqs) == list(range(len(prompts))),
                f"{label}: requests did not end exactly once: {rids}")
        require(all(r.done for r in reqs), f"{label}: a request never ended")
        ok = [r for r in done if r.status == "ok"]
        bad = [r.rid for r in ok if list(r.out_tokens) != ref[r.rid]]
        require(not bad, f"{label}: ok requests {bad} differ from the clean single engine")
        names = [n for _, n, _ in sup.resil_log]
        require("replica_lost" in names and "rewind" in names and "rescale" in names,
                f"{label}: the seeded schedule killed no replica mid-decode: {names}")
        leaf = params["layers"]["wq"]["w"].qw
        require(all(r.engine.params is params for r in sup.replicas) and
                all(r.engine.params["layers"]["wq"]["w"].qw.data_ptr() == leaf.data_ptr()
                    for r in sup.replicas), f"{label}: a replica holds its own weights")
        steps = sum(r.engine.stats.decode_steps for r in sup.replicas)
        fills = sum(r.engine.stats.prefill_calls for r in sup.replicas)
        check_launches(ctx, label, seen, {
            "axqmm": (5 * L + 1) * (steps + fills), "axqmm_gated": L * (steps + fills),
            "flash_decode": L * steps, "flash_decode_quant": 0,
            "flash_attention": L * fills, "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
        trace = (tuple(sup.resil_log),
                 tuple((e.tick, e.kind, e.slot) for e in plan.injected),
                 tuple(sorted((r.rid, r.status, tuple(r.out_tokens)) for r in done)))
        pools = sum((graph_summary(r.engine) or {}).get("pool_bytes", 0)
                    for r in sup.replicas)
        caches = sum(cache_bytes(r.engine.cache) for r in sup.replicas)
        runs.append({"trace": trace, "seen": seen, "statuses": sup.status_counts(),
                     "events": {n: names.count(n) for n in sorted(set(names))},
                     "live": len(sup.live), "steps": steps, "prefills": fills,
                     "pools": pools, "caches": caches,
                     "rescales": [dataclasses.asdict(p) for p in sup.rescales]})
        del sup, plan, reqs, done
        if ctx["on_card"]:
            torch.cuda.empty_cache()
    require(runs[0]["trace"] == runs[1]["trace"],
            f"{label}: two runs of seed {ctx['fleet_seed']} gave two recovery traces")
    a = runs[0]
    fleet_peak = a["seen"]["max_memory_allocated"]
    if ctx["on_card"]:
        require(fleet_peak - single_peak < wbytes,
                f"{label}: the fleet's peak {fleet_peak} B is {fleet_peak - single_peak} B "
                f"over the single engine's: a second copy of the {wbytes} B of packs?")
    out = {"arch": cfg.name, "replicas": ctx["fleet_replicas"], "loss_rate": ctx["fleet_loss"],
           "seed": ctx["fleet_seed"], "statuses": a["statuses"], "events": a["events"],
           "live_at_exit": a["live"], "decode_steps": a["steps"], "prefill_calls": a["prefills"],
           "launches": a["seen"]["launches"], "flash_schedules": a["seen"]["flash_schedules"],
           "wall_s": a["seen"]["wall_s"], "single_wall_s": cseen["wall_s"],
           "fleet_peak_bytes": fleet_peak, "single_peak_bytes": single_peak,
           "packed_weight_bytes": wbytes, "single_cache_and_pool_bytes": single_extra,
           "fleet_cache_bytes": a["caches"], "fleet_pool_bytes": a["pools"],
           "rescales": a["rescales"], "trace_len": len(a["trace"][0])}
    say(f"{label} ({cfg.name}, {out['replicas']} replicas on one device, replica_loss "
        f"{out['loss_rate']} seed {out['seed']}, VirtualClock): {out['statuses']}, events "
        f"{out['events']}, {out['live_at_exit']} live at exit; ok streams == the clean "
        f"single engine's; one recovery trace for two runs ({out['trace_len']} events); "
        f"peak {fleet_peak} B vs single {single_peak} B (packs {wbytes} B, held once); "
        f"fleet wall {out['wall_s']:.3f} s vs single {out['single_wall_s']:.3f} s")
    # the launcher: its own seeded weights, the real clock
    argv = ["--arch", cfg.name, "--device", str(ctx["dev"]), "--approx", "axq8",
            "--replicas", str(ctx["fleet_replicas"]), "--slots", str(ctx["slots"]),
            "--requests", str(ctx["requests"]), "--new-tokens", str(new_tokens),
            "--max-len", str(ctx["max_len"]), "--faults",
            f"replica_loss={ctx['fleet_loss']}", "--fault-seed", str(ctx["fleet_seed"]),
            "--metrics"]
    s, lsup, lseen = _launch(ctx, argv)
    require(s["requests"] == ctx["requests"] and
            sum(s["statuses"].values()) == ctx["requests"],
            f"{label} launch.serve: {s['requests']} terminations for {ctx['requests']}")
    require(not any(lseen["plain"].values()) or not ctx["on_card"],
            f"{label} launch.serve: plain versions on the card {lseen['plain']}")
    out["launch"] = {"argv": argv, "summary": s, "wall_s": lseen["wall_s"],
                     "launches": lseen["launches"]}
    out["launches"] = sum_launches([out["launches"], lseen["launches"]])
    say(f"{label} launch.serve --replicas {ctx['fleet_replicas']}: {s['statuses']}, "
        f"{s['generated_tokens']} tokens, {s.get('gen_tok_per_s')} tok/s, TTFT p50 "
        f"{s['ttft_p50_ms']} ms, {s['live']} live, {s['rescales']} rescale(s), "
        f"{lseen['wall_s']:.2f} s with init")
    del lsup
    return out


def swa_prompts(ctx, cfg):
    """Phase 3e/3f traffic, all submitted at t = 0: ``swa_n_long`` prompts
    longer than the window (the ``band`` schedule at prefill), one prompt
    just under the ring whose decode wraps it, and short ones, shuffled
    from a seed.  Returns (prompts, kinds)."""
    import numpy as np

    rng = np.random.default_rng(14)
    (llo, lhi), (slo, shi) = ctx["swa_long_range"], ctx["swa_short_range"]
    lens = ([("long", int(rng.integers(llo, lhi + 1))) for _ in range(ctx["swa_n_long"] - 1)]
            + [("long", lhi), ("wrap", ctx["swa_wrap_len"])]
            + [("short", int(rng.integers(slo, shi + 1)))
               for _ in range(ctx["swa_n_short"])])
    order = rng.permutation(len(lens))
    kinds = [lens[i][0] for i in order]
    prompts = [rng.integers(0, cfg.vocab, lens[i][1]) for i in order]
    return prompts, kinds


@contextlib.contextmanager
def _timed_prefills(ctx, eng, log, method="prefill"):
    """Time every call of the model's ``method`` (``prefill``: exact-length,
    ``prefill_batch``: bucketed), synchronised before and after, into
    ``log`` as (prompt prefix or bucket length, seconds)."""
    model = eng.workload.model
    orig = getattr(model, method)

    def prefill(params, cache, toks, *a, **kw):
        ctx["sync"]()
        t = time.time()
        out = orig(params, cache, toks, *a, **kw)
        ctx["sync"]()
        log.append((int(toks.shape[-1]), time.time() - t))
        return out

    setattr(model, method, prefill)
    try:
        yield
    finally:
        delattr(model, method)


@contextlib.contextmanager
def _timed_bucket_calls(ctx, eng, log):
    """Time every bucketed prefill call of ``eng``'s adapter (staging and
    its bucket's graph replay, or the eager call), synchronised before and
    after, into ``log`` as (bucket length, seconds)."""
    wl = eng.workload
    orig = wl._prefill_batch

    def call(params, cache, host, *a, **kw):
        ctx["sync"]()
        t = time.time()
        orig(params, cache, host, *a, **kw)
        ctx["sync"]()
        log.append((int(host["tokens"].shape[-1]), time.time() - t))

    wl._prefill_batch = call
    try:
        yield
    finally:
        del wl._prefill_batch


def _split_ttft(reqs, kinds) -> dict:
    """TTFT p50/p95 of the long and of the short prompts (ms)."""
    import numpy as np

    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None
    out = {}
    for k in ("long", "short"):
        xs = [r.ttft * 1e3 for r, kk in zip(reqs, kinds) if kk == k]
        out.update({f"{k}_ttft_p50_ms": pct(xs, 50), f"{k}_ttft_p95_ms": pct(xs, 95)})
    return out


def qwen_prompts(ctx, cfg):
    """Phase 3g/3h traffic, all submitted at t = 0: ``qwen_n_long``
    retrieval-sized prompts (``tri`` at D = 128 over up to ~4000 tokens)
    among ``qwen_n_short`` chat turns, shuffled from a seed.  Returns
    (prompts, kinds)."""
    import numpy as np

    rng = np.random.default_rng(16)
    (llo, lhi), (slo, shi) = ctx["qwen_long_range"], ctx["qwen_short_range"]
    lens = ([("long", int(rng.integers(llo, lhi + 1))) for _ in range(ctx["qwen_n_long"])]
            + [("short", int(rng.integers(slo, shi + 1)))
               for _ in range(ctx["qwen_n_short"])])
    order = rng.permutation(len(lens))
    kinds = [lens[i][0] for i in order]
    prompts = [rng.integers(0, cfg.vocab, lens[i][1]) for i in order]
    return prompts, kinds


def _long_summary(ctx, label, cfg, params, eng, reqs, seen, kinds, long_prefills, n_kv):
    """serve_summary, with TTFT split long/short and the KV cache's bytes
    (its first ``n_kv`` tensors).  The decode tick's bound reads the packed
    weights once, and the window arch's ring (its long prompts fill it from
    their first tick) whole; a linear cache's rows are not counted."""
    kv = cache_bytes(eng.cache[:n_kv])
    bound_bytes = packed_bytes(params) + (kv if cfg.swa_window else 0)
    out = serve_summary(ctx, label, eng, reqs, seen, bound_bytes / HBM_BPS * 1e3)
    out.update(_split_ttft(reqs, kinds), prompt_lens=[int(r.prompt.size) for r in reqs],
               prompt_kinds=kinds,
               wrap_ttft_ms=[r.ttft * 1e3 for r, k in zip(reqs, kinds) if k == "wrap"],
               long_prefill_s=long_prefills, flash_schedules=seen["flash_schedules"],
               kv_cache_bytes=kv)
    say(f"{label}: TTFT long p50 {out['long_ttft_p50_ms']} p95 {out['long_ttft_p95_ms']} ms, "
        f"short p50 {out['short_ttft_p50_ms']} p95 {out['short_ttft_p95_ms']} ms, wrap "
        f"{out['wrap_ttft_ms']} ms; long prefills {long_prefills}; flash_attention by "
        f"schedule {seen['flash_schedules']}; KV cache {out['kv_cache_bytes']} bytes")
    return out


def phase_serve_long(ctx, tag, cfg, model, params, prompts, kinds, *, max_len, new_tokens,
                     n_band):
    """Phases 3e and 3g: exact-length admission on the bf16 cache, long
    prompts among short ones (``swa_prompts`` / ``qwen_prompts``).  On the
    window arch (3e) the cache is a ring of the window, the ``n_band``
    prompts past it run the ``band`` schedule and the "wrap" prompt's
    decode crosses the ring; elsewhere (3g: qwen2.5-3b, D = 128) every
    prefill runs ``tri``.  A profiled window of steady decode ticks
    follows the timed run."""
    label = f"phase {tag}"
    make = lambda **kw: make_engine(ctx, model, params, max_len=max_len, **kw)
    warm = make()
    warm.submit(prompts[kinds.index("short")][:16], 2)
    warm.run_until_drained()
    del warm
    eng = make()
    T = eng.cache.k.shape[2]
    if cfg.swa_window:
        require(T == min(max_len, cfg.swa_window) and eng.workload._max_prompt is None,
                f"{label}: the cache is not a ring of the window (T = {T})")
    prefills: list = []
    with _timed_prefills(ctx, eng, prefills):
        reqs, seen = drive(ctx, eng, prompts, new_tokens)
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"{label}: the QoS degree never moved: {rungs}")
    require(all(r.prompt.size + new_tokens > T for r, k in zip(reqs, kinds) if k == "wrap"),
            f"{label}: the wrap prompt's decode does not cross the ring")
    steps, n, L = eng.stats.decode_steps, eng.stats.prefill_calls, cfg.n_layers
    check_launches(ctx, label, seen, {
        "axqmm": (5 * L + 1) * (steps + n), "axqmm_gated": L * (steps + n),
        "flash_decode": L * steps, "flash_decode_quant": 0, "flash_attention": L * n,
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    if ctx["on_card"]:
        require(seen["flash_schedules"] == {"dense": 0, "tri": L * (n - n_band),
                                            "band": L * n_band},
                f"{label}: flash_attention by schedule {seen['flash_schedules']}, expected "
                f"band = {L} x {n_band}")
    short_max = max(p.size for p, k in zip(prompts, kinds) if k != "long")
    out = _long_summary(ctx, f"{label} ({cfg.name}, exact admission, bf16 cache)", cfg,
                        params, eng, reqs, seen, kinds,
                        [{"prefix": m, "s": t} for m, t in prefills if m > short_max], 2)
    out.update(arch=cfg.name, new_tokens=new_tokens, slots=ctx["slots"], max_len=max_len,
               cache_T=T, packed_weight_bytes=packed_bytes(params))
    if ctx["on_card"]:
        out["eager"] = eager_twin(ctx, label, make, prompts, new_tokens, reqs, eng)
    out["profile"] = prof = _profile_lm_ticks(ctx, eng, prompts, ctx["profile_ticks"])
    if ctx["on_card"]:
        out["replay"] = replay_times(ctx, eng)
        capture_line(label, out)
    say(f"{label}: profiled {prof['ticks']} steady decode ticks (prompts "
        f"{prof['prompt_lens']}): {prof['tick_wall_ms']:.4f} ms wall per tick, "
        f"{prof['device_us_per_tick']:.2f} us of device kernel time per tick (busy share "
        f"{prof['device_busy_share']}); largest: " + "; ".join(
            f"{r['name'][:60]} x{r['calls']} {r['device_us']:.1f} us ({r['share']:.4f})"
            for r in prof["top_kernels"]))
    return out


def phase_serve_long_int8(ctx, tag, cfg, model, params, prompts, kinds, *, max_len,
                          new_tokens, n_band):
    """Phases 3f and 3h: 3e's / 3g's traffic on the int8 cache with bucketed
    admission (the ladder up to ``max_len``, pack 4): warmup runs every
    bucket shape first; the ``n_band`` prompts past the largest bucket take
    the exact path (``band``, one call shape each), the others the buckets
    (``tri``), and no other call shape is new.  The host-side write plan of
    each bucketed call (staging and the replay of its bucket's graph, its
    write plan on the device) is timed."""
    from repro_torch.serve.admission import AdmissionConfig, bucket_for

    label = f"phase {tag}"
    t = time.time()
    eng = make_engine(ctx, model, params, max_len=max_len, quant=True,
                      admission=AdmissionConfig(pack=4))
    ctx["sync"]()
    warmup_s = time.time() - t
    wl = eng.workload
    shapes = dict(wl.trace_counts)
    nb = len(wl.admission.buckets)
    require(shapes["prefill_batch"] == nb and shapes["step"] == 1,
            f"{label}: warmup ran {shapes}, expected {nb} bucket shapes and one step shape")
    exact_s: list = []
    batch_s: list = []
    with _timed_prefills(ctx, eng, exact_s), _timed_bucket_calls(ctx, eng, batch_s):
        reqs, seen = drive(ctx, eng, prompts, new_tokens)
    expect_shapes = dict(shapes)
    if n_band:
        expect_shapes["prefill"] = len({int(r.prompt.size) for r, k in zip(reqs, kinds)
                                        if k == "long"})
    require(wl.trace_counts == expect_shapes,
            f"{label}: call shapes {wl.trace_counts}, expected {expect_shapes} (the "
            "exact-path long prompts only)")
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"{label}: the QoS degree never moved: {rungs}")
    st, L = eng.stats, cfg.n_layers
    steps = st.decode_steps
    calls = sum(int(c.value) for c in st.c_admit_bucket.children.values())
    require(len(batch_s) == calls, f"{label}: {len(batch_s)} timed calls for {calls} calls")
    if ctx["on_card"]:
        replays = sum(c.replays for k, c in eng.graphs.graphs.items()
                      if k[0] == "prefill_batch")
        require(replays == calls, f"{label}: {replays} bucket graph replays for {calls} calls")
    check_launches(ctx, label, seen, {
        "axqmm": (5 * L + 1) * (steps + n_band) + 5 * L * calls,
        "axqmm_gated": L * (steps + n_band + calls), "flash_decode": 0,
        "flash_decode_quant": L * steps, "flash_attention": L * (n_band + calls),
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    if ctx["on_card"]:
        require(seen["flash_schedules"] == {"dense": 0, "tri": L * calls, "band": L * n_band},
                f"{label}: flash_attention by schedule {seen['flash_schedules']}")
    # the non-long prompts' largest bucket: a call past it holds a long prompt
    short_bucket = bucket_for(max(p.size - 1 for p, k in zip(prompts, kinds) if k != "long"),
                              wl.admission.buckets)
    long_prefills = ([{"prefix": m, "s": t} for m, t in exact_s]
                     + [{"bucket": m, "s": t} for m, t in batch_s if m > short_bucket])
    out = _long_summary(ctx, f"{label} ({cfg.name}, int8 cache, buckets, pack 4)", cfg,
                        params, eng, reqs, seen, kinds, long_prefills, 4)
    out.update(warmup_s=warmup_s, buckets=list(wl.admission.buckets), pack=wl.admission.pack,
               call_shapes=dict(wl.trace_counts), bucketed_calls=calls,
               bucket_flushes={k[0]: int(c.value) for k, c in st.c_admit_bucket.children.items()},
               bucket_call_ms=[{"bucket": m, "ms": 1e3 * t} for m, t in batch_s])
    if ctx["on_card"]:
        out["replay"] = replay_times(ctx, eng)
    say(f"{label}: warmup {warmup_s:.2f} s over {shapes}; {calls} bucketed calls "
        f"{out['bucket_flushes']}; each call (staging + replay) "
        f"{[(m, round(1e3 * t, 3)) for m, t in batch_s]} ms")
    if ctx["on_card"]:
        capture_line(label, out)
    return out


def moe_launches(cfg, steps, prefills, quant) -> dict:
    """The launches an MoE model's serving makes: each decode step and each
    exact-length prefill runs every layer's q/k/v/o projections and one
    expert-batched gated and down launch (plus the shared experts' gated
    half and down, where the config has them) and the unembedding; decode
    one attention kernel a layer, prefill one flash_attention."""
    L, calls = cfg.n_layers, steps + prefills
    shared = L if cfg.moe.n_shared else 0
    return {"axqmm": (4 * L + shared + 1) * calls, "axqmm_gated": shared * calls,
            "axqmm_experts": L * calls, "axqmm_gated_experts": L * calls,
            "flash_decode": 0 if quant else L * steps,
            "flash_decode_quant": L * steps if quant else 0, "flash_attention": L * prefills}


def phase_serve_moe(ctx, tag, cfg, model, params, prompts, *, quant):
    """Phases 3m and 3n: the MoE arch at full width on phase 3's traffic
    (its prompts, slots and budgets), exact-length admission (MoE's only
    one), on the bf16 (3m) or the int8 (3n) cache: the decode step replayed
    from one CUDA graph, an eager twin with equal tokens, the launches a
    tick predicted (the experts on one expert-batched launch each), and a
    profiled window of steady decode ticks.  The tick's bound reads every
    packed weight once: the capacity buffer runs every expert each tick."""
    label = f"phase {tag}"
    max_len, new_tokens = ctx["max_len"], ctx["new_tokens"]
    make = lambda **kw: make_engine(ctx, model, params, max_len=max_len, quant=quant, **kw)
    warm = make()
    warm.submit(prompts[0][:16], 2)
    warm.run_until_drained()
    del warm
    eng = make()
    require(eng.workload.admission is None, f"{label}: MoE admission is not exact-length")
    reqs, seen = drive(ctx, eng, prompts, new_tokens)
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"{label}: the QoS degree never moved: {rungs}")
    steps, prefills = eng.stats.decode_steps, eng.stats.prefill_calls
    check_launches(ctx, label, seen, moe_launches(cfg, steps, prefills, quant))
    wbytes = packed_bytes(params)
    out = serve_summary(ctx, f"{label} ({cfg.name}, exact admission, "
                             f"{'int8' if quant else 'bf16'} cache)", eng, reqs, seen,
                        wbytes / HBM_BPS * 1e3)
    out.update(arch=cfg.name, new_tokens=new_tokens, slots=ctx["slots"], max_len=max_len,
               packed_weight_bytes=wbytes, prompt_lens=[int(p.size) for p in prompts],
               experts=cfg.moe.n_experts, top_k=cfg.moe.top_k)
    if ctx["on_card"]:
        out["eager"] = eager_twin(ctx, label, make, prompts, new_tokens, reqs, eng)
    out["profile"] = prof = _profile_lm_ticks(ctx, eng, prompts, ctx["profile_ticks"])
    if ctx["on_card"]:
        out["replay"] = replay_times(ctx, eng)
        capture_line(label, out)
    say(f"{label}: profiled {prof['ticks']} steady decode ticks: {prof['tick_wall_ms']:.4f} ms "
        f"wall per tick, {prof['device_us_per_tick']:.2f} us of device kernel time per tick "
        f"(busy share {prof['device_busy_share']}, {prof['kernels_per_tick']} kernels a tick); "
        "largest: " + "; ".join(
            f"{r['name'][:60]} x{r['calls']} {r['device_us']:.1f} us ({r['share']:.4f})"
            for r in prof["top_kernels"]))
    return out


def recurrent_prompts(ctx, cfg, tag):
    """Phase 3o / 3p traffic, all submitted at t = 0: ``{tag}_n_long``
    prompts of ``long_range`` tokens (past the bucket ladder: exact-length
    prefill; on the hybrid past its window: ``band`` and the ring) among
    ``{tag}_n_short`` of ``prompt_range``, shuffled from a seed.  Returns
    (prompts, kinds)."""
    import numpy as np

    rng = np.random.default_rng(24 if tag == "ssm" else 25)
    (llo, lhi), (slo, shi) = ctx["rec_long_range"], ctx["prompt_range"]
    lens = ([("long", int(rng.integers(llo, lhi + 1))) for _ in range(ctx[f"{tag}_n_long"])]
            + [("short", int(rng.integers(slo, shi + 1)))
               for _ in range(ctx[f"{tag}_n_short"])])
    order = rng.permutation(len(lens))
    kinds = [lens[i][0] for i in order]
    prompts = [rng.integers(0, cfg.vocab, lens[i][1]) for i in order]
    return prompts, kinds


def recurrent_launches(cfg, steps, exact, calls) -> dict:
    """The launches a recurrent family's serving makes.  Mamba-2: each
    layer's in_proj and out_proj, and the tied unembedding on a decode step
    or an exact-length prefill (not on a bucketed call, which returns no
    logits).  The hybrid: a recurrent block's wx, wg, wa, wi, wo and down
    projections and its gated half, an attention block's q, k, v, o and
    down and its gated half; one flash_decode an attention block a decode
    step, one flash_attention a prefill call."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"axqmm": (2 * L + 1) * (steps + exact) + 2 * L * calls}
    n_attn = L // len(cfg.block_pattern) * cfg.block_pattern.count("attn")
    per = 6 * (L - n_attn) + 5 * n_attn
    return {"axqmm": (per + 1) * (steps + exact) + per * calls,
            "axqmm_gated": L * (steps + exact + calls), "flash_decode": n_attn * steps,
            "flash_attention": n_attn * (exact + calls)}


def phase_serve_recurrent(ctx, tag, cfg, model, params, prompts, kinds, *, max_len):
    """Phases 3o (mamba2-370m) and 3p (recurrentgemma-2b) at full width:
    bucketed, packed admission (``rec_buckets``, pack 4; warmup captures
    every bucket shape and the step, and no call shape is new after it:
    the long prompts take the exact-length path, eagerly) on the family's
    state cache, whose bytes must not depend on the prompts' lengths; the
    launches a tick and a call predicted; an eager twin with equal tokens;
    a profiled window of steady decode ticks.  The tick's bound reads the
    packed weights once, the recurrent state twice (read and written) and,
    on the hybrid, the attention rings whole."""
    torch = ctx["torch"]
    from repro_torch.serve.admission import AdmissionConfig

    label = f"phase {tag}"
    new_tokens = ctx["new_tokens"]
    adm = AdmissionConfig(buckets=ctx["rec_buckets"], pack=4)
    make = lambda **kw: make_engine(ctx, model, params, max_len=max_len, admission=adm, **kw)
    warm = make_engine(ctx, model, params, max_len=max_len, capture=False)
    warm.submit(prompts[kinds.index("short")][:16], 2)
    warm.run_until_drained()
    del warm
    t = time.time()
    eng = make()
    ctx["sync"]()
    warmup_s = time.time() - t
    wl = eng.workload
    shapes = dict(wl.trace_counts)
    nb = len(wl.admission.buckets)
    require(shapes["prefill_batch"] == nb and shapes["step"] == 1,
            f"{label}: warmup ran {shapes}, expected {nb} bucket shapes and one step shape")
    n_graphs = None if eng.graphs is None else len(eng.graphs.graphs)
    before = cache_bytes(eng.cache)
    longest = max(p.size for p in prompts) + new_tokens
    sizes = {n: cache_bytes(model.init_cache(1, ctx["slots"], n))
             for n in (max_len, max(max_len, longest))}
    exact_s: list = []
    batch_s: list = []
    with _timed_prefills(ctx, eng, exact_s), _timed_bucket_calls(ctx, eng, batch_s):
        reqs, seen = drive(ctx, eng, prompts, new_tokens)
    require(cache_bytes(eng.cache) == before and len(set(sizes.values())) == 1,
            f"{label}: the cache's bytes depend on the prompts' lengths: {before} served, "
            f"{sizes} by max_len")
    n_long = sum(k == "long" for k in kinds)
    expect_shapes = dict(shapes, prefill=len({int(r.prompt.size) for r, k in zip(reqs, kinds)
                                              if k == "long"}))
    require(wl.trace_counts == expect_shapes,
            f"{label}: call shapes {wl.trace_counts}, expected {expect_shapes}")
    require(n_graphs is None or len(eng.graphs.graphs) == n_graphs,
            f"{label}: a graph was captured after warmup")
    rungs = sorted({e for _, e in eng.stats.degree_history})
    require(len(rungs) > 1, f"{label}: the QoS degree never moved: {rungs}")
    st = eng.stats
    steps, exact, calls = st.decode_steps, len(exact_s), len(batch_s)
    require(exact == n_long, f"{label}: {exact} exact-length prefills for {n_long} long "
                             "prompts")
    require(calls == sum(int(c.value) for c in st.c_admit_bucket.children.values()),
            f"{label}: {calls} timed bucketed calls, the engine counted others")
    check_launches(ctx, label, seen, dict(
        {"axqmm_gated": 0, "flash_decode": 0, "flash_decode_quant": 0, "flash_attention": 0,
         "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0},
        **recurrent_launches(cfg, steps, exact, calls)))
    hybrid = cfg.family == "hybrid"
    n_attn = cfg.n_layers // 3 if hybrid else 0
    if ctx["on_card"] and hybrid:
        require(seen["flash_schedules"] == {"dense": 0, "tri": n_attn * calls,
                                            "band": n_attn * exact},
                f"{label}: flash_attention by schedule {seen['flash_schedules']}")
    c = eng.cache
    state = c.h.numel() * 4 + c.conv.numel() * c.conv.element_size()
    ring = (c.k.numel() + c.v.numel()) * c.k.element_size() if hybrid else 0
    wbytes = packed_bytes(params)
    out = serve_summary(ctx, f"{label} ({cfg.name}, buckets {list(wl.admission.buckets)}, "
                             f"pack 4, {type(c).__name__})", eng, reqs, seen,
                        (wbytes + 2 * state + ring) / HBM_BPS * 1e3)
    out.update(_split_ttft(reqs, kinds), arch=cfg.name, new_tokens=new_tokens,
               slots=ctx["slots"], max_len=max_len, packed_weight_bytes=wbytes,
               state_bytes=state, ring_bytes=ring, cache_bytes_by_max_len=sizes,
               prompt_lens=[int(r.prompt.size) for r in reqs], prompt_kinds=kinds,
               warmup_s=warmup_s, buckets=list(wl.admission.buckets), bucketed_calls=calls,
               call_shapes=dict(wl.trace_counts), flash_schedules=seen["flash_schedules"],
               long_prefill_s=[{"prefix": m, "s": t} for m, t in exact_s],
               bucket_call_ms=[{"bucket": m, "ms": 1e3 * t} for m, t in batch_s])
    say(f"{label}: warmup {warmup_s:.2f} s over {shapes}; TTFT long p50 "
        f"{out['long_ttft_p50_ms']} p95 {out['long_ttft_p95_ms']} ms, short p50 "
        f"{out['short_ttft_p50_ms']} p95 {out['short_ttft_p95_ms']} ms; long prefills "
        f"{[(m, round(t, 4)) for m, t in exact_s]} s; {calls} bucketed calls; cache "
        f"{before} bytes (state {state}, rings {ring}) at every max_len {sizes}")
    if ctx["on_card"]:
        out["eager"] = eager_twin(ctx, label, make, prompts, new_tokens, reqs, eng)
    out["profile"] = prof = _profile_lm_ticks(ctx, eng, prompts, ctx["profile_ticks"])
    if ctx["on_card"]:
        out["replay"] = replay_times(ctx, eng)
        capture_line(label, out)
    say(f"{label}: profiled {prof['ticks']} steady decode ticks: {prof['tick_wall_ms']:.4f} ms "
        f"wall per tick, {prof['device_us_per_tick']:.2f} us of device kernel time per tick "
        f"(busy share {prof['device_busy_share']}, {prof['kernels_per_tick']} kernels a tick); "
        "largest: " + "; ".join(
            f"{r['name'][:60]} x{r['calls']} {r['device_us']:.1f} us ({r['share']:.4f})"
            for r in prof["top_kernels"]))
    del eng
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    return out


def _stream_engine(ctx, cfg, capture=None):
    """A stream engine on the card with the per-site QoS ladder [e] * 3,
    e = 8 -> 5 (as ``launch.serve --workload stream --qos`` builds it);
    ``capture`` as ``ServeCore`` takes it."""
    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.stream import StreamAdapter, StreamServeEngine

    qos = QoSController(ladder=[{"degrees": [e] * (cfg.n_layers + 1)} for e in (8, 7, 6, 5)],
                        low_water=0.25, high_water=0.75, cooldown_steps=8)
    return StreamServeEngine(StreamAdapter(cfg, device=ctx["dev"]), slots=ctx["stream_slots"],
                             qos=qos, capture=capture)


def _serve_clips(ctx, cfg, clips, backend, capture=None):
    """Serve ``clips`` (all submitted at t = 0) on a fresh engine through
    ``backend`` (captured unless ``capture`` is False), with every launch
    count set to 0 just before and read just after.  Returns the engine,
    the requests and what was seen."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build

    with _backend(backend):
        warm = _stream_engine(ctx, cfg, capture)      # allocator, first launches
        warm.submit(clips[0][:2])
        warm.run_until_drained()
        del warm
        eng = _stream_engine(ctx, cfg, capture)
        ctx["sync"]()
        _build.reset_counts()
        base = 0
        if ctx["on_card"]:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        st = eng.stats
        t0 = time.time()
        reqs = [eng.submit(c) for c in clips]
        step_ticks, ticks = [], 0
        max_ticks = 4 * sum(len(c) for c in clips)
        while eng.queue or any(r is not None for r in eng.slot_req):
            require(ticks < max_ticks, f"the stream engine did not drain within {max_ticks} ticks")
            before = (st.admitted, st.decode_steps)
            t = time.time()
            eng.tick()                           # a step tick ends in a device->host read
            dt = time.time() - t
            ticks += 1
            if st.decode_steps != before[1] and st.admitted == before[0]:
                step_ticks.append(dt)
        ctx["sync"]()
        wall = time.time() - t0
    seen = {"wall_s": wall, "ticks": ticks, "step_ticks": step_ticks,
            "launches": dict(_build.launches), "plain": dict(_build.plain_cuda_calls),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if ctx["on_card"] else None),
            "memory_allocated_before": base if ctx["on_card"] else None}
    return eng, reqs, seen


def _profiled(ctx, tick, n):
    """``n`` calls of ``tick`` under a ``torch.profiler`` trace: the
    kernels' summed device time per tick against the tick's host wall time,
    and the largest kernels by name with their share of that device time."""
    torch = ctx["torch"]
    from torch.profiler import ProfilerActivity, profile

    ctx["sync"]()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx["on_card"] else [])
    with profile(activities=acts) as prof:
        t = time.time()
        for _ in range(n):
            tick()
        ctx["sync"]()
        wall = time.time() - t
    # the device-side events only: an operator's own entry repeats its
    # kernels' device time
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_us = sum(r[2] for r in rows)
    top = sorted(rows, key=lambda r: -r[2])[:8]
    # device time by kernel function, template arguments dropped
    # ("decode_kernel" sums every instantiation)
    by_fn = {}
    for k, _, t in rows:
        fn = re.split(r"[<(]", k.replace("(anonymous namespace)::", ""))[0].split()[-1]
        fn = fn.split("::")[-1]
        by_fn[fn] = by_fn.get(fn, 0.0) + t
    copies_ = sum(c for k, c, _ in rows if k.startswith(("Memcpy", "Memset")))
    # the host's side of a replay: the graph launch call (absent when eager)
    launch_us = sum(e.self_cpu_time_total for e in prof.key_averages()
                    if e.key == "cudaGraphLaunch")
    return {"ticks": n, "tick_wall_ms": 1e3 * wall / n, "device_us_per_tick": dev_us / n,
            "graph_launch_us_per_tick": launch_us / n,
            "kernels_per_tick": (sum(c for _, c, _ in rows) - copies_) / n,
            "copies_per_tick": copies_ / n,
            "device_busy_share": dev_us * 1e-6 / wall if wall > 0 else None,
            "top_kernels": [{"name": k, "calls": c, "device_us": t, "share": t / dev_us}
                            for k, c, t in top],
            "share_by_function": {fn: t / dev_us for fn, t in
                                  sorted(by_fn.items(), key=lambda x: -x[1])}}


def _profile_ticks(ctx, cfg, clips, n, capture=None):
    """Device time inside ``n`` steady stream ticks (every slot busy)."""
    eng = _stream_engine(ctx, cfg, capture)
    for c in clips[:ctx["stream_slots"]]:
        eng.submit(c)
    for _ in range(2):                        # admission tick + one more
        eng.tick()
    return _profiled(ctx, eng.tick, n)


def _profile_lm_ticks(ctx, eng, prompts, n):
    """Device time inside ``n`` steady decode ticks of ``eng`` with every
    slot busy: the phase's first ``slots`` prompts, all admitted (and one
    decode tick run) before the trace opens."""
    batch = prompts[:ctx["slots"]]
    for p in batch:
        eng.submit(p, n + 4)
    while eng.queue:
        eng.tick()
    eng.tick()
    out = _profiled(ctx, eng.tick, n)
    eng.run_until_drained()
    out["prompt_lens"] = [int(p.size) for p in batch]
    return out


def phase_stream(ctx):
    """Phase 3d: the streaming DSP workload at the repo's StreamConfig()
    widths (256-sample frames, 8 FIR taps, 16x16 tiles, Q12): a backlog of
    clips on ``stream_slots`` slots with the QoS ladder 8 -> 5 over the three
    sites.  One ``pr_fir`` and two ``pr_conv2d`` launches a tick, each stage
    reading its element of the degree vector in place, and no
    ``pr_multiply``; the frames and the degree history must equal a second
    run of the same traffic through the plain versions on the card.  Then the whole-clip forward's
    PSNR against the exact pipeline at uniform degrees 8..4."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.error_analysis import psnr_db
    from repro_torch.kernels import _build
    from repro_torch.serve.metrics import summarize
    from repro_torch.serve.stream import StreamAdapter, StreamConfig, make_clip

    cfg = StreamConfig()
    slots, n_clips, n_frames = ctx["stream_slots"], ctx["stream_clips"], ctx["stream_frames"]
    clips = [make_clip(n_frames, cfg.frame, q=cfg.q, seed=i) for i in range(n_clips)]
    kernels = "cuda" if ctx["on_card"] else "auto"
    eng, reqs, seen = _serve_clips(ctx, cfg, clips, kernels)
    require(all(r.done and len(r.out) == n_frames for r in reqs),
            f"phase 3d: a clip did not return all {n_frames} frames")
    steps = eng.stats.decode_steps
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect.update(pr_fir=steps, pr_conv2d=2 * steps)
    check_launches(ctx, "phase 3d", seen, expect)
    hist = [(t, tuple(d)) for t, d in eng.stats.degree_history]
    rungs = sorted({d for _, d in hist})
    require(len(rungs) > 1, f"phase 3d: the QoS degree never moved: {rungs}")
    same_frames = lambda a, b: all(
        len(r.out) == len(q.out) and all(np.array_equal(x, y) for x, y in zip(r.out, q.out))
        for r, q in zip(a, b))
    # the plain versions, and the kernels without graphs: eager comparisons
    peng, preqs, pseen = _serve_clips(ctx, cfg, clips, "torch", capture=False)
    require([(t, tuple(d)) for t, d in peng.stats.degree_history] == hist,
            "phase 3d: the plain run's degree history differs from the kernel run's")
    same = same_frames(reqs, preqs)
    require(same, "phase 3d: the kernel run's frames differ from the plain run's")
    eager = None
    if ctx["on_card"]:
        eeng, ereqs, eseen = _serve_clips(ctx, cfg, clips, kernels, capture=False)
        require([(t, tuple(d)) for t, d in eeng.stats.degree_history] == hist,
                "phase 3d: the eager run's degree history differs from the captured run's")
        require(same_frames(reqs, ereqs),
                "phase 3d: the captured run's frames differ from the eager run's")
        out_replay = replay_times(ctx, eng)
        edts = eseen["step_ticks"]
        eager = {"tick_ms_mean": 1e3 * sum(edts) / max(len(edts), 1),
                 "frames_per_s": sum(len(r.out) for r in ereqs) / eseen["wall_s"],
                 "wall_s": eseen["wall_s"], "frames_equal": True}
        del eeng, ereqs

    s = summarize(reqs, eng.stats, wall_s=seen["wall_s"])
    frames = sum(len(r.out) for r in reqs)
    dts = seen["step_ticks"]
    H, W = cfg.tile
    tick_bound = (fir_bytes(slots, cfg.frame, cfg.taps) + conv_bytes(slots, H, W, 3, 3)
                  + conv_bytes(slots, H, W, 1, 1)) / HBM_BPS * 1e3
    out = {"config": dataclasses.asdict(cfg), "slots": slots, "clips": n_clips,
           "frames_per_clip": n_frames, "frames": frames, "wall_s": seen["wall_s"],
           "frames_per_s": frames / seen["wall_s"], "ticks": seen["ticks"],
           "step_ticks": steps, "tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
           "ticks_timed": len(dts), "tick_bound_ms": tick_bound,
           "ttff_p50_ms": s["ttft_p50_ms"], "ttff_p95_ms": s["ttft_p95_ms"],
           "e2e_p50_ms": s["e2e_p50_ms"], "e2e_p95_ms": s["e2e_p95_ms"],
           "degree_rungs_visited": [list(r) for r in rungs],
           "degree_at_first_frame": s.get("degree_at_first_token"),
           "launches": seen["launches"], "max_memory_allocated": seen["max_memory_allocated"],
           "memory_allocated_before": seen["memory_allocated_before"],
           "plain_run": {"wall_s": pseen["wall_s"], "frames_per_s": frames / pseen["wall_s"],
                         "tick_ms_mean": 1e3 * sum(pseen["step_ticks"])
                         / max(len(pseen["step_ticks"]), 1)},
           "frames_bit_identical_to_plain": same, "graphs": graph_summary(eng),
           "eager": eager, "replay": out_replay if ctx["on_card"] else None}
    say(f"phase 3d (stream, {slots} slots, {n_clips} clips x {n_frames} frames): "
        f"{frames} frames in {seen['wall_s']:.3f} s ({out['frames_per_s']:.1f} frames/s; "
        f"plain versions {out['plain_run']['frames_per_s']:.1f}); tick "
        f"{out['tick_ms_mean']:.4f} ms over {len(dts)} ticks vs bound {tick_bound:.4g} ms; "
        f"TTFF p50 {s['ttft_p50_ms']} ms p95 {s['ttft_p95_ms']} ms; e2e p50 "
        f"{s['e2e_p50_ms']} ms p95 {s['e2e_p95_ms']} ms; rungs {rungs}; "
        f"max_memory_allocated {out['max_memory_allocated']} (before the run "
        f"{out['memory_allocated_before']}); frames bit-identical to "
        f"the plain run: {same}")

    # whole-clip forward against the exact pipeline (outside the counted run)
    ad = StreamAdapter(cfg, device=dev)
    params = ad.init_params()
    batch = {"frames": np.stack([make_clip(ctx["psnr_frames"], cfg.frame, q=cfg.q, seed=i)
                                 for i in range(ctx["psnr_clips"])])}
    with _backend(kernels):
        exact, _ = ad.forward(params, batch, None)
    psnr = {}
    for e in (8, 7, 6, 5, 4):
        deg = torch.tensor([e] * (cfg.n_layers + 1), dtype=torch.int32, device=dev)
        with _backend(kernels):
            yk, _ = ad.forward(params, batch, deg)
        with _backend("torch"):
            yp, _ = ad.forward(params, batch, deg)
        require(bool(torch.equal(yk, yp)),
                f"phase 3d: forward at degree {e}: kernel and plain differ")
        require(bool(torch.isfinite(yk).all()) and tuple(yk.shape) == tuple(exact.shape),
                f"phase 3d: forward at degree {e}: non-finite or misshapen output")
        psnr[e] = psnr_db(exact.cpu().numpy(), yk.cpu().numpy())
    require(bool(torch.equal(exact, ad.forward(params, batch, torch.full(
        (3,), 8, dtype=torch.int32, device=dev))[0])), "phase 3d: degree 8 is not exact")
    out["forward_psnr_db"] = psnr
    with _backend(kernels):
        out["profile"] = prof = _profile_ticks(ctx, cfg, clips,
                                               min(16, n_frames - 2))
        if ctx["on_card"]:
            out["profile_eager"] = _profile_ticks(ctx, cfg, clips, min(16, n_frames - 2),
                                                  capture=False)
    say(f"phase 3d: profiled {prof['ticks']} steady ticks: {prof['tick_wall_ms']:.4f} ms "
        f"wall per tick, {prof['device_us_per_tick']:.2f} us of device time per tick "
        f"(busy share {prof['device_busy_share']}), {prof['kernels_per_tick']} kernel "
        f"launches and {prof['copies_per_tick']} copies a tick; shares "
        f"{ {k: round(v, 4) for k, v in prof['share_by_function'].items()} }; largest: "
        + "; ".join(f"{r['name'][:60]} x{r['calls']} {r['device_us']:.1f} us"
                    for r in prof["top_kernels"]))
    if ctx["on_card"]:
        pe, g = out["profile_eager"], out["graphs"]
        say(f"phase 3d captured vs eager: tick {out['tick_ms_mean']:.4f} ms captured, "
            f"{eager['tick_ms_mean']:.4f} ms eager; frames/s {out['frames_per_s']:.1f} vs "
            f"{eager['frames_per_s']:.1f}; traced tick device time "
            f"{prof['device_us_per_tick']:.2f} vs {pe['device_us_per_tick']:.2f} us, busy "
            f"share {prof['device_busy_share']} vs {pe['device_busy_share']}, copies a tick "
            f"{prof['copies_per_tick']} vs {pe['copies_per_tick']}, graph launch call "
            f"{prof['graph_launch_us_per_tick']:.2f} us; untraced replay: launch call "
            f"{out['replay']['launch_ms']:.4f} ms, replay {out['replay']['replay_wall_ms']:.4f} "
            f"ms; {g['graphs']} graph "
            f"captured in {g['capture_s']:.4f} s, pool {g['pool_bytes']} bytes; frames equal "
            f"to the eager run: True")
    say(f"phase 3d: forward PSNR vs the exact pipeline ({ctx['psnr_clips']} clips x "
        f"{ctx['psnr_frames']} frames), kernel == plain bit for bit: "
        + ", ".join(f"degree {e}: {v:.3f} dB" for e, v in psnr.items()))
    return out


# ---------------------------------------------------------------------------
# phases 3i / 3j: per-layer approximation plans, traced and tapped
# ---------------------------------------------------------------------------


def _obs_dir() -> Path:
    d = HERE / "build" / "smoke_obs"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _fresh_obs():
    """A fresh process-global registry and tracer and no route seen yet, as
    a new launcher process has them."""
    from repro_torch.kernels import dispatch
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    obs_metrics.set_registry(None)
    obs_trace.set_tracer(None)
    dispatch.last_route.clear()


def _launch(ctx, argv):
    """``launch.serve`` on ``argv`` with every launch count set to 0 just
    before and read just after; the global tracer and registry are reset
    around it.  Returns (summary, engine, seen)."""
    from repro_torch.kernels import _build, dispatch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import trace as obs_trace

    _fresh_obs()
    ctx["sync"]()
    _build.reset_counts()
    t0 = time.time()
    try:
        s, eng = launch_serve.run(argv)
        ctx["sync"]()
    finally:
        dispatch.set_backend(None)
        obs_trace.set_tracer(None)
    seen = {"wall_s": time.time() - t0, "launches": dict(_build.launches),
            "plain": dict(_build.plain_cuda_calls)}
    return s, eng, seen


def _check_plan(label, plan, cfg, path):
    from repro_torch.tune import ApproxPlan

    plan.validate_for(cfg)
    pts = plan.ladder
    require(len(pts) > 1, f"{label}: the plan has {len(pts)} rung(s)")
    require(all(a.cost > b.cost and a.error < b.error for a, b in zip(pts, pts[1:])),
            f"{label}: the ladder is not Pareto-ordered: "
            f"{[(p.cost, p.error) for p in pts]}")
    plan.save(path)
    loaded = ApproxPlan.load(path)
    require(loaded == plan and loaded.to_dict() == plan.to_dict(),
            f"{label}: the plan did not survive the save/load round trip")


def _trace_events(path):
    return json.loads(Path(path).read_text())["traceEvents"]


def _metric(d, name, **labels):
    """Sum of the parsed samples of ``name`` whose labels include ``labels``."""
    return sum(v for (n, ls), v in d.items()
               if n == name and all(dict(ls).get(k) == str(x) for k, x in labels.items()))


def _timed_ticks(ctx, model, params, plan, prompts, new_tokens, *, tracer, quality_every):
    """Mean decode tick (ms) of an engine serving ``plan`` under QoS with
    ``tracer`` and the tap every ``quality_every`` ticks (0 = off)."""
    from repro_torch.core.dynamic import QoSController
    from repro_torch.serve.lm import ServeEngine

    qos = QoSController(ladder=[], low_water=0.25, high_water=0.75, cooldown_steps=8)
    eng = ServeEngine(model, params, slots=ctx["slots"], max_len=ctx["max_len"], qos=qos,
                      plan=plan, prepack=False, tracer=tracer, quality_every=quality_every)
    _, seen = drive(ctx, eng, prompts, new_tokens)
    dts = seen["decode_ticks"]
    return 1e3 * sum(dts) / max(len(dts), 1), len(dts)


def phase_plan_lm(ctx, cfg):
    """Phase 3i: a per-layer plan for ``cfg`` built on the device with
    ``build_plan`` (the launcher's seeded weights, a seeded calibration
    batch, the default nRMS metric), then served by ``launch.serve --plan
    --qos`` with the trace, the metrics file and the quality tap on."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.dynamic import QoSController
    from repro_torch.models import build_model
    from repro_torch.obs.metrics import parse_text
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.lm import ServeEngine
    from repro_torch.tune import build_plan, site_names, uniform_plan
    from repro_torch.tune.autotune import _Prober

    label = "phase 3i"
    L, S = cfg.n_layers, cfg.n_layers + 1
    # 1. the plan, calibrated on the weights the launcher will build (seed 0)
    model = build_model(cfg, uniform_plan(cfg).policy(), device=dev)
    params = model.init(seed=0)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, ctx["calib_shape"]).astype(np.int32)}
    kernels = "cuda" if ctx["on_card"] else "auto"
    ctx["sync"]()
    t = time.time()
    with _backend(kernels):
        prober = _Prober(model, params, batch)
        plan = build_plan(model, params, batch, grid=ctx["plan_grid"], prober=prober)
    ctx["sync"]()
    build_s = time.time() - t
    del model, params, prober
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    path = _obs_dir() / "plan_lm.json"
    _check_plan(label, plan, cfg, path)
    ladder = [{"degrees": list(p.degrees), "error": p.error, "cost": p.cost}
              for p in plan.ladder]
    say(f"{label}: plan for {cfg.name} built in {build_s:.2f} s, {plan.meta['visited']} "
        f"vectors visited ({plan.meta['strategy']}, grid {plan.meta['grid']}, calibration "
        f"{plan.meta['calibration']}), {len(ladder)} rungs: "
        + "; ".join(f"{p['degrees']} err {p['error']:.6g} cost {p['cost']:.6g}"
                    for p in ladder))

    # 2. served through the launcher
    tpath, mpath = _obs_dir() / "trace_lm.json", _obs_dir() / "metrics_lm.prom"
    argv = ["--arch", cfg.name, "--plan", str(path), "--qos", "--quality-every", "8",
            "--trace-out", str(tpath), "--metrics-out", str(mpath),
            "--requests", str(ctx["requests"]), "--slots", str(ctx["slots"]),
            "--new-tokens", str(ctx["new_tokens"]), "--max-len", str(ctx["max_len"]),
            "--device", str(dev.type), "--kernels", kernels]
    s, eng, seen = _launch(ctx, argv)
    st = eng.stats
    steps, prefills, samples = st.decode_steps, st.prefill_calls, eng._tap.samples
    require(s["requests"] == ctx["requests"]
            and s["generated_tokens"] == ctx["requests"] * ctx["new_tokens"],
            f"{label}: {s['requests']} requests, {s['generated_tokens']} tokens")
    # each tap sample runs two decode forwards beside the tick's step; a
    # captured engine ran one eager warm-up step at construction
    fwd = steps + 2 * samples + int(eng.capture)
    check_launches(ctx, label, seen, {
        "axqmm": (5 * L + 1) * (fwd + prefills), "axqmm_gated": L * (fwd + prefills),
        "flash_decode": L * fwd, "flash_decode_quant": 0, "flash_attention": L * prefills,
        "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
    rungs = {p.degrees for p in plan.ladder}
    visited = {d for _, d in st.degree_history}
    require(len(visited) > 1 and visited <= rungs,
            f"{label}: visited {sorted(visited)}, ladder {sorted(rungs)}")
    evs = _trace_events(tpath)
    ticks = [e for e in evs if e["name"] == "decode_tick"]
    moves = [e for e in evs if e["name"] == "qos_rung"]
    require(len(ticks) == steps, f"{label}: {len(ticks)} decode_tick spans, {steps} steps")
    require(moves and all(len(e["args"]["degrees"]) == S for e in moves),
            f"{label}: qos_rung events {[e['args'].get('degrees') for e in moves]}")
    d = parse_text(mpath.read_text())
    sites = {dict(ls)["site"] for n, ls in d if n == "repro_degree_ebits"}
    require(sites == set(site_names(cfg)), f"{label}: degree gauges for {sorted(sites)}")
    backend = "cuda" if ctx["on_card"] else "torch"
    routes = _metric(d, "repro_kernel_route_steps_total", site="decode", backend=backend)
    require(routes == steps, f"{label}: decode route counters {routes}, {steps} steps")
    counts = _metric(d, "repro_quality_logit_rms_count")
    require(samples > 0 and counts == samples == _metric(d, "repro_quality_probes_total"),
            f"{label}: {counts} logit-RMS observations, {samples} tap samples")
    probes = [e["args"] for e in evs if e["name"] == "quality_probe"]
    require(len(probes) == samples, f"{label}: {len(probes)} quality_probe events")

    # 3. a rung pinned through the plan serves what its vector by hand serves
    model, params = eng.workload.model, eng.params
    r = len(plan.ladder) - 1
    rng = np.random.default_rng(11)
    short = [rng.integers(0, cfg.vocab, int(rng.integers(2, 10))) for _ in range(4)]

    def pinned(**kw):
        e = ServeEngine(model, params, slots=ctx["slots"], max_len=ctx["max_len"],
                        prepack=False, **kw)
        reqs = [e.submit(p, 8) for p in short]
        e.run_until_drained()
        return [q.out_tokens for q in reqs]

    held = QoSController(ladder=[], low_water=-1.0, high_water=2.0, degree=r)
    by_hand = pinned(degree=plan.degrees(r))
    require(by_hand == pinned(plan=plan, qos=held),
            f"{label}: rung {r} through the plan and by hand served different tokens")

    # 4. the tick with the tracer and the tap off and on, in turns (off,
    # traced, tapped, tapped, traced, off) on phase 3's prompts, and the
    # tracer's own cost a call on this host
    rng = np.random.default_rng(0)
    lo, hi = ctx["prompt_range"]
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
               for _ in range(ctx["requests"])]
    modes = {"off": (False, 0), "traced": (True, 0), "tapped": (True, 8)}
    ticks_ms = {m: [] for m in modes}
    for m in ("off", "traced", "tapped", "tapped", "traced", "off"):
        on, every = modes[m]
        ms, n_ticks = _timed_ticks(ctx, model, params, plan, prompts, ctx["new_tokens"],
                                   tracer=Tracer(enabled=on), quality_every=every)
        ticks_ms[m].append(ms)
    tracer_us = _tracer_call_us()
    del eng, model, params
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    vals = [p["logit_rms"] for p in probes]
    out = {"arch": cfg.name, "build_s": build_s, "probes": plan.meta["visited"],
           "strategy": plan.meta["strategy"], "grid": plan.meta["grid"],
           "calibration": plan.meta["calibration"], "ladder": ladder,
           "requests": s["requests"], "generated_tokens": s["generated_tokens"],
           "wall_s": seen["wall_s"], "gen_tok_per_s": s["gen_tok_per_s"],
           "decode_steps": steps, "prefill_calls": prefills, "tap_samples": samples,
           "tap_logit_rms": [min(vals), max(vals)],
           "decode_tick_ms_traced_run": sum(e["dur"] for e in ticks) / 1e3 / len(ticks),
           "rungs_visited": [list(v) for v in sorted(visited)],
           "rung_moves": len(moves), "launches": seen["launches"],
           "trace_events": len(evs),
           "tick_ms": {"tracer_off_tap_off": ticks_ms["off"],
                       "tracer_on_tap_off": ticks_ms["traced"],
                       "tracer_on_tap_every_8": ticks_ms["tapped"], "ticks_timed": n_ticks},
           "trace_events_per_step": len(evs) / steps, "tracer_call_us": tracer_us,
           "pinned_rung": r}
    say(f"{label}: launch.serve --plan --qos: {s['requests']} requests, "
        f"{s['generated_tokens']} tokens, {s['gen_tok_per_s']} tok/s (launcher wall clock, "
        f"model build excluded); {steps} decode steps, {prefills} prefills, {samples} tap "
        f"samples (logit RMS {min(vals):.4g}..{max(vals):.4g}); mean decode_tick span "
        f"{out['decode_tick_ms_traced_run']:.3f} ms; {len(moves)} rung moves over "
        f"{len(visited)} rungs; {len(evs)} trace events; rung {r} pinned through the plan == "
        f"by hand")
    say(f"{label}: mean decode tick over {n_ticks} ticks, runs in the order off, traced, "
        f"tapped, tapped, traced, off: tracer off, tap off {ticks_ms['off']} ms; tracer on "
        f"{ticks_ms['traced']} ms; tracer on, tap every 8 {ticks_ms['tapped']} ms; "
        f"{out['trace_events_per_step']:.2f} trace events a decode step; one tracer call "
        f"on this host {tracer_us}")
    return out


def _tracer_call_us() -> dict:
    """Host microseconds of one tracer call (a span, an event, a counter)
    enabled and disabled: the instrumentation's own cost."""
    from repro_torch.obs.trace import Tracer

    out = {}
    n = 20000
    for on in (True, False):
        tr = Tracer(capacity=n, enabled=on)
        t = time.perf_counter()
        for i in range(n):
            with tr.span("decode_tick", track="engine", tick=i, active=8, queued=0):
                pass
        t_span = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n):
            tr.event("first_token", track="engine", rid=i, slot=0, ttft_ms=1.0)
        t_event = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n):
            tr.counter("slots", track="engine", active=8, queued=0)
        t_counter = time.perf_counter() - t
        key = "enabled" if on else "disabled"
        out[key] = {"span": 1e6 * t_span / n, "event": 1e6 * t_event / n,
                    "counter": 1e6 * t_counter / n}
    return out


def phase_plan_stream(ctx):
    """Phase 3j: a plan for the stream pipeline calibrated on per-frame
    PSNR, built twice on the device (kernels, then plain versions: equal
    field for field but the build time), served by ``launch.serve
    --workload stream --plan --qos`` with the trace, the metrics file and
    the PSNR tap on; the frames equal a plain run of the same traffic."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.obs.metrics import parse_text
    from repro_torch.serve.stream import StreamAdapter, StreamConfig, make_clip, psnr_metric
    from repro_torch.tune import build_plan

    label = "phase 3j"
    cfg = StreamConfig()
    ad = StreamAdapter(cfg, device=ctx["dev"])
    params = ad.init_params()
    batch = {"frames": np.stack([make_clip(ctx["psnr_frames"], cfg.frame, q=cfg.q, seed=i)
                                 for i in range(ctx["psnr_clips"])])}
    kernels = "cuda" if ctx["on_card"] else "auto"
    plans, secs = {}, {}
    for backend in (kernels, "torch"):
        t = time.time()
        with _backend(backend):
            plans[backend] = build_plan(ad, params, batch, grid=(8, 6, 4), metric=psnr_metric)
        ctx["sync"]()
        secs[backend] = time.time() - t
    dk, dp = plans[kernels].to_dict(), plans["torch"].to_dict()
    dk["meta"].pop("tune_seconds"), dp["meta"].pop("tune_seconds")
    require(dk == dp, f"{label}: the kernel-built plan differs from the plain-built one")
    plan = plans[kernels]
    path = _obs_dir() / "plan_stream.json"
    _check_plan(label, plan, cfg, path)
    ladder = [{"degrees": list(p.degrees), "psnr_db": -p.error, "cost": p.cost}
              for p in plan.ladder]
    say(f"{label}: stream plan built in {secs[kernels]:.3f} s with the kernels "
        f"({secs['torch']:.3f} s with the plain versions on the device; equal field for "
        f"field), {plan.meta['visited']} vectors: "
        + "; ".join(f"{p['degrees']} {p['psnr_db']:.3f} dB cost {p['cost']:.6g}"
                    for p in ladder))

    tpath, mpath = _obs_dir() / "trace_stream.json", _obs_dir() / "metrics_stream.prom"
    base = ["--workload", "stream", "--plan", str(path), "--qos", "--quality-every", "8",
            "--requests", str(ctx["stream_clips"]), "--frames", str(ctx["stream_frames"]),
            "--slots", str(ctx["stream_slots"]), "--device", str(ctx["dev"].type)]
    s, eng, seen = _launch(ctx, base + ["--kernels", kernels, "--trace-out", str(tpath),
                                        "--metrics-out", str(mpath)])
    ps, peng, pseen = _launch(ctx, base + ["--kernels", "torch"])
    st = eng.stats
    steps, samples = st.decode_steps, eng._tap.samples
    reqs, preqs = sorted(eng.done, key=lambda r: r.rid), sorted(peng.done, key=lambda r: r.rid)
    require(len(reqs) == ctx["stream_clips"]
            and all(len(r.out) == ctx["stream_frames"] for r in reqs),
            f"{label}: a clip did not return all its frames")
    same = all(len(r.out) == len(q.out) and all(np.array_equal(x, y) for x, y in
                                                 zip(r.out, q.out))
               for r, q in zip(reqs, preqs))
    require(same, f"{label}: the kernel run's frames differ from the plain run's")
    require([d for _, d in st.degree_history] == [d for _, d in peng.stats.degree_history],
            f"{label}: the plain run walked other rungs")
    fwd = steps + 2 * samples + int(eng.capture)
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect.update(pr_fir=fwd, pr_conv2d=2 * fwd)
    check_launches(ctx, label, seen, expect)
    visited = {d for _, d in st.degree_history}
    require(len(visited) > 1 and visited <= {p.degrees for p in plan.ladder},
            f"{label}: visited {sorted(visited)}")
    d = parse_text(mpath.read_text())
    counts = _metric(d, "repro_quality_psnr_db_count")
    require(samples > 0 and counts == samples,
            f"{label}: {counts} PSNR observations, {samples} tap samples")
    evs = _trace_events(tpath)
    require(sum(e["name"] == "stream_tick" for e in evs) == steps,
            f"{label}: stream_tick spans do not match the {steps} steps")
    frames = sum(len(r.out) for r in reqs)
    vals = [e["args"]["psnr_db"] for e in evs if e["name"] == "quality_probe"]
    spans = [e["dur"] for e in evs if e["name"] == "stream_tick"]
    out = {"build_s": secs[kernels], "build_s_plain": secs["torch"],
           "probes": plan.meta["visited"], "ladder": ladder, "frames": frames,
           "wall_s": seen["wall_s"], "frames_per_s": frames / seen["wall_s"],
           "plain_frames_per_s": frames / pseen["wall_s"], "steps": steps,
           "stream_tick_ms_traced_run": sum(spans) / 1e3 / len(spans),
           "tap_samples": samples, "tap_psnr_db": [min(vals), max(vals)],
           "rungs_visited": [list(v) for v in sorted(visited)],
           "launches": seen["launches"], "frames_bit_identical_to_plain": same}
    say(f"{label}: launch.serve --workload stream --plan --qos: {frames} frames in "
        f"{seen['wall_s']:.3f} s ({out['frames_per_s']:.1f} frames/s; plain versions "
        f"{out['plain_frames_per_s']:.1f}; the launcher's wall clock, making the clips "
        f"included); mean stream_tick span {out['stream_tick_ms_traced_run']:.4f} ms; "
        f"{steps} steps, {samples} tap samples (PSNR "
        f"{min(vals):.3f}..{max(vals):.3f} dB); rungs {sorted(visited)}; frames "
        f"bit-identical to the plain run: {same}")
    return out


# ---------------------------------------------------------------------------
# phases 3k / 3l: the EMUL / POW2_W arithmetic and the resilience layer
# ---------------------------------------------------------------------------

#: phase 3k's policies: (mode, knobs), each uniform over every projection
EMUL_MODES = (("pr_emul", {"p": 1, "r": 2}), ("rad_emul", {"k": 4}),
              ("roup_emul", {"k": 4, "p": 1, "r": 1}), ("pow2_w", {}))


def weight_bytes(params) -> int:
    """Bytes of every weight as served (packs or floats) but the embedding
    table: what one decode step reads at the least."""
    from repro_torch.resil.faults import tree_leaves

    return sum(t.numel() * t.element_size()
               for k, v in params.items() if k != "embed" for t in tree_leaves(v))


def _emul_model(ctx, cfg, mode, kw):
    """tinyllama under one uniform EMUL / POW2_W policy: random weights
    from a seeded generator on the device, prepacked (POW2_W keeps its
    float weights: it has no pack)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core.approx import ApproxMode, ApproxSpec, uniform
    from repro_torch.models import build_model

    model = build_model(cfg, uniform(ApproxSpec(mode=ApproxMode(mode), **kw)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.prepack(model.init(generator=gen))
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    return model, params


def _check_emul_tick(ctx, eng, mode) -> dict:
    """One decode step on a scratch copy of the engine's live cache (its
    feed, every slot active), eagerly, with every integer product (or, for
    POW2_W, every weight snap) checked as it is made: the card's int32
    accumulator against an exact CPU product of the same int8 operands
    (float64 products and sums of int8 codes are exact below 2^53; compared
    as int64), the snapped weights against a CPU snap, bit for bit."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core import encodings as enc
    from repro_torch.kernels import ops

    calls = {"n": 0, "max_abs_acc": 0}
    if mode == "pow2_w":
        snap = enc.pow2_snap

        def hook(w):
            out = snap(w)
            want = snap(w.cpu())
            same = torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
            require(same, f"phase 3k pow2_w: snap {calls['n']} of {tuple(w.shape)} "
                          "differs from the CPU snap")
            calls["n"] += 1
            return out

        owner, name = enc, "pow2_snap"
    else:
        product = ops.int_product

        def hook(qx, qw):
            acc = product(qx, qw)
            want = (qx.cpu().to(torch.float64) @ qw.cpu().to(torch.float64)).to(torch.int64)
            got = acc.cpu().to(torch.int64)
            require(acc.dtype == torch.int32 and torch.equal(got, want),
                    f"phase 3k {mode}: product {calls['n']} of {tuple(qx.shape)} x "
                    f"{tuple(qw.shape)}: the int32 accumulator differs from the int64 "
                    f"CPU product (max diff {int((got - want).abs().max())})")
            calls["n"] += 1
            calls["max_abs_acc"] = max(calls["max_abs_acc"], int(got.abs().max()))
            return acc

        owner, name = ops, "int_product"
    scratch = type(eng.state)(*(t.clone() for t in eng.state))
    feed = torch.from_numpy(eng._feed).to(dev)
    active = torch.ones(eng.slots, dtype=torch.bool, device=dev)
    setattr(owner, name, hook)
    try:
        eng.model.decode_step(eng.params, scratch, feed, degree=None, active=active)
    finally:
        setattr(owner, name, snap if mode == "pow2_w" else product)
    ctx["sync"]()
    L = eng.model.cfg.n_layers
    require(calls["n"] == 7 * L + 1, f"phase 3k {mode}: {calls['n']} products or snaps "
                                     f"checked in one decode step, expected {7 * L + 1}")
    return calls


def _int_mm_rows(ctx, K, N) -> list:
    """``torch._int_mm`` as the EMUL product calls it: at decode (8 rows
    zero-padded to 32) and at M = 255, beside its bound (bytes: both
    operands read and the int32 result written once; operations at the
    int8 tensor-core peak)."""
    torch, dev, timer = ctx["torch"], ctx["dev"], ctx["timer"]
    from repro_torch.kernels import ops
    from repro_torch.kernels.qstore import emul_layout

    rows = []
    gen = torch.Generator(device=dev).manual_seed(K + N)
    for M in (8, 255):
        qx = torch.randint(-127, 128, (M, K), generator=gen, device=dev).to(torch.int8)
        qws = copies(lambda: emul_layout(torch.randint(-127, 128, (K, N), generator=gen,
                                                       device=dev).to(torch.int8)),
                     K * N, ctx["on_card"])
        Mp = ops.pad_for_int_mm(qx).shape[0]
        row = {"M": M, "M_padded": Mp, "K": K, "N": N}
        call = lambda i: ops.int_product(qx, qws[i % len(qws)])
        row["ms"] = timer(call)
        row["ms_graph"] = timer.graph(call, len(qws))
        row["bound_ms"], row["bound_by"] = bound(M * K + K * N + M * N * 4, 2.0 * M * N * K,
                                                 INT8_OPS)
        rows.append(row)
        say(f"phase 3k int product M={M} (padded {Mp}) K={K} N={N}: {row['ms']} ms eager, "
            f"{row['ms_graph']} ms by graph replay, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']})")
    return rows


def phase_emul(ctx, cfg):
    """Phase 3k: tinyllama under PR_EMUL (p=1, r=2), RAD_EMUL (k=4),
    ROUP_EMUL (k=4, p=1, r=1) and POW2_W, each uniform at a fixed degree,
    prepacked and captured: at one decode tick every integer product is
    bit-identical to an exact CPU product (POW2_W: every snapped weight to
    a CPU snap); the traffic served with no GEMM kernel launched (the
    product is ``torch._int_mm``) and the flash kernels as predicted."""
    torch = ctx["torch"]
    import numpy as np

    rng = np.random.default_rng(3)
    lo, hi = ctx["prompt_range"]
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
               for _ in range(ctx["slots"])]
    out = {"modes": {}, "prompt_range": [lo, hi], "prompts": len(prompts),
           "new_tokens": ctx["new_tokens"]}
    from repro_torch.serve.lm import ServeEngine

    for mode, kw in EMUL_MODES:
        t0 = time.time()
        mcfg = depth_cut(ctx, "3k", cfg)
        model, params = _emul_model(ctx, mcfg, mode, kw)
        wbytes = weight_bytes(params)
        eng = ServeEngine(model, params, slots=ctx["slots"], max_len=ctx["max_len"],
                          prepack=False, seed=0)
        graphs = 0 if eng.graphs is None else len(eng.graphs.graphs)
        reqs, seen = drive(ctx, eng, prompts, ctx["new_tokens"])
        require(eng.graphs is None or len(eng.graphs.graphs) == graphs,
                f"phase 3k {mode}: a graph was captured after warmup")
        steps, prefills, L = eng.stats.decode_steps, eng.stats.prefill_calls, mcfg.n_layers
        label = f"phase 3k ({mode} {kw})"
        check_launches(ctx, label, seen, {
            "axqmm": 0, "axqmm_gated": 0, "flash_decode": L * steps,
            "flash_decode_quant": 0, "flash_attention": L * prefills,
            "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0})
        checked = _check_emul_tick(ctx, eng, mode)
        res = serve_summary(ctx, label, eng, reqs, seen, wbytes / HBM_BPS * 1e3)
        res.update(spec=kw, weight_bytes=wbytes, checked_calls=checked["n"],
                   max_abs_acc=checked["max_abs_acc"], seconds=time.time() - t0)
        first = [r.out_tokens[:4] for r in reqs[:2]]
        say(f"{label}: {checked['n']} products/snaps bit-identical at one decode tick "
            f"(max |acc| {checked['max_abs_acc']}); first tokens {first}; "
            f"{res['seconds']:.1f} s")
        out["modes"][mode] = res
        if mode == "pr_emul":
            out["int_mm"] = (_int_mm_rows(ctx, cfg.d_model, cfg.vocab)
                             + _int_mm_rows(ctx, cfg.d_model, cfg.d_ff))
        del eng, model, params
        if ctx["on_card"]:
            torch.cuda.empty_cache()
    out["launches"] = sum_launches(m["launches"] for m in out["modes"].values())
    return out


def drive_resil(ctx, eng, prompts, new_tokens, clock=None, dt=0.01):
    """Serve ``prompts`` to the end of every request, whatever its status,
    advancing ``clock`` (a VirtualClock) by ``dt`` a tick; then the final
    scrub.  Checks the accounting (each request done once, the statuses a
    partition, ok requests with all their tokens) and that the parameters
    are byte-equal to the golden copy after the scrub."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build

    ctx["sync"]()
    _build.reset_counts()
    if ctx["on_card"]:
        torch.cuda.reset_peak_memory_stats()
    graphs = None if eng.graphs is None else len(eng.graphs.graphs)
    shapes = dict(eng.workload.trace_counts)
    t0 = time.time()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    ticks, step_ticks = 0, []
    while eng.queue or any(r is not None for r in eng.slot_req):
        require(ticks < 40 * len(prompts) * new_tokens, "a resilience run did not drain")
        before = (eng.stats.admitted, eng.stats.decode_steps)
        t = time.time()
        eng.tick()
        if eng.stats.decode_steps != before[1] and eng.stats.admitted == before[0]:
            step_ticks.append(time.time() - t)
        ticks += 1
        if clock is not None:
            clock.advance(dt)
    ctx["sync"]()
    wall = time.time() - t0
    statuses = [r.status for r in reqs]
    counts = {s: statuses.count(s) for s in sorted(set(statuses))}
    require(all(r.done for r in reqs) and len(eng.done) == len(reqs)
            and len({r.rid for r in eng.done}) == len(reqs),
            f"resilience run: requests not terminated exactly once ({counts})")
    require(set(counts) <= {"ok", "failed", "shed", "deadline"},
            f"resilience run: a status outside the partition: {counts}")
    require(all(len(r.out_tokens) == new_tokens for r in reqs if r.status == "ok"),
            "resilience run: an ok request without all its tokens")
    require(graphs is None or len(eng.graphs.graphs) == graphs,
            "resilience run: a graph was captured after warmup")
    require(eng.workload.trace_counts.get("prefill_batch", 0) == shapes.get("prefill_batch", 0),
            f"resilience run: a request met a new bucket shape: {eng.workload.trace_counts}")
    if eng.guards is not None:
        eng._scrub("final")
        require(eng.params_golden(), "resilience run: the parameters differ from the golden "
                                     "copy after the final scrub")
    events = {}
    for _, name, _ in eng.resil_log:
        events[name] = events.get(name, 0) + 1
    return reqs, {"wall_s": wall, "ticks": ticks, "statuses": counts, "events": events,
                  "log": list(eng.resil_log), "tokens": [list(r.out_tokens) for r in reqs],
                  "status_list": statuses,
                  "step_tick_ms_mean": 1e3 * sum(step_ticks) / max(len(step_ticks), 1),
                  "step_ticks_timed": len(step_ticks), "launches": dict(_build.launches),
                  "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                           if ctx["on_card"] else None),
                  "graphs": graph_summary(eng)}


def _storm_runs(ctx, label, make, prompts, new_tokens, storm, *, eager_twin=True):
    """The storm twice with one seed (identical logs and statuses), its
    eager twin (the same), the guarded clean run against the unguarded
    captured run (the same tokens), and, at a fixed degree, a storm of only
    nan, drop and spike (every request ok, with the clean run's tokens)."""
    from repro_torch.resil import FaultPlan, FaultSpec, GuardConfig, ServePolicy, VirtualClock

    def run(spec, seed=7, capture=None, qos=True, guards=True, policy=None):
        clock = VirtualClock()
        kw = {}
        if spec is not None:
            kw = dict(faults=FaultPlan(FaultSpec.parse(spec), seed=seed), clock=clock,
                      policy=policy or ServePolicy(
                          deadline_ms=ctx["resil_deadline_ms"], max_retries=4,
                          max_queue=ctx["resil_shed"], brownout=True))
        elif guards:
            kw = dict(guards=GuardConfig(), clock=clock)
        eng = make(capture=capture, qos=qos, **kw)
        reqs, seen = drive_resil(ctx, eng, prompts, new_tokens, clock)
        del eng
        return seen

    out = {}
    plain = run(None, guards=False)
    clean = run(None)
    require(clean["tokens"] == plain["tokens"],
            f"{label}: the guarded clean run's tokens differ from the unguarded run's")
    require(clean["log"] == [], f"{label}: the clean guarded run logged {clean['events']}")
    a = run(storm)
    b = run(storm)
    require(a["log"] == b["log"] and a["status_list"] == b["status_list"],
            f"{label}: two storm runs with one seed differ")
    require(a["events"].get("guard_tripped", 0) > 0 and a["events"].get("retry", 0) > 0,
            f"{label}: the storm tripped no guard: {a['events']}")
    out.update(unguarded=plain, guarded_clean=clean, storm=a)
    if eager_twin and ctx["on_card"]:
        e = run(storm, capture=False)
        require(e["log"] == a["log"] and e["status_list"] == a["status_list"],
                f"{label}: the eager twin's recovery trace differs from the captured run's")
        out["storm_eager"] = e
    fixed_clean = run(None, qos=False)
    soft = run(ctx["resil_soft_storm"], qos=False, policy=ServePolicy(max_retries=4))
    require(set(soft["statuses"]) == {"ok"},
            f"{label}: the nan/drop/spike storm ended requests non-ok: {soft['statuses']}")
    require(soft["tokens"] == fixed_clean["tokens"],
            f"{label}: the nan/drop/spike storm changed the tokens of ok requests")
    require(soft["events"].get("retry", 0) > 0,
            f"{label}: the nan/drop/spike storm retried nothing: {soft['events']}")
    out.update(fixed_clean=fixed_clean, soft_storm=soft)
    for key in out:
        out[key] = {k: v for k, v in out[key].items() if k not in ("tokens", "log")} | {
            "log_len": len(out[key]["log"])}
    say(f"{label}: storm {a['statuses']} {a['events']} in {a['ticks']} ticks; guarded clean "
        f"tick {clean['step_tick_ms_mean']:.4f} ms vs unguarded {plain['step_tick_ms_mean']:.4f} "
        f"ms; storm peak memory {a['max_memory_allocated']}; nan/drop/spike storm "
        f"{soft['statuses']} {soft['events']}, tokens equal to the clean run")
    return out


def _ok_read(ctx, eng, n=16) -> dict:
    """Untraced medians of the tick's staging, replay and pinned read (the
    emissions with the ok bits packed in, under guards) on a drained
    engine, every slot free."""
    import numpy as np

    torch = ctx["torch"]
    host = {"feed": eng._feed, "active": np.zeros(eng.slots, bool)}
    if eng.guards is not None:
        host["fault"] = np.zeros(eng.slots, np.float32)
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng._replay_step(host)
        ts.append(time.perf_counter() - t0)
    return {"replay_and_read_ms": 1e3 * float(np.median(ts)),
            "read_bytes": eng._out_pin.numel() * eng._out_pin.element_size()}


def phase_resil(ctx, cfg, model, params, prompts):
    """Phase 3l: the serving resilience layer on tinyllama, captured —
    through ``launch.serve`` with a fault storm, deadlines, retries,
    shedding and brownout; through ``ServeCore`` with a VirtualClock on
    phase 3's engine and on 3b's int8 bucketed engine (:func:`_storm_runs`);
    through the stream engine on 3d's traffic."""
    torch = ctx["torch"]

    from repro_torch.resil import GuardConfig
    from repro_torch.serve.admission import AdmissionConfig

    out = {}
    # launch.serve: its own seeded weights, real clock
    argv = ["--arch", cfg.name, "--approx", "axq8", "--qos", "--slots", str(ctx["slots"]),
            "--requests", str(ctx["requests"]), "--new-tokens", str(ctx["new_tokens"]),
            "--faults", ctx["resil_launch_storm"], "--fault-seed", "7",
            "--deadline-ms", str(ctx["resil_launch_deadline_ms"]), "--retries", "4",
            "--shed", str(ctx["resil_shed"]), "--brownout", "--metrics"]
    if not ctx["on_card"]:
        argv += ["--device", "cpu"]
    s, eng, seen = _launch(ctx, argv)
    statuses = [r.status for r in eng.done]
    require(len(eng.done) == ctx["requests"] == len({r.rid for r in eng.done}),
            f"phase 3l launch.serve: {len(eng.done)} terminations for {ctx['requests']} requests")
    require(set(statuses) <= {"ok", "failed", "shed", "deadline"}, f"phase 3l: {statuses}")
    require(eng.faults is not None and eng.faults.injected, "phase 3l launch.serve: no fault")
    require(not ctx["on_card"] or eng.graphs is not None, "phase 3l launch.serve: not captured")
    eng._scrub("final")
    require(eng.params_golden(), "phase 3l launch.serve: parameters differ from golden "
                                 "after the final scrub")
    events = {}
    for _, name, _ in eng.resil_log:
        events[name] = events.get(name, 0) + 1
    out["launch"] = {"argv": argv, "wall_s": seen["wall_s"], "summary": s, "events": events,
                     "statuses": {k: statuses.count(k) for k in sorted(set(statuses))},
                     "launches": seen["launches"]}
    say(f"phase 3l launch.serve: {out['launch']['statuses']} {events} in "
        f"{seen['wall_s']:.2f} s; {s.get('gen_tok_per_s')} tok/s")
    del eng
    # ServeCore with a VirtualClock: phase 3's engine, then 3b's
    traffic = prompts[:ctx["resil_prompts"]]
    make3 = lambda **kw: make_engine(ctx, model, params, max_len=ctx["max_len"], **kw)
    out["3"] = _storm_runs(ctx, "phase 3l (3: exact admission, bf16)", make3, traffic,
                           ctx["new_tokens"], ctx["resil_storm"])
    if ctx["on_card"]:
        eng = make3(guards=GuardConfig())
        out["3"]["ok_read_guarded"] = _ok_read(ctx, eng)
        del eng
        eng = make3()
        out["3"]["read_unguarded"] = _ok_read(ctx, eng)
        del eng
        say(f"phase 3l: replay + read {out['3']['ok_read_guarded']} guarded, "
            f"{out['3']['read_unguarded']} unguarded")
    adm = AdmissionConfig(buckets=(), pack=4)
    make3b = lambda **kw: make_engine(ctx, model, params, max_len=ctx["max_len"], quant=True,
                                      admission=adm, **kw)
    out["3b"] = _storm_runs(ctx, "phase 3l (3b: int8, buckets, pack 4)", make3b, traffic,
                            ctx["new_tokens"], ctx["resil_storm"], eager_twin=False)
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    out["stream"] = _resil_stream(ctx)
    runs = [out["launch"]] + [r for k in ("3", "3b", "stream") for r in out[k].values()
                              if isinstance(r, dict) and "launches" in r]
    out["launches"] = sum_launches(r["launches"] for r in runs)
    say(f"phase 3l launches over {len(runs)} runs: {out['launches']}")
    return out


def sum_launches(dicts) -> dict:
    """Per-kernel totals of several runs' launch counts."""
    from repro_torch.kernels import _build

    tot = dict.fromkeys(_build.KERNELS, 0)
    for d in dicts:
        for k, n in d.items():
            tot[k] += n
    return tot


def _resil_stream(ctx) -> dict:
    """3d's traffic through the stream engine under a storm of nan,
    seu_state and drop (twice with one seed, and eagerly: identical logs
    and statuses), and under nan and drop alone (every clip ok, frames equal
    to a clean run's)."""
    import numpy as np

    from repro_torch.resil import FaultPlan, FaultSpec, ServePolicy, VirtualClock
    from repro_torch.serve.stream import StreamAdapter, StreamConfig, StreamServeEngine, make_clip

    cfg = StreamConfig()
    clips = [make_clip(ctx["stream_frames"], cfg.frame, q=cfg.q, seed=i)
             for i in range(ctx["stream_clips"])]

    def run(spec, capture=None):
        from repro_torch.kernels import _build

        clock = VirtualClock()
        kw = {} if spec is None else dict(
            faults=FaultPlan(FaultSpec.parse(spec), seed=7), clock=clock,
            policy=ServePolicy(max_retries=6, backoff_ms=0.01))
        eng = StreamServeEngine(StreamAdapter(cfg, device=ctx["dev"]), slots=ctx["stream_slots"],
                                degree=[8, 8, 8], capture=capture, **kw)
        graphs = None if eng.graphs is None else len(eng.graphs.graphs)
        ctx["sync"]()
        _build.reset_counts()
        t0 = time.time()
        reqs = [eng.submit(c) for c in clips]
        ticks = 0
        while eng.queue or any(r is not None for r in eng.slot_req):
            require(ticks < 40 * len(clips) * len(clips[0]), "phase 3l stream: no drain")
            eng.tick()
            ticks += 1
            clock.advance(0.001)
        ctx["sync"]()
        wall = time.time() - t0
        require(len(eng.done) == len(reqs) == len({r.rid for r in eng.done}),
                "phase 3l stream: a clip not terminated exactly once")
        require(graphs is None or len(eng.graphs.graphs) == graphs,
                "phase 3l stream: a graph was captured after warmup")
        if eng.guards is not None:
            eng._scrub("final")
            require(eng.params_golden(), "phase 3l stream: parameters differ from golden")
        st = [r.status for r in reqs]
        events = {}
        for _, name, _ in eng.resil_log:
            events[name] = events.get(name, 0) + 1
        return {"statuses": {k: st.count(k) for k in sorted(set(st))}, "status_list": st,
                "events": events, "log": list(eng.resil_log), "ticks": ticks, "wall_s": wall,
                "launches": dict(_build.launches),
                "frames": [np.stack(r.out) if r.out else None for r in reqs]}

    clean = run(None)
    a = run(ctx["resil_stream_storm"])
    b = run(ctx["resil_stream_storm"])
    require(a["log"] == b["log"] and a["status_list"] == b["status_list"],
            "phase 3l stream: two storm runs with one seed differ")
    require(a["events"].get("guard_tripped", 0) > 0, f"phase 3l stream: no trip {a['events']}")
    out = {"clean": clean, "storm": a}
    if ctx["on_card"]:
        e = run(ctx["resil_stream_storm"], capture=False)
        require(e["log"] == a["log"] and e["status_list"] == a["status_list"],
                "phase 3l stream: the eager twin's recovery trace differs")
        out["storm_eager"] = e
    soft = run("nan=0.05,drop=0.05")
    require(set(soft["statuses"]) == {"ok"}, f"phase 3l stream: {soft['statuses']}")
    require(all(np.array_equal(x, y) for x, y in zip(soft["frames"], clean["frames"])),
            "phase 3l stream: the nan/drop storm changed an ok clip's frames")
    out["soft_storm"] = soft
    for k in out:
        out[k] = {key: v for key, v in out[k].items() if key not in ("log", "frames")}
    say(f"phase 3l stream ({len(clips)} clips on {ctx['stream_slots']} slots): storm "
        f"{a['statuses']} {a['events']} in {a['ticks']} ticks ({a['wall_s']:.2f} s); "
        f"nan/drop storm {soft['statuses']} {soft['events']}, frames equal to the clean run")
    return out


# ---------------------------------------------------------------------------
# phases 3s / 3t: tensor-parallel serving, two ranks on the one card
# ---------------------------------------------------------------------------

#: the tensor-parallel degree of 3s / 3t: two ranks, both on the one card
TP = 2


def phase_kernels_tp(ctx, cfg, moe_cfg):
    """Phase 2's rows at the tp=2 shard shapes that 3s and 3t launch, each
    held to its plain version.  Per rank at decode (M = the slots), for
    tinyllama-1.1b and granite-moe-3b-a800m: wq (N 1024 / 768), wk/wv
    (N 128 / 256), wo (K 1024 / 768) and tinyllama's down (K 2816) as
    row-parallel partials (no residual in the epilogue), the unembedding's
    vocab shard (N 16000 / 24578), tinyllama's gated half (N 2816); decode
    at the kv heads a rank (2 of G 8 / 4 of G 3); tri prefill at the heads
    a rank (16 over 2 kv / 12 over 4 kv).  granite's expert-batched
    launches on its 20 experts a rank, at the decode and prefill
    capacities."""
    torch = ctx["torch"]
    from repro_torch.models.moe import capacity

    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots, T = ctx["slots"], ctx["max_len"]
    nvalid, active = decode_lengths(T, slots)
    rows = {"axqmm": [], "axqmm_gated": [], "axqmm_experts": [], "axqmm_gated_experts": [],
            "flash_decode": [], "flash_attention": []}
    for c, S in ((cfg, ctx["prefill_m"]), (moe_cfg, ctx["moe_prefill_len"])):
        d, D, pd = c.d_model, c.head_dim, c.padded(TP)
        H, KVr = pd.n_heads // TP, pd.n_kv_rep // TP
        shapes = [(H * D, d), (KVr * D, d), (d, H * D)]
        if c.moe is None:
            shapes.append((d, pd.d_ff // TP))
            rows["axqmm_gated"].append(check_gated(ctx, slots, pd.d_ff // TP, d, deg))
        shapes.append((pd.vocab // TP, d))
        for N, K in shapes:
            rows["axqmm"].append(check_axqmm(ctx, slots, N, K, False, deg))
        rows["flash_decode"].append(check_decode(ctx, slots, KVr, H // KVr, D, T, nvalid,
                                                 active))
        rows["flash_attention"].append(check_prefill(ctx, H, S, D, H, KVr))
    E, f, d = moe_cfg.padded(TP).n_experts // TP, moe_cfg.moe.d_expert, moe_cfg.d_model
    for C in (capacity(moe_cfg, slots, TP), capacity(moe_cfg, ctx["moe_prefill_len"], TP)):
        rows["axqmm_gated_experts"].append(check_experts(ctx, E, C, f, d, deg, True))
        rows["axqmm_experts"].append(check_experts(ctx, E, C, d, f, deg, False))
    report_rows(rows, f"tp={TP} shard: ")
    return rows


def phase_kernels_tp_recurrent(ctx, ssm_cfg, rg_cfg):
    """Phase 2's rows at the tp=2 shard shapes that 3u and 3v launch at
    decode (M = the slots), each held to its plain version.  mamba2-370m:
    in_proj's ``[z_r | x_r | B | C | dt_r]`` (N = d_in + 2 N + H / 2 = 2320),
    out_proj's rows (K 1024, an f32 partial: no residual in the epilogue),
    the tied vocab shard (N 25140).  recurrentgemma-2b: the rec block's
    column projections and wq (N 1280, K 2560), wo's rows (K 1280), wk / wv
    (N 128: the kv-split path's half of MQA's one head), down's rows (K
    3840), the gelu gated half (N 3840), the vocab shard (N 128000); decode
    at G 5 over the rank's one repeated kv head at D 256 on the 2048-row
    ring (lengths at the split edges); ``band`` at 5 / 1 heads over a
    prompt past the window."""
    torch = ctx["torch"]
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    slots = ctx["slots"]
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_attention": []}
    s, d = ssm_cfg.ssm, ssm_cfg.d_model
    d_in = s.expand * d
    for N, K in ((d_in + 2 * s.d_state + d_in // s.headdim // TP, d), (d, d_in // TP),
                 (ssm_cfg.padded(TP).vocab // TP, d)):
        rows["axqmm"].append(check_axqmm(ctx, slots, N, K, False, deg))
    d, D, pd = rg_cfg.d_model, rg_cfg.head_dim, rg_cfg.padded(TP)
    H, KVr, F = pd.n_heads // TP, pd.n_kv_rep // TP, pd.d_ff // TP
    for N, K in ((d // TP, d), (d, d // TP), (rg_cfg.n_kv_heads * D // TP, d), (d, F),
                 (pd.vocab // TP, d)):
        rows["axqmm"].append(check_axqmm(ctx, slots, N, K, False, deg))
    rows["axqmm_gated"].append(check_gated(ctx, slots, F, d, deg, act=rg_cfg.act))
    W = rg_cfg.local_window
    T = min(W, ctx["rg_max_len"])
    edge, edge_active = split_edge_lengths(decode_split_width(ctx, D), T, slots)
    rows["flash_decode"].append(check_decode(ctx, slots, KVr, H // KVr, D, T, edge,
                                             edge_active))
    rows["flash_attention"].append(check_band(ctx, 1, H, KVr, D, ctx["rg_band_len"], W))
    report_rows(rows, f"tp={TP} shard (3u / 3v): ")
    return rows


#: the serving data axis's mesh (3w): 2 data coordinates of TP model ranks
DP = (2, TP)


def phase_kernels_dp(ctx, cfg):
    """Phase 2's rows at the shard shapes 3w launches: one data
    coordinate's rows at decode (M = the slots over the data axis, 4 of 8)
    at tp=2 — wq (N 1024), wk/wv (N 128), wo (K 1024) and down (K 2816) as
    row-parallel partials, the vocab shard (N 16000), the gated half (N
    2816) — and decode on the bf16 and int8 caches at B 4, 2 kv heads of G
    8 a rank.  Prefill attention runs at 3s's shapes (one prompt, 16 / 2
    heads a rank)."""
    torch = ctx["torch"]
    deg = torch.tensor(6, dtype=torch.int32, device=ctx["dev"])
    D_, M_ = DP
    B, T = ctx["slots"] // D_, ctx["max_len"]
    nvalid, active = decode_lengths(T, B)
    d, hd, pd = cfg.d_model, cfg.head_dim, cfg.padded(M_)
    H, KVr = pd.n_heads // M_, pd.n_kv_rep // M_
    rows = {"axqmm": [], "axqmm_gated": [], "flash_decode": [], "flash_decode_quant": []}
    for N, K in ((H * hd, d), (KVr * hd, d), (d, H * hd), (d, pd.d_ff // M_),
                 (pd.vocab // M_, d)):
        rows["axqmm"].append(check_axqmm(ctx, B, N, K, False, deg))
    rows["axqmm_gated"].append(check_gated(ctx, B, pd.d_ff // M_, d, deg))
    rows["flash_decode"].append(check_decode(ctx, B, KVr, H // KVr, hd, T, nvalid, active))
    rows["flash_decode_quant"].append(check_decode_quant(ctx, B, KVr, H // KVr, hd, T, nvalid,
                                                         active, 8))
    report_rows(rows, f"{D_}x{M_} shard: ")
    return rows


def _rank_ctx(torch, dev, on_card: bool, slots: int) -> dict:
    """The ``ctx`` keys a rank's helpers read (``drive``, ``check_launches``)."""
    return {"torch": torch, "dev": dev, "on_card": on_card, "slots": slots,
            "sync": torch.cuda.synchronize if on_card else (lambda: None)}


def _tp_policy(job):
    from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec, uniform

    if job["approx"] == "exact":
        return ApproxPolicy()
    return uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=8, block=job["block"], dynamic=True))


def _tp_rank(rank: int, world: int, jobs: list) -> list:
    """One rank of 3s / 3t, in its own process (``spawn_ranks``): the rank's
    mesh over the gloo group on the card (or the CPU in the rehearsal),
    then each job of ``jobs`` in turn, ``kind`` ``serve`` or ``logits``;
    one result a job.  The jobs share the processes' start and warm-up."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import meshctx
    from repro_torch.kernels import _build
    from repro_torch.models import moe as moe_mod

    on_card = jobs[0]["on_card"]
    mesh = meshctx.set_mesh(meshctx.make_mesh((1, world), ("data", "model"),
                                              device="cuda" if on_card else "cpu",
                                              backend="gloo"))
    if on_card:
        torch.cuda.set_device(mesh.device)
        _build.build_all()                   # loads the parent's build (content-keyed)
    out = []
    for job in jobs:
        ctx = _rank_ctx(torch, mesh.device, on_card, job["slots"])
        cfg = get_config(job["arch"])
        if job.get("n_layers"):
            cfg = dataclasses.replace(cfg, n_layers=job["n_layers"])
        if job.get("dtype"):
            cfg = dataclasses.replace(cfg, dtype=job["dtype"])
        # the combine a serving run asks for; a logits run sets its own
        moe_mod._MOE_RING = job["kind"] == "serve" and bool(job.get("moe_ring"))
        t = time.time()
        if job["kind"] == "serve":
            out.append(_tp_serve(ctx, mesh, cfg, job))
        else:
            out.append(_tp_logits(ctx, mesh, cfg, job))
        out[-1]["job_s"] = time.time() - t
        if on_card:
            torch.cuda.empty_cache()
    return out


def _tp_serve(ctx, mesh, cfg, job) -> dict:
    """Serve ``job["prompts"]`` through a ShardedServeEngine (eager), with
    the launch counts and the collective counts set to 0 just before and
    read just after; the ranks' streams compared at the end."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core.dynamic import QoSController
    from repro_torch.dist import collectives
    from repro_torch.models import build_model
    from repro_torch.serve.sharded import ShardedServeEngine

    model = build_model(cfg, _tp_policy(job), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(generator=gen, tp=TP)      # the global tree, equal on every rank
    qos = QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)], low_water=0.25,
                        high_water=0.75, cooldown_steps=8) if job["qos"] else None
    adm = None
    if job.get("buckets"):
        from repro_torch.serve.admission import AdmissionConfig

        adm = AdmissionConfig(buckets=tuple(job["buckets"]), pack=job["pack"])
    eng = ShardedServeEngine(model, params, mesh=mesh, ring=job["ring"], slots=job["slots"],
                             max_len=job["max_len"], qos=qos, seed=0, admission=adm)
    del params                                     # each rank keeps its shards, packed
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    prompts, new_tokens = job["prompts"], job["new_tokens"]
    eng.submit(prompts[0][:16], 2)                 # library loads, allocator
    eng.run_until_drained()
    st = eng.stats
    steps0, prefills0 = st.decode_steps, st.prefill_calls
    # the model's prefill calls by kind (an admission call may make an
    # exact-length prefill and a bucketed one)
    forwards = {"prefill": 0, "prefill_batch": 0}
    for name in forwards:
        def counted(*a, _f=getattr(model, name), _n=name, **kw):
            forwards[_n] += 1
            return _f(*a, **kw)
        setattr(model, name, counted)
    collectives.counter.reset()
    reqs, seen = drive(ctx, eng, prompts, new_tokens)
    coll = collectives.counter.snapshot()
    fwd = dict(forwards)
    eng.check_streams()
    state = None
    if job.get("state_check"):
        # one bucketed, packed call against exact-length prefills, after
        # the counts are read
        state = _bucketed_state_equal(ctx, model, eng.params, job["state_check"],
                                      job["buckets"], job["max_len"])
    dry = _tick_dryrun(ctx, mesh, cfg, model, eng, job) if job.get("dryrun") else None
    from repro_torch.serve.metrics import summarize

    s = summarize(reqs, eng.stats, wall_s=seen["wall_s"])
    dts = seen["decode_ticks"]
    return {"rank": mesh.coord("model"), "transport": mesh.transport, "ring": eng.ring,
            "streams": [list(r.out_tokens) for r in reqs],
            "statuses": sorted({r.status for r in reqs}),
            "steps": st.decode_steps - steps0,
            "prefills": st.prefill_calls - prefills0, "exact": fwd["prefill"],
            "bucketed": fwd["prefill_batch"],
            "state_equal": state, "flash_schedules": seen["flash_schedules"],
            "ticks": seen["ticks"], "wall_s": seen["wall_s"],
            "decode_tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
            "decode_ticks_timed": len(dts), "gen_tok_per_s": s["generated_tokens"] /
            seen["wall_s"], "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p95_ms": s["ttft_p95_ms"],
            "tpot_p50_ms": s["tpot_p50_ms"],
            "rungs": sorted({e for _, e in eng.stats.degree_history}),
            "launches": seen["launches"], "plain": seen["plain"],
            "max_memory_allocated": seen["max_memory_allocated"],
            "packed_weight_bytes": packed_bytes(eng.params),
            "collectives": coll, "dryrun": dry}


def _tick_dryrun(ctx, mesh, cfg, model, eng, job) -> dict:
    """One decode tick of ``slots`` rows (the step, then the logits' vocab
    columns gathered as the engine gathers them) on the engine's shards:
    its collectives by ``collectives.counter`` on the card (after the
    serving run's counts are read), and the same tick's by the dry run on
    this rank's meta mesh (``dist/hlo_analysis.py``)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.dist import collectives, meshctx
    from repro_torch.dist.hlo_analysis import analyze_step
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    from repro_torch.models.layers import gather_vocab
    from repro_torch.train import step as S

    def tick(m, params, cache, tokens):
        logits, cache = S.serve_step(m, params, cache, tokens, tp=TP)
        return gather_vocab(logits), cache

    B = ctx["slots"]
    with kops.ring_tp(eng.ring):
        cache = model.init_cache(TP, B, job["max_len"])
        tokens = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        collectives.counter.reset()
        tick(model, eng.params, cache, tokens)
        snap = collectives.counter.snapshot()
        del cache
        with meshctx.use_mesh(meshctx.make_meta_mesh(mesh.shape, mesh.axis_names,
                                                     rank=mesh.rank)):
            mm = build_model(cfg, model.policy, device="meta")
            rep = analyze_step(tick, mm, _meta_like(eng.params),
                               mm.init_cache(TP, B, job["max_len"]), _meta_like(tokens))
    return {"what": f"one decode tick of {B} slots", "live": {"bytes": snap["bytes"],
                                                               "calls": snap["calls"]},
            "meta": _dryrun_counts(rep), "trace_s": rep.trace_s}


def _bucketed_state_equal(ctx, model, params, prompts, buckets, max_len) -> dict:
    """{field: bool}: this rank's cache after one bucketed, packed prefill
    of ``prompts`` (rows padded to the least bucket that holds them)
    against the same prompts prefilled one by one at their exact lengths,
    bit for bit (the model's cache dtype)."""
    torch, dev = ctx["torch"], ctx["dev"]
    B = len(prompts)
    Pb = min(b for b in buckets if b >= max(len(p) for p in prompts))
    rows = torch.zeros((B, Pb), dtype=torch.int64, device=dev)
    for i, p in enumerate(prompts):
        rows[i, :len(p)] = torch.as_tensor(p, device=dev)
    exact = model.init_cache(TP, B, max_len)
    packed = model.init_cache(TP, B, max_len)
    for i, p in enumerate(prompts):
        model.prefill(params, exact, torch.as_tensor(p, device=dev), i, tp=TP)
    model.prefill_batch(params, packed, rows, list(range(B)), [len(p) for p in prompts],
                        tp=TP)
    return {k: bool(torch.equal(a, b)) for k, a, b in zip(exact._fields, exact, packed)}


def _tp_logits(ctx, mesh, cfg, job) -> dict:
    """The first decode step's whole-row logits of the cut model at tp=2
    after prefilling ``job["prompt"]`` into slot 1 of 2 (a cache in the
    model's dtype), and
    the collective bytes of that decode step (the reference's probe: the
    model's own collectives, not the sampling gather); with ``ring`` the
    same under the int8 ring.  Rank 0 adds tp=1 on the same tp-padded
    weights (kernels), and the model's noise floor: the plain tp=1 logits
    against the plain ones with the projections' f32 outputs perturbed by
    NOISE_EPS (phase 4's measure)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.dist import collectives, meshctx, sharding
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    from repro_torch.models.layers import gather_vocab

    model = build_model(cfg, _tp_policy(job), device=dev)
    params = model.init(seed=1, tp=TP)
    prompt = torch.as_tensor(job["prompt"], device=dev)
    deg = torch.tensor(8, dtype=torch.int32, device=dev)

    def step(p, tp, ring=False, backend=None):
        with kops.ring_tp(ring), (_backend(backend) if backend else contextlib.nullcontext()):
            cache = model.init_cache(tp, 2, prompt.shape[0] + 8, quant=False,
                                     dtype=torch.float32 if cfg.dtype == "float32"
                                     else torch.bfloat16)
            model.prefill(p, cache, prompt, 1, tp=tp, degree=deg)
            toks = torch.zeros((2, 1), dtype=torch.int64, device=dev)
            toks[1, 0] = int(prompt[-1])
            collectives.counter.reset()
            lg, _ = model.decode_step(p, cache, toks, tp=tp, degree=deg,
                                      active=torch.tensor([False, True], device=dev))
            nbytes = collectives.counter.snapshot()
            return gather_vocab(lg)[1, 0].float(), nbytes

    local = model.prepack(sharding.shard_params(params, mesh=mesh))
    out = {}
    lg, out["bytes"] = step(local, TP)
    out["logits"] = lg.cpu()
    if job.get("ring") or job.get("moe_ring"):
        from repro_torch.models import moe as moe_mod

        prev = moe_mod._MOE_RING
        moe_mod._MOE_RING = bool(job.get("moe_ring"))
        lr, out["ring_bytes"] = step(local, TP, ring=bool(job.get("ring")))
        moe_mod._MOE_RING = prev
        out["ring_logits"] = lr.cpu()
    if mesh.coord("model") == 0 and job.get("single", True):
        with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
            full = model.prepack(params)
            lk = step(full, TP)[0]
            out["single_logits"] = lk.cpu()
            if job["approx"] != "exact":
                lp = step(full, TP, backend="torch")[0]
                with _perturbed_projections(ctx, NOISE_EPS):
                    ln = step(full, TP, backend="torch")[0]
                out["noise_floor"] = float((ln - lp).abs().max())
                out["single_kernel_vs_plain"] = float((lk - lp).abs().max())
    return out


def _tp_jobs(ctx, tag, jobs, timeout_s) -> list:
    """Run ``jobs`` in turn on one spawn of TP ranks (gloo on the one
    card); [every rank's result] a job."""
    from repro_torch.dist import meshctx

    jobs = [dict(job, on_card=ctx["on_card"], slots=ctx["slots"]) for job in jobs]
    t0 = time.time()
    out = meshctx.spawn_ranks(_tp_rank, TP, timeout_s=timeout_s, backend="gloo",
                              device="cuda" if ctx["on_card"] else "cpu", args=(jobs,),
                              threads=0 if ctx["on_card"] else 1)
    names = ", ".join(f"{job.get('tag', tag)} {job['kind']}{', ring' if job.get('ring') else ''}"
                      f"{', ring combine' if job.get('moe_ring') else ''} "
                      f"({job['arch']}, {out[0][i]['job_s']:.1f} s)"
                      for i, job in enumerate(jobs))
    say(f"phase {tag}: {TP} ranks ran {names} in {time.time() - t0:.1f} s")
    return [[rank[i] for rank in out] for i in range(len(jobs))]


def tp_prompts(ctx, cfg) -> list:
    """Phase 3's prompts (its seed and lengths), for ``--tp-only``."""
    import numpy as np

    rng = np.random.default_rng(0)
    lo, hi = ctx["prompt_range"]
    rng.integers(0, cfg.vocab, lo)                 # phase 3's warm-up prompt
    return [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(ctx["requests"])]


def tp_launches(path) -> dict:
    """A 3s / 3t record's kernel launches, summed over its runs and ranks."""
    total: dict = {}
    runs = [path] if "ranks" in path else [v for v in path.values()
                                            if isinstance(v, dict) and "ranks" in v]
    for run in runs:
        for r in run["ranks"]:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    return {"launches": total}


def _tp_serve_gates(ctx, label, cfg, ranks, expect, per_tick) -> dict:
    """3s / 3t gates on the ranks' results: every request ok with equal
    streams on every rank, each rank's launches as predicted with no plain
    version on the card, and the collectives a call as predicted
    (``per_tick``: {kind: calls a decode step and a prefill}); prints a
    line a rank and one for the collectives."""
    r0 = ranks[0]
    require(all(r["statuses"] == ["ok"] for r in ranks), f"{label}: a request not ok")
    require(all(r["streams"] == r0["streams"] for r in ranks),
            f"{label}: the ranks' token streams differ")
    for r in ranks:
        check_launches(ctx, f"{label} rank {r['rank']}", r, expect(r))
        say(f"{label} rank {r['rank']}: {r['ticks']} ticks, decode tick "
            f"{r['decode_tick_ms_mean']:.3f} ms over {r['decode_ticks_timed']} ticks, "
            f"{r['gen_tok_per_s']:.1f} tok/s, TTFT p50 {r['ttft_p50_ms']} ms p95 "
            f"{r['ttft_p95_ms']} ms, peak memory {r['max_memory_allocated']}, rungs "
            f"{r['rungs']}, launches {r['launches']}")
        calls, nbytes = r["collectives"]["calls"], r["collectives"]["bytes"]
        want = {k: v(r["steps"], r["prefills"]) for k, v in per_tick.items()}
        require({k: calls.get(k, 0) for k in want} == want and set(calls) <= set(want),
                f"{label} rank {r['rank']}: collectives {calls}, expected {want} ({r['steps']} "
                f"decode steps, {r['prefills']} prefill calls)")
    n = max(r0["steps"], 1)
    coll = r0["collectives"]
    per = {"host_ms_per_tick": coll["host_ms"] / n, "wait_ms_per_tick": coll["wait_ms"] / n,
           "bytes_per_tick": {k: v / n for k, v in coll["bytes"].items()},
           "calls_per_tick": {k: v / n for k, v in coll["calls"].items()}}
    say(f"{label} collectives per decode step (prefills included, over {n} steps): host "
        f"{per['host_ms_per_tick']:.3f} ms in the collectives after "
        f"{per['wait_ms_per_tick']:.3f} ms waiting for the queued kernels, bytes {per['bytes_per_tick']}, calls "
        f"{per['calls_per_tick']}; transport {r0['transport']}")
    return {"ranks": [{k: v for k, v in r.items() if k not in ("streams", "dryrun")}
                      for r in ranks],
            "collectives_per_tick": per, "transport": r0["transport"]}


def _tp_logit_gates(ctx, label, ranks, ring_kind, combine_only=False) -> dict:
    """The cut model's gates: the ranks' whole rows equal; tp=2 against tp=1
    within 4x the noise floor (AXQ) or 1e-4 of the largest logit (EXACT,
    f32); the ring's rows within rel 0.05 of the exact ones, moving at most
    half the bytes of the reductions it replaces: the decode step's, or
    with ``combine_only`` (the MoE combine under AXQ, where wo keeps its
    exact all-reduce) the combine's."""
    r0 = ranks[0]
    require(all(bool((r["logits"] == r0["logits"]).all()) for r in ranks),
            f"{label}: the ranks' gathered logits differ")
    diff = float((r0["logits"] - r0["single_logits"]).abs().max())
    out = {"tp2_vs_tp1_max_abs_diff": diff, "bytes": r0["bytes"]}
    if "noise_floor" in r0:
        tol = 4 * max(r0["noise_floor"], 1e-3)
        out.update(noise_floor=r0["noise_floor"], tolerance=tol,
                   tp1_kernel_vs_plain=r0["single_kernel_vs_plain"])
    else:
        tol = 1e-4 * max(float(r0["single_logits"].abs().max()), 1.0)
        out["tolerance"] = tol
    say(f"{label}: first decode step's logits tp={TP} vs tp=1 on the same weights max |diff| "
        f"{diff:.4g} (tolerance {tol:.4g}{', 4x the noise floor' if 'noise_floor' in r0 else ''})"
        f"; decode step collective bytes {r0['bytes']['bytes']}")
    require(diff <= tol, f"{label}: tp={TP} logits differ from tp=1 by {diff} (tol {tol})")
    if "ring_logits" in r0:
        ex, rg = r0["logits"], r0["ring_logits"]
        rel = float((rg - ex).abs().mean() / (ex.abs().mean() + 1e-9))
        eb, rb = r0["bytes"]["total"], r0["ring_bytes"]["total"]
        if combine_only:
            # the combine's all-reduce bytes, against the ring's hops
            eb = r0["bytes"]["bytes"]["all-reduce"] - r0["ring_bytes"]["bytes"]["all-reduce"]
            rb = r0["ring_bytes"]["bytes"]["collective-permute"]
        out.update(ring_rel=rel, ring_bytes=r0["ring_bytes"], ring_over_exact_bytes=rb / eb)
        say(f"{label}: {ring_kind} logits rel {rel:.4g} of the exact ones (envelope 0.05); "
            f"decode step bytes {rb} vs {eb} exact ({rb / eb:.3f}x): {r0['ring_bytes']['bytes']}")
        require(0 < rel < 0.05, f"{label}: {ring_kind} logits outside the envelope: {rel}")
        require(rb <= 0.5 * eb, f"{label}: {ring_kind} moves {rb} bytes, more than half of "
                                f"the exact {eb}")
    return out


def phase_tp_dense(ctx, cfg, prompts, extra_jobs=()) -> tuple:
    """Phase 3s: tinyllama-1.1b at full width and depth, tp=2 as two ranks
    on the one card through an explicit gloo group (host-staged
    collectives), axq8 with the ladder 8 -> 5, packs built per shard, the
    bf16 cache, phase 3's traffic, eager.  Then the model cut to 2 layers:
    the first decode step's logits at tp=2 against tp=1 on the same
    tp-padded weights (4x the noise floor), and under EXACT with the int8
    ring (rel 0.05 of exact tp=2, at most half the bytes).  Then
    ``launch.serve --tp 2 --dist-backend gloo`` for the wall numbers.
    ``extra_jobs`` (3u / 3v's) run in the same spawn of ranks after 3s's;
    returns (3s's result, their results)."""
    label = "phase 3s"
    # the served model's depth (cut on the card: the time limit); the
    # launcher below serves the whole model
    L = depth_cut(ctx, "3s", cfg).n_layers
    serve = {"kind": "serve", "tag": "3s", "arch": cfg.name, "n_layers": L, "approx": "axq8",
             "block": ctx["tp_block"], "ring": False, "qos": True, "max_len": ctx["max_len"], "prompts": prompts,
             "new_tokens": ctx["new_tokens"], "dryrun": True}
    cut = {"kind": "logits", "tag": "3s", "arch": cfg.name, "n_layers": 2, "prompt": prompts[0],
           "block": ctx["tp_block"]}
    # one spawn of the two ranks: the serving run, then the two cuts
    ranks, cut_axq8, cut_ring, *extra = _tp_jobs(
        ctx, "3s / 3u / 3v" if extra_jobs else "3s",
        [serve, dict(cut, approx="axq8"),
         dict(cut, approx="exact", ring=True, dtype="float32")] + list(extra_jobs),
        ctx["tp_timeout_s"])
    expect = lambda r: {
        "axqmm": (5 * L + 1) * (r["steps"] + r["prefills"]),
        "axqmm_gated": L * (r["steps"] + r["prefills"]), "flash_decode": L * r["steps"],
        "flash_decode_quant": 0, "flash_attention": L * r["prefills"], "pr_multiply": 0,
        "pr_fir": 0, "pr_conv2d": 0}
    # a decode step: the embedding's all-reduce, wo's and down's a layer,
    # the logits' all-gather; a prefill: the same but the gather
    per_tick = {"all-reduce": lambda st, pf: (2 * L + 1) * (st + pf),
                "all-gather": lambda st, pf: st}
    out = _tp_serve_gates(ctx, label, cfg, ranks, expect, per_tick)
    out["dryrun"] = _dryrun_gate(label, ranks)
    # the rehearsal's few ticks stay inside the controller's cooldown
    require(len(ranks[0]["rungs"]) > 1 or not ctx["on_card"],
            f"{label}: the QoS degree never moved: {ranks[0]['rungs']}")
    out["model_2layer_axq8"] = _tp_logit_gates(ctx, f"{label} 2-layer axq8", cut_axq8, "")
    out["model_2layer_exact_ring"] = _tp_logit_gates(ctx, f"{label} 2-layer EXACT f32",
                                                     cut_ring, "int8 ring")
    argv = ["--arch", cfg.name, "--tp", str(TP), "--dist-backend", "gloo", "--approx",
            ctx["tp_launch_approx"], "--qos", "--metrics", "--slots", str(ctx["slots"]),
            "--requests", str(ctx["requests"]), "--new-tokens", str(ctx["new_tokens"])]
    if not ctx["on_card"]:
        argv += ["--device", "cpu"]
    s, _, seen = _launch(ctx, argv)
    require(s["statuses"] == {"ok": ctx["requests"]} and s["streams_equal"],
            f"{label}: launch.serve --tp {TP}: {s['statuses']}")
    out["launcher"] = {k: s.get(k) for k in (
        "requests", "generated_tokens", "gen_tok_per_s", "ttft_p50_ms", "ttft_p95_ms",
        "tpot_p50_ms", "transport", "collective_bytes_per_tick", "collective_calls_per_tick",
        "collective_host_ms_per_tick", "collective_wait_ms_per_tick")}
    out["launcher"]["wall_s"] = seen["wall_s"]
    say(f"{label} launch.serve --tp {TP} --dist-backend gloo: {out['launcher']}")
    return out, extra


def tp_recurrent_jobs(ctx, ssm_cfg, rg_cfg, prompts) -> list:
    """3u's and 3v's jobs for 3s's spawn: each family's serving run at full
    width (depth ``depth_cuts``), axq8 with the ladder 8 -> 5, bucketed
    and packed admission (``rec_buckets``, pack 4), phase 3's prompts and
    one past the ladder (on the hybrid past its window: ``band`` and the
    ring), the bucketed state checked on each rank after it; then the cut
    model (2 layers; the hybrid one group) under axq8 and under EXACT in
    f32."""
    import numpy as np

    rng = np.random.default_rng(26)
    lo, hi = ctx["rec_long_range"]
    out = []
    for tag, c, n_cut in (("3u", ssm_cfg, 2), ("3v", rg_cfg, len(rg_cfg.block_pattern))):
        long = rng.integers(0, c.vocab, int(rng.integers(lo, hi + 1)))
        ps = list(prompts) + [long]
        serve = {"kind": "serve", "tag": tag, "arch": c.name,
                 "n_layers": depth_cut(ctx, tag, c).n_layers, "approx": "axq8",
                 "block": ctx["tp_block"], "ring": False, "qos": True,
                 "max_len": ctx["ssm_max_len" if tag == "3u" else "rg_max_len"],
                 "prompts": ps, "new_tokens": ctx["tp_moe_new_tokens"],
                 "buckets": ctx["rec_buckets"], "pack": 4,
                 "state_check": [list(map(int, p)) for p in prompts[:4]]}
        cut = {"kind": "logits", "tag": tag, "arch": c.name, "n_layers": n_cut,
               "prompt": prompts[0], "block": ctx["tp_block"]}
        out += [serve, dict(cut, approx="axq8"), dict(cut, approx="exact", dtype="float32")]
    return out


def phase_tp_recurrent(ctx, ssm_cfg, rg_cfg, results) -> dict:
    """Phases 3u (mamba2-370m) and 3v (recurrentgemma-2b) at tp=2 on 3s's
    spawn of ranks (``tp_recurrent_jobs``): every request ok with equal
    streams on every rank; each rank's launches as the family's serving
    predicts (``recurrent_launches``: the same GEMMs on the rank's shards,
    the hybrid's flash_decode and flash_attention on its 5 / 1 heads), the
    hybrid's prefills by schedule (``tri`` a bucketed call, ``band`` the
    long prompt's); the collectives a call: the embedding's all-reduce and
    two a layer (a Mamba-2 layer's gnorm sum of squares and out_proj's
    partials; a hybrid block's wo and down) on a decode step and on a
    prefill, the hybrid's k and v gathered on each attention block (the
    kv-split path), the logits gathered on a decode step; each rank's
    bucketed state equal to the exact-length one bit for bit; the cut
    models' tp=2 logits against tp=1 (4x the noise floor under axq8, 1e-4
    of the largest logit under EXACT f32)."""
    out = {}
    for (serve, cut_axq8, cut_exact), c in zip((results[:3], results[3:6]), (ssm_cfg, rg_cfg)):
        tag = "3u" if c.family == "ssm" else "3v"
        label = f"phase {tag}"
        cfg = depth_cut(ctx, tag, c)
        L = cfg.n_layers
        n_attn = (L // len(cfg.block_pattern) * cfg.block_pattern.count("attn")
                  if cfg.family == "hybrid" else 0)
        for r in serve:
            # the gates' per-call count: the model's forwards, exact and bucketed
            r["prefills"] = r["exact"] + r["bucketed"]
        expect = lambda r, cfg=cfg: dict(
            {"axqmm_gated": 0, "flash_decode": 0, "flash_decode_quant": 0, "flash_attention": 0,
             "pr_multiply": 0, "pr_fir": 0, "pr_conv2d": 0},
            **recurrent_launches(cfg, r["steps"], r["exact"], r["bucketed"]))
        per_tick = {"all-reduce": lambda st, pf, L=L: (2 * L + 1) * (st + pf),
                    "all-gather": lambda st, pf, n=n_attn: st + 2 * n * (st + pf)}
        res = _tp_serve_gates(ctx, f"{label} ({c.name}, {L} layers)", cfg, serve, expect,
                              per_tick)
        for r in serve:
            require(r["bucketed"] > 0 and r["exact"] > 0,
                    f"{label} rank {r['rank']}: {r['bucketed']} bucketed and {r['exact']} "
                    "exact-length prefills: both paths should run")
            require(all(r["state_equal"].values()),
                    f"{label} rank {r['rank']}: bucketed state differs from exact-length "
                    f"{r['state_equal']}")
            if ctx["on_card"] and n_attn:
                want = {"dense": 0, "tri": n_attn * r["bucketed"], "band": n_attn * r["exact"]}
                require(r["flash_schedules"] == want,
                        f"{label}: flash_attention by schedule {r['flash_schedules']}, "
                        f"expected {want}")
        say(f"{label}: each rank's bucketed state equal to exact-length bit for bit "
            f"({serve[0]['state_equal']}); {serve[0]['bucketed']} bucketed calls and "
            f"{serve[0]['exact']} exact-length prefills")
        res["model_cut_axq8"] = _tp_logit_gates(ctx, f"{label} cut axq8", cut_axq8, "")
        res["model_cut_exact"] = _tp_logit_gates(ctx, f"{label} cut EXACT f32", cut_exact, "")
        out[tag] = res
    return out


def phase_tp_moe(ctx, cfg, prompts) -> dict:
    """Phase 3t: granite-moe-3b-a800m at full width (on the card cut to
    ``depth_cuts["3t"]`` of its 32 layers: the script's time limit), tp=2, 20 of
    its 40 experts a rank (the expert-batched launches on the local
    experts), axq8 with the ladder 8 -> 5, eager, on phase 3's prompts:
    the exact combine (an f32 all-reduce a layer) and the int8-ring
    combine (``REPRO_RING_TP``).  Then the model cut to 2 layers, EXACT in
    f32: tp=2 against tp=1 within 1e-4 of the largest logit, the ring
    combine's logits within rel 0.05 of the exact combine's with at most
    half the bytes."""
    label = "phase 3t"
    L = cfg.n_layers
    out = {}
    serve = {"kind": "serve", "arch": cfg.name, "approx": "axq8", "block": ctx["tp_block"],
             "ring": False, "qos": True, "max_len": ctx["max_len"], "prompts": prompts,
             "new_tokens": ctx["tp_moe_new_tokens"], "n_layers": L}
    # EXACT in f32, as 3s's ring cut: the router then sees inputs a few
    # f32 roundings apart at tp=1 and tp=2, so no routing flip inflates
    # the bar, which is 1e-4 of the largest logit
    cut = {"kind": "logits", "arch": cfg.name, "n_layers": 2, "prompt": prompts[0],
           "block": ctx["tp_block"], "approx": "exact", "dtype": "float32", "moe_ring": True}
    # one spawn of the two ranks: the exact combine, the ring combine, the cut
    *served, cut_ranks = _tp_jobs(ctx, "3t", [dict(serve, moe_ring=False),
                                               dict(serve, moe_ring=True), cut],
                                  ctx["tp_timeout_s"])
    for ring, ranks in zip((False, True), served):
        expect = lambda r: moe_launches(cfg, r["steps"], r["prefills"], False)
        if ring:
            # wo's all-reduce and the embedding's; the combine as 2 (n-1) hops a layer
            per_tick = {"all-reduce": lambda st, pf: (L + 1) * (st + pf),
                        "collective-permute": lambda st, pf: 2 * (TP - 1) * L * (st + pf),
                        "all-gather": lambda st, pf: st}
        else:
            per_tick = {"all-reduce": lambda st, pf: (2 * L + 1) * (st + pf),
                        "all-gather": lambda st, pf: st}
        key = "ring_combine" if ring else "exact_combine"
        out[key] = _tp_serve_gates(ctx, f"{label} ({key.replace('_', ' ')})", cfg, ranks,
                                   expect, per_tick)
    out["model_2layer_exact"] = _tp_logit_gates(ctx, f"{label} 2-layer EXACT f32", cut_ranks,
                                                "int8-ring combine", combine_only=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel-vs-plain on the whole model
# ---------------------------------------------------------------------------


#: phase 4 runs: (dtype, runtime degree, int8 KV cache)
MODEL_RUNS = (("float32", [8, 6, 7], False), ("bfloat16", 8, False),
              ("float32", [8, 6, 7], True), ("bfloat16", 8, True))

#: relative perturbation of the plain run's projection outputs that measures
#: the model's own noise floor (phase 4)
NOISE_EPS = 1e-6


def _call_tols(dtype):
    """(rtol, atol) of each kernel against its plain version on the model's
    own inputs: the GEMMs at the qmm oracle tolerance (observed
    bit-identical); attention to f32 summation order, or one bf16 ulp at
    |o| < 4 for bf16 outputs; the int8-cache decode at 1e-5 abs, the
    reference's kernel-vs-jnp tolerance."""
    attn = (1e-4, 1e-4) if dtype == "float32" else (0.0, 1 / 64)
    return {"axqmm": (1e-5, 1e-4), "axqmm_gated": (1e-5, 1e-4),
            "axqmm_experts": (1e-5, 1e-4), "axqmm_gated_experts": (1e-5, 1e-4),
            "flash_decode": (1e-4, 1e-4), "flash_decode_quant": (0.0, 1e-5),
            "flash_attention": attn}


@contextlib.contextmanager
def _patched(pairs):
    """Temporarily replace module attributes: pairs of (module, name, fn)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, fn in pairs:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _checked_kernels(ctx, dtype, report):
    """Each kernel wrapper, wrapped to also run its plain version on the
    same inputs and record the worst difference and any call outside the
    tolerance into ``report`` {name: [calls, max_err, bad_calls]}."""
    torch = ctx["torch"]
    from repro_torch.kernels import axqmm as A
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD

    tols = _call_tols(dtype)

    def checked(name, kernel, plain):
        def call(*a, **kw):
            y = kernel(*a, **kw)
            yp = plain(*a, **kw)
            rtol, atol = tols[name]
            key = f"{name} (bias)" if kw.get("bias") is not None else name
            row = report.setdefault(key, [0, 0.0, 0])
            row[0] += 1
            row[1] = max(row[1], float((y.float() - yp.float()).abs().max()))
            row[2] += not bool(torch.allclose(y.float(), yp.float(), rtol=rtol, atol=atol))
            return y
        return call

    return _patched([
        (A, "axqmm_packed", checked("axqmm", A.axqmm_packed, A.axqmm_packed_plain)),
        (A, "axqmm_gated_packed", checked("axqmm_gated", A.axqmm_gated_packed,
                                          A.axqmm_gated_plain)),
        (A, "axqmm_experts_packed", checked("axqmm_experts", A.axqmm_experts_packed,
                                            A.axqmm_experts_plain)),
        (A, "axqmm_gated_experts_packed", checked("axqmm_gated_experts",
                                                  A.axqmm_gated_experts_packed,
                                                  A.axqmm_gated_experts_plain)),
        (FD, "flash_decode", checked("flash_decode", FD.flash_decode,
                                     FD.flash_decode_plain)),
        (FD, "flash_decode_quant", checked("flash_decode_quant", FD.flash_decode_quant,
                                           FD.flash_decode_quant_plain)),
        (FA, "flash_attention_grouped",
         checked("flash_attention", FA.flash_attention_grouped,
                 FA.flash_attention_grouped_plain)),
    ])


def _perturbed_projections(ctx, eps):
    """The plain AXQ projections with their f32 outputs perturbed by
    ``eps`` relative (seeded noise) before the cast to the working dtype,
    so the perturbation survives a bf16 rounding where it crosses one."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.kernels import axqmm as A

    gen = torch.Generator(device=dev).manual_seed(7)

    def perturbed(plain):
        def call(*a, **kw):
            y = plain(*a, **kw)
            return y * (1 + eps * torch.randn(y.shape, generator=gen, device=dev))
        return call

    return _patched([(A, name, perturbed(getattr(A, name)))
                     for name in ("axqmm_packed_plain", "axqmm_experts_plain")])


@contextlib.contextmanager
def _backend(name):
    from repro_torch.kernels import dispatch

    dispatch.set_backend(name)
    try:
        yield
    finally:
        dispatch.set_backend(None)


def _model_logits(ctx, model, params, prompt, deg, backend, feed, quant):
    """One prefill and 4 decode steps of slot 1 (slot 0 free); returns the
    5 logit rows and the greedy tokens fed."""
    torch, dev = ctx["torch"], ctx["dev"]
    with _backend(backend):
        B, slot = 2, 1
        cache = model.init_cache(1, B, prompt.shape[0] + 8, quant=quant)
        lg, cache = model.prefill(params, cache, prompt, slot, degree=deg)
        logits = [lg[0]]
        toks = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        active = torch.tensor([False, True], device=dev)
        fed = []
        for t in range(4):
            fed.append(int(logits[-1].argmax()) if feed is None else feed[t])
            toks[slot, 0] = fed[-1]
            lg, cache = model.decode_step(params, cache, toks, degree=deg,
                                          active=active)
            logits.append(lg[slot, 0])
        return torch.stack(logits).float(), fed


def _padded_vs_exact(ctx, model, params, deg, backend, quant, vocab):
    """Prompts of ``ctx["padded_lens"]`` prefilled one by one at their exact
    lengths, and packed into one bucketed call padded to the next power of
    two: the largest difference of each cache field, and of the logits of
    one decode step from each cache."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    lens = ctx["padded_lens"]
    Pb = 1 << (max(lens) - 1).bit_length()
    rng = np.random.default_rng(2)
    rows = [torch.as_tensor(rng.integers(0, vocab, n), device=dev) for n in lens]
    toks = torch.zeros((len(lens), Pb), dtype=torch.int64, device=dev)
    for i, r in enumerate(rows):
        toks[i, :r.numel()] = r
    nxt = torch.as_tensor(rng.integers(0, vocab, (len(lens), 1)), device=dev)
    with _backend(backend):
        exact = model.init_cache(1, len(lens), Pb, quant=quant)
        for i, r in enumerate(rows):
            model.prefill(params, exact, r, i, degree=deg)
        padded = model.prefill_batch(params, model.init_cache(1, len(lens), Pb, quant=quant),
                                     toks, list(range(len(lens))), list(lens), degree=deg)
        fields = {f: float((getattr(exact, f).float() - getattr(padded, f).float())
                           .abs().max()) for f in exact._fields}
        le, _ = model.decode_step(params, exact, nxt, degree=deg)
        lp, _ = model.decode_step(params, padded, nxt, degree=deg)
    ctx["sync"]()
    return {"lens": list(lens), "bucket": Pb, "cache_max_abs_diff": fields,
            "bit_identical": all(v == 0 for v in fields.values()),
            "logits_max_abs_diff": float((le - lp).abs().max())}


def phase_model(ctx, cfg, prompt_len, n_layers=2):
    """Phase 4: kernel vs plain on the model cut to ``n_layers`` layers
    (2; the hybrid 4: one group and one tail block), on the bf16 and on the
    int8 cache (the recurrent families on their one cache), prefilling one
    ``prompt_len``-token prompt (for a window arch, past the window: the
    ``band`` schedule and a ring prefill, whose decode steps then wrap).

    (a) Every kernel call of a kernel run is checked against its plain
    version on the same (the model's own) inputs, at the stated tolerance.
    (b) The logits of the kernel run and of a plain run are compared.  AXQ
    makes the model chaotic in its inputs: a difference in the last f32 bit
    can move an int8 activation code, whose step then moves every later
    code.  So (b) is held to the model's own noise floor, measured in this
    run as the change of the plain logits when the plain projections' f32
    outputs are perturbed by NOISE_EPS relative: the kernel run may differ
    from the plain run by at most 4x that floor.
    (c) Bucketed prefill against exact-length prefill through the kernels:
    the attention tile width follows the padded length, so the online
    softmax may sum in another order; the difference is reported, and the
    next decode step's logits are held to the same 4x floor.  The
    recurrent families' states must be bit-identical (the SSD chunk
    products of one shape, the doubling scan, and at head_dim 256 chunks
    at absolute multiples of 32 for every tile width)."""
    torch, dev = ctx["torch"], ctx["dev"]
    import numpy as np

    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model
    from repro_torch.models.transformer import attn_window

    from repro_torch.kernels import _build

    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, prompt_len), device=dev)
    recurrent = cfg.family in ("ssm", "hybrid")
    window = attn_window(cfg)
    band = window is not None and prompt_len > window
    # attention blocks of the cut model
    n_attn = (0 if cfg.family == "ssm" else
              n_layers // len(cfg.block_pattern) if cfg.family == "hybrid" else n_layers)
    out = []
    for dtype, degree, quant in MODEL_RUNS:
        if recurrent and quant:
            continue                 # no int8 cache: init_cache gives the state cache
        if isinstance(degree, list):
            degree = (degree * n_layers)[:n_layers] + degree[-1:]
        label = (f"{cfg.name} {n_layers}-layer {dtype} at degree {degree}, "
                 f"{'int8' if quant else 'bf16'} cache, prompt {prompt_len}")
        cut = dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype)
        model = build_model(cut, policy_from_flag("axq8", dynamic=True), device=dev)
        params = model.prepack(model.init(seed=1))
        seed_biases(ctx, params, 1)
        deg = torch.tensor(degree, dtype=torch.int32, device=dev)
        # the rehearsal drives the same sequence with `auto`, which routes
        # the CPU tensors to the plain versions (no kernel call to check)
        kernels = "cuda" if ctx["on_card"] else "auto"
        calls: dict = {}
        band_before = _build.flash_schedules["band"]
        with _checked_kernels(ctx, dtype, calls):
            lk, fed = _model_logits(ctx, model, params, prompt, deg, kernels, None, quant)
        band_launches = _build.flash_schedules["band"] - band_before
        require(not (band and ctx["on_card"]) or band_launches == n_attn,
                f"{label}: {band_launches} band launches, expected {n_attn}")
        # both plain runs decode the kernel run's greedy tokens
        lp, _ = _model_logits(ctx, model, params, prompt, deg, "torch", fed, quant)
        with _perturbed_projections(ctx, NOISE_EPS):
            ln, _ = _model_logits(ctx, model, params, prompt, deg, "torch", fed, quant)
        ctx["sync"]()
        diff = float((lk - lp).abs().max())
        floor = float((ln - lp).abs().max())
        tol = 4 * max(floor, 1e-3)
        # MoE admits at the exact length only (capacity couples the rows)
        pve = None if cfg.moe else _padded_vs_exact(ctx, model, params, deg, kernels, quant,
                                                    cfg.vocab)
        say(f"{label}: kernel calls vs plain on the model's inputs "
            f"{{name: [calls, max_err, outside tolerance]}} {calls}")
        say(f"{label}: logits kernels vs plain max |diff| {diff:.4g}; the plain model's "
            f"own change under a {NOISE_EPS:g} relative perturbation of its projections "
            f"{floor:.4g}; tolerance {tol:.4g}")
        if pve is not None:
            say(f"{label}: padded (bucket {pve['bucket']}) vs exact prefill of lengths "
                f"{pve['lens']}: bit-identical {pve['bit_identical']}, cache max |diff| "
                f"{pve['cache_max_abs_diff']}, next-step logits max |diff| "
                f"{pve['logits_max_abs_diff']:.4g}")
        decode = "flash_decode_quant" if quant else "flash_decode"
        ffn = (("axqmm_experts", "axqmm_gated_experts")
               + (("axqmm_gated",) if cfg.moe.n_shared else ())) if cfg.moe else ("axqmm_gated",)
        names = ("axqmm",) + ffn + (decode, "flash_attention")
        if cfg.family == "ssm":
            names = ("axqmm",)
        if recurrent:
            require(pve["bit_identical"], f"{label}: padded prefill's state differs from the "
                                          f"exact-length prefill's: {pve['cache_max_abs_diff']}")
        for name in names + (("axqmm (bias)",) if cfg.qkv_bias else ()):
            n, err, bad = calls.get(name, (0, 0.0, 0))
            require(n > 0 or not ctx["on_card"], f"{label}: {name} never ran")
            require(bad == 0, f"{label}: {bad} of {n} {name} calls outside "
                              f"tolerance of the plain version (max err {err})")
        require(diff <= tol, f"{label}: kernel-vs-plain logits differ by {diff} "
                             f"(noise floor {floor})")
        if pve is not None:
            require(pve["logits_max_abs_diff"] <= tol,
                    f"{label}: padded-vs-exact prefill moves the next logits by "
                    f"{pve['logits_max_abs_diff']} (noise floor {floor})")
        out.append({"arch": cfg.name, "prompt_len": prompt_len, "band_launches": band_launches,
                    "dtype": dtype, "degree": degree, "int8_cache": quant,
                    "kernel_calls": calls, "max_abs_logit_diff": diff,
                    "n_layers": n_layers, "noise_floor": floor, "noise_eps": NOISE_EPS,
                    "tolerance": tol,
                    "max_abs_logit": float(lp.abs().max()), "padded_vs_exact": pve})
    return out


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------


def _train_batch(ctx, cfg, batch, seq, step=0):
    """One batch of the synthetic pipeline (numpy-seeded, the reference's
    numbers) on the device."""
    torch = ctx["torch"]
    from repro_torch.data.pipeline import make_pipeline

    pipe = make_pipeline(cfg, seq_len=seq, global_batch=batch)
    return device_batch(ctx, pipe.batch_at(step))


def device_batch(ctx, batch: dict) -> dict:
    """A pipeline batch on the device: token ids and labels as int64, the
    frontends' features as f32."""
    torch = ctx["torch"]
    return {k: torch.from_numpy(v).to(ctx["dev"], torch.int64 if v.dtype.kind in "iu"
                                      else torch.float32)
            for k, v in batch.items()}


def _train_model(ctx, cfg, approx):
    from repro_torch.core.approx import policy_from_flag
    from repro_torch.models import build_model

    return build_model(cfg, policy_from_flag(approx, dynamic=True), device=ctx["dev"])


def _finite(t) -> bool:
    return bool(t.isfinite().all())


#: the frontend projections a train step runs on ``axqmm``
FRONTEND_GEMMS = {None: 0, "vision": 2, "audio": 1}


def train_launches(cfg, remat: str) -> dict:
    """Forward launches of one dense train step: each layer's wq, wk, wv,
    wo and down on ``axqmm``, its up/gate half on ``axqmm_gated``, its
    attention on ``flash_attention`` (``tri``; ``dense`` for a non-causal
    encoder), the unembedding and the frontend projections (the VLM's
    fc1 and fc2, the audio encoder's fc1); an MoE layer runs its experts'
    halves on ``axqmm_gated_experts`` and ``axqmm_experts`` instead of the
    MLP's; remat ``dots`` / ``full`` run each layer's forward twice.  A
    Mamba-2 layer runs in_proj and out_proj (the tied unembedding besides);
    a hybrid's recurrent block wx, wg, wa, wi, wo and down, its attention
    block wq, wk, wv, wo and down, each its gated half (remat: the groups
    twice, the tail blocks once)."""
    r = 1 if remat == "none" else 2
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"axqmm": 2 * L * r + 1, "axqmm_gated": 0, "flash_attention": 0}
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_groups, tail = divmod(L, len(pat))
        n_attn = n_groups * pat.count("attn")
        grouped = n_groups * len(pat)
        return {"axqmm": (6 * (grouped - n_attn) + 5 * n_attn) * r + 6 * tail + 1,
                "axqmm_gated": grouped * r + tail, "flash_attention": n_attn * r}
    out = {"axqmm": (4 if cfg.moe else 5) * L * r + (0 if cfg.tie_embeddings else 1)
           + FRONTEND_GEMMS[cfg.frontend],
           "axqmm_gated": 0 if cfg.moe else L * r, "flash_attention": L * r}
    if cfg.moe:
        out.update(axqmm_gated_experts=L * r, axqmm_experts=L * r)
    return out


def train_backwards(cfg) -> dict:
    """Backward oracles of one train step (whatever the remat policy: the
    backward runs once a layer): ``flash_attention_bwd`` a layer, one
    ``axqmm_bwd`` a forward ``axqmm`` projection, ``axqmm_gated_bwd`` a
    dense layer, ``axqmm_experts_bwd`` twice an MoE layer (the experts'
    halves; a Mamba-2 layer none but its projections', a hybrid's
    attention blocks one each)."""
    L = cfg.n_layers
    fwd = train_launches(cfg, "none")
    return {"flash_attention_bwd": fwd["flash_attention"], "axqmm_bwd": fwd["axqmm"],
            "axqmm_gated_bwd": fwd["axqmm_gated"],
            "axqmm_experts_bwd": 2 * L if cfg.moe else 0}


def train_kernel_rows(ctx, cfg):
    """The kernels at the training step's shapes (M = batch x seq rows on
    float weights quantized per call; tri over the batch's heads)."""
    torch = ctx["torch"]
    M = ctx["train_batch"] * ctx["train_seq"]
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd = cfg.n_heads * cfg.head_dim
    deg = torch.tensor(8, dtype=torch.int32, device=ctx["dev"])
    rows = {"axqmm": [check_axqmm(ctx, M, qd, d, False, deg),
                      check_axqmm(ctx, M, d, dff, False, deg),
                      check_axqmm(ctx, M, V, d, False, deg)],
            "axqmm_gated": [check_gated(ctx, M, dff, d, deg)],
            "flash_attention": [check_prefill(ctx, ctx["train_batch"] * cfg.n_heads,
                                              ctx["train_seq"], cfg.head_dim, cfg.n_heads,
                                              cfg.n_kv_heads, dtype=torch.bfloat16)]}
    report_rows(rows, "phase 5 (training shapes): ")
    return rows


def phase_train(ctx, cfg, label="phase 5a", shape=None, remat=None):
    """Phase 5a: tinyllama-1.1b at full width and depth trained under axq8
    with the QoS ladder 8 -> 5 (the trainer's control law on the loss
    improvement, thresholds that step it down at every check), batch x seq
    from the synthetic pipeline, one ``train_step`` a step: the forward on
    the kernels, the backward through the oracles.  Gates: finite loss and
    grad norm, the degree moving, launches as predicted, no plain version
    on the card.  The last step times the backward oracles with CUDA
    events.  Phases 5e / 5f run the same on the frontend archs, at their
    own ``shape`` (batch, seq) and ``remat``."""
    torch = ctx["torch"]
    from repro_torch.core.dynamic import QoSController, degree_operand, entry_degree
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import _build
    from repro_torch.train import step as S

    B, T = shape or (ctx["train_batch"], ctx["train_seq"])
    n = ctx["train_steps"]
    remat = remat or ctx["train_remat"]
    model = _train_model(ctx, cfg, "axq8")
    pipe = make_pipeline(cfg, seq_len=T, global_batch=B)
    if ctx["on_card"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = S.init_state(model, seed=0)
    ctx["sync"]()
    init_s = time.time() - t0
    scfg = S.StepConfig(remat=remat, total_steps=4 * n, warmup=2)
    qos = QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)], low_water=1e9,
                        high_water=2e9, cooldown_steps=0)
    entry = qos.ladder[0]
    degree = degree_operand(entry, ctx["dev"])
    hist, last_loss = [], None
    ctx["sync"]()
    _build.reset_counts()
    for step in range(n):
        batch = device_batch(ctx, pipe.batch_at(step))
        _build.time_backwards = step == n - 1
        args = (state, batch, degree)
        ctx["sync"]()
        t = time.time()
        state, met = S.train_step(model, scfg, state, batch, degree=degree)
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        ctx["sync"]()
        dt = time.time() - t
        hist.append({"step": step, "loss": loss, "grad_norm": gn, "s": dt,
                     "degree": entry_degree(entry)})
        require(math.isfinite(loss) and math.isfinite(gn),
                f"{label}: step {step} loss {loss} grad_norm {gn} not finite")
        if step % 2 == 0 and step > 0:      # the trainer's QoS check, qos_every 2
            entry = qos.update(step, (last_loss - loss) if last_loss is not None else 0.0)
            degree = degree_operand(entry, ctx["dev"])
            last_loss = loss
        elif last_loss is None:
            last_loss = loss
    _build.time_backwards = False
    oracle_ms = _build.backward_ms()
    seen = {"launches": dict(_build.launches), "plain": dict(_build.plain_cuda_calls),
            "flash_schedules": dict(_build.flash_schedules),
            "backward_calls": dict(_build.backward_calls)}
    want = {k: v * n for k, v in train_launches(cfg, remat).items()}
    check_launches(ctx, label, seen, want)
    sched = "tri" if cfg.causal else "dense"
    require(not ctx["on_card"] or seen["flash_schedules"][sched] == want["flash_attention"],
            f"{label}: flash schedules {seen['flash_schedules']}")
    once = train_launches(cfg, "none")
    bwd_want = {"flash_attention_bwd": cfg.n_layers * n, "axqmm_bwd": once["axqmm"] * n,
                "axqmm_gated_bwd": cfg.n_layers * n, "axqmm_experts_bwd": 0}
    require(seen["backward_calls"] == bwd_want,
            f"{label}: backward oracles {seen['backward_calls']}, expected {bwd_want}")
    degrees = [h["degree"] for h in hist]
    require(len(set(degrees)) > 1, f"{label}: the QoS degree never moved: {degrees}")
    steady = [h["s"] for h in hist[1:]]
    step_s = sum(steady) / len(steady)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": T, "steps": n,
           "remat": remat, "history": hist, "init_s": init_s, "step_s_mean": step_s,
           "launches_per_step": {k: v / n for k, v in seen["launches"].items() if v},
           "predicted_per_step": train_launches(cfg, remat),
           "tokens_per_s": B * T / step_s, "seen": seen, "oracle_ms": oracle_ms,
           "oracle_share_last_step": sum(oracle_ms.values()) / 1e3 / hist[-1]["s"]
           if oracle_ms else None}
    if ctx["on_card"]:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if label == "phase 5a":
        out["analysis"] = _train_analysis(ctx, label, cfg, scfg, args, step_s,
                                          out.get("peak_memory_bytes"))
    del args
    say(f"{label} ({cfg.name}, {cfg.n_layers} layers, batch {B} x seq {T}, axq8, remat "
        f"{remat}): losses {[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}, degrees {degrees}")
    say(f"{label}: step {step_s:.4f} s mean over steps 1-{n - 1} (first {hist[0]['s']:.4f} s), "
        f"{out['tokens_per_s']:.1f} tokens/s, init {init_s:.3f} s, peak memory "
        f"{out.get('peak_memory_bytes')} B; backward oracles in the last step "
        f"{ {k: round(v, 3) for k, v in oracle_ms.items()} } ms = "
        f"{out['oracle_share_last_step']} of its {hist[-1]['s']:.4f} s; launches "
        f"{ {k: v for k, v in seen['launches'].items() if v} }")
    del state
    return out


def _meta_like(tree):
    """``tree`` with every tensor an empty one of its shape and dtype on the
    meta device."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to("meta"), tree)


def _train_analysis(ctx, label, cfg, scfg, args, step_s, peak_bytes) -> dict:
    """5a's train step counted on the meta device (``dist/hlo_analysis.py``,
    at (1, 1)): the state built there from the seed as on the card, a meta
    batch and degree of the live ones' shapes.  Gate: its
    ``argument_bytes`` equal the bytes of the live step's arguments (the
    state, the batch, the degree) exactly.  Prints the dot FLOPs by dtype,
    the achieved rate of each over 5a's measured step time beside the
    card's dense peak for that dtype (``DOT_PEAKS``); the same again with
    the forward attention's products, which the analysis counts f32 as the
    reference's dots cover them (the whole S x S, ``tri`` included), under
    the dtype the attention kernel runs them in on the tensor cores (the
    model's); and the counted eager peak beside
    ``torch.cuda.max_memory_allocated()`` (a reading: the caching allocator
    is not modelled)."""
    from repro_torch.core.approx import policy_from_flag
    from repro_torch.dist.hlo_analysis import analyze_step, hlo_dtype, tree_bytes
    from repro_torch.models import build_model
    from repro_torch.train import step as S

    state, batch, degree = args
    model = build_model(cfg, policy_from_flag("axq8", dynamic=True), device="meta")
    rep = analyze_step(S.train_step, model, scfg, S.init_state(model, seed=0),
                       _meta_like(batch), degree=_meta_like(degree))
    live = tree_bytes(args)
    require(rep.memory.argument_bytes == live,
            f"{label} analysis: meta argument_bytes {rep.memory.argument_bytes} != the live "
            f"step's {live}")
    by = dict(rep.dot_flops_by_dtype)
    by_what: dict = {}
    for what, dt, f in rep.dots:
        by_what[f"{what} ({dt})"] = by_what.get(f"{what} ({dt})", 0.0) + f
    rate = {dt: f / step_s for dt, f in by.items()}
    share = {dt: rate[dt] / DOT_PEAKS[dt][0] for dt in by if dt in DOT_PEAKS}
    attn_dt = hlo_dtype(getattr(ctx["torch"], cfg.dtype))
    attn = {dt: 0.0 for dt in by}
    for what, dt, f in rep.dots:
        if what.startswith("repro_torch.flash_attention"):
            attn[dt] += f
    card_by = {dt: f - attn[dt] for dt, f in by.items()}
    card_by[attn_dt] = card_by.get(attn_dt, 0.0) + sum(attn.values())
    card_share = {dt: f / step_s / DOT_PEAKS[dt][0] for dt, f in card_by.items()
                  if dt in DOT_PEAKS}
    out = {"dot_flops": rep.dot_flops, "dot_flops_by_dtype": by, "by_what": by_what,
           "rate_per_s": rate,
           "share_of_peak": share, "peaks": {dt: DOT_PEAKS[dt] for dt in DOT_PEAKS},
           "forward_attention_flops": sum(attn.values()), "attention_dtype": attn_dt,
           "card_dtype_flops": card_by, "card_dtype_share_of_peak": card_share,
           "step_s": step_s, "argument_bytes": rep.memory.argument_bytes,
           "live_argument_bytes": live, "peak_bytes": rep.memory.peak_bytes,
           "max_memory_allocated": peak_bytes, "trace_s": rep.trace_s, "card": ctx["card"]}
    say(f"{label} analysis (meta, {rep.trace_s:.1f} s): dot FLOPs a step {rep.dot_flops:.6g} "
        f"by dtype { {k: f'{v:.6g}' for k, v in by.items()} }; over the {step_s:.4f} s step "
        f"{ {k: f'{v / 1e12:.4g} T/s' for k, v in rate.items()} }, of the dense peak "
        f"{ {k: f'{v:.4g}' for k, v in share.items()} } (peaks: "
        f"{ {dt: DOT_PEAKS[dt][1] for dt in share} }) on {'; '.join(ctx['card'])}")
    say(f"{label} analysis: the forward attention's {sum(attn.values()):.6g} FLOPs, counted "
        f"f32 by the reference's extents (tri's whole S x S), run by the attention kernel in "
        f"{attn_dt} on the tensor cores: by the dtype the card runs "
        f"{ {k: f'{v:.6g}' for k, v in card_by.items()} }, of the dense peak "
        f"{ {k: f'{v:.4g}' for k, v in card_share.items()} }")
    say(f"{label} analysis: dot FLOPs by what runs them "
        f"{ {k: f'{v:.6g}' for k, v in by_what.items()} }")
    say(f"{label} analysis: argument_bytes {rep.memory.argument_bytes} == live {live}; "
        f"counted eager peak {rep.memory.peak_bytes} B beside max_memory_allocated "
        f"{peak_bytes} B (not gated)")
    return out


def _dryrun_counts(rep) -> dict:
    return {"bytes": {k: int(v) for k, v in rep.collectives.bytes_by_kind.items()},
            "calls": dict(rep.collectives.calls_by_kind)}


def _dryrun_gate(label, ranks) -> dict:
    """Each rank's dry-run collectives (calls and bytes by kind) equal its
    live counter's; prints rank 0's."""
    for r in ranks:
        d = r["dryrun"]
        require(d["meta"] == d["live"], f"{label} rank {r['rank']}: dry-run collectives "
                                        f"{d['meta']} != live {d['live']}")
    d = ranks[0]["dryrun"]
    say(f"{label} dry run (meta mesh, {d['trace_s']:.1f} s) == live counter on every rank: "
        f"{d['what']}: calls {d['live']['calls']}, bytes {d['live']['bytes']}")
    return d


def _leaf_rel(a, b) -> float:
    """||a - b|| / ||b|| (0 where they are equal)."""
    na = float((a.float() - b.float()).norm())
    nb = float(b.float().norm())
    return 0.0 if na == 0 else na / max(nb, 1e-30)


#: kernel-route vs plain-route tolerances of one training step: the loss at
#: the bf16 logit bound of tests/test_torch_models_bf16.py; under EXACT each
#: gradient leaf within TRAIN_GRAD_REL in relative Frobenius norm; the
#: updated parameters within two learning-rate steps (a gradient entry
#: whose sign flips, or that is zero in one run, moves Adam's first update
#: by up to 2 lr).  Under AXQ the gradient reaches x and w only at each
#: block's amax (kernels/axq_grad.py): a one-ulp bf16 difference of an
#: activation (the tensor-core attention's bf16 P) can move a block's amax
#: to another entry and the gradient with it, so each leaf is held to
#: TRAIN_NOISE_MULT x the model's own noise floor — the change of the plain
#: run's gradient when its projections' f32 outputs are perturbed by
#: NOISE_EPS relative (phase 4's measure) and its attention outputs moved by
#: one ulp at random entries (the kernel's documented difference) — plus
#: TRAIN_NOISE_SLACK
TRAIN_LOSS_ATOL = 0.25
TRAIN_GRAD_REL = 5e-2
TRAIN_NOISE_MULT = 4.0
TRAIN_NOISE_SLACK = 1e-3


@contextlib.contextmanager
def _train_noise(ctx):
    """The plain versions with phase 4's projection noise, and each plain
    attention output moved by one ulp (of its dtype) up or down at a random
    half of its entries."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(11)
    plain = FA.flash_attention_grouped_plain
    ints = {2: torch.int16, 4: torch.int32}

    def moved(*a, **kw):
        o = plain(*a, **kw)
        step = torch.randint(-1, 2, o.shape, generator=gen, device=dev)
        bits = o.view(ints[o.element_size()])
        return torch.where((o != 0) & o.isfinite(), (bits + step.to(bits.dtype)).view(o.dtype),
                           o)

    with _perturbed_projections(ctx, NOISE_EPS), _patched(
            [(FA, "flash_attention_grouped_plain", moved)]):
        yield


def _step_both_routes(ctx, label, cfg, approx, batch, degree, expect_schedule=None):
    """One ``train_step`` (and its gradients) with the kernels and with the
    plain versions on the card, from one seeded state."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build
    from repro_torch.tree import named_leaves, tree_leaves, tree_map
    from repro_torch.train import step as S

    model = _train_model(ctx, cfg, approx)
    scfg = S.StepConfig(remat="none", total_steps=10, warmup=2)
    exact = approx == "exact"
    runs = {}
    # the rehearsal's "kernel" run is auto on the CPU: the plain versions
    routes = [("kernel", "cuda" if ctx["on_card"] else "auto", contextlib.nullcontext()),
              ("plain", "torch", contextlib.nullcontext())]
    if not exact:
        routes.append(("noise", "torch", _train_noise(ctx)))
    host = lambda tree: tree_map(lambda t: t.detach().float().cpu(), tree)
    for route, backend, patch in routes:
        with _backend(backend), patch:
            state = S.init_state(model, seed=0)
            ctx["sync"]()
            _build.reset_counts()
            (loss, _), grads = S.value_and_grad(model, state.params, batch, degree=degree,
                                                remat="none")
            # what is compared goes to the host: three routes' gradients and
            # updated parameters do not fit beside a full-width state
            run = {"loss": float(loss), "grads": host(grads)}
            del grads
            if route != "noise":
                new, met = S.train_step(model, scfg, state, batch, degree=degree)
                run.update(step_loss=float(met["loss"]), params=host(new.params))
                del new, met
            ctx["sync"]()
            run.update(launches=dict(_build.launches), plain=dict(_build.plain_cuda_calls),
                       schedules=dict(_build.flash_schedules))
            runs[route] = run
        del state
        if ctx["on_card"]:
            torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    if ctx["on_card"]:
        require(not any(k["plain"].values()), f"{label}: the kernel run called plain "
                                              f"versions {k['plain']}")
        require(k["launches"]["flash_attention"] > 0 or cfg.family == "ssm",
                f"{label}: no flash_attention launch")
        gemm = sum(v for n, v in k["launches"].items() if n.startswith("axqmm"))
        require(gemm > 0 or exact, f"{label}: no GEMM kernel launched")
        require(not any(p["launches"].values()), f"{label}: the plain run launched kernels")
        if expect_schedule:
            require(k["schedules"][expect_schedule] > 0,
                    f"{label}: no {expect_schedule} schedule ({k['schedules']})")
    dl = abs(k["loss"] - p["loss"])
    require(dl <= TRAIN_LOSS_ATOL and math.isfinite(k["loss"]),
            f"{label}: loss {k['loss']} vs plain {p['loss']}")
    names = [n for n, _ in named_leaves(k["grads"])]
    grel = [_leaf_rel(a, b) for a, b in zip(tree_leaves(k["grads"]), tree_leaves(p["grads"]))]
    if exact:
        tols = [TRAIN_GRAD_REL] * len(grel)
        floor = None
    else:
        floor = [_leaf_rel(a, b) for a, b in zip(tree_leaves(runs["noise"]["grads"]),
                                                  tree_leaves(p["grads"]))]
        tols = [TRAIN_NOISE_MULT * f + TRAIN_NOISE_SLACK for f in floor]
    worst = max(range(len(grel)), key=lambda i: grel[i] / tols[i])
    require(grel[worst] <= tols[worst],
            f"{label}: gradient {names[worst]} {grel[worst]} relative to the plain run's "
            f"(tolerance {tols[worst]}; noise floor {None if floor is None else floor[worst]})")
    lr = 2 * 3e-4
    pdiff = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(k["params"]), tree_leaves(p["params"])))
    require(pdiff <= lr, f"{label}: updated params differ by {pdiff} (> {lr})")
    zero = [n for n, g in named_leaves(k["grads"]) if n.split("/")[-2:-1] in (["wq"], ["wk"], ["wv"])
            and float(g.abs().sum()) == 0]
    require(not zero, f"{label}: zero attention gradients on the kernel route: {zero}")
    out = {"approx": approx, "loss": k["loss"], "plain_loss": p["loss"], "loss_diff": dl,
           "grad_rel_worst": grel[worst], "grad_rel_worst_leaf": names[worst],
           "grad_tol_worst": tols[worst], "grad_rel": dict(zip(names, grel)),
           "noise_floor": None if floor is None else dict(zip(names, floor)),
           "params_max_abs_diff": pdiff, "launches": k["launches"],
           "schedules": k["schedules"]}
    say(f"{label}: {approx}, loss {k['loss']:.6f} kernels vs {p['loss']:.6f} plain (|d| "
        f"{dl:.3g} <= {TRAIN_LOSS_ATOL}); gradient nearest its tolerance {names[worst]} "
        f"{grel[worst]:.3g} relative (<= {tols[worst]:.3g}{'' if floor is None else f', noise floor {floor[worst]:.3g}'}); "
        f"largest {max(grel):.3g}; params after the step within {pdiff:.3g} (<= {lr}); "
        f"launches {dict((n, v) for n, v in k['launches'].items() if v)}")
    return out


def phase_train_cut(ctx, cfg):
    """Phase 5b: tinyllama-1.1b cut to 2 layers at full width — one EXACT
    and one axq8 step with the kernels against the same with the plain
    versions (TRAIN_* tolerances), then 30
    EXACT steps on one batch dropping the loss by more than 1.0 (as
    tests/test_train.py::test_overfit_tiny_batch holds the reference)."""
    torch = ctx["torch"]
    from repro_torch.train import step as S

    c2 = dataclasses.replace(cfg, n_layers=2)
    batch = _train_batch(ctx, c2, *ctx["train_cut_shape"])
    deg = torch.tensor(8, dtype=torch.int32, device=ctx["dev"])
    out = {f"routes_{a}": _step_both_routes(ctx, "phase 5b (kernels vs plain)", c2, a, batch,
                                            deg)
           for a in ("exact", "axq8")}
    model = _train_model(ctx, c2, "exact")
    state = S.init_state(model, seed=0)
    scfg = S.StepConfig(remat="none", total_steps=60, warmup=5)
    ob = _train_batch(ctx, c2, *ctx["overfit_shape"])
    losses = []
    t = time.time()
    for _ in range(30):
        state, met = S.train_step(model, scfg, state, ob)
        losses.append(float(met["loss"]))
    out["overfit"] = {"losses": losses, "s": time.time() - t, "shape": ctx["overfit_shape"]}
    say(f"phase 5b (overfit, exact, batch x seq {ctx['overfit_shape']}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} in 30 steps ({out['overfit']['s']:.2f} s)")
    require(losses[-1] < losses[0] - 1.0,
            f"phase 5b: 30 exact steps dropped the loss by {losses[0] - losses[-1]} (<= 1.0)")
    del state
    return out


#: the launcher run by phase 5c: a 2-layer variant of the arch registered
#: first; a restored state's bytes checked against the checkpoint's
#: manifest digests; the run's losses printed as JSON
TRAIN_WRAPPER = r"""
import dataclasses, hashlib, json, sys
from repro_torch.configs import base, get_config
arch = sys.argv[1]
base.register(dataclasses.replace(get_config(arch), name=arch + "-2l", n_layers=2))
from repro_torch.checkpoint import checkpointer as C
from repro_torch.train import trainer as T
from repro_torch.tree import named_leaves
orig, check = T.Trainer.init_or_restore, {}
def init_or_restore(self, seed=0):
    state, start = orig(self, seed)
    if start:
        man = json.loads((self.ckpt.dir / f"step_{start:010d}" / "manifest.json").read_text())
        check["restored_step"] = start
        check["restored_equal"] = all(
            hashlib.sha1(C._host(v).tobytes()).hexdigest()[:16] == man["arrays"][n]["digest"]
            for n, v in named_leaves(state))
    return state, start
T.Trainer.init_or_restore = init_or_restore
from repro_torch.launch import train as L
out = L.main(["--arch", arch + "-2l"] + sys.argv[2:])
print("TRAIN_RESULT " + json.dumps({"final_step": out["final_step"],
      "preempted": out["preempted"], "losses": [h["loss"] for h in out["history"]],
      "steps": [h["step"] for h in out["history"]], **check}), flush=True)
"""


def _train_launcher(ctx, arch, argv, preempt_after=None, script=None):
    """``python -m repro_torch.launch.train`` (through TRAIN_WRAPPER, or the
    wrapper file ``script``) in a child process; with ``preempt_after`` a
    SIGTERM to it once its output has logged that step."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(HERE / "src"), PYTHONUNBUFFERED="1")
    cmd = [str(script)] if script is not None else ["-c", TRAIN_WRAPPER]
    proc = subprocess.Popen([sys.executable, "-u", *cmd, arch, *argv],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, result, sent = [], None, False
    t = time.time()
    try:
        for ln in proc.stdout:
            lines.append(ln.rstrip())
            if (preempt_after is not None and not sent
                    and ln.startswith(f"[trainer] step {preempt_after} ")):
                proc.send_signal(signal.SIGTERM)
                sent = True
            if ln.startswith("TRAIN_RESULT "):
                result = json.loads(ln[len("TRAIN_RESULT "):])
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(rc == 0 and result is not None,
            f"launch.train {argv} exited {rc}: " + " | ".join(lines[-15:]))
    result["wall_s"] = time.time() - t
    result["log"] = [ln for ln in lines if ln.startswith(("[trainer]", "[launch.train]"))]
    return result


def phase_train_launch(ctx, cfg):
    """Phase 5c: ``launch.train`` end to end at full width and 2 layers with
    --compress-grads --trace-out --metrics-out: an uninterrupted run; a run
    preempted by SIGTERM (a blocking checkpoint, exit); its resumption
    from that checkpoint (the restored device state's bytes equal to the
    saved manifest's digests) to the end.  The resumed losses sit within
    TRAIN_RESUME_ATOL of the uninterrupted run's (CUDA's embedding backward
    sums with atomics: runs differ in the last bits), the trace holds every
    step's spans and the metrics file the trainer's families.  The
    checkpoints go to a temporary directory removed afterwards."""
    import shutil
    import tempfile

    from repro_torch.obs.metrics import parse_text

    B, T, n = ctx["launch_shape"]
    tmp = Path(tempfile.mkdtemp(prefix="smoke_train_", dir=HERE / "build"
                                if (HERE / "build").is_dir() else None))
    dev = ["--device", "cuda" if ctx["on_card"] else "cpu"]
    common = ["--steps", str(n), "--seq", str(T), "--batch", str(B), "--compress-grads",
              *dev]
    try:
        ref = _train_launcher(ctx, cfg.name, common + [
            "--ckpt-dir", str(tmp / "ref"), "--trace-out", str(tmp / "trace.json"),
            "--metrics-out", str(tmp / "metrics.prom")])
        cut = _train_launcher(ctx, cfg.name, common + ["--ckpt-dir", str(tmp / "run")],
                              preempt_after=0)
        p = cut["final_step"]
        require(cut["preempted"] and 0 < p < n,
                f"phase 5c: the SIGTERM did not preempt the run ({cut['final_step']}, "
                f"{cut['preempted']})")
        step_dir = tmp / "run" / f"step_{p:010d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        res = _train_launcher(ctx, cfg.name, common + ["--ckpt-dir", str(tmp / "run")])
        require(res.get("restored_step") == p and res.get("restored_equal"),
                f"phase 5c: the restored state is not the saved one ({res.get('restored_step')}"
                f", {res.get('restored_equal')})")
        require(res["steps"][0] == p and res["final_step"] == n,
                f"phase 5c: resumed at {res['steps'][:1]} to {res['final_step']}")
        losses = cut["losses"] + res["losses"]
        require(len(losses) == len(ref["losses"]) == n, f"phase 5c: {len(losses)} losses")
        dl = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
        require(dl <= TRAIN_RESUME_ATOL,
                f"phase 5c: resumed losses {losses} vs uninterrupted {ref['losses']}")
        ev = json.loads((tmp / "trace.json").read_text())["traceEvents"]
        spans = {name: sorted(e["args"]["step"] for e in ev if e.get("name") == name)
                 for name in ("data_batch", "train_step")}
        require(spans["train_step"] == spans["data_batch"] == list(range(n)),
                f"phase 5c: trace spans {spans}")
        require(any(e.get("name") == "checkpoint" for e in ev), "phase 5c: no checkpoint span")
        prom = parse_text((tmp / "metrics.prom").read_text())
        fams = {k[0] for k in prom}
        need = {"repro_train_steps_total", "repro_train_checkpoints_total", "repro_train_loss",
                "repro_degree_ebits", "repro_train_step_seconds_count"}
        require(need <= fams and prom[("repro_train_steps_total", ())] == n,
                f"phase 5c: metrics {sorted(fams)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"shape": ctx["launch_shape"], "preempted_at": p, "checkpoint_bytes": ckpt_bytes,
           "losses_uninterrupted": ref["losses"], "losses_resumed": losses,
           "max_loss_diff": dl, "wall_s": {"ref": ref["wall_s"], "preempted": cut["wall_s"],
                                           "resumed": res["wall_s"]},
           "logs": {"ref": ref["log"], "preempted": cut["log"], "resumed": res["log"]}}
    say(f"phase 5c (launch.train, {cfg.name} at 2 layers, batch {B} x seq {T}, {n} steps, "
        f"--compress-grads): preempted at step {p}, checkpoint {ckpt_bytes} B, restored "
        f"bit for bit, resumed to {n}; losses within {dl:.3g} of the uninterrupted run "
        f"(<= {TRAIN_RESUME_ATOL}); wall {ref['wall_s']:.1f} / {cut['wall_s']:.1f} / "
        f"{res['wall_s']:.1f} s")
    return out


#: resumed vs uninterrupted launcher losses (phase 5c): the same data and
#: seed; only the card's atomics differ
TRAIN_RESUME_ATOL = 2e-2


def depth_cut(ctx, tag, cfg, register=False):
    """``cfg`` cut to the depth ``ctx["depth_cuts"]`` gives phase ``tag``
    (none: its own depth): the script's time limit cuts the depth of some
    earlier paths, never their width.  ``register``: the cut under a name
    of its own, registered in this process, for a phase that serves
    through the in-process launcher (which finds its arch by name)."""
    n = ctx["depth_cuts"].get(tag)
    if n is None:
        return cfg
    if not register:
        return dataclasses.replace(cfg, n_layers=n)
    from repro_torch.configs import base

    return base.register(dataclasses.replace(cfg, name=f"{cfg.name}-{n}l", n_layers=n))


def train_phases(ctx, record, cfg, moe_cfg, ssm_cfg, rg_cfg, vlm_cfg, audio_cfg) -> None:
    """Phase 5 but the launchers (5c, 5j: :func:`launcher_phases`), in
    order, each sub-phase's result set in ``record`` (which times it); each
    sub-phase frees the card's cache after it."""
    for key, fn, args in (("train_kernels", train_kernel_rows, (cfg,)),
                          ("train_path", phase_train, (cfg,)),
                          ("train_cut", phase_train_cut, (cfg,)),
                          ("train_families", phase_train_families,
                           (moe_cfg, ssm_cfg, rg_cfg, vlm_cfg, audio_cfg)),
                          ("train_vlm", phase_train,
                           (depth_cut(ctx, "5e", vlm_cfg), "phase 5e",
                            ctx["vlm_train_shape"])),
                          ("train_audio", phase_train,
                           (depth_cut(ctx, "5f", audio_cfg), "phase 5f",
                            ctx["audio_train_shape"], ctx["audio_train_remat"]))):
        record[key] = fn(ctx, *args)
        if ctx["on_card"]:
            ctx["torch"].cuda.empty_cache()


def train_mesh_phases(ctx, record, cfg, moe_cfg, vlm_cfg, audio_cfg, ssm_cfg,
                      rg_cfg) -> None:
    """The mesh-training phases but the launchers (5j:
    :func:`launcher_phases`), in order: phase 2's rows at 5g's, 5h's, 5k's,
    5l's and 5m's shard shapes, 5g / 5h / 5k / 5l / 5m, 5i with the serving
    data axis's 3w and 3x in its four-rank spawn; each sets its result in
    ``record``."""
    for key, fn, args in (("kernels_train_mesh", phase_kernels_train_mesh, (cfg, moe_cfg)),
                          ("kernels_train_mesh_rec", phase_kernels_train_mesh_recurrent,
                           (ssm_cfg, rg_cfg)),
                          ("train_mesh", phase_train_mesh,
                           (cfg, depth_cut(ctx, "5k", moe_cfg), depth_cut(ctx, "5l", ssm_cfg),
                            depth_cut(ctx, "5m", rg_cfg))),
                          ):
        record[key] = fn(ctx, *args)
        if ctx["on_card"]:
            ctx["torch"].cuda.empty_cache()
    record["train_mesh_cut"], (w_ranks, x_ranks) = phase_train_mesh_cut(
        ctx, cfg, moe_cfg, vlm_cfg, audio_cfg, ssm_cfg, rg_cfg,
        serve_runs=dp_serve_runs(ctx, cfg, tp_prompts(ctx, cfg)))
    record["dp_path"], record["fleet_mesh_path"] = phase_dp_serve(ctx, cfg, w_ranks, x_ranks)
    if ctx["on_card"]:
        ctx["torch"].cuda.empty_cache()


def launcher_phases(ctx, record, cfg, moe_cfg, single=True, mesh=True) -> None:
    """The launcher phases at once: 5c (``single``: ``launch.train`` on one
    device), 5j and 5j's MoE run (``mesh``: ``launch.train --mesh 1x2``).
    Each runs its launcher in child processes and only waits on them here;
    their time is mostly process start, warm-up and checkpoints, so they
    overlap on the card and the host's cores.  Each result is set in
    ``record`` when the phase ends (its time: since the entry before)."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = {}
    if single:
        jobs["train_launch"] = (phase_train_launch, (cfg,))
    if mesh:
        jobs["train_mesh_launch"] = (phase_train_mesh_launch, (cfg,))
        jobs["train_mesh_launch_moe"] = (phase_train_mesh_launch,
                                         (moe_cfg, "phase 5j (MoE)", False))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn, ctx, *args) for k, (fn, args) in jobs.items()}
        for k, fut in futures.items():
            record[k] = fut.result()
    if ctx["on_card"]:
        ctx["torch"].cuda.empty_cache()


def phase_train_families(ctx, moe_cfg, ssm_cfg, rg_cfg, vlm_cfg, audio_cfg):
    """Phase 5d: one axq8 train step each of granite-moe-3b-a800m (2
    layers), mamba2-370m (2 layers), recurrentgemma-2b (one (rec, rec,
    attn) group, a sequence past its 2048 window: ``band`` at head_dim 256),
    internvl2-1b (2 layers, its image and text tokens) and hubert-xlarge (2
    layers, non-causal ``dense`` at head_dim 80), at full width, the
    kernels against the plain versions."""
    torch = ctx["torch"]
    deg = torch.tensor(8, dtype=torch.int32, device=ctx["dev"])
    out = {}
    for tag, c, layers, shape in (("moe", moe_cfg, 2, ctx["fam_shape"]),
                                  ("ssm", ssm_cfg, 2, ctx["fam_shape"]),
                                  ("rg", rg_cfg, len(rg_cfg.block_pattern),
                                   ctx["rg_train_shape"]),
                                  ("vlm", vlm_cfg, 2, ctx["vlm_fam_shape"]),
                                  ("audio", audio_cfg, 2, ctx["fam_shape"])):
        cut = dataclasses.replace(c, n_layers=layers)
        batch = _train_batch(ctx, cut, *shape)
        out[tag] = _step_both_routes(ctx, f"phase 5d ({c.name}, {layers} layers, "
                                          f"batch x seq {shape})", cut, "axq8", batch, deg,
                                     expect_schedule={"rg": "band", "audio": "dense"}.get(tag))
        if ctx["on_card"]:
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# training on a mesh: two (or four) ranks on the one card through gloo
# ---------------------------------------------------------------------------


def phase_kernels_train_mesh(ctx, cfg, moe_cfg):
    """Phase 2's rows at the training shard shapes of 5g, 5h and 5k.  5g (1x2,
    the global batch's M rows on every rank): wq (N 1024), wk / wv (N 128),
    wo (K 1024 -> N 2048, an f32 partial: no residual in the epilogue),
    down (K 2816), the vocab shard (N 16000) and the gated half (N 2816),
    tri at 16 heads over 2 kv heads a rank.  5h (2x1, a data rank's M / 2
    rows on the full weights): wq / wo (N 2048, K 2048), wk / wv (N 256),
    down (K 5632), the unembedding (N 32000), the gated half (N 5632), tri
    at 32 / 4 heads.  5k (granite-moe-3b-a800m at 1x2, 4 x 1024 rows on
    every rank): the expert-batched halves at E 20 a rank and the capacity
    C = ceil(4096 x 8 / 40 x 1.25), wq (N 768) and the vocab shard (N
    24578), tri at 12 / 4 heads."""
    torch = ctx["torch"]
    T = ctx["train_seq"]
    deg = torch.tensor(8, dtype=torch.int32, device=ctx["dev"])
    d, D, pd = cfg.d_model, cfg.head_dim, cfg.padded(TP)
    H, KVr, F, V = pd.n_heads // TP, pd.n_kv_rep // TP, pd.d_ff // TP, pd.vocab // TP
    rows = {"axqmm": [], "axqmm_gated": [], "flash_attention": []}
    for M, B, shapes, f, h, kv in (
            (ctx["mesh_train_batch"] * T, ctx["mesh_train_batch"],
             [(H * D, d), (KVr * D, d), (d, H * D), (d, F), (V, d)], F, H, KVr),
            (ctx["mesh_dp_rows"] * T, ctx["mesh_dp_rows"],
             [(pd.n_heads * D, d), (pd.n_kv_rep * D, d), (d, pd.d_ff), (pd.vocab, d)],
             pd.d_ff, pd.n_heads, pd.n_kv_rep)):
        for N, K in shapes:
            rows["axqmm"].append(check_axqmm(ctx, M, N, K, False, deg))
        rows["axqmm_gated"].append(check_gated(ctx, M, f, d, deg))
        rows["flash_attention"].append(check_prefill(ctx, B * h, T, D, h, kv,
                                                     dtype=torch.bfloat16))
    B, T = ctx["moe_mesh_shape"][:2]
    from repro_torch.models.moe import capacity

    md, mD, mp = moe_cfg.d_model, moe_cfg.head_dim, moe_cfg.padded(TP)
    E, f = mp.n_experts // TP, moe_cfg.moe.d_expert
    C = capacity(moe_cfg, B * T, TP)
    rows["axqmm_gated_experts"] = [check_experts(ctx, E, C, f, md, deg, gated=True)]
    rows["axqmm_experts"] = [check_experts(ctx, E, C, md, f, deg, gated=False)]
    for N in (mp.n_heads // TP * mD, mp.vocab // TP):
        rows["axqmm"].append(check_axqmm(ctx, B * T, N, md, False, deg))
    h = mp.n_heads // TP
    rows["flash_attention"].append(check_prefill(ctx, B * h, T, mD, h, mp.n_kv_rep // TP,
                                                 dtype=torch.bfloat16))
    report_rows(rows, "phase 2 (training shards, 5g / 5h / 5k): ")
    return rows


def phase_kernels_train_mesh_recurrent(ctx, ssm_cfg, rg_cfg):
    """Phase 2's rows at 5l's and 5m's training shard shapes (1x2, the
    global batch's ``rec_mesh_shape`` rows on every rank, float weights
    quantized per call): mamba2-370m's in_proj (N 2320), out_proj's rows
    (K 1024) and the tied vocab shard (N 25140); recurrentgemma-2b's column
    projections (N 1280), wo's rows (K 1280), down's rows (K 3840), the
    gelu gated half (N 3840), the vocab shard (N 128000) and ``tri`` at 5
    heads over 1 kv head a rank."""
    torch = ctx["torch"]
    B, T = ctx["rec_mesh_shape"][:2]
    M = B * T
    deg = torch.tensor(8, dtype=torch.int32, device=ctx["dev"])
    rows = {"axqmm": [], "axqmm_gated": [], "flash_attention": []}
    s, d = ssm_cfg.ssm, ssm_cfg.d_model
    d_in = s.expand * d
    for N, K in ((d_in + 2 * s.d_state + d_in // s.headdim // TP, d), (d, d_in // TP),
                 (ssm_cfg.padded(TP).vocab // TP, d)):
        rows["axqmm"].append(check_axqmm(ctx, M, N, K, False, deg))
    d, D, pd = rg_cfg.d_model, rg_cfg.head_dim, rg_cfg.padded(TP)
    H, KVr, F = pd.n_heads // TP, pd.n_kv_rep // TP, pd.d_ff // TP
    for N, K in ((d // TP, d), (d, d // TP), (d, F), (pd.vocab // TP, d)):
        rows["axqmm"].append(check_axqmm(ctx, M, N, K, False, deg))
    rows["axqmm_gated"].append(check_gated(ctx, M, F, d, deg, act=rg_cfg.act))
    rows["flash_attention"].append(check_prefill(ctx, B * H, T, D, H, KVr,
                                                 dtype=torch.bfloat16))
    report_rows(rows, "phase 2 (training shards, 5l / 5m): ")
    return rows


def _fingerprint(ctx, tree) -> list:
    """One int a leaf: a position-weighted sum of the leaf's 32-bit words,
    on the device (equal leaves give equal sums; a changed bit changes
    it), read to the host."""
    torch = ctx["torch"]
    from repro_torch.tree import tree_leaves

    chunk = 1 << 22
    wts = torch.arange(chunk, dtype=torch.int64, device=ctx["dev"]) % 65521 + 1
    out = []
    for t in tree_leaves(tree):
        v = t.detach().reshape(-1)
        v = v.view(torch.int32) if v.element_size() == 4 else v.view(torch.int16)
        acc = torch.zeros((), dtype=torch.int64, device=v.device)
        for i, part in enumerate(v.split(chunk)):
            acc = acc + torch.sum(part.to(torch.int64) * wts[:part.numel()]) * (i + 1)
        out.append(acc)
    return [int(x) for x in torch.stack(out).cpu()] if out else []


def _mesh_rank(rank: int, world: int, runs: list) -> list:
    """One rank of 5g / 5h / 5i (and 3w / 3x in 5i's four-rank spawn) in
    its own process (``spawn_ranks``): each run of ``runs`` on its (data,
    model) mesh of all the ranks, over a gloo group on the card (the CPU in
    the rehearsal), ``kind`` ``path``, ``cut``, ``dp_serve`` (3w) or
    ``fleet`` (3x, whose replicas' meshes ``fleet_meshes`` builds); one
    result a run.  The ranks' processes and the card's
    warm-up are shared by the runs; each run frees what it held."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import meshctx
    from repro_torch.kernels import _build

    on_card = runs[0]["on_card"]
    if on_card:
        torch.cuda.set_device(meshctx.rank_device(rank))
        _build.build_all()                   # loads the parent's build (content-keyed)
    out, noise = [], {}
    for job in runs:
        cfg = get_config(job["arch"])
        if job.get("n_layers"):
            cfg = dataclasses.replace(cfg, n_layers=job["n_layers"])
        t = time.time()
        if job["kind"] == "fleet":
            # 3x builds its replicas' meshes itself (fleet_meshes)
            dev = meshctx.rank_device(rank, "cuda" if on_card else "cpu")
            out.append(_fleet_serve(_rank_ctx(torch, dev, on_card, job["slots"]), rank, cfg,
                                    job))
            out[-1]["job_s"] = time.time() - t
            if on_card:
                torch.cuda.empty_cache()
            continue
        mesh = meshctx.set_mesh(meshctx.make_mesh(tuple(job["mesh"]), ("data", "model"),
                                                  device="cuda" if on_card else "cpu",
                                                  backend="gloo"))
        ctx = _rank_ctx(torch, mesh.device, on_card, job.get("slots", 0))
        if job["kind"] == "dp_serve":
            out.append(_dp_serve(ctx, mesh, cfg, job))
        elif job["kind"] == "path":
            out.append(_mesh_path(ctx, mesh, cfg, job))
        else:
            # the one-rank noise floor: measured once an arch, by rank 0's
            # first run of it
            arch = job["arch"]
            out.append(_mesh_cut(ctx, mesh, cfg, dict(job, noise=job["noise"].get(arch)
                                                      or noise.get(arch))))
            if noise.get(arch) is None:
                noise[arch] = out[-1]["jobs"].get("axq8", {}).get("noise")
        out[-1]["job_s"] = time.time() - t
        if on_card:
            torch.cuda.empty_cache()
    return out


def _mesh_path(ctx, mesh, cfg, job) -> dict:
    """``job["steps"]`` train steps of the full model on this rank's shards
    and rows (the synthetic pipeline's global batch), axq8 with the QoS
    ladder 8 -> 5 stepping down each step: every step's loss, grad norm,
    degree, time and collectives, the launches of the whole run (counts
    set to 0 just before the first step), the backward oracles timed by
    CUDA events in the last step, the peak memory, and the parameters'
    fingerprints (every step with ``job["every_step"]``, else the last)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core.dynamic import QoSController, degree_operand, entry_degree
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.dist import collectives, meshctx, sharding
    from repro_torch.dist.hlo_analysis import analyze_step
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train import step as S

    M = mesh.size("model")
    model = build_model(cfg, _tp_policy(job), device=dev)
    pipe = make_pipeline(cfg, seq_len=job["seq"], global_batch=job["batch"])
    if ctx["on_card"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = S.init_state(model, seed=0, tp=M, mesh=mesh)
    init_peak = torch.cuda.max_memory_allocated() if ctx["on_card"] else None
    remat = job.get("remat", "none")
    scfg = S.StepConfig(remat=remat, total_steps=4 * job["steps"], warmup=2)
    qos = QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)], low_water=1e9,
                        high_water=2e9, cooldown_steps=0)
    entry = qos.ladder[0]
    degree = degree_operand(entry, dev)
    n = job["steps"]
    hist, prints = [], []
    ctx["sync"]()
    _build.reset_counts()
    for step in range(n):
        host = {k: torch.from_numpy(v).to(torch.int64) for k, v in pipe.batch_at(step).items()}
        batch = {k: v.to(dev) for k, v in sharding.shard_batch(host, mesh).items()}
        _build.time_backwards = step == n - 1
        ctx["sync"]()
        collectives.counter.reset()
        t = time.time()
        state, met = S.train_step(model, scfg, state, batch, tp=M, degree=degree)
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        ctx["sync"]()
        dt = time.time() - t
        hist.append({"step": step, "loss": loss, "grad_norm": gn, "s": dt,
                     "degree": entry_degree(entry), "ntokens": float(met["ntokens"]),
                     "collectives": collectives.counter.snapshot()})
        if job.get("every_step") or step == n - 1:
            prints.append(_fingerprint(ctx, state.params))
        if step < n - 1:                    # the trainer's QoS check, every step
            entry = qos.update(step, 1.0)
            degree = degree_operand(entry, dev)
    _build.time_backwards = False
    dry = None
    if job.get("dryrun"):
        # the last step's collectives against the dry run of the same step on
        # this rank's meta mesh: the state made there from the seed and cut
        with meshctx.use_mesh(meshctx.make_meta_mesh(mesh.shape, mesh.axis_names,
                                                     rank=mesh.rank)) as mm_mesh:
            mm = build_model(cfg, _tp_policy(job), device="meta")
            rep = analyze_step(S.train_step, mm, scfg, S.init_state(mm, seed=0, tp=M,
                                                                    mesh=mm_mesh),
                               _meta_like(batch), tp=M, degree=_meta_like(degree))
        live = hist[-1]["collectives"]
        dry = {"what": f"train step {n - 1}", "trace_s": rep.trace_s,
               "live": {"bytes": live["bytes"], "calls": live["calls"]},
               "meta": _dryrun_counts(rep)}
    out = {"rank": mesh.rank, "coord": {a: mesh.coord(a) for a in mesh.axis_names},
           "transport": mesh.transport, "history": hist, "remat": remat,
           "peak_after_init_bytes": init_peak,
           "launches": dict(_build.launches), "plain": dict(_build.plain_cuda_calls),
           "flash_schedules": dict(_build.flash_schedules),
           "backward_calls": dict(_build.backward_calls), "oracle_ms": _build.backward_ms(),
           "fingerprints": prints, "sharded": sharding.model_sharded(state.params, mesh),
           "param_count": sum(t.numel() for t in _leaves(state.params)),
           "n_leaves": len(_leaves(state.params)), "dryrun": dry}
    if ctx["on_card"]:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


@contextlib.contextmanager
def _kv_int8(on: bool):
    """``REPRO_KV_INT8`` while an engine is built (its cache reads it)."""
    import os

    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = prev


def _record_tops(eng, against=None) -> dict:
    """{(rid, token index): (the step's largest logit, [the logit of
    ``against[rid][index]``])} of every token of this rank's rows that
    ``eng`` harvests, from its adapter's whole-row logits (a data axis'
    rank holds its slots' rows).  ``against``: {rid: another run's
    tokens}, whose logits this run's step is read at."""
    tops, last = {}, {}
    wl = eng.workload
    shard = getattr(wl, "shard", None)
    logits_fn, harvest = wl._logits, wl.harvest

    def logits_and_note(*a, **kw):
        logits, cache = logits_fn(*a, **kw)
        last["l"] = logits.float()
        return logits, cache

    def harvest_and_note(req, feed, slot, emission):
        row = slot if shard is None else shard.local(slot)
        if row is not None:
            lg, t = last["l"][row], len(req.out)
            other = (against or {}).get(req.rid, ())
            tops[(req.rid, t)] = (float(lg.max()),
                                  float(lg[other[t]]) if t < len(other) else None)
        return harvest(req, feed, slot, emission)

    wl._logits, wl.harvest = logits_and_note, harvest_and_note
    return tops


def _dp_serve(ctx, mesh, cfg, job) -> dict:
    """3w on this rank: ``job["runs"]`` (the bf16 cache with exact-length
    admission; the int8 cache with bucketed, packed admission) of the
    2x2 engine over phase 3's prompts, axq8 with the ladder 8 -> 5, eager:
    each run's streams, the model's prefill calls on this rank (its data
    coordinate's rows only), the launch and collective counts (set to 0
    just before and read just after), tick, tokens/s, TTFT and peak memory.
    Each rank records the largest logit of its rows' every step.  Rank 0
    then serves each run on one rank (a trivial mesh, the same weights,
    warm-up and QoS ladder), recording its largest logit and its logit of
    the 2x2 run's token at every step (:func:`_one_rank_gate`)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.core.dynamic import QoSController
    from repro_torch.dist import collectives, meshctx
    from repro_torch.models import build_model
    from repro_torch.serve.admission import AdmissionConfig
    from repro_torch.serve.lm import ServeEngine
    from repro_torch.serve.metrics import summarize
    from repro_torch.serve.sharded import ShardedServeEngine

    M = mesh.size("model")
    model = build_model(cfg, _tp_policy(job), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(generator=gen, tp=M)       # the global tree, equal on every rank
    forwards = {"prefill": 0, "prefill_batch": 0}
    for name in forwards:
        def counted(*a, _f=getattr(model, name), _n=name, **kw):
            forwards[_n] += 1
            return _f(*a, **kw)
        setattr(model, name, counted)
    prompts, new_tokens = job["prompts"], job["new_tokens"]
    ladder = lambda: QoSController(ladder=[{"ebits": e} for e in (8, 7, 6, 5)], low_water=0.25,
                                   high_water=0.75, cooldown_steps=8)
    warm = prompts[0][:16]
    out = {"rank": mesh.rank, "coord": {a: mesh.coord(a) for a in mesh.axis_names},
           "transport": mesh.transport, "runs": {}}
    for run in job["runs"]:
        adm = (AdmissionConfig(buckets=tuple(run["buckets"]), pack=run["pack"])
               if run.get("buckets") else None)
        with _kv_int8(run["quant"]):
            eng = ShardedServeEngine(model, params, mesh=mesh, slots=job["slots"],
                                     max_len=job["max_len"], qos=ladder(), seed=0,
                                     admission=adm)
        eng.submit(warm, 2)                            # library loads, allocator
        eng.run_until_drained()
        st = eng.stats
        steps0, f0 = st.decode_steps, dict(forwards)
        collectives.counter.reset()
        tops = _record_tops(eng)
        reqs, seen = drive(ctx, eng, prompts, new_tokens)
        coll = collectives.counter.snapshot()
        eng.check_streams()
        fwd = {k: forwards[k] - f0[k] for k in forwards}
        s = summarize(reqs, eng.stats, wall_s=seen["wall_s"])
        dts = seen["decode_ticks"]
        res = {"streams": [list(r.out_tokens) for r in reqs],
               "statuses": sorted({r.status for r in reqs}), "steps": st.decode_steps - steps0,
               "prefills": fwd["prefill"] + fwd["prefill_batch"], "forwards": fwd,
               "rows": int(eng.cache.length.shape[0]), "cache": type(eng.cache).__name__,
               "ticks": seen["ticks"], "wall_s": seen["wall_s"],
               "decode_tick_ms_mean": 1e3 * sum(dts) / max(len(dts), 1),
               "decode_ticks_timed": len(dts),
               "gen_tok_per_s": s["generated_tokens"] / seen["wall_s"],
               "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p95_ms": s["ttft_p95_ms"],
               "tpot_p50_ms": s["tpot_p50_ms"],
               "rungs": sorted({e for _, e in eng.stats.degree_history}),
               "launches": seen["launches"], "plain": seen["plain"],
               "flash_schedules": seen["flash_schedules"],
               "max_memory_allocated": seen["max_memory_allocated"], "collectives": coll,
               "tops": tops}
        del eng
        if ctx["on_card"]:
            torch.cuda.empty_cache()
        if mesh.rank == 0:
            with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))), \
                    _kv_int8(run["quant"]):
                ref = ServeEngine(model, params, slots=job["slots"], max_len=job["max_len"],
                                  tp=M, qos=ladder(), seed=0, admission=adm, capture=False)
                ref.submit(warm, 2)
                ref.run_until_drained()
                # the 2x2 run's requests had these rids too (one warm-up before)
                one = _record_tops(ref, against={r.rid: r.out_tokens for r in reqs})
                rr = [ref.submit(p, new_tokens) for p in prompts]
                ref.run_until_drained()
            res["one_rank"] = {"streams": {r.rid: list(r.out_tokens) for r in rr},
                               "tops": one, "statuses": sorted({r.status for r in rr})}
            del ref
            if ctx["on_card"]:
                torch.cuda.empty_cache()
        out["runs"][run["name"]] = res
    return out


def _fleet_serve(ctx, rank, cfg, job) -> dict:
    """3x on this rank: a FleetSupervisor of ``job["replicas"]`` replicas x
    tp=2 over the world (``fleet_meshes``: disjoint slices), every replica
    a ShardedServeEngine at a fixed degree (axq8 at 8, the bf16 cache,
    exact-length admission) on the one weight tree, under seeded
    ``replica_loss`` on a VirtualClock, twice; then a clean engine on
    replica 0's ranks (the others shadow it).  Each fleet run: the recovery
    trace, every request's (status, tokens), the last rescale, the launch
    and collective counts of the run (set to 0 just before and read just
    after) beside the decode steps and prefills of the replicas this rank
    computes, wall time, TTFT, peak memory."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.dist import collectives, meshctx
    from repro_torch.dist.fleet import FleetSupervisor
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.resil import FaultPlan, FaultSpec, VirtualClock
    from repro_torch.serve.metrics import summarize
    from repro_torch.serve.sharded import ShardedServeEngine

    model = build_model(cfg, _tp_policy(job), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(generator=gen, tp=TP)       # the global tree, equal on every rank
    prompts, new_tokens = job["prompts"], job["new_tokens"]
    deg = torch.tensor(8, dtype=torch.int32, device=dev)

    def engine(mesh, clock, policy):
        return ShardedServeEngine(model, params, mesh=mesh, slots=job["slots"],
                                  max_len=job["max_len"], seed=0, degree=deg, clock=clock,
                                  policy=policy)

    out = {"rank": rank, "runs": []}
    for _ in range(2):
        clock, policy = VirtualClock(), _fleet_policy()
        plan = FaultPlan(FaultSpec(replica_loss=job["loss"]), seed=job["seed"])
        sup = FleetSupervisor(lambda mesh, rid: engine(mesh, clock, policy), job["replicas"],
                              tp=TP, clock=clock, faults=plan, policy=policy,
                              device="cuda" if ctx["on_card"] else "cpu", backend="gloo")
        ctx["sync"]()
        _build.reset_counts()
        collectives.counter.reset()
        if ctx["on_card"]:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        reqs = [sup.submit(p, new_tokens) for p in prompts]
        done = sup.run_until_drained(max_ticks=8 * len(prompts) * new_tokens)
        ctx["sync"]()
        wall = time.time() - t0
        s = summarize(done, None, wall_s=wall)
        mine = [r for r in sup.replicas if r.mesh.member]
        out["runs"].append({
            "resil_log": list(sup.resil_log),
            "done": sorted((r.rid, r.status, tuple(r.out)) for r in done),
            "submitted": [r.rid for r in reqs], "ticks": sup._ticks,
            "rescale": ({"data": sup.rescales[-1].data, "model": sup.rescales[-1].model,
                         "idle": sup.rescales[-1].idle_devices} if sup.rescales else None),
            "alive": [r.alive for r in sup.replicas],
            "ranks": [list(r.mesh.ranks) for r in sup.replicas],
            "members": [r.rid for r in mine],
            "steps": sum(r.engine.stats.decode_steps for r in mine),
            "prefills": sum(r.engine.stats.prefill_calls for r in mine),
            "launches": dict(_build.launches), "plain": dict(_build.plain_cuda_calls),
            "collectives": collectives.counter.snapshot(), "wall_s": wall,
            "gen_tok_per_s": s["generated_tokens"] / wall, "ttft_p50_ms": s["ttft_p50_ms"],
            "ttft_p95_ms": s["ttft_p95_ms"],
            "max_memory_allocated": (torch.cuda.max_memory_allocated() if ctx["on_card"]
                                     else None)})
        del sup, mine
        if ctx["on_card"]:
            torch.cuda.empty_cache()
    clock, policy = VirtualClock(), _fleet_policy()
    mesh0 = meshctx.make_mesh((1, TP), ("data", "model"), device=dev, backend="gloo",
                              ranks=range(TP))
    clean = engine(mesh0, clock, policy)
    creqs = [clean.submit(p, new_tokens) for p in prompts]
    clean.run_until_drained()                       # the ranks' streams compared
    out["clean"] = {r.rid: tuple(r.out) for r in creqs}
    return out


def _leaves(tree) -> list:
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


def _state_stats(new, ref, start, sharded, ill_lr) -> list:
    """Per leaf of params / mu / nu of this rank's ``new`` state against
    the matching shard of the one-rank ``ref`` state: [max |diff| over the
    well-conditioned entries, max |ref|, sum of squared diffs, sum of
    squared refs, the largest move of an ill-conditioned entry from
    ``start`` on either side, sharded] (an entry is ill-conditioned where
    the one-rank clipped gradient, mu / (1 - b1), is below ILL_GRAD)."""
    out = []
    ill = [(m.abs() / 0.1 < ILL_GRAD) for m in _leaves(ref.opt.mu)] if ill_lr else None
    for field in ("params", "mu", "nu"):
        a_l = _leaves(getattr(new, field) if field == "params" else getattr(new.opt, field))
        b_l = _leaves(getattr(ref, field) if field == "params" else getattr(ref.opt, field))
        for i, (a, b) in enumerate(zip(a_l, b_l)):
            a, b = a.float(), b.float()
            d = (a - b).abs()
            move = 0.0
            if field == "params" and ill is not None:
                p0 = _leaves(start.params)[i].float()
                m = ill[i]
                if bool(m.any()):
                    move = max(float(((a - p0).abs() * m).max()), float(((b - p0).abs() * m).max()))
                d = d * ~m
            out.append([field, float(d.max()), float(b.abs().max()), float((a - b).square().sum()),
                        float(b.square().sum()), move, bool(sharded[i])])
    return out


def _shard_of(ref, mesh):
    """The one-rank state cut to this rank's part."""
    from repro_torch.dist import sharding

    return sharding.shard_train_state(ref, mesh)


def _mesh_cut(ctx, mesh, cfg, job) -> dict:
    """5i on this rank: for each sub-job one ``train_step`` on the mesh from
    the seeded state and the global batch's rows, and the same step on one
    rank (a trivial mesh, in this process, the whole batch), then this
    rank's shards of the new state against the matching shards of the
    one-rank step (``_state_stats``), the losses, grad norms and the mesh
    step's collectives.  A ``ring`` sub-job is also held to the exact mesh
    step before it; rank 0 adds, under axq8, the noise floor of the
    one-rank gradients (plain vs plain with phase 4's noise, per leaf)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.dist import collectives, meshctx, sharding
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    from repro_torch.train import step as S

    D, M = mesh.size("data"), mesh.size("model")
    one = meshctx.make_mesh((1, 1), ("data", "model"))
    host = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    to_dev = lambda b: {k: v.to(dev, v.dtype if v.is_floating_point() else torch.int64)
                        for k, v in b.items()}
    full_batch = to_dev(host)
    batch = to_dev(sharding.shard_batch(host, mesh))
    deg = torch.tensor(8, dtype=torch.int32, device=dev)
    out = {"rank": mesh.rank, "coord": {a: mesh.coord(a) for a in mesh.axis_names},
           "jobs": {}}
    exact_mesh = None
    for sub in job["subs"]:
        c = dataclasses.replace(cfg, dtype=sub.get("dtype", cfg.dtype))
        model = build_model(c, _tp_policy({**job, "approx": sub["approx"]}), device=dev)
        if sub.get("grads_only"):
            d = None if sub["approx"] == "exact" else deg
            out["jobs"][sub["name"]] = _mesh_grads(ctx, mesh, one, model, M, full_batch, batch,
                                                   d, job.get("noise") is None)
            if ctx["on_card"]:
                torch.cuda.empty_cache()
            continue
        scfg = S.StepConfig(remat="none", total_steps=10, warmup=2,
                            compress_grads=sub.get("compress", False))
        d = None if sub["approx"] == "exact" else deg
        # the one-rank step first, cut to this rank's shards and the whole
        # state freed before the mesh step (four ranks share the card)
        ref_route = _backend("torch") if sub.get("ref_plain") else contextlib.nullcontext()
        with meshctx.use_mesh(one), ref_route:
            start = S.init_state(model, seed=0, tp=M)
            if c.moe and D > 1:
                ref, rmet = _data_shard_step(model, scfg, start, full_batch, D, M, d)
            else:
                ref, rmet = S.train_step(model, scfg, start, full_batch, tp=M, degree=d)
            ref_s, start_s = _shard_of(ref, mesh), _shard_of(start, mesh)
            del ref, start
        if ctx["on_card"]:
            torch.cuda.empty_cache()
        with kops.ring_tp(sub.get("ring", False)):
            state = S.init_state(model, seed=0, tp=M, mesh=mesh)
            collectives.counter.reset()
            new, met = S.train_step(model, scfg, state, batch, tp=M, degree=d)
            coll = collectives.counter.snapshot()
        sharded = sharding.model_sharded(new.params, mesh)
        res = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
               "ref_loss": float(rmet["loss"]), "ref_grad_norm": float(rmet["grad_norm"]),
               "collectives": coll,
               "stats": _state_stats(new, ref_s, start_s, sharded, ill_lr=True),
               "fingerprint": _fingerprint(ctx, new)}
        if sub.get("ring"):
            res["vs_exact_mesh"] = _state_stats(new, exact_mesh, state, sharded, ill_lr=False)
        if sub.get("diagnose"):
            res["diagnosis"] = _diagnose(ctx, mesh, one, model, state, new, ref_s, batch,
                                         full_batch)
        if sub["approx"] == "exact" and not sub.get("ring") and not sub.get("compress"):
            exact_mesh = new
        if sub["approx"] != "exact" and mesh.rank == 0 and job.get("noise") is None:
            res["noise"] = _noise_floor(ctx, model, M, one, full_batch, d)
        out["jobs"][sub["name"]] = res
        del new, ref_s, start_s
        if ctx["on_card"]:
            torch.cuda.empty_cache()
    return out


def _diagnose(ctx, mesh, one, model, start, new, ref, batch, full_batch) -> dict:
    """Where a data-axis mesh step parts from one rank's (ROADMAP §C): for
    mu and nu the leaf and entry of the largest difference over the leaf's
    largest entry, both values there; at mu's entry this rank's share of
    the gradient (its rows' log-likelihood over the global token count, not
    yet summed), the data ranks' sum of the shares (the step's
    all-reduce), the one-rank gradient on the whole batch, and the leaf's
    and the share's largest entries; the five gradient leaves farthest from
    the one-rank gradient, each beside the one-rank gradient's distance
    from itself with the batch's rows in the other order (the same sums in
    another order: the size of a rounding)."""
    from repro_torch.dist import collectives, meshctx
    from repro_torch.train import step as S
    from repro_torch.tree import named_leaves

    out = {}
    for field in ("mu", "nu"):
        worst = None
        for (name, a), (_, b) in zip(named_leaves(getattr(new.opt, field)),
                                     named_leaves(getattr(ref.opt, field))):
            a, b = a.float().reshape(-1), b.float().reshape(-1)
            d, big = (a - b).abs(), float(b.abs().max())
            j = int(d.argmax())
            rel = float(d[j]) / big if big else 0.0
            if worst is None or rel > worst["rel"]:
                worst = {"rel": rel, "leaf": name, "entry": j, "mesh": float(a[j]),
                         "one_rank": float(b[j]), "leaf_max": big}
        out[field] = worst
    group = meshctx.data_group(mesh)
    _, share = S.value_and_grad(model, start.params, batch, tp=1, remat="none")
    with meshctx.use_mesh(one):
        _, whole = S.value_and_grad(model, start.params, full_batch, tp=1, remat="none")
        flip = {k: v.flip(0) for k, v in full_batch.items()}
        _, swapped = S.value_and_grad(model, start.params, flip, tp=1, remat="none")
    leaves = []
    for (name, g), (_, w), (_, v) in zip(named_leaves(share), named_leaves(whole),
                                         named_leaves(swapped)):
        total = collectives.all_reduce(g, group)
        big = float(w.abs().max()) or 1.0
        leaves.append((float((total - w).abs().max()) / big,
                       float((v - w).abs().max()) / big, name))
        if name == out["mu"]["leaf"]:
            j = out["mu"]["entry"]
            out["grad"] = {"leaf": name, "entry": j, "share": float(g.reshape(-1)[j]),
                           "sum": float(total.reshape(-1)[j]),
                           "one_rank": float(w.reshape(-1)[j]), "leaf_max": big,
                           "share_max": float(g.abs().max())}
    out["grad_leaves"] = sorted(leaves, reverse=True)[:5]
    return out


def _diagnosis_lines(label, ranks) -> dict:
    """Print 5i's diagnosis of a data-axis exact step (``_diagnose``) from
    every rank; returns it with the ranks' shares."""
    d0 = ranks[0]["jobs"]["exact"]["diagnosis"]
    shares = [r["jobs"]["exact"]["diagnosis"]["grad"]["share"] for r in ranks]
    g = d0["grad"]
    for field in ("mu", "nu"):
        w = d0[field]
        say(f"{label} exact diagnosis: {field} {w['rel']:.4g} of its leaf's largest entry at "
            f"{w['leaf']}[{w['entry']}] (mesh {w['mesh']!r}, one rank {w['one_rank']!r}, "
            f"leaf's largest {w['leaf_max']!r})")
    say(f"{label} exact diagnosis: gradient of {g['leaf']}[{g['entry']}]: the data ranks' "
        f"shares {shares} sum to {g['sum']!r}, one rank {g['one_rank']!r}; the leaf's "
        f"largest entry {g['leaf_max']!r}, a share's largest {g['share_max']!r}; the "
        f"farthest gradient leaves (mesh, one rank with its rows swapped, leaf): "
        f"{d0['grad_leaves']}")
    return dict(d0, shares=shares)


def _mesh_grads(ctx, mesh, one, model, M, full_batch, batch, degree, noise) -> dict:
    """5i's gradient-only sub-job (a state too large to hold twice a rank
    and twice on the card: recurrentgemma-2b's two 655 M-parameter
    embeddings): the one-rank ``value_and_grad`` on the whole batch, cut to
    this rank's shards and freed, then the mesh's on this rank's shards
    and rows; per leaf ["grads", max |diff|, max |ref|, sum of squared
    diffs, sum of squared refs, 0, sharded] (``_state_stats``' columns),
    the losses and both global gradient norms (``adamw.global_norm``: the
    mesh's sums the split columns over ``model`` and counts in_proj's B / C
    columns once); under axq8, with ``noise``, rank 0 adds the one-rank
    noise floor."""
    torch = ctx["torch"]
    from repro_torch.dist import collectives, meshctx, sharding
    from repro_torch.optim import adamw
    from repro_torch.train import step as S

    with meshctx.use_mesh(one):
        params = model.init(seed=0, tp=M)
        (rloss, _), g = S.value_and_grad(model, params, full_batch, tp=M, degree=degree,
                                         remat="none")
        rgn = float(adamw.global_norm(g))
        del params
        ref = sharding.shard_params(g, mesh=mesh)
        del g
    if ctx["on_card"]:
        torch.cuda.empty_cache()
    params = sharding.shard_params(model.init(seed=0, tp=M), mesh=mesh)
    collectives.counter.reset()
    (loss, _), g = S.value_and_grad(model, params, batch, tp=M, degree=degree, remat="none")
    coll = collectives.counter.snapshot()
    gn = float(adamw.global_norm(g))
    sharded = sharding.model_sharded(g, mesh)
    stats = []
    for a, b, sh in zip(_leaves(g), _leaves(ref), sharded):
        a, b = a.float(), b.float()
        stats.append(["grads", float((a - b).abs().max()), float(b.abs().max()),
                      float((a - b).square().sum()), float(b.square().sum()), 0.0, bool(sh)])
    res = {"loss": float(loss), "grad_norm": gn, "ref_loss": float(rloss), "ref_grad_norm": rgn,
           "collectives": coll, "stats": stats, "fingerprint": _fingerprint(ctx, g)}
    del params, g, ref
    if degree is not None and noise and mesh.rank == 0:
        res["noise"] = _noise_floor(ctx, model, M, one, full_batch, degree)
    return res


def _mesh_grad_gates(ctx, label, ranks, names, noise=None) -> dict:
    """5i's gates on gradient-only sub-jobs (``_mesh_grads``): the ranks'
    losses equal; under EXACT f32 the loss and the global gradient norm
    within MESH_EXACT_REL relative and every gradient leaf within
    MESH_EXACT_REL of its largest entry; under axq8 the loss within
    TRAIN_LOSS_ATOL and each leaf (relative Frobenius) within
    TRAIN_NOISE_MULT x the one-rank noise floor plus TRAIN_NOISE_SLACK."""
    r0 = ranks[0]
    out = {}
    for name in names:
        require(all(r["jobs"][name]["loss"] == r0["jobs"][name]["loss"] for r in ranks),
                f"{label} {name}: the ranks' losses differ")
        j = r0["jobs"][name]
        rows = _combine(ranks, name)
        dl = abs(j["loss"] - j["ref_loss"])
        dg = abs(j["grad_norm"] - j["ref_grad_norm"]) / max(j["ref_grad_norm"], 1e-30)
        res = {"loss": j["loss"], "ref_loss": j["ref_loss"], "loss_diff": dl,
               "grad_norm": j["grad_norm"], "ref_grad_norm": j["ref_grad_norm"],
               "grad_norm_rel": dg, "collective_bytes": j["collectives"]["bytes"],
               "collective_calls": j["collectives"]["calls"]}
        if name == "exact":
            worst = max(row[1] for row in rows)
            res["grads_rel_max_worst"] = worst
            require(dl <= MESH_EXACT_REL * max(abs(j["ref_loss"]), 1.0) and dg <= MESH_EXACT_REL,
                    f"{label} {name}: loss {j['loss']} / grad norm {j['grad_norm']} vs one "
                    f"rank {j['ref_loss']} / {j['ref_grad_norm']}")
            require(worst <= MESH_EXACT_REL, f"{label} {name}: a gradient leaf within {worst} "
                                             f"of its largest entry (> {MESH_EXACT_REL})")
            say(f"{label} {name}: loss {j['loss']:.7f} vs one rank {j['ref_loss']:.7f}, grad "
                f"norm {j['grad_norm']:.6f} vs {j['ref_grad_norm']:.6f} (rel {dg:.3g}); every "
                f"gradient leaf within {worst:.3g} of its largest entry; collectives "
                f"{j['collectives']['calls']}")
        else:
            floor = j.get("noise") or noise
            tols = [TRAIN_NOISE_MULT * f + TRAIN_NOISE_SLACK for f in floor]
            worst = max(range(len(rows)), key=lambda i: rows[i][2] / tols[i])
            res.update(grad_rel_worst=rows[worst][2], grad_tol_worst=tols[worst],
                       noise_floor_worst=floor[worst])
            require(dl <= TRAIN_LOSS_ATOL, f"{label} {name}: loss {j['loss']} vs one rank "
                                           f"{j['ref_loss']}")
            require(rows[worst][2] <= tols[worst],
                    f"{label} {name}: gradient leaf {worst} {rows[worst][2]} relative to the "
                    f"one-rank one (tolerance {tols[worst]}, noise floor {floor[worst]})")
            say(f"{label} {name}: loss {j['loss']:.6f} vs one rank {j['ref_loss']:.6f}; "
                f"gradient nearest its tolerance {rows[worst][2]:.3g} (<= {tols[worst]:.3g}, "
                f"noise floor {floor[worst]:.3g})")
        out[name] = res
    return out


def _data_shard_step(model, scfg, start, batch, D, M, degree):
    """The reference's MoE mesh step at D data shards, on one rank: each
    shard's rows (at its own capacity) give the gradient of ``llsum_r /
    ntok_global + 0.01 aux_r / D``, the shards' gradients are summed, and
    ``train_step``'s update follows (the one-rank step on the whole batch
    is not it: capacity and the aux loss are per data shard)."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.train import step as S
    from repro_torch.tree import tree_leaves, tree_unflatten

    rows = next(iter(batch.values())).shape[0] // D
    shards = [{k: v[r * rows:(r + 1) * rows] for k, v in batch.items()} for r in range(D)]
    ntok = sum((b["labels"] >= 0).sum() for b in shards).to(torch.float32)
    total, loss = None, 0.0
    for b in shards:
        leaves = [p.detach().requires_grad_() for p in tree_leaves(start.params)]
        with torch.enable_grad():
            lv, met = model.loss(tree_unflatten(start.params, leaves), b, tp=M, degree=degree,
                                 remat="none")
            obj = (lv - 0.01 * met["aux"]) * (met["ntokens"] / ntok) + 0.01 * met["aux"] / D
            g = torch.autograd.grad(obj, leaves, allow_unused=True)
        loss += float(obj.detach())
        if total is None:
            total = [torch.zeros_like(p) if x is None else x for x, p in zip(g, leaves)]
        else:
            for a, x in zip(total, g):
                if x is not None:
                    a.add_(x)
        del g, leaves, obj
    lr_scale = adamw.cosine_warmup(start.step, warmup=scfg.warmup, total=scfg.total_steps)
    params, opt, met = adamw.update(scfg.optimizer, start.opt, start.params,
                                    tree_unflatten(start.params, total), lr_scale)
    return S.TrainState(params, opt, start.step + 1), {"loss": loss, **met}


def _noise_floor(ctx, model, tp, one, batch, degree) -> list:
    """Each gradient leaf's relative change (Frobenius) when the one-rank
    plain step's projections and attention are perturbed (``_train_noise``,
    5b's measure)."""
    from repro_torch.dist import meshctx
    from repro_torch.train import step as S

    grads = {}
    for route, patch in (("plain", contextlib.nullcontext()), ("noise", _train_noise(ctx))):
        with meshctx.use_mesh(one), _backend("torch"), patch:
            st = S.init_state(model, seed=0, tp=tp)
            (_, _), g = S.value_and_grad(model, st.params, batch, tp=tp, degree=degree,
                                         remat="none")
            grads[route] = [t.float() for t in _leaves(g)]
            del st, g
    return [_leaf_rel(a, b) for a, b in zip(grads["noise"], grads["plain"])]


def _mesh_job(ctx, tag, runs, timeout_s) -> list:
    """``runs`` (each with its ``mesh`` shape, all of one world size) on one
    spawn of ranks (gloo on the one card); [every rank's result] a run."""
    import os

    from repro_torch.dist import meshctx

    world = math.prod(runs[0]["mesh"])
    runs = [dict(r, on_card=ctx["on_card"], block=ctx["tp_block"]) for r in runs]
    # the ranks share the card: let each rank's allocator return what it
    # frees between phases instead of holding fragments of it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.time()
    out = meshctx.spawn_ranks(_mesh_rank, world, timeout_s=timeout_s, backend="gloo",
                              device="cuda" if ctx["on_card"] else "cpu", args=(runs,),
                              threads=0 if ctx["on_card"] else 1)
    meshes = ", ".join(f"{r['mesh'][0]}x{r['mesh'][1]} {r['kind']} ({r['arch']}, "
                       f"{out[0][i]['job_s']:.1f} s)" for i, r in enumerate(runs))
    say(f"phase {tag}: {world} ranks ran {meshes} in {time.time() - t0:.1f} s")
    return [[rank[i] for rank in out] for i in range(len(runs))]


def mesh_collective_calls(cfg, shape, n_leaves, remat="none") -> dict:
    """Collectives of one mesh train step a rank, by kind.  All-reduces: on
    the model axis the embedding's and two a layer forward (wo's partials;
    down's, or the experts' combine; a Mamba-2 layer's gnorm sum of squares
    and out_proj's), the loss's max, sum of exponentials and target logit,
    backward two a dense or hybrid layer (three an MoE layer: the
    dispatched rows' and the gates' cotangents; five a Mamba-2 layer: the
    normed input's dx, gnorm's sum of squares, and the B / C columns'
    gradients of in_proj, the conv taps and the conv bias) and the head's,
    the gradient norm, each hybrid attention block's two kv-head gathers'
    backward, and under remat ``dots`` / ``full`` each dense layer's wo
    reduction again (the recomputation stops at the last tensor the
    backward needs, before the layer's closing reduction: PyTorch's
    non-reentrant checkpoint stops early); on the data axis the token
    count, every gradient leaf and the loss with ce and aux.  All-gathers:
    the hybrid's k and v on each attention block (the kv-split path)."""
    D, M = shape
    L = cfg.n_layers
    out = {}
    if M > 1:
        if cfg.family == "ssm":
            out["all-reduce"] = 7 * L + 6
        elif cfg.family == "hybrid":
            n_attn = L // len(cfg.block_pattern) * cfg.block_pattern.count("attn")
            out["all-reduce"] = 4 * L + 2 * n_attn + 6
            out["all-gather"] = 2 * n_attn
        else:
            out["all-reduce"] = (4 + bool(cfg.moe)) * L + 6 + (0 if remat == "none" else L)
    if D > 1:
        out["all-reduce"] = out.get("all-reduce", 0) + n_leaves + 2
    return out


def _mesh_path_gates(ctx, label, cfg, shape, ranks) -> dict:
    """5g / 5h gates on the ranks' results: finite losses equal bit for bit
    on every rank, the degree moving, the replicated leaves' fingerprints
    equal on every rank (5h: every leaf, every step), launches a step a
    rank as 5a's at the shard shapes with no plain version on the card, the
    backward oracles as many, the collectives of every step as predicted;
    prints a line a rank and the step's numbers."""
    D, M = shape
    r0 = ranks[0]
    n = len(r0["history"])
    losses = [h["loss"] for h in r0["history"]]
    require(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    require(all([h["loss"] for h in r["history"]] == losses for r in ranks),
            f"{label}: the ranks' losses differ")
    degrees = [h["degree"] for h in r0["history"]]
    require(len(set(degrees)) > 1 or not ctx["on_card"],
            f"{label}: the QoS degree never moved: {degrees}")
    for i, fp in enumerate(r0["fingerprints"]):
        for r in ranks:
            same = [a == b for a, b in zip(r["fingerprints"][i], fp)]
            want = [True] * len(fp) if (D > 1 and r["coord"]["model"] == 0) else \
                [not s for s in r0["sharded"]]
            require(all(s for s, w in zip(same, want) if w),
                    f"{label}: rank {r['rank']}'s parameters differ from rank 0's after "
                    f"step {i if len(r0['fingerprints']) == n else n - 1}")
    remat = r0["remat"]
    want = {k: v * n for k, v in train_launches(cfg, remat).items()}
    bwd_want = {k: v * n for k, v in train_backwards(cfg).items()}
    calls = mesh_collective_calls(cfg, shape, r0["n_leaves"], remat)
    for r in ranks:
        check_launches(ctx, f"{label} rank {r['rank']}", r, want)
        require(not ctx["on_card"] or r["flash_schedules"]["tri"] == want["flash_attention"],
                f"{label}: flash schedules {r['flash_schedules']}")
        require(r["backward_calls"] == bwd_want,
                f"{label}: backward oracles {r['backward_calls']}, expected {bwd_want}")
        for h in r["history"]:
            got = h["collectives"]["calls"]
            require({k: got.get(k, 0) for k in calls} == calls and set(got) <= set(calls),
                    f"{label} rank {r['rank']} step {h['step']}: collectives {got}, "
                    f"expected {calls}")
    steady = [h["s"] for h in r0["history"][1:]] or [r0["history"][0]["s"]]
    step_s = sum(steady) / len(steady)
    tokens = r0["history"][0]["ntokens"]
    coll = [h["collectives"] for h in r0["history"][1:]] or [r0["history"][0]["collectives"]]
    per = {"host_ms": sum(c["host_ms"] for c in coll) / len(coll),
           "wait_ms": sum(c["wait_ms"] for c in coll) / len(coll),
           "bytes": {k: sum(c["bytes"].get(k, 0) for c in coll) / len(coll)
                     for k in coll[0]["bytes"]},
           "calls": coll[0]["calls"]}
    out = {"mesh": list(shape), "steps": n, "remat": remat, "history": r0["history"],
           "step_s_mean": step_s, "peak_after_init_bytes": [r.get("peak_after_init_bytes")
                                                            for r in ranks],
           "tokens_per_s": tokens / step_s, "collectives_per_step": per,
           "gloo_gb_per_s": per["bytes"].get("all-reduce", 0) / (per["host_ms"] * 1e-3) / 1e9
           if per["host_ms"] else None,
           "peak_memory_bytes": [r.get("peak_memory_bytes") for r in ranks],
           "oracle_ms_last_step": r0["oracle_ms"],
           "oracle_share_last_step": sum(r0["oracle_ms"].values()) / 1e3 / r0["history"][-1]["s"]
           if r0["oracle_ms"] else None,
           "launches_per_step": {k: v / n for k, v in r0["launches"].items() if v},
           "param_count": r0["param_count"], "transport": r0["transport"],
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}}
    say(f"{label} ({cfg.name}, {cfg.n_layers} layers, mesh {shape[0]}x{shape[1]}, "
        f"{int(tokens)} tokens a step, axq8, remat {remat}): losses {[round(v, 4) for v in losses]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in r0['history']]}, degrees {degrees}")
    say(f"{label}: step {step_s:.4f} s mean over steps 1-{n - 1}, {out['tokens_per_s']:.1f} "
        f"tokens/s, peak memory a rank {out['peak_memory_bytes']} B (after the state's "
        f"init {out['peak_after_init_bytes']} B); collectives a step "
        f"(rank 0): host {per['host_ms']:.1f} ms in them after {per['wait_ms']:.1f} ms "
        f"waiting for the queued kernels, bytes {per['bytes']}, calls {per['calls']}, "
        f"{out['gloo_gb_per_s']} GB/s all-reduce operand bytes over host time; backward "
        f"oracles in the last step {out['oracle_ms_last_step']} ms = "
        f"{out['oracle_share_last_step']} of it; launches a step a rank "
        f"{out['launches_per_step']} (predicted {train_launches(cfg, remat)}); collectives "
        f"{calls} a step predicted; transport {r0['transport']}")
    return out


def phase_train_mesh(ctx, cfg, moe_cfg, ssm_cfg, rg_cfg) -> dict:
    """5g: tinyllama-1.1b at full width and depth at 1x2 (two ranks on the
    one card through gloo, each 16 of the 32 heads and half the MLP and
    vocab), axq8 with the ladder 8 -> 5 stepping each step, the global
    batch of 8 x 1024 on both ranks, 3 steps.  5h: the same at 2x1 (each
    rank the full weights and 4 x 1024 of the rows), the parameters of both
    ranks compared after every step and the gradient all-reduce bytes equal
    to 4 x the parameter count.  5k: granite-moe-3b-a800m (``moe_cfg``) at
    full width at 1x2 (20 of the 40 experts and 12 / 4 of the 24 / 8 heads
    a rank, the router replicated), axq8 with the ladder, the pipeline's
    global batch on both ranks, remat full (the state alone of the full
    depth, p / g / mu / nu in f32, is ~27 GB a rank),
    ``ctx["moe_mesh_shape"]``'s steps: 5g's gates with the MoE's launches
    (the expert-batched kernels a layer a rank) and collectives.  5l:
    mamba2-370m (``ssm_cfg``, its depth cut) and 5m: recurrentgemma-2b
    (``rg_cfg``, cut for memory: AdamW's functional update holds ~32 B a
    parameter, and its two 655 M-parameter embeddings alone ~21 GB a rank)
    at full width at 1x2 (16 of the 32 SSD heads, or half the RG-LRU
    channels and 5 of the 10 query heads over MQA's one kv head, a rank),
    axq8 with the ladder, the pipeline's global batch of
    ``ctx["rec_mesh_shape"]`` on both ranks, remat none: 5g's gates with
    the families' launches and collectives (``train_launches``,
    ``mesh_collective_calls``).  The five run in one spawn of two ranks,
    one after another."""
    T, n = ctx["train_seq"], ctx["mesh_train_steps"]
    common = {"kind": "path", "arch": cfg.name, "approx": "axq8", "seq": T, "steps": n}
    B, Tk, nk = ctx["moe_mesh_shape"]
    Br, Tr, nr = ctx["rec_mesh_shape"]
    rec = lambda c: {"kind": "path", "arch": c.name, "approx": "axq8", "n_layers": c.n_layers,
                     "seq": Tr, "steps": nr, "mesh": (1, TP), "batch": Br}
    cases = (("5g", cfg, dict(common, mesh=(1, TP), batch=ctx["mesh_train_batch"],
                              dryrun=True)),
             ("5h", cfg, dict(common, mesh=(TP, 1), batch=TP * ctx["mesh_dp_rows"],
                              every_step=True)),
             ("5k", moe_cfg, {"kind": "path", "arch": moe_cfg.name, "approx": "axq8",
                              "n_layers": moe_cfg.n_layers, "seq": Tk, "steps": nk,
                              "mesh": (1, TP), "batch": B, "remat": ctx["moe_mesh_remat"]}),
             ("5l", ssm_cfg, rec(ssm_cfg)), ("5m", rg_cfg, rec(rg_cfg)))
    results = _mesh_job(ctx, "5g / 5h / 5k / 5l / 5m", [job for _, _, job in cases],
                        ctx["mesh_timeout_s"])
    out = {}
    for (tag, c, job), ranks in zip(cases, results):
        shape = job["mesh"]
        res = _mesh_path_gates(ctx, f"phase {tag}", c, shape, ranks)
        if job.get("dryrun"):
            res["dryrun"] = _dryrun_gate(f"phase {tag}", ranks)
        if shape[0] > 1:
            # less the token count's 4 bytes and the loss / ce / aux's 12
            grad = res["collectives_per_step"]["bytes"]["all-reduce"] - 16
            require(grad == 4 * res["param_count"],
                    f"phase {tag}: gradient all-reduce bytes {grad} a step, expected 4 x "
                    f"{res['param_count']} parameters")
        res["seen"] = {"launches": res["launches"]}
        out[tag] = res
    return out


def dp_serve_runs(ctx, cfg, prompts) -> list:
    """3w's and 3x's runs for 5i's four-rank spawn: tinyllama-1.1b at full
    width, ``depth_cuts`` of its layers, axq8 (block ``tp_block``), phase
    3's slots and new tokens; 3w phase 3's prompts, 3x half of them."""
    common = {"arch": cfg.name, "approx": "axq8", "block": ctx["tp_block"],
              "slots": ctx["slots"], "max_len": ctx["max_len"], "prompts": prompts,
              "new_tokens": ctx["new_tokens"]}
    w = dict(common, kind="dp_serve", mesh=DP, n_layers=depth_cut(ctx, "3w", cfg).n_layers,
             runs=[{"name": "bf16", "quant": False},
                   {"name": "int8", "quant": True, "buckets": ctx["rec_buckets"], "pack": 4}])
    # 3x serves its traffic three times: half of 3w's prompts (the time limit)
    x = dict(common, kind="fleet", mesh=(2, TP), n_layers=depth_cut(ctx, "3x", cfg).n_layers,
             replicas=2, loss=ctx["fleet_loss"], seed=ctx["fleet_seed"],
             prompts=prompts[:len(prompts) // 2])
    return [w, x]


def _one_rank_gate(label, ranks, name) -> dict:
    """3w against one rank: a request's tokens equal until its first
    differing token, which must be a near-tie: the one-rank engine's
    margin of its token over the 2x2 run's, on the same inputs (the
    history is equal up to it), at most twice the largest distance of the
    two runs' largest logits over every step compared before (tp = 2 sums
    the row-parallel partials in another f32 order than one rank, and AXQ
    moves an int8 code with a rounding: the distance is measured, not
    assumed; ROADMAP §C).  The request's comparison ends there."""
    mine: dict = {}
    for r in ranks:
        if r["coord"]["model"] == 0:
            mine.update(r["runs"][name]["tops"])
    r0 = ranks[0]["runs"][name]
    one = r0["one_rank"]
    rids = sorted(one["streams"])
    compared, differ, delta = 0, [], 0.0
    for rid, a in zip(rids, r0["streams"]):
        for t, (x, y) in enumerate(zip(a, one["streams"][rid])):
            top, at_mine = one["tops"][(rid, t)]
            if x != y:
                differ.append((rid, t, top - at_mine))
                break
            delta = max(delta, abs(mine[(rid, t)][0] - top))
            compared += 1
    for rid, t, margin in differ:
        require(margin <= 2 * delta, f"{label}: request {rid} token {t} differs from one "
                                     f"rank's at a margin {margin} (> twice the largest-logit "
                                     f"distance {delta} on equal inputs): not a near-tie")
    return {"compared": compared, "tokens": sum(len(a) for a in r0["streams"]),
            "differ_at": differ, "delta": delta}


def phase_dp_serve(ctx, cfg, w_ranks, x_ranks) -> tuple:
    """3w / 3x gates on the ranks' results (:func:`dp_serve_runs`).

    3w, tinyllama-1.1b at 2x2 (four ranks on the card through gloo, each 4
    of the 8 slots and half the heads): every request ok; the four ranks'
    streams equal; each rank's launches as the layer count predicts on its
    rows — a decode step's (5L + 1) GEMMs, L gated GEMMs and L decode
    kernels on every rank, a prefill's on the ranks of its rows' data
    coordinate (5L + 1 GEMMs exact, 5L bucketed) — and its collectives: the model group's all-reduces (2L +
    1 a step or prefill), the logits' all-gather over ``model`` and the
    tokens' over ``data`` (two a step); no plain version on the card; the
    tokens equal one rank's on the same weights up to near-ties
    (:func:`_one_rank_gate`), which end a request's comparison.

    3x, 2 replicas x tp=2 on the four ranks (disjoint slices), seeded
    ``replica_loss`` on a VirtualClock, twice: every request ends once and
    ok; the ok streams equal a clean engine's on replica 0's ranks; the two
    runs give one recovery trace; the last rescale reads data=1, model=2;
    each rank's launches as its member replicas' decode steps and
    prefills predict."""
    L_w = depth_cut(ctx, "3w", cfg).n_layers
    out_w = {"runs": {}}
    for name in ("bf16", "int8"):
        label = f"phase 3w {name}"
        rs = [r["runs"][name] for r in w_ranks]
        r0 = rs[0]
        require(all(r["statuses"] == ["ok"] for r in rs), f"{label}: a request not ok")
        require(all(r["streams"] == r0["streams"] for r in rs),
                f"{label}: the ranks' token streams differ")
        require(all(r["rows"] == ctx["slots"] // DP[0] for r in rs),
                f"{label}: a rank's cache rows {[r['rows'] for r in rs]}")
        quant = name == "int8"
        for rank, r in zip(w_ranks, rs):
            st, pf, pb = r["steps"], r["prefills"], r["forwards"]["prefill_batch"]
            # a bucketed call computes no logits (5 L GEMMs), an exact one
            # its last token's (5 L + 1)
            expect = {"axqmm": (5 * L_w + 1) * (st + pf) - pb, "axqmm_gated": L_w * (st + pf),
                      "flash_decode": 0 if quant else L_w * st,
                      "flash_decode_quant": L_w * st if quant else 0,
                      "flash_attention": L_w * pf, "pr_multiply": 0, "pr_fir": 0,
                      "pr_conv2d": 0}
            check_launches(ctx, f"{label} rank {rank['rank']} {rank['coord']}", r, expect)
            want = {"all-reduce": (2 * L_w + 1) * (st + pf), "all-gather": 2 * st}
            calls = r["collectives"]["calls"]
            require(calls == want, f"{label} rank {rank['rank']}: collectives {calls}, "
                                   f"expected {want} ({st} steps, {pf} prefills)")
            say(f"{label} rank {rank['rank']} {rank['coord']}: {r['ticks']} ticks, decode "
                f"tick {r['decode_tick_ms_mean']:.3f} ms over {r['decode_ticks_timed']} ticks, "
                f"{r['gen_tok_per_s']:.1f} tok/s, TTFT p50 {r['ttft_p50_ms']} ms p95 "
                f"{r['ttft_p95_ms']} ms, peak memory {r['max_memory_allocated']}, "
                f"{r['prefills']} prefills here ({r['forwards']}), rungs {r['rungs']}")
        one = _one_rank_gate(label, w_ranks, name)
        require(r0["one_rank"]["statuses"] == ["ok"], f"{label}: one rank: a request not ok")
        n = max(r0["steps"], 1)
        coll = r0["collectives"]
        per = {"host_ms_per_tick": coll["host_ms"] / n, "wait_ms_per_tick": coll["wait_ms"] / n,
               "bytes_per_tick": {k: v / n for k, v in coll["bytes"].items()},
               "calls_per_tick": {k: v / n for k, v in coll["calls"].items()}}
        say(f"{label}: {one['compared']} of {one['tokens']} tokens equal one rank's before "
            f"a near-tie ended a request's comparison ({len(one['differ_at'])} near-ties: "
            f"{one['differ_at']}; the largest logit {one['delta']:.4g} apart at most on equal "
            f"inputs); collectives per decode step (prefills included) on rank 0: "
            f"host {per['host_ms_per_tick']:.3f} ms after {per['wait_ms_per_tick']:.3f} ms "
            f"waiting, bytes {per['bytes_per_tick']}, calls {per['calls_per_tick']}; "
            f"transport {w_ranks[0]['transport']}")
        out_w["runs"][name] = {"ranks": [{k: v for k, v in r.items()
                                          if k not in ("streams", "tops", "one_rank")}
                                         for r in rs], "collectives_per_tick": per,
                               "one_rank": one}
    out_w["seen"] = {"launches": sum_launches([r["launches"] for w in w_ranks
                                               for r in w["runs"].values()])}

    L_x = depth_cut(ctx, "3x", cfg).n_layers
    label = "phase 3x"
    x0 = x_ranks[0]
    first, again = x0["runs"]
    n_req = len(first["submitted"])
    require(first["ranks"] == [[0, 1], [2, 3]], f"{label}: replica slices {first['ranks']}")
    for xr in x_ranks:
        for run in xr["runs"]:
            require(run["resil_log"] == first["resil_log"] and run["done"] == first["done"],
                    f"{label} rank {xr['rank']}: a recovery trace or a stream differs")
    require(sorted(r[0] for r in first["done"]) == sorted(first["submitted"]),
            f"{label}: requests did not end exactly once")
    require(all(st == "ok" for _, st, _ in first["done"]), f"{label}: a request not ok")
    for rid, _, toks in first["done"]:
        require(toks == x0["clean"][rid], f"{label}: request {rid}'s tokens differ from a "
                                          "clean engine's")
    require(any(n == "replica_lost" for _, n, _ in first["resil_log"]),
            f"{label}: no replica was lost")
    require(first["rescale"] is not None and (first["rescale"]["data"],
                                              first["rescale"]["model"]) == (1, TP),
            f"{label}: last rescale {first['rescale']}")
    runs = []
    for xr in x_ranks:
        for i, run in enumerate(xr["runs"]):
            st, pf = run["steps"], run["prefills"]
            expect = {"axqmm": (5 * L_x + 1) * (st + pf), "axqmm_gated": L_x * (st + pf),
                      "flash_decode": L_x * st, "flash_decode_quant": 0,
                      "flash_attention": L_x * pf, "pr_multiply": 0, "pr_fir": 0,
                      "pr_conv2d": 0}
            check_launches(ctx, f"{label} run {i + 1} rank {xr['rank']} (replicas "
                                f"{run['members']})", run, expect)
            n = max(run["ticks"], 1)
            coll = run["collectives"]
            say(f"{label} run {i + 1} rank {xr['rank']}: {run['ticks']} fleet ticks in "
                f"{run['wall_s']:.3f} s ({1e3 * run['wall_s'] / n:.3f} ms a tick), "
                f"{run['gen_tok_per_s']:.1f} tok/s, TTFT p50 {run['ttft_p50_ms']} ms p95 "
                f"{run['ttft_p95_ms']} ms, peak memory {run['max_memory_allocated']}; "
                f"collectives a fleet tick: calls "
                f"{ {k: v / n for k, v in coll['calls'].items()} } bytes "
                f"{ {k: v / n for k, v in coll['bytes'].items()} } host "
                f"{coll['host_ms'] / n:.3f} ms")
            runs.append({k: v for k, v in run.items() if k not in ("done", "resil_log")})
    events: dict = {}
    for _, name, _ in first["resil_log"]:
        events[name] = events.get(name, 0) + 1
    say(f"{label}: {n_req} requests ended once, all ok, tokens == a clean engine's; one "
        f"recovery trace in both runs ({events}); last rescale {first['rescale']}")
    out_x = {"runs": runs, "events": events, "rescale": first["rescale"],
             "seen": {"launches": sum_launches([r["launches"] for xr in x_ranks
                                                for r in xr["runs"]])}}
    return out_w, out_x


#: 5i: a mesh step against the one-rank step under EXACT f32 (params, mu
#: and nu within MESH_EXACT_REL of each leaf's largest entry, the loss and
#: the gradient norm relative); a compressed step's mu and nu within one
#: int8 quantum of the leaf's largest entry (a gradient summed in another
#: order can round to the next code) plus MESH_EXACT_REL, its parameters
#: within Adam's step bound, 2 lr (a moved code moves the update by up to
#: lr: 1.5e-4 against a leaf's largest entry of 0.0268); the ring's gradient
#: (mu, all leaves as one vector) within MESH_RING_REL (Frobenius) of the
#: exact mesh step's.  The ring quantizes each column projection's dx
#: partial (2 x 1024 rows x 2048, heavy-tailed) against one amax a chunk,
#: as the reference's ``_ring_dx_matmul`` does: the reference's own ring
#: step sits 0.1653 from its exact step at this shape
#: (``tools/ring_grad_ref.py``, JAX on the CPU), so the bound is that
#: envelope with room, not the 0.05 of 3s's forward logits (ROADMAP §C)
MESH_EXACT_REL = 1e-4
MESH_RING_REL = 0.25
#: a clipped gradient entry below this (1000 x AdamW's eps) is
#: ill-conditioned for a parity check of Adam's first update, lr * g /
#: (|g| + eps): held within 2 lr of the start on both sides instead
#: (tests/test_torch_frontends.py's rule, ROADMAP §C)
ILL_GRAD = 1e-5


def _combine(ranks, name, key="stats") -> list:
    """Per leaf of params / mu / nu: (field, max |diff| / max |ref|,
    Frobenius |diff| / |ref|, the ill-conditioned entries' largest move,
    max |diff|), a sharded leaf's numbers combined over the model ranks of
    data coordinate 0."""
    first = [r for r in ranks if r["coord"]["data"] == 0]
    rows = []
    for i, st in enumerate(first[0]["jobs"][name][key]):
        field, sharded = st[0], st[6]
        parts = [r["jobs"][name][key][i] for r in first] if sharded else [st]
        md, mr = max(p[1] for p in parts), max(p[2] for p in parts)
        sd, sr = sum(p[3] for p in parts), sum(p[4] for p in parts)
        rows.append((field, 0.0 if md == 0 else md / max(mr, 1e-30),
                     0.0 if sd == 0 else math.sqrt(sd / max(sr, 1e-30)),
                     max(p[5] for p in parts), md))
    return rows


def _combine_sums(ranks, name, key, field) -> tuple:
    """(sum of squared diffs, sum of squared refs) of every ``field`` leaf,
    each sharded leaf's over the model ranks of data coordinate 0."""
    first = [r for r in ranks if r["coord"]["data"] == 0]
    sd = sr = 0.0
    for i, st in enumerate(first[0]["jobs"][name][key]):
        if st[0] != field:
            continue
        parts = [r["jobs"][name][key][i] for r in first] if st[6] else [st]
        sd += sum(p[3] for p in parts)
        sr += sum(p[4] for p in parts)
    return sd, sr


def _mesh_cut_gates(ctx, label, shape, ranks, names, noise=None) -> dict:
    """5i's gates on one mesh's sub-jobs (module constants above); the
    data ranks' states bit-identical; prints a line a sub-job.  ``noise``:
    the one-rank noise floor, where the ranks did not measure it."""
    r0 = ranks[0]
    out = {}
    lr = 2 * 3e-4
    for r in ranks:
        for name in names:
            peers = [q for q in ranks if q["coord"]["model"] == r["coord"]["model"]]
            require(all(q["jobs"][name]["fingerprint"] == r["jobs"][name]["fingerprint"]
                        for q in peers), f"{label} {name}: the data ranks' states differ")
            require(r["jobs"][name]["loss"] == r0["jobs"][name]["loss"],
                    f"{label} {name}: the ranks' losses differ")
    for name in names:
        j = r0["jobs"][name]
        rows = _combine(ranks, name)
        dl = abs(j["loss"] - j["ref_loss"])
        dg = abs(j["grad_norm"] - j["ref_grad_norm"]) / max(j["ref_grad_norm"], 1e-30)
        move = max(row[3] for row in rows)
        res = {"loss": j["loss"], "ref_loss": j["ref_loss"], "loss_diff": dl,
               "grad_norm_rel": dg, "ill_move_max": move,
               "collective_bytes": j["collectives"]["bytes"]}
        require(move <= lr or name == "ring",
                f"{label} {name}: an ill-conditioned entry moved {move} (> 2 lr)")
        if name == "axq8":
            floor = j.get("noise") or noise
            mu = [row for row in rows if row[0] == "mu"]
            tols = [TRAIN_NOISE_MULT * f + TRAIN_NOISE_SLACK for f in floor]
            worst = max(range(len(mu)), key=lambda i: mu[i][2] / tols[i])
            pdiff = max(row[1] for row in rows if row[0] == "params")
            pabs = max(row[4] for row in rows if row[0] == "params")
            res.update(grad_rel_worst=mu[worst][2], grad_tol_worst=tols[worst],
                       noise_floor_worst=floor[worst], params_rel_max=pdiff,
                       params_max_abs_diff=pabs)
            require(pabs <= lr, f"{label} {name}: params differ by {pabs} (> 2 lr, 5b's bound)")
            require(dl <= TRAIN_LOSS_ATOL, f"{label} {name}: loss {j['loss']} vs one rank "
                                           f"{j['ref_loss']}")
            require(mu[worst][2] <= tols[worst],
                    f"{label} {name}: gradient leaf {worst} {mu[worst][2]} relative to the "
                    f"one-rank step's (tolerance {tols[worst]}, noise floor {floor[worst]})")
            say(f"{label} {name}: loss {j['loss']:.6f} vs one rank {j['ref_loss']:.6f}; "
                f"gradient nearest its tolerance {mu[worst][2]:.3g} (<= {tols[worst]:.3g}, "
                f"noise floor {floor[worst]:.3g}); params within {pdiff:.3g} of each leaf's "
                f"largest entry; ill-conditioned entries moved <= {move:.3g}")
        elif name != "ring":                 # the ring is held to the exact mesh step
            tol = MESH_EXACT_REL + (1 / 127 if name == "compress" else 0.0)
            worst = max(rows, key=lambda row: row[1] / (tol if row[0] == "mu" else
                                                        MESH_EXACT_REL))
            res.update(rel_max_worst=worst[1], rel_max_worst_field=worst[0],
                       rel_max_by_field={f: max(row[1] for row in rows if row[0] == f)
                                         for f in ("params", "mu", "nu")})
            require(dl <= MESH_EXACT_REL * max(abs(j["ref_loss"]), 1.0) and dg <= MESH_EXACT_REL,
                    f"{label} {name}: loss {j['loss']} / grad norm {j['grad_norm']} vs one "
                    f"rank {j['ref_loss']} / {j['ref_grad_norm']}")
            for field in ("params", "mu", "nu"):
                if field == "params" and name == "compress":
                    # a gradient code that moves by one moves Adam's first
                    # update by up to lr: the step bound, as 5b holds it
                    m = max(row[4] for row in rows if row[0] == "params")
                    res["params_max_abs_diff"] = m
                    require(m <= lr, f"{label} {name}: params differ by {m} (> 2 lr)")
                    continue
                # nu is g^2: a moved code moves it by up to 2 quanta of amax
                t = ((2 if field == "nu" else 1) * (tol - MESH_EXACT_REL) + MESH_EXACT_REL
                     if name == "compress" else MESH_EXACT_REL)
                m = res["rel_max_by_field"][field]
                require(m <= t, f"{label} {name}: {field} within {m} of a leaf's largest "
                                f"entry (> {t})")
            say(f"{label} {name}: loss {j['loss']:.7f} vs one rank {j['ref_loss']:.7f}, grad "
                f"norm rel {dg:.3g}; largest difference over each leaf's largest entry "
                f"{res['rel_max_by_field']}; ill-conditioned entries moved <= {move:.3g}; "
                f"collective bytes {j['collectives']['bytes']}")
        if name == "ring":
            # the gradient (mu) as one vector: its relative Frobenius distance
            # from the exact mesh step's; the worst leaf and the loss (the
            # forward's row-parallel partials ride the ring too) beside it
            ring = [row for row in _combine(ranks, name, "vs_exact_mesh") if row[0] == "mu"]
            sq = _combine_sums(ranks, name, "vs_exact_mesh", "mu")
            rel = math.sqrt(sq[0] / max(sq[1], 1e-30))
            eb = r0["jobs"]["exact"]["collectives"]["total"]
            rb = j["collectives"]["total"]
            res.update(ring_grad_rel=rel, ring_grad_rel_worst_leaf=max(r[2] for r in ring),
                       ring_bytes=rb, exact_bytes=eb, ring_over_exact_bytes=rb / eb,
                       ring_loss_diff=abs(j["loss"] - r0["jobs"]["exact"]["loss"]))
            say(f"{label} ring: the gradient within rel {rel:.4g} of the exact mesh step's "
                f"(<= {MESH_RING_REL}; worst leaf {res['ring_grad_rel_worst_leaf']:.4g}); loss "
                f"{j['loss']:.6f} vs {r0['jobs']['exact']['loss']:.6f} exact; step bytes {rb} "
                f"vs {eb} exact ({rb / eb:.3f}x)")
            require(math.isfinite(j["loss"]), f"{label} ring: loss {j['loss']}")
            require(0 < rel <= MESH_RING_REL, f"{label} ring: gradients rel {rel}")
            require(rb <= 0.5 * eb, f"{label} ring: {rb} bytes, more than half of {eb}")
        out[name] = res
    return out


def phase_train_mesh_cut(ctx, cfg, moe_cfg, vlm_cfg, audio_cfg, ssm_cfg, rg_cfg,
                         serve_runs=(), diagnosis_only=False) -> tuple:
    """5i: tinyllama-1.1b cut to 2 layers at full width, one train step at
    1x2, 2x1 and 2x2 (four ranks) from the seeded state on one batch,
    each rank's shards held to the same step on one rank (computed in each
    rank's process): EXACT in f32 and axq8 everywhere, the int8-ring lever
    under EXACT f32 at 1x2 (held to the exact mesh step) and
    --compress-grads (EXACT f32) at 2x1.  granite-moe-3b-a800m at 2 layers
    the same at 1x2, 2x1 and 2x2 (EXACT f32 and axq8; at 1x2 its axq8 one
    rank on the plain versions: the kernel route's step against the plain
    route's, at the noise floor), held at 2x1 / 2x2 to the reference's mesh
    semantics computed on one rank (``_data_shard_step``); internvl2-1b
    and hubert-xlarge at 2 layers at 1x2 under EXACT f32; mamba2-370m at 2
    layers at 1x2 and 2x1 (EXACT f32 and axq8, whole steps); and
    recurrentgemma-2b at one (rec, rec, attn) group at 1x2, its gradients
    alone (``_mesh_grads``: its one-rank state does not fit twice a rank
    beside the other rank's on the card, and at 2x1 each rank would hold
    one).  mamba2-370m's exact 2x1 step also reports where it parts from
    one rank (``_diagnose``; ``diagnosis_only``: that run alone).
    ``serve_runs`` (3w / 3x) join the four-rank spawn after 5i's runs;
    returns (5i's gates, their results)."""
    import numpy as np

    from repro_torch.data.pipeline import make_pipeline

    B, T = ctx["mesh_cut_shape"]
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, T + 1))
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    f32 = {"dtype": "float32"}
    exact, axq8 = dict(name="exact", approx="exact", **f32), dict(name="axq8", approx="axq8")
    subs = {(1, 2): [exact, axq8, dict(name="ring", approx="exact", ring=True, **f32)],
            (2, 1): [exact, axq8, dict(name="compress", approx="exact", compress=True, **f32)],
            (2, 2): [exact, axq8]}
    moe_subs = {(1, 2): [exact, dict(axq8, ref_plain=True)], (2, 1): [exact, axq8],
                (2, 2): [exact, axq8]}

    def run(c, shape, subs_, b, n_layers=2):
        return {"kind": "cut", "arch": c.name, "n_layers": n_layers, "batch": b,
                "mesh": shape, "subs": subs_}

    grads = [dict(exact, grads_only=True), dict(axq8, grads_only=True)]

    fe = {c.name: make_pipeline(c, seq_len=s, global_batch=B).batch_at(0)
          for c, s in ((vlm_cfg, ctx["mesh_cut_vlm_seq"]), (audio_cfg, T))}
    # two ranks run 1x2 then 2x1 of each arch, four ranks 2x2; the noise
    # floor is each arch's one-rank model's, measured by rank 0 of its
    # first run
    groups = [[run(cfg, (1, 2), subs[(1, 2)], batch), run(cfg, (2, 1), subs[(2, 1)], batch),
               run(moe_cfg, (1, 2), moe_subs[(1, 2)], batch),
               run(moe_cfg, (2, 1), moe_subs[(2, 1)], batch),
               run(vlm_cfg, (1, 2), [exact], fe[vlm_cfg.name]),
               run(audio_cfg, (1, 2), [exact], fe[audio_cfg.name]),
               run(ssm_cfg, (1, 2), [exact, axq8], batch),
               run(ssm_cfg, (2, 1), [dict(exact, diagnose=True), axq8], batch),
               run(rg_cfg, (1, 2), grads, batch, len(rg_cfg.block_pattern))],
              [run(cfg, (2, 2), subs[(2, 2)], batch), run(moe_cfg, (2, 2), moe_subs[(2, 2)], batch)]
              + list(serve_runs)]
    if diagnosis_only:
        groups = [[run(ssm_cfg, (2, 1), [dict(exact, diagnose=True)], batch)]]
    out, noise, extra = {}, {}, []
    for runs in groups:
        results = _mesh_job(ctx, "5i / 3w / 3x" if any(r["kind"] != "cut" for r in runs)
                            else "5i",
                            [dict(r, noise=dict(noise)) for r in runs], ctx["mesh_timeout_s"])
        for r, ranks in zip(runs, results):
            if r["kind"] != "cut":
                extra.append(ranks)
                continue
            arch, shape = r["arch"], r["mesh"]
            if "axq8" in ranks[0]["jobs"] and noise.get(arch) is None:
                noise[arch] = ranks[0]["jobs"]["axq8"]["noise"]
            tag = f"{shape[0]}x{shape[1]}"
            key = tag if arch == cfg.name else f"{arch} {tag}"
            names = [sub["name"] for sub in r["subs"]]
            if r["subs"][0].get("grads_only"):
                out[key] = _mesh_grad_gates(ctx, f"phase 5i {key}", ranks, names,
                                            noise.get(arch))
            else:
                out[key] = _mesh_cut_gates(ctx, f"phase 5i {key}", shape, ranks, names,
                                           noise.get(arch))
            if "diagnosis" in ranks[0]["jobs"].get("exact", {}):
                out[key]["diagnosis"] = _diagnosis_lines(f"phase 5i {key}", ranks)
    return out, extra


#: the launcher run by phase 5j (written to a file: the spawned ranks run
#: it as their main module, so each registers the 2-layer arch and the
#: restore check: each rank's restored shards equal to its slices of the
#: saved arrays, which the restore verified against the manifest's
#: digests); prints rank 0's result as JSON
MESH_TRAIN_WRAPPER = r"""
import dataclasses, hashlib, json, sys
from repro_torch.configs import base, get_config
arch = sys.argv[1]
base.register(dataclasses.replace(get_config(arch), name=arch + "-2l", n_layers=2))
import numpy as np
import torch
from repro_torch.dist import sharding
from repro_torch.train import trainer as T
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten
orig_init, orig_run = T.Trainer.init_or_restore, T.Trainer.run
def init_or_restore(self, seed=0):
    # each rank's restored shards against its slices of the saved arrays
    state, start = orig_init(self, seed)
    if start:
        d = self.ckpt.dir / f"step_{start:010d}"
        man = json.loads((d / "manifest.json").read_text())
        saved = tree_unflatten(state, [torch.from_numpy(np.load(d / man["arrays"][n]["file"]))
                                       for n, _ in named_leaves(state)])
        if self.mesh:
            saved = sharding.shard_train_state(saved, self.mesh)
        self._check = {"restored_step": start, "restored_equal": all(
            torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(state), tree_leaves(saved)))}
    return state, start
def run(self, seed=0):
    out = orig_run(self, seed)
    out.update(getattr(self, "_check", {}))
    return out
T.Trainer.init_or_restore, T.Trainer.run = init_or_restore, run
if __name__ == "__main__":
    from repro_torch.launch import train as L
    out = L.main(["--arch", arch + "-2l"] + sys.argv[2:])
    print("TRAIN_RESULT " + json.dumps({k: out.get(k) for k in (
        "final_step", "preempted", "restored_step", "restored_equal",
        "collective_bytes_per_step", "collective_host_ms_per_step")} | {
        "losses": [h["loss"] for h in out["history"]],
        "steps": [h["step"] for h in out["history"]]}), flush=True)
"""


def phase_train_mesh_launch(ctx, cfg, label="phase 5j", restore_1x1=True) -> dict:
    """5j: ``launch.train --mesh 1x2 --dist-backend gloo`` at full width and
    2 layers, axq8 (EXACT in the rehearsal, whose block would cut the
    smoke's shards) --compress-grads: uninterrupted; SIGTERM'd (the launcher
    passes the signal to its ranks, which checkpoint at one step: gathered,
    rank 0 writes); resumed (every rank's restored shards gathered equal to
    the manifest's digests), the losses within TRAIN_RESUME_ATOL of the
    uninterrupted run's.  Then the 1x2 checkpoint restored at 1x1 by the
    one-device trainer, its device state's bytes equal to the digests of
    the gathered state rank 0 wrote."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.train import step as S
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import named_leaves

    B, T, n = ctx["mesh_launch_shape"]
    tmp = Path(tempfile.mkdtemp(prefix="smoke_mesh_train_", dir=HERE / "build"
                                if (HERE / "build").is_dir() else None))
    wrapper = tmp / "mesh_train.py"
    wrapper.write_text(MESH_TRAIN_WRAPPER)
    dev = ["--device", "cuda" if ctx["on_card"] else "cpu"]
    common = ["--steps", str(n), "--seq", str(T), "--batch", str(B), "--mesh", f"1x{TP}",
              "--dist-backend", "gloo", "--approx", ctx["tp_launch_approx"], "--compress-grads",
              *dev]
    run = lambda argv, **kw: _train_launcher(ctx, cfg.name, argv, script=wrapper, **kw)
    try:
        ref = run(common + ["--ckpt-dir", str(tmp / "ref")])
        cut = run(common + ["--ckpt-dir", str(tmp / "run")], preempt_after=0)
        p = cut["final_step"]
        require(cut["preempted"] and 0 < p < n,
                f"{label}: the SIGTERM did not preempt the run ({p}, {cut['preempted']}): "
                f"{cut['log']}")
        res = run(common + ["--ckpt-dir", str(tmp / "run")])
        require(res.get("restored_step") == p and res.get("restored_equal"),
                f"{label}: the restored shards are not the saved state "
                f"({res.get('restored_step')}, {res.get('restored_equal')})")
        require(res["steps"][0] == p and res["final_step"] == n,
                f"{label}: resumed at {res['steps'][:1]} to {res['final_step']}")
        losses = cut["losses"] + res["losses"]
        require(len(losses) == len(ref["losses"]) == n, f"{label}: {len(losses)} losses")
        dl = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
        require(dl <= TRAIN_RESUME_ATOL,
                f"{label}: resumed losses {losses} vs uninterrupted {ref['losses']}")
        if restore_1x1:
            # the final checkpoint of the uninterrupted 1x2 run, at 1x1
            c2 = dataclasses.replace(cfg, n_layers=2)
            model = _train_model(ctx, c2, ctx["tp_launch_approx"])
            t = Trainer(model, S.StepConfig(remat="none"),
                        TrainerConfig(total_steps=n, ckpt_dir=str(tmp / "ref")), pipeline=None)
            state, start = t.init_or_restore()
            man = json.loads((tmp / "ref" / f"step_{n:010d}" / "manifest.json").read_text())
            equal = all(hashlib.sha1(C._host(v).tobytes()).hexdigest()[:16]
                        == man["arrays"][name]["digest"] for name, v in named_leaves(state))
            require(start == n and equal, f"{label}: the 1x2 checkpoint restored at 1x1: step "
                                          f"{start}, bytes equal {equal}")
            del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"shape": ctx["mesh_launch_shape"], "mesh": f"1x{TP}", "preempted_at": p,
           "losses_uninterrupted": ref["losses"], "losses_resumed": losses,
           "max_loss_diff": dl, "restored_at_1x1": restore_1x1,
           "collective_bytes_per_step": ref.get("collective_bytes_per_step"),
           "collective_host_ms_per_step": ref.get("collective_host_ms_per_step"),
           "wall_s": {"ref": ref["wall_s"], "preempted": cut["wall_s"],
                      "resumed": res["wall_s"]},
           "logs": {"ref": ref["log"], "preempted": cut["log"], "resumed": res["log"]}}
    say(f"{label} (launch.train --mesh 1x{TP} --dist-backend gloo, {cfg.name} at 2 layers, "
        f"batch {B} x seq {T}, {n} steps, {ctx['tp_launch_approx']} --compress-grads): "
        f"preempted at step {p}, "
        f"every rank's restored shards equal to the saved state, resumed to {n}; losses "
        f"within {dl:.3g} of the uninterrupted run (<= {TRAIN_RESUME_ATOL}); the 1x{TP} "
        f"checkpoint restored at 1x1 bit for bit: {restore_1x1}; wall {ref['wall_s']:.1f} / "
        f"{cut['wall_s']:.1f} / {res['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------


class TimedRecord(dict):
    """The run's record; each entry set also notes (and prints) the
    seconds since the entry before it — the phase's cost, its model's
    construction included — in ``times``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.times: dict = {}
        self._t = time.time()

    def __setitem__(self, key, value):
        now = time.time()
        self.times[key] = round(now - self._t, 1)
        self._t = now
        say(f"{key}: {self.times[key]} s since the entry before")
        super().__setitem__(key, value)


def write_record(path, record) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU with the plain versions at "
                         "smoke size (prints no result line)")
    ap.add_argument("--record", type=Path, default=None, metavar="PATH",
                    help="also write every number to this JSON file")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks; prints "
                         "no result line)")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then only phase 5 (training; prints no result line)")
    ap.add_argument("--tp-only", action="store_true",
                    help="build, then only the tensor-parallel phases (2's shard rows, "
                         "3s, 3t, 3u, 3v; prints no result line)")
    ap.add_argument("--dp-only", action="store_true",
                    help="build, then only the serving data axis (2's 2x2 shard rows, 3w, "
                         "3x) and 5i's mamba2-370m 2x1 diagnosis (prints no result line)")
    ap.add_argument("--train-mesh-only", action="store_true",
                    help="build, then only the mesh-training phases (2's training shard "
                         "rows, 5g-5m; prints no result line)")
    args = ap.parse_args(argv)
    if not (HERE / "src" / "repro_torch").is_dir():
        say("FAIL: src/repro_torch not found next to this script (run it from "
            "a checkout of the repository)")
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch

    on_card = not args.rehearse
    if on_card and not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false: no card, no result")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        say(f"nvidia-smi: {'; '.join(smi)}")
        say(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind} "
            f"x{count}, capability {torch.cuda.get_device_capability(0)}")
        t = time.time()
        _build.build_all()
        say(f"built {sorted(_build.SOURCES)} in {time.time() - t:.1f} s")
        for name, lines in _build.ptxas_log.items():
            for ln in lines:
                say(f"ptxas[{name}] {ln.strip()}")
        ctx = {"torch": torch, "dev": torch.device("cuda", 0), "on_card": True, "card": smi,
               "sync": torch.cuda.synchronize, "dtype": torch.bfloat16,
               "slots": 8, "prefill_m": 255, "max_len": 1024, "requests": 16,
               "new_tokens": 32, "prompt_range": (64, 512),
               "chunk_tokens": 256, "max_len_chunked": 1056, "n_long": 4,
               "long_range": (700, 1000), "n_short": 12, "short_range": (64, 200),
               "padded_lens": (20, 60, 255, 500),
               "swa_max_len": 4096, "swa_long_range": (4500, 8192), "swa_wrap_len": 4080,
               "swa_short_range": (64, 512), "swa_n_long": 4, "swa_n_short": 7,
               "swa_new_tokens": 32, "swa_band_lens": (4500, 8192), "swa_model_prompt": 4500,
               "qwen_max_len": 4096, "qwen_long_range": (2048, 4000), "qwen_n_long": 3,
               "long_prefill_m": 4096,
               "qwen_short_range": (64, 512), "qwen_n_short": 9, "qwen_model_prompt": 1500,
               "h128_tri_lens": (4096, 1024), "h128_band": (8192, 4096),
               "moe_prefill_len": 512,
               "rg_max_len": 8192, "rg_band_len": 8192,
               "ssm_max_len": 512, "rec_buckets": (64, 128, 256, 512),
               "rec_long_range": (4096, 8192), "ssm_n_long": 2, "ssm_n_short": 16,
               "rg_n_long": 3, "rg_n_short": 9, "ssm_model_prompt": 1000,
               "rg_model_prompt": 4500,
               "profile_ticks": 8, "stream_slots": 64, "stream_clips": 256, "stream_frames": 32,
               "psnr_clips": 4, "psnr_frames": 8,
               "train_batch": 8, "train_seq": 1024, "train_steps": 8, "train_remat": "none",
               "train_cut_shape": (2, 1024), "overfit_shape": (1, 256),
               "launch_shape": (2, 256, 10), "fam_shape": (2, 512), "rg_train_shape": (1, 2304),
               "vlm_train_shape": (4, 2048), "audio_train_shape": (8, 1024),
               "audio_train_remat": "none", "vlm_fam_shape": (1, 2048),
               "fleet_replicas": 3, "fleet_loss": 0.05, "fleet_seed": 3,
               "tp_block": 256, "tp_timeout_s": 600.0, "tp_moe_new_tokens": 16,
               # depth cuts of earlier paths that keep the script in its limit
               # (PERF.md §7 names the run that forced each)
               "depth_cuts": {"3t": 4, "5e": 6, "5f": 12, "3i": 4, "3k": 4, "3g": 6,
                              "3m": 4, "3o": 8, "3q": 4, "3s": 4, "5k": 12, "3p": 8,
                              "3u": 2, "3v": 3, "5l": 6, "5m": 5, "3w": 4, "3x": 4},
               "mesh_train_batch": 8, "mesh_dp_rows": 4, "mesh_train_steps": 3,
               "mesh_cut_shape": (2, 1024), "mesh_launch_shape": (2, 256, 6),
               "mesh_timeout_s": 900.0, "mesh_cut_vlm_seq": 2048,
               "moe_mesh_shape": (4, 1024, 3), "moe_mesh_remat": "full",
               "rec_mesh_shape": (4, 1024, 3),
               "tp_launch_approx": "axq8",
               "calib_shape": (2, 64), "plan_grid": (8, 5),
               "resil_prompts": 8, "resil_deadline_ms": 5000.0, "resil_shed": 8,
               "resil_storm": "seu_state=0.05,seu_param=0.03,nan=0.08,spike=0.05,drop=0.05",
               "resil_soft_storm": "nan=0.08,drop=0.05,spike=0.05",
               "resil_launch_storm": "seu_state=0.02,seu_param=0.01,nan=0.05,spike=0.02,drop=0.02",
               "resil_launch_deadline_ms": 1500.0,
               "resil_stream_storm": "nan=0.05,seu_state=0.05,drop=0.05",
               "pr_shapes": (((8, 64, 256), "stream tick: FIR planes, 64 slots"),
                             ((9, 64, 256), "stream tick: 3x3 blur planes"),
                             ((1, 64, 256), "stream tick: 1x1 gain plane"),
                             ((32, 4064), "Ch. 7: 32-tap FIR over 4096 samples"),
                             ((25, 1, 128, 128), "Ch. 7: 5x5 blur on 128x128"),
                             ((1_000_003,), "ragged"),
                             ((1 << 24,), "flat 2^24")),
               "fir_shapes": (((64, 256, 8, 12), "stream tick: FIR, 64 slots"),
                              ((1, 4096, 32, 14), "Ch. 7: 32-tap FIR over 4096 samples"),
                              ((5, 1001, 13, 12), "ragged")),
               "conv_shapes": (((64, 16, 16, 3, 3, "edge", 8), "stream tick: 3x3 edge blur"),
                               ((64, 16, 16, 1, 1, "zero", 12), "stream tick: 1x1 gain"),
                               ((1, 128, 128, 5, 5, "zero", 8), "Ch. 7: 5x5 blur on 128x128"),
                               ((1, 128, 128, 5, 5, "edge", 8), "Ch. 7: 5x5 edge blur"),
                               ((3, 37, 45, 4, 6, "edge", 8), "ragged, even 4x6 kernel"))}
        cfg = get_config("tinyllama-1.1b")
        swa_cfg = get_config("h2o-danube-1.8b")
        qwen_cfg = get_config("qwen2.5-3b")
        nemo_cfg = get_config("mistral-nemo-12b")
        moe_cfg = get_config("granite-moe-3b-a800m")
        qmoe_cfg = get_config("qwen2-moe-a2.7b")
        ssm_cfg = get_config("mamba2-370m")
        rg_cfg = get_config("recurrentgemma-2b")
        vlm_cfg = get_config("internvl2-1b")
        audio_cfg = get_config("hubert-xlarge")
    else:
        torch.set_num_threads(4)
        smi, kind, count = ["cpu rehearsal"], "cpu", 0
        ctx = {"torch": torch, "dev": torch.device("cpu"), "on_card": False, "card": smi,
               "sync": lambda: None, "dtype": torch.float32,
               "slots": 4, "prefill_m": 37, "max_len": 64, "requests": 6,
               "new_tokens": 4, "prompt_range": (8, 40),
               "chunk_tokens": 16, "max_len_chunked": 64, "n_long": 2,
               "long_range": (40, 56), "n_short": 4, "short_range": (8, 20),
               "padded_lens": (3, 9, 20, 37),
               # window 32; prompts past 4 blocks of 128, where band < tri
               "swa_max_len": 32, "swa_long_range": (520, 700), "swa_wrap_len": 24,
               "swa_short_range": (8, 30), "swa_n_long": 4, "swa_n_short": 7,
               "swa_new_tokens": 12, "swa_band_lens": (520, 700), "swa_model_prompt": 600,
               "qwen_max_len": 64, "qwen_long_range": (40, 60), "qwen_n_long": 3,
               "long_prefill_m": 70,
               "qwen_short_range": (8, 20), "qwen_n_short": 9, "qwen_model_prompt": 50,
               "h128_tri_lens": (300, 40), "h128_band": (520, 32),
               "moe_prefill_len": 37,
               # window 32 at smoke width; a band past 4 blocks of 128
               "rg_max_len": 64, "rg_band_len": 600,
               # chunk 16 at smoke width; the long prompts past the ladder
               # and the window of 32
               "ssm_max_len": 64, "rec_buckets": (16, 32, 64),
               "rec_long_range": (70, 120), "ssm_n_long": 2, "ssm_n_short": 6,
               "rg_n_long": 3, "rg_n_short": 5, "ssm_model_prompt": 50,
               "rg_model_prompt": 100,
               "profile_ticks": 2, "stream_slots": 4, "stream_clips": 6, "stream_frames": 4,
               "psnr_clips": 2, "psnr_frames": 3,
               "train_batch": 2, "train_seq": 32, "train_steps": 4, "train_remat": "none",
               "train_cut_shape": (2, 32), "overfit_shape": (2, 16),
               "launch_shape": (2, 16, 10), "fam_shape": (2, 32), "rg_train_shape": (1, 48),
               "vlm_train_shape": (2, 24), "audio_train_shape": (2, 32),
               "audio_train_remat": "none", "vlm_fam_shape": (1, 24),
               "fleet_replicas": 3, "fleet_loss": 0.2, "fleet_seed": 3,
               # block 32 divides the smoke's row-parallel K shards (64 / 2)
               "tp_block": 32, "tp_timeout_s": 300.0, "tp_moe_new_tokens": 4,
               "depth_cuts": {},
               "mesh_train_batch": 4, "mesh_dp_rows": 2, "mesh_train_steps": 3,
               "mesh_cut_shape": (2, 32), "mesh_launch_shape": (2, 16, 30),
               "mesh_timeout_s": 300.0, "mesh_cut_vlm_seq": 24,
               "moe_mesh_shape": (4, 32, 2), "moe_mesh_remat": "full",
               "rec_mesh_shape": (4, 32, 2),
               "tp_launch_approx": "exact",
               "calib_shape": (2, 16), "plan_grid": (8, 6, 4),
               "resil_prompts": 4, "resil_deadline_ms": 5000.0, "resil_shed": 4,
               "resil_storm": "seu_state=0.2,seu_param=0.1,nan=0.3,spike=0.1,drop=0.1",
               "resil_soft_storm": "nan=0.3,drop=0.1,spike=0.1",
               "resil_launch_storm": "seu_state=0.1,seu_param=0.05,nan=0.2,spike=0.05,drop=0.05",
               "resil_launch_deadline_ms": 1500.0,
               "resil_stream_storm": "nan=0.2,seu_state=0.2,drop=0.1",
               "pr_shapes": (((8, 4, 256), "stream tick: FIR planes, 4 slots"),
                             ((9, 4, 256), "stream tick: 3x3 blur planes"),
                             ((1, 4, 256), "stream tick: 1x1 gain plane"),
                             ((32, 4064), "Ch. 7: 32-tap FIR over 4096 samples"),
                             ((1003,), "ragged")),
               "fir_shapes": (((4, 256, 8, 12), "stream tick: FIR, 4 slots"),
                              ((1, 4096, 32, 14), "Ch. 7: 32-tap FIR over 4096 samples"),
                              ((2, 5, 13, 12), "ragged, frames shorter than the tail")),
               "conv_shapes": (((4, 16, 16, 3, 3, "edge", 8), "stream tick: 3x3 edge blur"),
                               ((4, 16, 16, 1, 1, "zero", 12), "stream tick: 1x1 gain"),
                               ((1, 128, 128, 5, 5, "zero", 8), "Ch. 7: 5x5 blur on 128x128"),
                               ((3, 37, 45, 4, 6, "edge", 8), "ragged, even 4x6 kernel"))}
        cfg = get_config("tinyllama-1.1b-smoke")
        swa_cfg = get_config("h2o-danube-1.8b-smoke")
        # the smoke variants have head_dim 16: keep the D = 128 paths
        qwen_cfg = dataclasses.replace(get_config("qwen2.5-3b-smoke"), head_dim=128)
        nemo_cfg = dataclasses.replace(get_config("mistral-nemo-12b-smoke"), head_dim=128)
        moe_cfg = get_config("granite-moe-3b-a800m-smoke")
        qmoe_cfg = get_config("qwen2-moe-a2.7b-smoke")
        ssm_cfg = get_config("mamba2-370m-smoke")
        # head_dim 16 at smoke width: keep the D = 256 paths
        rg_cfg = dataclasses.replace(get_config("recurrentgemma-2b-smoke"), head_dim=256)
        vlm_cfg = get_config("internvl2-1b-smoke")
        audio_cfg = get_config("hubert-xlarge-smoke")
    ctx["timer"] = Timer(torch, on_card)

    record = TimedRecord(card=smi, kind=kind, count=count)
    if on_card:
        record["flash_attention_resources"] = flash_resources(ctx)
        record["decode_resources"] = decode_resources(ctx)
        record["axqmm_resources"] = axqmm_resources(ctx)
        record["pr_resources"] = pr_resources(ctx)
    if args.train_only:
        train_phases(ctx, record, cfg, moe_cfg, ssm_cfg, rg_cfg, vlm_cfg, audio_cfg)
        launcher_phases(ctx, record, cfg, moe_cfg, mesh=False)
        write_record(args.record, record)
        say("training phases done (--train-only): no result line")
        return 0
    if args.dp_only:
        record["kernels_dp"] = phase_kernels_dp(ctx, cfg)
        w, x = _mesh_job(ctx, "3w / 3x", dp_serve_runs(ctx, cfg, tp_prompts(ctx, cfg)),
                         ctx["mesh_timeout_s"])
        record["dp_path"], record["fleet_mesh_path"] = phase_dp_serve(ctx, cfg, w, x)
        record["train_mesh_diagnosis"], _ = phase_train_mesh_cut(
            ctx, cfg, moe_cfg, vlm_cfg, audio_cfg, ssm_cfg, rg_cfg, diagnosis_only=True)
        record["phase_seconds"] = dict(record.times)
        write_record(args.record, record)
        say("serving data-axis phases done (--dp-only): no result line")
        return 0
    if args.train_mesh_only:
        record["kernels_dp"] = phase_kernels_dp(ctx, cfg)
        train_mesh_phases(ctx, record, cfg, moe_cfg, vlm_cfg, audio_cfg, ssm_cfg, rg_cfg)
        launcher_phases(ctx, record, cfg, moe_cfg, single=False)
        record["phase_seconds"] = dict(record.times)
        write_record(args.record, record)
        say("mesh-training phases done (--train-mesh-only): no result line")
        return 0
    if args.tp_only:
        record["kernels_tp"] = phase_kernels_tp(ctx, cfg, moe_cfg)
        record["kernels_tp_rec"] = phase_kernels_tp_recurrent(ctx, ssm_cfg, rg_cfg)
        prompts = tp_prompts(ctx, cfg)
        record["tp_dense_path"], rec = phase_tp_dense(
            ctx, cfg, prompts, tp_recurrent_jobs(ctx, ssm_cfg, rg_cfg, prompts))
        record["tp_rec_path"] = phase_tp_recurrent(ctx, ssm_cfg, rg_cfg, rec)
        record["tp_moe_path"] = phase_tp_moe(ctx, depth_cut(ctx, "3t", moe_cfg),
                                             prompts)
        record["phase_seconds"] = dict(record.times)
        write_record(args.record, record)
        say("tensor-parallel phases done (--tp-only): no result line")
        return 0
    record["kernels"] = phase_kernels(ctx, cfg)
    record["kernels_swa"] = phase_kernels_swa(ctx, swa_cfg)
    record["kernels_h128"] = phase_kernels_head128(ctx, qwen_cfg, nemo_cfg)
    record["kernels_moe"] = phase_kernels_moe(ctx, moe_cfg, qmoe_cfg)
    record["kernels_rec"] = phase_kernels_recurrent(ctx, ssm_cfg, rg_cfg)
    record["kernels_fe"] = phase_kernels_frontends(ctx, vlm_cfg, audio_cfg)
    record["kernels_tp"] = phase_kernels_tp(ctx, cfg, moe_cfg)
    record["kernels_tp_rec"] = phase_kernels_tp_recurrent(ctx, ssm_cfg, rg_cfg)
    record["kernels_dp"] = phase_kernels_dp(ctx, cfg)
    if args.kernels_only:
        write_record(args.record, record)
        say("kernel checks done (--kernels-only): no result line")
        return 0
    model, params = serving_model(ctx, cfg)
    record["main_path"], prompts_3 = phase_serve(ctx, cfg, model, params)
    record["int8_cache_path"] = phase_serve_int8(ctx, cfg, model, params, prompts_3)
    record["chunked_path"] = phase_serve_chunked(ctx, cfg, model, params)
    record["resil_path"] = phase_resil(ctx, cfg, model, params, prompts_3)
    record["fleet_path"] = phase_fleet(ctx, "3r", cfg, model, params, prompts_3)
    del model, params
    if on_card:
        torch.cuda.empty_cache()
    record["tp_dense_path"], rec = phase_tp_dense(
        ctx, cfg, prompts_3, tp_recurrent_jobs(ctx, ssm_cfg, rg_cfg, prompts_3))
    record["tp_rec_path"] = phase_tp_recurrent(ctx, ssm_cfg, rg_cfg, rec)
    record["tp_moe_path"] = phase_tp_moe(ctx, depth_cut(ctx, "3t", moe_cfg),
                                         prompts_3)
    record["emul_path"] = phase_emul(ctx, cfg)
    record["stream_path"] = phase_stream(ctx)
    record["plan_path"] = phase_plan_lm(ctx, depth_cut(ctx, "3i", cfg, register=True))
    record["stream_plan_path"] = phase_plan_stream(ctx)
    record["model_2layer"] = phase_model(ctx, cfg, ctx["prefill_m"])
    model, params = serving_model(ctx, swa_cfg)
    prompts, kinds = swa_prompts(ctx, swa_cfg)
    long_path = dict(max_len=ctx["swa_max_len"], new_tokens=ctx["swa_new_tokens"],
                     n_band=kinds.count("long"))
    record["swa_path"] = phase_serve_long(ctx, "3e", swa_cfg, model, params, prompts, kinds,
                                          **long_path)
    record["swa_int8_path"] = phase_serve_long_int8(ctx, "3f", swa_cfg, model, params,
                                                    prompts, kinds, **long_path)
    del model, params
    if on_card:
        torch.cuda.empty_cache()
    record["swa_model_2layer"] = phase_model(ctx, swa_cfg, ctx["swa_model_prompt"])
    qwen_serve_cfg = depth_cut(ctx, "3g", qwen_cfg)
    model, params = serving_model(ctx, qwen_serve_cfg)
    prompts, kinds = qwen_prompts(ctx, qwen_cfg)
    long_path = dict(max_len=ctx["qwen_max_len"], new_tokens=ctx["new_tokens"], n_band=0)
    record["qwen_path"] = phase_serve_long(ctx, "3g", qwen_serve_cfg, model, params, prompts,
                                           kinds, **long_path)
    record["qwen_int8_path"] = phase_serve_long_int8(ctx, "3h", qwen_serve_cfg, model, params,
                                                     prompts, kinds, **long_path)
    del model, params
    if on_card:
        torch.cuda.empty_cache()
    record["qwen_model_2layer"] = phase_model(ctx, qwen_cfg, ctx["qwen_model_prompt"])
    moe_serve_cfg = depth_cut(ctx, "3m", moe_cfg)
    model, params = serving_model(ctx, moe_serve_cfg)
    record["moe_path"] = phase_serve_moe(ctx, "3m", moe_serve_cfg, model, params, prompts_3,
                                         quant=False)
    record["moe_int8_path"] = phase_serve_moe(ctx, "3n", moe_serve_cfg, model, params, prompts_3,
                                              quant=True)
    del model, params
    if on_card:
        torch.cuda.empty_cache()
    record["moe_model_2layer"] = phase_model(ctx, moe_cfg, ctx["prefill_m"])
    vlm_serve_cfg = depth_cut(ctx, "3q", vlm_cfg)
    model, params = serving_model(ctx, vlm_serve_cfg)
    record["vlm_path"] = phase_serve_vlm(ctx, "3q", vlm_serve_cfg, model, params, prompts_3)
    del model, params
    if on_card:
        torch.cuda.empty_cache()
    for tag, c in (("ssm", ssm_cfg), ("rg", rg_cfg)):
        ptag = "3o" if tag == "ssm" else "3p"
        c_serve = depth_cut(ctx, ptag, c)
        model, params = serving_model(ctx, c_serve)
        prompts, kinds = recurrent_prompts(ctx, c, tag)
        record[f"{tag}_path"] = phase_serve_recurrent(
            ctx, ptag, c_serve, model, params, prompts, kinds,
            max_len=ctx[f"{tag}_max_len"])
        del model, params
        if on_card:
            torch.cuda.empty_cache()
        record[f"{tag}_model"] = phase_model(ctx, c, ctx[f"{tag}_model_prompt"],
                                             n_layers=2 if tag == "ssm" else 4)

    train_phases(ctx, record, cfg, moe_cfg, ssm_cfg, rg_cfg, vlm_cfg, audio_cfg)
    train_mesh_phases(ctx, record, cfg, moe_cfg, vlm_cfg, audio_cfg, ssm_cfg, rg_cfg)
    launcher_phases(ctx, record, cfg, moe_cfg)

    paths = {"5a": record["train_path"]["seen"],
             "5g": record["train_mesh"]["5g"]["seen"],
             "5h": record["train_mesh"]["5h"]["seen"],
             "5k": record["train_mesh"]["5k"]["seen"],
             "5l": record["train_mesh"]["5l"]["seen"],
             "5m": record["train_mesh"]["5m"]["seen"],
             "5e": record["train_vlm"]["seen"], "5f": record["train_audio"]["seen"],
             "3q": record["vlm_path"], "3r": record["fleet_path"],
             "3": record["main_path"], "3b": record["int8_cache_path"],
             "3c": record["chunked_path"], "3d": record["stream_path"],
             "3e": record["swa_path"], "3f": record["swa_int8_path"],
             "3g": record["qwen_path"], "3h": record["qwen_int8_path"],
             "3i": record["plan_path"], "3j": record["stream_plan_path"],
             "3k": record["emul_path"], "3l": record["resil_path"],
             "3m": record["moe_path"], "3n": record["moe_int8_path"],
             "3o": record["ssm_path"], "3p": record["rg_path"],
             "3s": tp_launches(record["tp_dense_path"]),
             "3t": tp_launches(record["tp_moe_path"]),
             "3u": tp_launches(record["tp_rec_path"]["3u"]),
             "3v": tp_launches(record["tp_rec_path"]["3v"]),
             "3w": record["dp_path"]["seen"], "3x": record["fleet_mesh_path"]["seen"]}
    summary = []
    moe_rows = record["kernels_moe"]
    tp_rows = {k: v + record["kernels_tp_rec"].get(k, []) + record["kernels_train_mesh_rec"].get(
        k, []) + record["kernels_dp"].get(k, []) for k, v in record["kernels_tp"].items()}
    for k, v in record["kernels_dp"].items():
        tp_rows.setdefault(k, v)
    for name in list(record["kernels"]) + ["axqmm_experts", "axqmm_gated_experts"]:
        src, replaces = SOURCES[name]
        rows = record["kernels"].get(name) or moe_rows[name]
        swa_rows = record["kernels_swa"].get(name, [])
        h128_rows = record["kernels_h128"].get(name, [])
        rec_rows = record["kernels_rec"].get(name, [])
        fe_rows = record["kernels_fe"].get(name, [])
        if name in record["kernels"]:
            h128_rows = h128_rows + moe_rows.get(name, []) + rec_rows + fe_rows
        h128_rows = (h128_rows + tp_rows.get(name, [])
                     + record["kernels_train_mesh"].get(name, []))
        # the summary row: the unembedding GEMM (the largest decode GEMM)
        # for axqmm, the decode-shaped row for the others
        lead = rows[-1] if name == "axqmm" else rows[0]
        by_path = {k: v["launches"].get(name, 0) for k, v in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows + swa_rows + h128_rows),
            "ms": lead.get("ms"), "plain_ms": lead.get("plain_ms"),
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead.get("library_ms"),
            "shape": {k: lead[k] for k in lead if k in SHAPE_KEYS},
        }
        for key in ("wrapper_ms", "old_route_ms", "launch_floor_ms", "int_mm_loop_ms_graph"):
            if key in lead:
                # the PR rows: the eager call, the old route and the floor
                entry[key] = lead[key]
        if "ms_graph" in lead:
            # decode: the device times beside the eager ones
            entry.update(ms_graph=lead["ms_graph"], library_ms_graph=lead["library_ms_graph"])
        if name == "flash_attention":
            entry["launches_by_schedule"] = {
                sched: sum(v.get("flash_schedules", {}).get(sched, 0) for v in paths.values())
                for sched in ("dense", "tri", "band")}
            # the sliding-window arch's longest band row
            band = max((r for r in swa_rows if r.get("schedule") == "band"),
                       key=lambda r: r["S"])
            keys = ("S", "BH", "D", "window", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")
            entry["band"] = {k: band.get(k) for k in keys}
            # qwen2.5-3b's longest tri row at head_dim 128 (bf16 body)
            tri128 = h128_rows[0]
            entry["head_dim_128"] = {k: tri128.get(k) for k in keys + ("dtype",)}
            # recurrentgemma-2b's band row at head_dim 256, MQA 10/1
            entry["head_dim_256"] = {k: rec_rows[0].get(k) for k in keys + ("dtype",)}
            # hubert-xlarge's non-causal dense row (D 80) and internvl2-1b's
            # tri at G = 7
            entry["dense_noncausal"] = {k: fe_rows[0].get(k) for k in keys + ("dtype",)}
            entry["tri_g7"] = {k: fe_rows[1].get(k) for k in keys + ("dtype",)}
        if name == "flash_decode":
            # recurrentgemma-2b's decode at head_dim 256, G 10, split edges
            keys = ("B", "KVr", "G", "D", "T", "ms", "ms_graph", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_ms_graph", "max_abs_err")
            entry["head_dim_256"] = {k: rec_rows[0].get(k) for k in keys}
        summary.append(entry)
    record["summary"] = summary
    record["phase_seconds"] = dict(record.times)
    write_record(args.record, record)
    if not on_card:
        say("rehearsal done on the CPU (plain versions, smoke size): no device result")
        return 0
    print(smi[0])
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        rc = 1
    sys.exit(rc)
