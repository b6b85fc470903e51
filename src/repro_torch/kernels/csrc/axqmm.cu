// axqmm / axqmm_gated — block-quantized, runtime-degradable int8 GEMMs on
// Hopper's int8 tensor cores.
//
// Replaces the TPU kernels repro/kernels/axqmm.py::_axqmm_kernel (launched in
// _axqmm_call) and ::_axqmm_gated_kernel (launched in _axqmm_gated_call).
//
//   y[m, n] = fold over kb = 0 .. nb - 1, in order, of
//               f32(dot(degrade(qx[m, kb]), degrade(qw[n, kb]))) * (sx[m, kb] * sw[n, kb])
//             (+ bias[n]) (+ residual[m, n])
//   gated:    act(x @ w_gate) * (x @ w_up), both GEMMs on one staged x tile.
//
// What bounds it.  At decode M is the slot count (<= 16): each int8 weight
// byte meets at most 16 activation rows, 2 M operations a byte against the
// card's ~590 int8 operations per byte of memory rate, so the kernel is
// bound by the weight bytes and must keep enough of them in flight on every
// SM.  A long prefill (M = 4096) does 8192 operations a weight byte and is
// bound by the int8 tensor-core rate.  The design:
//
//  * Tensor cores.  Both packs are K-major, the operand layout of
//    mma.sync.m16n8k32.row.col.s32.s8.s8.s32 and of wgmma's s8 shapes.
//    The int32 dot of one quantization block is exact in any order; at
//    each block's end the int32 sums are converted, scaled by sx * sw and
//    folded into f32 accumulators in block order with explicitly rounded
//    ops (no FMA contraction), the plain version's order, then reset.
//  * Decode (M <= 16, axq_decode_kernel): A and B swapped, so weight rows fill
//    the MMA's 16-row side and the slots its n = 8 side.  A block is one
//    warp on 16 weight rows (of up and gate, gated) over one split of K.
//    Its steps of 256 bytes of K are copied whole rows at a time (16
//    lanes, 16 bytes each, a row) through a 4-stage cp.async ring in
//    shared memory and read back as fragments by ldmatrix.  K is split
//    across blocks at quantization-block edges, or at exact parts of a
//    block where the blocks are too few, so that every decode projection
//    launches at least one block an SM (the split plan is the wrapper's,
//    kernels/axqmm.py::plan).  A split writes its int32 sums per unit to a
//    scratch the wrapper allocates; axq_combine_kernel, launched from the same
//    C entry point, adds a block's units (exact), folds the blocks in
//    order and applies the epilogue, so the result is bit-identical for
//    every split count.
//  * Prefill, 128-row tiles (axq_wgmma_kernel, when they fill the card): two
//    warpgroups each take 64 rows of a 128 x 128 output tile (gated: 64
//    columns of each of up and gate in one n128 wgmma), 128 bytes of K a
//    stage through a 4-stage cp.async ring laid out in the 128-byte
//    swizzle that wgmma's shared-memory descriptors read; a block's first
//    wgmma does not accumulate, which resets its int32 sums.
//  * Prefill, 64-row tiles (axq_tile_kernel, shapes too small to fill the card
//    with 128-row tiles): mma.sync on 4 warps, ldmatrix from XOR-swizzled
//    64-byte rows, K split like decode when even these tiles leave more
//    than half the card idle.  Every block's scales are copied with the
//    stage that ends it; tiles are walked in groups of 8 row tiles for L2
//    reuse.
//  * Degrade.  The shift is read from the device int32 degree (a QoS rung
//    move rebuilds and recaptures nothing).  Shift 0 skips the degrade;
//    otherwise it runs word-wide (common.cuh Degrade, 11 integer operations
//    for 4 codes): on the fragments in registers at decode, where ldmatrix
//    hands each code to one lane once, and at prefill by each thread on the
//    16-byte pieces it copied into the stage, once, before the barrier that
//    releases the stage to the MMAs.  A long prefill (M >= 1024 on 128-row
//    tiles, where each weight row meets M / 128 tiles) instead degrades x
//    and the weights once, in a pre-pass (axq_degrade_kernel), into a
//    scratch the wrapper allocates, which the wgmma tiles then read.
//  * Ragged M, N and K edges are zero-filled by the copies (source size 0)
//    and masked at the stores; nothing is padded or copied on the host.
//  * Experts.  The expert-batched entries (axqmm_experts_launch,
//    axqmm_gated_experts_launch) run E independent products of one shape
//    in one launch, the counterpart of the reference's vmap of the Pallas
//    call over an MoE layer's experts: the expert is the grid's last axis
//    (z; y for the combine and the pre-pass), and each block first moves
//    every operand pointer to its expert's slice of the contiguous
//    (E, ...) tensors (expert_slice).  A block then computes exactly what
//    the 2-D launch computes on that slice, so each expert's output is
//    bit-identical to it.  The plan counts the tiles of all E experts
//    (kernels/axqmm.py::plan): at an MoE decode the experts alone fill the
//    card, and K is not split.

#include "common.cuh"

namespace {

using repro::Degrade;

constexpr int KC = 64;  // the kernels' least step of K in bytes; bk is a multiple

// Tile configurations, the `cfg` argument of the C entry points.
enum Cfg : int { kDecode = 0, kTileSmall = 1, kTileLarge = 2 };

struct Args {
  const int8_t* qx;
  const float* sx;
  const int8_t* qw[2];  // the weight (or up), the gate
  const float* sw[2];
  const float* bias;
  const float* res;
  const int* ebits;
  float* out;
  void* scratch;  // int32 (G, nb * part, M, N) sums of a split launch, or the
                  // int8 degraded x then weights of a pre-degraded wgmma launch
                  // (each expert's in turn, for an expert-batched launch)
  int M, N, K, bk, act, n_split, part;
  int E;          // experts of an expert-batched launch; 1 for a 2-D one
};

// Expert e's slice of an expert-batched launch: each operand is a
// contiguous (E, ...) tensor, so expert e's data sits e whole slices past
// the first (expert 0, every 2-D launch, is the launch itself).
template <bool GATED>
__device__ __forceinline__ Args expert_slice(const Args& a, int e) {
  constexpr int G = GATED ? 2 : 1;
  const size_t M = a.M, N = a.N, K = a.K, nb = a.K / a.bk;
  Args b = a;
  b.qx += e * M * K;
  b.sx += e * M * nb;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    b.qw[gi] += e * N * K;
    b.sw[gi] += e * N * nb;
  }
  b.out += e * M * N;
  if (a.scratch != nullptr) {
    b.scratch = a.n_split > 1
        ? static_cast<void*>(static_cast<int*>(a.scratch) + e * G * nb * a.part * M * N)
        : static_cast<void*>(static_cast<int8_t*>(a.scratch) + e * (M + G * N) * K);
  }
  return b;
}

// The gated activations, each written as PyTorch's CUDA kernel writes it
// (same operations in the same order, so the same contractions and
// roundings): silu x / (1 + exp(-x)); gelu's tanh form with x^3 = x x x
// and kBeta = sqrt(2) * 2 / sqrt(pi) / 2; relu.
__device__ __forceinline__ float act_apply(float g, int act) {
  if (act == 0) return g / (1.0f + expf(-g));
  if (act == 1) {
    constexpr float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
    const float x_cube = g * g * g;
    const float inner = kBeta * (g + kKappa * x_cube);
    return 0.5f * g * (1.0f + tanhf(inner));
  }
  return fmaxf(g, 0.0f);
}

// f + f32(c) * (sxv * swv), rounded as the plain version rounds it.
__device__ __forceinline__ float fold(float f, int c, float sxv, float swv) {
  return __fadd_rn(f, __fmul_rn(__int2float_rn(c), __fmul_rn(sxv, swv)));
}

__device__ __forceinline__ int shift_of(const int* ebits) {
  return min(max(8 - __ldg(ebits), 0), 8);
}

// The output (or its gated product) of element (m, n) from its f32 folds.
template <bool GATED>
__device__ __forceinline__ float epilogue(const Args& a, const float (&f)[2], int m, int n) {
  if constexpr (GATED) {
    return __fmul_rn(act_apply(f[1], a.act), f[0]);
  } else {
    float y = f[0];
    if (a.bias != nullptr) y = __fadd_rn(y, a.bias[n]);
    if (a.res != nullptr) y = __fadd_rn(y, a.res[(size_t)m * a.N + n]);
    return y;
  }
}

// The units [u0, u1) of split s: nb * part units of bk / part bytes,
// dealt as evenly as the count allows.
__device__ __forceinline__ int unit_edge(int s, int units, int n_split) {
  return static_cast<int>(static_cast<long long>(s) * units / n_split);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16- / 4-byte global -> shared copies; ok = false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16 x 32 int8, row) * b (32 x 8 int8, col), exact int32 sums
// (registers only: the compiler may schedule it among the loads).
__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 degrade_vec(const Degrade& dg, uint4 v) {
  return make_uint4(dg(v.x), dg(v.y), dg(v.z), dg(v.w));
}

// Byte offset of 16-byte chunk `c` of row `r` in a stage of rows of `cpr`
// chunks, XOR-swizzled so that ldmatrix's 8 rows at one chunk hit 8
// different bank groups (rows of 4 chunks pair up: two share 128 bytes).
template <int CPR>
__device__ __forceinline__ int swizzle(int r, int c) {
  if constexpr (CPR >= 8) return (r * CPR + (c ^ (r & 7))) << 4;
  else return (r * CPR + (c ^ ((r >> 1) & 3))) << 4;
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------------------
// decode: M <= 16, A = weight rows, B = slots
// ---------------------------------------------------------------------------

// One warp: 16 weight rows (of each of G weights) x 8 * NT slots, over
// one split of K, in steps of 64 CH bytes.  A step's rows are copied whole,
// 64 CH contiguous bytes a row (CH 4: 16 lanes a row, two rows an
// instruction), into a ring of S stages; the warp's own __syncwarp orders
// its lanes' copies before the ldmatrix reads.  With few tiles a warp the
// k32 slices alternate between two int32 accumulator sets, so consecutive
// MMAs do not wait on each other; the sets are added (exactly) at each
// unit's end.
template <int NT, bool GATED, int CH>
struct DecodeTile {
  static constexpr int kG = GATED ? 2 : 1;
  static constexpr int kWRows = kG * 16;             // weight rows a stage
  static constexpr int kRows = kWRows + NT * 8;      // + slots
  static constexpr int kCPR = 4 * CH;                // 16-byte chunks a row
  static constexpr int kRPI = 32 / kCPR;             // rows a copy instruction
  static constexpr int kStageBytes = kRows * kCPR * 16;
  static constexpr int kStages = CH == 1 ? 8 : 4;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kSets = kG * NT >= 4 ? 1 : 2;
  static_assert(kWRows % kRPI == 0 && (NT * 8) % kRPI == 0, "whole rows an instruction");
};

template <int NT, bool GATED, int CH>
__global__ void __launch_bounds__(32)
axq_decode_kernel(const __grid_constant__ Args batch) {
  const Args a = expert_slice<GATED>(batch, blockIdx.z);
  using T = DecodeTile<NT, GATED, CH>;
  constexpr int G = T::kG, S = T::kStages, CPR = T::kCPR, P = T::kSets, SB = 64 * CH;
  extern __shared__ __align__(128) unsigned char ring[];

  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int M = a.M, N = a.N, K = a.K;
  const int n0 = blockIdx.x * 16;
  const int nb = K / a.bk, units = nb * a.part, ub = a.bk / a.part;
  const int u0 = unit_edge(blockIdx.y, units, a.n_split);
  const int u1 = unit_edge(blockIdx.y + 1, units, a.n_split);
  const int spu = ub / SB, kbeg = u0 * ub, steps = (u1 - u0) * spu;
  const bool in_kernel_fold = a.n_split == 1;  // then part == 1: a unit is a block

  // copies: lane l takes chunk l % CPR of row l / CPR of each group of RPI rows
  const int crow = lane / CPR, cch = lane % CPR;
  auto fetch = [&](int i) {
    if (i < steps) {
      const int k = kbeg + i * SB + cch * 16;
      unsigned char* st = ring + (i % S) * T::kStageBytes;
#pragma unroll
      for (int r0 = 0; r0 < T::kRows; r0 += T::kRPI) {
        const int r = r0 + crow;
        const int8_t* src;
        bool ok;
        if (r0 < T::kWRows) {  // row r % 16 of weight r / 16
          const int n = n0 + r % 16;
          ok = n < N;
          src = a.qw[r0 / 16] + (size_t)(ok ? n : 0) * K + k;
        } else {               // slot
          const int m = r - T::kWRows;
          ok = m < M;
          src = a.qx + (size_t)(ok ? m : 0) * K + k;
        }
        cp_async16(st + swizzle<CPR>(r, cch), src, ok);
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

  const int shift = shift_of(a.ebits);
  const Degrade dg(shift);
  int c[P][G][NT][4];
  float f[G][NT][4];
  float sxv[NT][2], swv[G][2];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int par = 0; par < P; ++par) c[par][gi][nt][r] = 0;
        f[gi][nt][r] = 0.f;
      }

  // ldmatrix lanes: A (rows 0-7 | 8-15) x (k 0-15 | 16-31) -> a0 a1 a2 a3;
  // B (slots 0-7, k 0-15 | 16-31) -> b0 b1 (x4: slots 8-15 after them)
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3), a_ch = lane >> 4;
  const int b_row = T::kWRows + (lane & 7) + (NT == 2 ? (lane >> 4) << 3 : 0);
  const int b_ch = (lane >> 3) & 1;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(i);
  int step_in_unit = 0, u = u0;
  for (int i = 0; i < steps; ++i) {
    if (in_kernel_fold && step_in_unit == 0) {  // this block's scales, used at its end
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = nt * 8 + 2 * t + q;
          sxv[nt][q] = m < M ? a.sx[(size_t)m * nb + u] : 0.f;
        }
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + h * 8 + g;
          swv[gi][h] = n < N ? a.sw[gi][(size_t)n * nb + u] : 0.f;
        }
    }
    cp_async_wait<S - 2>();  // this lane's copies of step i landed
    __syncwarp();            // and every lane's; step i - 1's slot is free
    fetch(i + S - 1);
    const unsigned char* st = ring + (i % S) * T::kStageBytes;
#pragma unroll
    for (int sl = 0; sl < 2 * CH; ++sl) {  // the step's k32 slices
      const int ch0 = 2 * sl;              // their first chunk
      unsigned b[NT][2];
      if constexpr (NT == 2) {
        unsigned r4[4];
        ldmatrix_x4(r4, st + swizzle<CPR>(b_row, ch0 + b_ch));
        b[0][0] = r4[0]; b[0][1] = r4[1]; b[1][0] = r4[2]; b[1][1] = r4[3];
      } else {
        ldmatrix_x2(b[0], st + swizzle<CPR>(b_row, ch0 + b_ch));
      }
      if (shift != 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) { b[nt][0] = dg(b[nt][0]); b[nt][1] = dg(b[nt][1]); }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        unsigned af[4];
        ldmatrix_x4(af, st + swizzle<CPR>(gi * 16 + a_row, ch0 + a_ch));
        if (shift != 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) af[r] = dg(af[r]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(c[sl % P][gi][nt], af[0], af[1], af[2], af[3], b[nt][0], b[nt][1]);
      }
    }
    if (++step_in_unit < spu) continue;
    // the unit ends: fold it, or hand it to the combine
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int sum = c[0][gi][nt][r];
#pragma unroll
          for (int par = 1; par < P; ++par) sum += c[par][gi][nt][r];
#pragma unroll
          for (int par = 0; par < P; ++par) c[par][gi][nt][r] = 0;
          if (in_kernel_fold) {
            f[gi][nt][r] = fold(f[gi][nt][r], sum, sxv[nt][r & 1], swv[gi][r >> 1]);
          } else {
            const int n = n0 + (r >> 1) * 8 + g, m = nt * 8 + 2 * t + (r & 1);
            if (m < M && n < N) static_cast<int*>(a.scratch)[((size_t)(gi * units + u) * M + m) * N + n] = sum;
          }
        }
    step_in_unit = 0;
    ++u;
  }
  cp_async_wait<0>();
  if (!in_kernel_fold) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + (r >> 1) * 8 + g, m = nt * 8 + 2 * t + (r & 1);
      if (m >= M || n >= N) continue;
      const float fr[2] = {f[0][nt][r], f[G - 1][nt][r]};
      a.out[(size_t)m * N + n] = epilogue<GATED>(a, fr, m, n);
    }
}

// ---------------------------------------------------------------------------
// prefill: M > 16, A = x rows, B = weight rows
// ---------------------------------------------------------------------------

// BM x BN output tile (of each of G weights) on warps of WM x WN.  A stage
// holds BM x rows and G * BN weight rows of 64 bytes (swizzle<4>), then
// one f32 scale a row, filled by the stage that ends a quantization block.
// Thread e copies chunk e % 4 of rows e / 4 + j * (threads / 4): each of
// its copies has a fixed source row, so its pointers are set up once.
template <int BM, int BN, int WM, int WN, bool GATED>
struct TileCfg {
  static constexpr int kG = GATED ? 2 : 1;
  static constexpr int kWarps = (BM / WM) * (BN / WN);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = BM + kG * BN;
  static constexpr int kCopies = kRows * 4 / kThreads;  // 16-byte copies a thread a stage
  static constexpr int kStageBytes = kRows * KC + kRows * 4;
  static constexpr int kStages = 4;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static_assert(kNT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(kRows == kThreads, "one scale a thread");
  static_assert(BM % (kThreads / 4) == 0 && BN % (kThreads / 4) == 0,
                "each copy stays in one operand");
};

template <int BM, int BN, int WM, int WN, bool GATED>
__global__ void __launch_bounds__(TileCfg<BM, BN, WM, WN, GATED>::kThreads, 1)
axq_tile_kernel(const __grid_constant__ Args batch) {
  const Args a = expert_slice<GATED>(batch, blockIdx.z);
  using C = TileCfg<BM, BN, WM, WN, GATED>;
  constexpr int G = C::kG, S = C::kStages, MT = C::kMT, NT = C::kNT;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int M = a.M, N = a.N, K = a.K, bk = a.bk, nb = K / bk;

  // tile order: groups of 8 row tiles, walked column by column
  const int tn = (N + BN - 1) / BN, tm = (M + BM - 1) / BM;
  const int per = 8 * tn, first = (blockIdx.x / per) * 8, gm = min(tm - first, 8);
  const int m0 = (first + (blockIdx.x % per) % gm) * BM;
  const int n0 = ((blockIdx.x % per) / gm) * BN;
  const int u0 = unit_edge(blockIdx.y, nb, a.n_split);
  const int u1 = unit_edge(blockIdx.y + 1, nb, a.n_split);
  const int spb = bk / KC, steps = (u1 - u0) * spb;
  const bool in_kernel_fold = a.n_split == 1;

  // this thread's copies: sources at the split's first byte, destinations
  const int8_t* src[C::kCopies];
  int dst[C::kCopies];
  unsigned ok = 0;
#pragma unroll
  for (int j = 0; j < C::kCopies; ++j) {
    const int row = (tid >> 2) + j * (C::kThreads / 4), ch = tid & 3;
    bool in;
    if (j * (C::kThreads / 4) < BM) {
      const int m = m0 + row;
      in = m < M;
      src[j] = a.qx + (size_t)(in ? m : 0) * K;
    } else {
      const int gi = (row - BM) / BN, n = n0 + (row - BM) % BN;
      in = n < N;
      src[j] = (gi == 0 ? a.qw[0] : a.qw[1]) + (size_t)(in ? n : 0) * K;
    }
    src[j] += (size_t)u0 * bk + ch * 16;
    dst[j] = swizzle<4>(row, ch);
    ok |= (in ? 1u : 0u) << j;
  }
  const float* ssrc;  // this thread's scale row
  bool sok;
  if (tid < BM) {
    sok = m0 + tid < M;
    ssrc = a.sx + (size_t)(sok ? m0 + tid : 0) * nb;
  } else {
    const int gi = (tid - BM) / BN, n = n0 + (tid - BM) % BN;
    sok = n < N;
    ssrc = (gi == 0 ? a.sw[0] : a.sw[1]) + (size_t)(sok ? n : 0) * nb;
  }
  ssrc += u0;  // the split's first block
  int fetched_in_block = 0;  // fetch(i) is called for i = 0, 1, 2, ... in order
  auto fetch = [&](int i) {
    if (i < steps) {
      unsigned char* st = smem + (i % S) * C::kStageBytes;
#pragma unroll
      for (int j = 0; j < C::kCopies; ++j)
        cp_async16(st + dst[j], src[j] + i * KC, (ok >> j) & 1u);
      if (++fetched_in_block == spb) {  // this stage ends a block: bring its scales
        cp_async4(st + C::kRows * KC + tid * 4, ssrc, sok);
        ++ssrc;
        fetched_in_block = 0;
      }
    }
    cp_async_commit();
  };

  const int shift = shift_of(a.ebits);
  const Degrade dg(shift);
  int c[G][MT][NT][4];
  float f[G][MT][NT][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          c[gi][mt][nt][r] = 0;
          f[gi][mt][nt][r] = 0.f;
        }

  // ldmatrix lanes: A matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31) give
  // a0 a1 a2 a3; B matrices (k 0-15 | 16-31) x (n 0-7 | 8-15) give b0 b1
  // of two n8 tiles
  const int a_row = wm * WM + (((lane >> 3) & 1) << 3) + (lane & 7), a_ch = lane >> 4;
  const int b_row = BM + wn * WN + ((lane >> 4) << 3) + (lane & 7), b_ch = (lane >> 3) & 1;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(i);
  int step_in_block = 0, kb = u0;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 2>();  // this thread's copies of stage i landed
    unsigned char* st = smem + (i % S) * C::kStageBytes;
    if (shift != 0) {        // degrade them in place, once
#pragma unroll
      for (int j = 0; j < C::kCopies; ++j) {
        uint4* w = reinterpret_cast<uint4*>(st + dst[j]);
        *w = degrade_vec(dg, *w);
      }
    }
    __syncthreads();  // every thread's stage i is in place; stage i - 1 is free
    fetch(i + S - 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned b[G][NT / 2][4];
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldmatrix_x4(b[gi][np], st + swizzle<4>(b_row + gi * BN + np * 16, 2 * kk + b_ch));
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], st + swizzle<4>(a_row + mt * 16, 2 * kk + a_ch));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_s8(c[gi][mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                   b[gi][nt >> 1][(nt & 1) * 2], b[gi][nt >> 1][(nt & 1) * 2 + 1]);
    }
    if (++step_in_block < spb) continue;
    // block kb ends: fold it, or hand it to the combine
    const float* sc = reinterpret_cast<const float*>(st + C::kRows * KC);
    if (in_kernel_fold) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sxv = sc[wm * WM + mt * 16 + h * 8 + g];
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float2 swv = *reinterpret_cast<const float2*>(
                  sc + BM + gi * BN + wn * WN + nt * 8 + 2 * t);
              f[gi][mt][nt][h * 2] = fold(f[gi][mt][nt][h * 2], c[gi][mt][nt][h * 2], sxv,
                                          swv.x);
              f[gi][mt][nt][h * 2 + 1] = fold(f[gi][mt][nt][h * 2 + 1],
                                              c[gi][mt][nt][h * 2 + 1], sxv, swv.y);
            }
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * WM + mt * 16 + h * 8 + g;
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int n = n0 + wn * WN + nt * 8 + 2 * t + q;
                if (m < M && n < N)
                  static_cast<int*>(a.scratch)[((size_t)(gi * nb + kb) * M + m) * N + n] =
                      c[gi][mt][nt][h * 2 + q];
              }
        }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) c[gi][mt][nt][r] = 0;
    step_in_block = 0;
    ++kb;
  }
  cp_async_wait<0>();
  if (!in_kernel_fold) return;
  const bool pairs = (N & 1) == 0;  // two adjacent columns as one 8-byte store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mt * 16 + h * 8 + g;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WN + nt * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float fr[2] = {f[0][mt][nt][h * 2 + q], f[G - 1][mt][nt][h * 2 + q]};
          y[q] = n + q < N ? epilogue<GATED>(a, fr, m, n + q) : 0.f;
        }
        float* o = a.out + (size_t)m * N + n;
        if (pairs && n < N) {
          *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
        } else {
          if (n < N) o[0] = y[0];
          if (n + 1 < N) o[1] = y[1];
        }
      }
    }
}

// ---------------------------------------------------------------------------
// prefill, 128-row tiles: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, chunk c of row r at c ^ (r % 8) (swizzle<8>),
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// shared-memory writes by the threads (copies, the degrade) become
// visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128 int32 of one warpgroup) = (acc ? d : 0) + A (64 x 32 int8) . B (128 x 32 int8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// A 128 x BN output tile (gated: 64 columns of each of up and gate, one
// n128 wgmma over both) on two warpgroups of 64 rows.  A stage is 128 bytes
// of K: 128 x rows and 128 weight rows of 128 bytes each, copied by
// cp.async into the 128-byte swizzle (thread e copies chunk e % 8 of rows
// e / 8 + 32 j), degraded by the thread that copied it (or read from the
// pre-pass's scratch), then read by four m64n128k32 wgmmas a warpgroup.
// One stage's wgmmas stay in flight while the next stage is released and
// refilled (copies run S - 2 stages ahead).  The first wgmma of a
// quantization block does not accumulate, so the int32 sums start at 0
// without a reset; at the block's end they are folded into f32 with the
// scales copied with that stage.
template <bool GATED>
struct WgCfg {
  static constexpr int kThreads = 256;
  static constexpr int BM = 128, BN = GATED ? 64 : 128, BK = 128;
  static constexpr int kTile = 128 * BK;  // bytes of the x (or weight) rows of a stage
  static constexpr int kCopies = 2 * kTile / 16 / kThreads;
  static constexpr int kStages = 5;
  static constexpr int kSmem = kStages * (2 * kTile + 256 * 4) + 1024;  // + alignment
};

// The pre-pass of a long prefill: x and the weights degraded once, word
// by word, into the launch's scratch (x, then each weight), so that the
// wgmma blocks, each of which meets an x row and a weight row many times
// over, read codes already degraded.  Nothing runs at shift 0.
__global__ void __launch_bounds__(256)
axq_degrade_kernel(const __grid_constant__ Args batch, int gated) {
  const Args a = gated ? expert_slice<true>(batch, blockIdx.y)
                       : expert_slice<false>(batch, blockIdx.y);
  const int shift = shift_of(a.ebits);
  if (shift == 0) return;
  const Degrade dg(shift);
  const size_t xw = (size_t)a.M * a.K / 16, ww = (size_t)a.N * a.K / 16;
  const size_t total = xw + (gated ? 2 : 1) * ww;
  uint4* out = static_cast<uint4*>(a.scratch);
  for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < total; i += (size_t)gridDim.x * 256) {
    const uint4* src = i < xw ? reinterpret_cast<const uint4*>(a.qx) + i
                       : i < xw + ww ? reinterpret_cast<const uint4*>(a.qw[0]) + (i - xw)
                                     : reinterpret_cast<const uint4*>(a.qw[1]) + (i - xw - ww);
    out[i] = degrade_vec(dg, __ldg(src));
  }
}

template <bool GATED>
__global__ void __launch_bounds__(256, 1)
axq_wgmma_kernel(const __grid_constant__ Args batch) {
  const Args a = expert_slice<GATED>(batch, blockIdx.z);
  using C = WgCfg<GATED>;
  constexpr int S = C::kStages, BM = C::BM, BN = C::BN, BK = C::BK;
  extern __shared__ __align__(1024) unsigned char wsmem[];
  // tiles 1024-byte aligned: the swizzle is a function of the address
  unsigned char* base = wsmem + ((1024 - (smem_addr(wsmem) & 1023)) & 1023);
  float* scales = reinterpret_cast<float*>(base + S * 2 * C::kTile);  // [S][256]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int M = a.M, N = a.N, K = a.K, bk = a.bk, nb = K / bk;

  // tile order: groups of 8 row tiles, walked column by column
  const int tn = (N + BN - 1) / BN, tm = (M + BM - 1) / BM;
  const int per = 8 * tn, first = (blockIdx.x / per) * 8, gm = min(tm - first, 8);
  const int m0 = (first + (blockIdx.x % per) % gm) * BM;
  const int n0 = ((blockIdx.x % per) / gm) * BN;
  const int spb = bk / BK, steps = nb * spb;
  const int shift = shift_of(a.ebits);
  const bool pre = a.scratch != nullptr && shift != 0;  // the pre-pass degraded the codes
  const int8_t* xq = pre ? static_cast<const int8_t*>(a.scratch) : a.qx;
  const int8_t* wq[2] = {pre ? xq + (size_t)M * K : a.qw[0],
                         pre ? xq + (size_t)(M + N) * K : a.qw[1]};

  // this thread's copies: fixed source rows, destinations in the stage
  const int8_t* src[C::kCopies];
  int dst[C::kCopies];
  unsigned ok = 0;
#pragma unroll
  for (int j = 0; j < C::kCopies; ++j) {
    const int row = (tid >> 3) + 32 * (j % 4), ch = tid & 7;
    bool in;
    if (j < 4) {
      const int m = m0 + row;
      in = m < M;
      src[j] = xq + (size_t)(in ? m : 0) * K;
    } else {
      const int gi = GATED ? row / BN : 0, n = n0 + (GATED ? row % BN : row);
      in = n < N;
      src[j] = wq[gi] + (size_t)(in ? n : 0) * K;
    }
    src[j] += ch * 16;
    dst[j] = (j < 4 ? 0 : C::kTile) + row * BK + ((ch ^ (row & 7)) << 4);
    ok |= (in ? 1u : 0u) << j;
  }
  const float* ssrc;  // this thread's scale row: x rows, then weight rows
  bool sok;
  if (tid < BM) {
    sok = m0 + tid < M;
    ssrc = a.sx + (size_t)(sok ? m0 + tid : 0) * nb;
  } else {
    const int r = tid - BM, gi = GATED ? r / BN : 0, n = n0 + (GATED ? r % BN : r);
    sok = n < N;
    ssrc = (gi == 0 ? a.sw[0] : a.sw[1]) + (size_t)(sok ? n : 0) * nb;
  }
  int fetched_in_block = 0;  // fetch(i) is called for i = 0, 1, 2, ... in order
  auto fetch = [&](int i) {
    if (i < steps) {
      unsigned char* st = base + (i % S) * 2 * C::kTile;
#pragma unroll
      for (int j = 0; j < C::kCopies; ++j)
        cp_async16(st + dst[j], src[j] + i * BK, (ok >> j) & 1u);
      if (++fetched_in_block == spb) {  // this stage ends a block: bring its scales
        cp_async4(scales + (i % S) * 256 + tid, ssrc, sok);
        ++ssrc;
        fetched_in_block = 0;
      }
    }
    cp_async_commit();
  };

  const Degrade dg(shift);
  int d[64];
  float f[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    d[r] = 0;
    f[r] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < S - 2; ++i) fetch(i);
  int step_in_block = 0;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 3>();  // this thread's copies of stage i landed
    unsigned char* st = base + (i % S) * 2 * C::kTile;
    if (shift != 0 && !pre) {  // degrade them in place, once
#pragma unroll
      for (int j = 0; j < C::kCopies; ++j) {
        uint4* w = reinterpret_cast<uint4*>(st + dst[j]);
        *w = degrade_vec(dg, *w);
      }
    }
    fence_async_smem();
    __syncthreads();  // every thread's stage i is in place; stage i - 2's wgmmas are done
    fetch(i + S - 2);
    const uint64_t da = smem_desc(st + wg * 64 * BK), db = smem_desc(st + C::kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)  // +32 bytes: +2 in the address field
      wgmma_s8(d, da + 2 * kk, db + 2 * kk, step_in_block > 0 || kk > 0);
    wgmma_commit();
    if (++step_in_block < spb) {
      wgmma_wait_one();  // the previous stage's wgmmas are done: its slot is free
      continue;
    }
    wgmma_wait_all();  // the block's sums are final
    step_in_block = 0;
    // block ends: fold it (scales of x rows, then of weight rows)
    const float* sc = scales + (i % S) * 256;
    const float sx0 = sc[wg * 64 + (warp & 3) * 16 + g], sx1 = sc[wg * 64 + (warp & 3) * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 sw = *reinterpret_cast<const float2*>(sc + BM + 8 * j + 2 * t);
      f[4 * j + 0] = fold(f[4 * j + 0], d[4 * j + 0], sx0, sw.x);
      f[4 * j + 1] = fold(f[4 * j + 1], d[4 * j + 1], sx0, sw.y);
      f[4 * j + 2] = fold(f[4 * j + 2], d[4 * j + 2], sx1, sw.x);
      f[4 * j + 3] = fold(f[4 * j + 3], d[4 * j + 3], sx1, sw.y);
    }
  }
  cp_async_wait<0>();
  const bool pairs = (N & 1) == 0;  // two adjacent columns as one 8-byte store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float y[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = 4 * j + 2 * h + q;
        const float fr[2] = {f[r], f[GATED ? r + 32 : r]};  // gate columns: 64 on
        y[q] = n + q < N ? epilogue<GATED>(a, fr, m, n + q) : 0.f;
      }
      float* o = a.out + (size_t)m * N + n;
      if (pairs && n < N) {
        *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
      } else {
        if (n < N) o[0] = y[0];
        if (n + 1 < N) o[1] = y[1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// combine: the split units, folded in block order
// ---------------------------------------------------------------------------

// The most parts a quantization block is cut into (a 256-byte block in
// 64-byte parts); unrolled, so that a batch's loads are all in flight before its fold.
constexpr int kMaxParts = 4;

template <bool GATED>
__global__ void __launch_bounds__(256)
axq_combine_kernel(const __grid_constant__ Args batch) {
  const Args a = expert_slice<GATED>(batch, blockIdx.y);
  constexpr int G = GATED ? 2 : 1, B = 8;  // blocks whose loads are in flight together
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= static_cast<long long>(a.M) * a.N) return;
  const int M = a.M, N = a.N, nb = a.K / a.bk, P = a.part, units = nb * P;
  const int m = static_cast<int>(idx / N), n = static_cast<int>(idx % N);
  const size_t plane = (size_t)M * N;
  const int* sp = static_cast<const int*>(a.scratch) + (size_t)m * N + n;
  float f[2] = {0.f, 0.f};
  for (int kb0 = 0; kb0 < nb; kb0 += B) {
    int s[G][B];
    float sxv[B], swv[G][B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int kb = min(kb0 + j, nb - 1);
      sxv[j] = a.sx[(size_t)m * nb + kb];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        int v = 0;
#pragma unroll
        for (int p = 0; p < kMaxParts; ++p)  // a block's parts: an exact int32 sum
          if (p < P) v += sp[(size_t)(gi * units + kb * P + p) * plane];
        s[gi][j] = v;
        swv[gi][j] = a.sw[gi][(size_t)n * nb + kb];
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (kb0 + j < nb) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) f[gi] = fold(f[gi], s[gi][j], sxv[j], swv[gi][j]);
      }
  }
  a.out[(size_t)m * N + n] = epilogue<GATED>(a, f, m, n);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Allow `kernel` `bytes` of dynamic shared memory on the current device,
// once per device (`ready` is the caller's per-instantiation flags).
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  return 0;
}

template <int NT, bool GATED, int CH>
int launch_decode(const Args& a, cudaStream_t s) {
  using T = DecodeTile<NT, GATED, CH>;
  static bool ready[64] = {};
  const int err = allow_smem(axq_decode_kernel<NT, GATED, CH>, T::kSmem, ready);
  if (err != 0) return err;
  axq_decode_kernel<NT, GATED, CH><<<dim3((a.N + 15) / 16, a.n_split, a.E), 32, T::kSmem, s>>>(a);
  return 0;
}

// Steps of 256 bytes where the units allow them, else of 64.
template <int NT, bool GATED>
int launch_decode(const Args& a, cudaStream_t s) {
  return (a.bk / a.part) % (4 * KC) == 0 ? launch_decode<NT, GATED, 4>(a, s)
                                         : launch_decode<NT, GATED, 1>(a, s);
}

template <bool GATED>
int launch_wgmma(const Args& a, cudaStream_t s) {
  using C = WgCfg<GATED>;
  static bool ready[64] = {};
  const int err = allow_smem(axq_wgmma_kernel<GATED>, C::kSmem, ready);
  if (err != 0) return err;
  if (a.scratch != nullptr)  // ~8 blocks an SM over all the experts
    axq_degrade_kernel<<<dim3((132 * 8 + a.E - 1) / a.E, a.E), 256, 0, s>>>(a, GATED);
  const int tiles = ((a.M + C::BM - 1) / C::BM) * ((a.N + C::BN - 1) / C::BN);
  axq_wgmma_kernel<GATED><<<dim3(tiles, 1, a.E), C::kThreads, C::kSmem, s>>>(a);
  return 0;
}

template <int BM, int BN, int WM, int WN, bool GATED>
int launch_tile(const Args& a, cudaStream_t s) {
  using C = TileCfg<BM, BN, WM, WN, GATED>;
  static bool ready[64] = {};
  const int err = allow_smem(axq_tile_kernel<BM, BN, WM, WN, GATED>, C::kSmem, ready);
  if (err != 0) return err;
  const int tiles = ((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  axq_tile_kernel<BM, BN, WM, WN, GATED><<<dim3(tiles, a.n_split, a.E), C::kThreads, C::kSmem,
                                           s>>>(a);
  return 0;
}

bool bad_plan(const Args& a, int cfg) {
  if (a.M <= 0 || a.N <= 0 || a.K <= 0 || a.bk <= 0 || a.bk % KC != 0 || a.K % a.bk != 0)
    return true;
  if (a.part <= 0 || a.part > kMaxParts || a.bk % (KC * a.part) != 0) return true;
  // an expert-batched launch: at most 65535 experts (the grid's z / y),
  // no bias or residual epilogue
  if (a.E <= 0 || a.E > 65535 || (a.E > 1 && (a.bias != nullptr || a.res != nullptr)))
    return true;
  const int nb = a.K / a.bk;
  if (a.n_split <= 0 || a.n_split > nb * a.part) return true;
  if (a.n_split == 1 ? a.part != 1 : a.scratch == nullptr) return true;
  if (cfg == kDecode) return a.M > 16;
  if (cfg == kTileSmall) return a.part != 1;
  if (cfg == kTileLarge) return a.n_split != 1 || a.bk % 128 != 0;
  return true;
}

template <bool GATED>
int dispatch(const Args& a, int cfg, void* stream) {
  if (bad_plan(a, cfg)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (cfg == kDecode) {
    err = a.M <= 8 ? launch_decode<1, GATED>(a, s) : launch_decode<2, GATED>(a, s);
  } else if (cfg == kTileSmall) {
    err = launch_tile<64, GATED ? 32 : 64, 32, GATED ? 16 : 32, GATED>(a, s);
  } else {
    err = launch_wgmma<GATED>(a, s);
  }
  if (err != 0) return err;
  if (a.n_split > 1) {
    const long long n = static_cast<long long>(a.M) * a.N;
    axq_combine_kernel<GATED><<<dim3(static_cast<unsigned>((n + 255) / 256), a.E), 256, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cfg: kDecode (M <= 16), kTileSmall (64-row tiles, mma.sync), kTileLarge
// (128-row tiles, wgmma; bk a multiple of 128, K not split); n_split:
// splits of K (1: fold in the kernel, part must be 1); part: units a
// quantization block (decode only); scratch: int32 (G, K / bk * part, M, N)
// when n_split > 1; for kTileLarge, null or M K + G N K bytes that the
// pre-pass degrades x and the weights into; else null.  The *_experts_
// entries take E experts' contiguous (E, ...) operands and an E-fold
// scratch (each expert's as above, in turn), and no bias or residual.

extern "C" int axqmm_launch(const void* qx, const void* sx, const void* qw,
                            const void* sw, const void* bias, const void* res,
                            const void* ebits, void* out, void* scratch, int M, int N,
                            int K, int bk, int cfg, int n_split, int part, void* stream) {
  const Args a{static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
               {static_cast<const int8_t*>(qw), nullptr},
               {static_cast<const float*>(sw), nullptr},
               static_cast<const float*>(bias), static_cast<const float*>(res),
               static_cast<const int*>(ebits), static_cast<float*>(out),
               scratch, M, N, K, bk, 0, n_split, part, 1};
  return dispatch<false>(a, cfg, stream);
}

extern "C" int axqmm_experts_launch(const void* qx, const void* sx, const void* qw,
                                    const void* sw, const void* ebits, void* out,
                                    void* scratch, int E, int M, int N, int K, int bk, int cfg,
                                    int n_split, int part, void* stream) {
  const Args a{static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
               {static_cast<const int8_t*>(qw), nullptr},
               {static_cast<const float*>(sw), nullptr},
               nullptr, nullptr, static_cast<const int*>(ebits), static_cast<float*>(out),
               scratch, M, N, K, bk, 0, n_split, part, E};
  return dispatch<false>(a, cfg, stream);
}

extern "C" int axqmm_gated_launch(const void* qx, const void* sx, const void* qu,
                                  const void* su, const void* qg, const void* sg,
                                  const void* ebits, void* out, void* scratch, int M, int N,
                                  int K, int bk, int act, int cfg, int n_split, int part,
                                  void* stream) {
  const Args a{static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
               {static_cast<const int8_t*>(qu), static_cast<const int8_t*>(qg)},
               {static_cast<const float*>(su), static_cast<const float*>(sg)},
               nullptr, nullptr, static_cast<const int*>(ebits), static_cast<float*>(out),
               scratch, M, N, K, bk, act, n_split, part, 1};
  return dispatch<true>(a, cfg, stream);
}

extern "C" int axqmm_gated_experts_launch(const void* qx, const void* sx, const void* qu,
                                          const void* su, const void* qg, const void* sg,
                                          const void* ebits, void* out, void* scratch, int E,
                                          int M, int N, int K, int bk, int act, int cfg,
                                          int n_split, int part, void* stream) {
  const Args a{static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
               {static_cast<const int8_t*>(qu), static_cast<const int8_t*>(qg)},
               {static_cast<const float*>(su), static_cast<const float*>(sg)},
               nullptr, nullptr, static_cast<const int*>(ebits), static_cast<float*>(out),
               scratch, M, N, K, bk, act, n_split, part, E};
  return dispatch<true>(a, cfg, stream);
}
