// flash_decode — one-token GQA attention against the serving KV cache.
//
// Replaces the TPU kernels repro/kernels/flash_decode.py::_decode_kernel
// (launched in flash_decode; bf16/f32 cache) and ::_decode_kernel_quant
// (launched in flash_decode_quant; int8 cache with per-(token, head) f32
// scales and the runtime effective-bits degrade of the codes).
//
//   out[b, h, g] = softmax_t(q[b, h, g] . k[b, t, h] / sqrt(D)) @ v[b, t, h]
//   over t < nvalid[b]; slots with active[b] == 0 write exact zeros.
//   int8 cache: k[b, t, h] = degrade(kq[b, t, h], ebits) * ks[b, t, h]
//   (and the same for v), degrade rounding to nearest at 2^(8 - ebits)
//   and saturating to +-127 (repro.core.quantization.degrade).
//
// What bounds it: each cached K/V row is read once and meets the G query
// rows of its group, so a bf16 cache gives G flops per byte (8 at G = 8)
// and the int8 cache twice that: the kernel is bound by device-memory
// bytes.  The card's f32 rate outside the tensor cores is ~20 flops per
// byte of its memory rate, so at G = 8 the FMAs must run at ~40% of that
// rate to keep up: the arithmetic is register-blocked.  Tensor cores are
// not used: bf16 mma.sync rounds q and P, TF32 rounds q and K, and either
// moves the result past the 1e-4 (bf16 cache) / 1e-5 (int8 cache) gates,
// for work whose pace the bytes set anyway.
//
// Design, for the bytes:
//  * Splits.  The grid is (n_split, KVr, B): split s of a (slot, kv head)
//    covers cache rows [s W, min((s + 1) W, nvalid[b])), at absolute
//    positions, W fixed per head dim (Split below).  A block whose split
//    starts at or past nvalid[b] (read on the device) exits at once, so
//    rows past a slot's length are never read (the reference's runtime
//    tile skipping), and the card fills with one block per W live rows.
//  * Combine.  Each live split writes its f32 partial (acc[G][D], m, l)
//    to scratch; a second kernel, launched from the same C entry point,
//    merges each slot's partials in a fixed order (ascending splits in
//    each of a few split lanes, then the lanes in order) and writes out
//    (a slot with one live split is written directly).  The result is a pure function of the slot's rows and length:
//    bit-identical across launches, batch sizes and cache capacities.
//    Nothing is read on the host and no state outlives a call: safe to
//    capture in a CUDA graph.  A merge by the last-arriving split inside
//    decode_kernel (threadfence + a per-(slot, kv head) arrival counter)
//    was measured slower: one block then pulls every partial of its slot
//    through one SM (PERF.md).
//  * Copies.  Each split walks its rows in 32-row tiles through a ring of
//    shared-memory stages filled by 16-byte cp.async.cg copies (neighbour
//    threads, neighbour 16-byte pieces of a row; the int8 scales by 4-byte
//    copies), tiles ahead in flight while one is computed.  Tiles stay in
//    their stored type (bf16, f32 or int8 codes) in shared memory; rows
//    past the split's end are zero-filled without a read.
//  * Arithmetic, f32 on the CUDA cores.  A block has one warp per query row
//    of a P.V register block (GQ = 4 rows for groups of at most 4, else 8:
//    128 or 256 threads).  Scores: LPR = 4 or 8 lanes a tile row, each
//    converting its share of the row's 8-element chunks to f32 in
//    registers once and using it for every query row of the group
//    (broadcast float4 reads of the scaled q), summed by shuffles.  Online
//    softmax: one warp a query row, expf, masked entries exact zeros (the
//    reference's s > 0.5 NEG_INF guard).  P.V: a thread owns GQ query rows
//    x 8 columns in registers and a group of tile rows, so each V element
//    is converted once and meets GQ query rows; the row groups' blocks are
//    summed in a fixed order at the split's end.  int8: the codes are
//    degraded at shift = max(8 - *ebits, 0) (read from the device degree
//    operand: a QoS rung move rebuilds nothing) as they are converted; the
//    K scale multiplies the score, the V scale the probability.

#include <type_traits>

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int BT = 32;        // cache rows a tile (one per lane of a softmax warp)
constexpr int STAGES = 2;     // tiles of the cp.async ring
constexpr int CH = 8;         // row elements a chunk (a thread's unit of a row)
constexpr int MAXG = 32;
constexpr int MAXGD = 2048;   // G * D bound below D = 256

// G * D bound at head dim D: 16 query rows at D = 256 (recurrentgemma-2b's
// group of 10 over one kv head), MAXGD below.
__host__ __device__ constexpr int max_gd(int D) { return D > 128 ? 16 * D : MAXGD; }
constexpr int PT = MAXG + 4;  // row stride (floats) of the p^T tile
constexpr int NTC = 128;      // threads a combine block

// Cache rows a split, fixed per head dim so that a slot's splits sit at
// the same absolute positions whatever the batch or cache capacity.  Each
// width is the fastest of 64, 128, 256 and 512 on an H100 at the slot
// lengths of a steady serving tick of the arch that has the head dim
// (tinyllama-1.1b's path 3 at D = 64, h2o-danube-1.8b's 3e at 80,
// qwen2.5-3b's 3g at 128; tools/tune_decode_split.py, PERF.md); no one
// width came within 5% of each of them.  D = 256 (recurrentgemma-2b's ring
// of 2048) takes 128, untuned: 16 splits of its 8 slots fill the card once.
template <int D>
struct Split {
  static constexpr int W = D == 64 ? 64 : D == 80 ? 256 : 128;
};

// f(std::integral_constant<int, D>{}) for an instantiated head dim D;
// cudaErrorInvalidValue for any other (the wrapper's HEAD_DIMS; D = 256
// only with kWide: the bf16/f32 cache, not the int8 one, which no path
// reaches at D = 256, the wrapper's QUANT_HEAD_DIMS).
template <bool kWide, typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256:
      if constexpr (kWide) return f(std::integral_constant<int, 256>{});
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Query rows a P.V register block at head dim D for a group of G: 4 for
// groups of at most 4 below D = 256, else 8 (D = 256 has the one width).
__host__ __device__ constexpr int gq_for(int D, int G) { return G <= 4 && D <= 128 ? 4 : 8; }

// Blocks an SM of decode_kernel's launch bounds: at D = 256 one, so that a
// thread may hold the 8 x 8 P.V block and its 32 floats of a K row in up to
// 255 registers (B x KVr x T / W blocks fill the card about once at
// recurrentgemma-2b's decode anyway); below, 4 for 4-row and 2 for 8-row
// P.V blocks.
__host__ __device__ constexpr int decode_blocks(int D, int GQ) {
  return D > 128 ? 1 : GQ == 4 ? 4 : 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy through L2; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4-byte global -> shared copy; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Byte I of w, sign-extended (prmt's sign-replicate selector).
template <int I>
__device__ __forceinline__ int sbyte(unsigned w) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(w), "r"(0), "n"(I | ((8 | I) << 4) | ((8 | I) << 8) | ((8 | I) << 12)));
  return r;
}

// An integer |v| < 2^22 as f32, exactly (1.5 * 2^23 carries it in its mantissa).
__device__ __forceinline__ float int_f32(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.f;
}

// Rows of a bf16/f32 cache: (B, T, KVr, D).
template <typename KV>
struct FloatRows {
  using Elem = KV;
  static constexpr bool kScaled = false;
  const unsigned char* k;
  const unsigned char* v;

  // this block's (slot b, kv head h) view: row 0 of its cache
  __device__ FloatRows at(int b, int h, int T, int KVr, int D) const {
    const size_t off = ((size_t)b * T * KVr + h) * D * sizeof(KV);
    return {k + off, v + off};
  }

  // 8 elements at p (shared memory) to f32
  __device__ __forceinline__ void chunk(const unsigned char* p, float (&f)[CH]) const {
    if constexpr (sizeof(KV) == 2) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
  }
};

// Rows of an int8 cache: codes (B, T, KVr, D) int8, scales (B, T, KVr) f32,
// degraded by shift = max(8 - *ebits, 0) low bits as they are converted.
struct Int8Rows {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  const int* ebits;  // the runtime degree, read on the device
  int shift;

  __device__ Int8Rows at(int b, int h, int T, int KVr, int D) const {
    const size_t off = (size_t)b * T * KVr + h;
    return {k + off * D, v + off * D, ks + off, vs + off, ebits, max(8 - *ebits, 0)};
  }

  __device__ __forceinline__ void chunk(const unsigned char* p, float (&f)[CH]) const {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    int c[CH] = {sbyte<0>(x.x), sbyte<1>(x.x), sbyte<2>(x.x), sbyte<3>(x.x),
                 sbyte<0>(x.y), sbyte<1>(x.y), sbyte<2>(x.y), sbyte<3>(x.y)};
    if (shift > 0) {  // round to nearest at 2^shift, saturate to +-127
      const int half = 1 << (shift - 1), keep = ~((1 << shift) - 1);
#pragma unroll
      for (int i = 0; i < CH; ++i) c[i] = min(max((c[i] + half) & keep, -127), 127);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) f[i] = int_f32(c[i]);
  }
};

// A block of decode_kernel with GQ query rows a P.V register block: one
// warp per query row of a block (128 threads for groups of at most 4, 256
// above), LPR score lanes a tile row, RPW tile rows a scoring warp.
template <int GQ>
struct Threads {
  static constexpr int kN = 32 * GQ;
  static constexpr int kLPR = kN / BT;
  static constexpr int kRPW = 32 / kLPR;
};

// Bytes a tile row takes in shared memory: 16-byte units padded so that the
// 8 lanes of a quarter-warp reading chunks of the score rows (rpw rows,
// 8 / rpw neighbouring chunks each) fall in 8 different groups of banks.
constexpr int row_stride(int row_bytes, int rpw) {
  int u = row_bytes / 16 + 1;
  while (rpw == 8 ? u % 2 == 0 : u % 8 != 2) ++u;
  return 16 * u;
}

// Shared-memory layout of one block.
template <typename Rows, int D, int GQ>
struct Tile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(typename Rows::Elem));
  static constexpr int kStride = row_stride(kRowBytes, Threads<GQ>::kRPW);
  static constexpr int kPieces = kRowBytes / 16;  // 16-byte copies a row
  static constexpr int kKV = BT * kStride;        // one K (or V) tile
  static constexpr int kStage = 2 * kKV + (Rows::kScaled ? 2 * BT * 4 : 0);
  // the ring, which every thread's P.V block reuses at the split's end
  static constexpr int kRed = Threads<GQ>::kN * GQ * CH * 4;
  static constexpr int kRing = STAGES * kStage > kRed ? STAGES * kStage : kRed;
  static constexpr int kSmem = kRing + (max_gd(D) + MAXG * (BT + 1) + BT * PT + 3 * MAXG) * 4;
};

// GQ query rows a P.V register block (gq_for).
template <typename Rows, int D, int GQ>
__global__ void __launch_bounds__(Threads<GQ>::kN, decode_blocks(D, GQ))
decode_kernel(Rows rows, const float* __restrict__ q, const int* __restrict__ nvalid,
              const int* __restrict__ active, float* __restrict__ out,
              float* __restrict__ part, int T, int KVr, int G, float scale) {
  using L = Tile<Rows, D, GQ>;
  constexpr int NT = Threads<GQ>::kN;
  constexpr int LPR = Threads<GQ>::kLPR;
  constexpr int RPW = Threads<GQ>::kRPW;
  constexpr int W = Split<D>::W;
  constexpr int NCH = D / CH;          // chunks a row
  constexpr int KCH = (NCH + LPR - 1) / LPR;  // chunks of a row one score lane holds
  constexpr int ESZ = sizeof(typename Rows::Elem);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kRing);  // scaled q [G][D]
  float* sc = qs + max_gd(D);                             // scores [MAXG][BT + 1]
  float* pt = sc + MAXG * (BT + 1);                       // probabilities [BT][PT]
  float* m_s = pt + BT * PT;                              // running max a query row
  float* l_s = m_s + MAXG;                                // running sum
  float* c_s = l_s + MAXG;                                // this tile's rescale

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int GD = G * D;
  const int nv = active[b] != 0 ? max(min(nvalid[b], T), 0) : 0;
  const int n_live = (nv + W - 1) / W;
  float* o = out + ((size_t)b * KVr + h) * GD;
  if (n_live == 0) {  // a free slot: exact zeros, written by split 0 alone
    if (split == 0)
      for (int e = tid; e < GD; e += NT) o[e] = 0.f;
    return;
  }
  if (split >= n_live) return;  // past the slot's length: nothing to read
  const int t_begin = split * W, t_end = min(t_begin + W, nv);
  const int n_tiles = (t_end - t_begin + BT - 1) / BT;
  const Rows r = rows.at(b, h, T, KVr, D);
  const size_t row_step = (size_t)KVr * L::kRowBytes;  // bytes between cache rows

  auto stage = [&](int i) { return smem + (i % STAGES) * L::kStage; };
  auto load = [&](int i) {
    if (i < n_tiles) {
      unsigned char* st = stage(i);
      const int t0 = t_begin + i * BT;
      for (int e = tid; e < BT * L::kPieces; e += NT) {
        const int row = e / L::kPieces, piece = e - row * L::kPieces;
        const bool ok = t0 + row < t_end;
        const size_t src = (size_t)(ok ? t0 + row : t0) * row_step + piece * 16;
        const int dst = row * L::kStride + piece * 16;
        cp_async16(st + dst, r.k + src, ok ? 16 : 0);
        cp_async16(st + L::kKV + dst, r.v + src, ok ? 16 : 0);
      }
      if constexpr (Rows::kScaled) {
        for (int e = tid; e < 2 * BT; e += NT) {
          const int row = e % BT;
          const bool ok = t0 + row < t_end;
          const float* src = (e < BT ? r.ks : r.vs) + (size_t)(ok ? t0 + row : t0) * KVr;
          cp_async4(st + 2 * L::kKV + e * 4, src, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);

  const float* qb = q + ((size_t)b * KVr + h) * GD;
  for (int e = tid; e < GD; e += NT) qs[e] = qb[e] * scale;
  for (int e = tid; e < BT * PT; e += NT) pt[e] = 0.f;  // query rows past G stay 0
  if (tid < MAXG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }

  // scores: LPR lanes a tile row, lane qj summing chunks qj, qj + LPR, ...
  const int q_row = (tid & (RPW - 1)) + RPW * (tid >> 5);
  const int qj = (tid & 31) / RPW;
  // P.V: thread (row group pr, query block pgb, chunk pc)
  const int nGB = (G + GQ - 1) / GQ;
  const int R = NT / (NCH * nGB);
  const int pc = tid % NCH, pgb = (tid / NCH) % nGB, pr = tid / (NCH * nGB);
  const bool pv_on = pr < R;
  float acc[GQ][CH];
#pragma unroll
  for (int g = 0; g < GQ; ++g)
#pragma unroll
    for (int d = 0; d < CH; ++d) acc[g][d] = 0.f;

  const int warp = tid >> 5, lane = tid & 31;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed for every thread; tile i - 1 consumed
    load(i + STAGES - 1);
    const unsigned char* st = stage(i);
    const int n_rows = min(BT, t_end - (t_begin + i * BT));

    {  // scores of this tile's rows, every query row of the group
      float kr[KCH][CH];
#pragma unroll
      for (int j = 0; j < KCH; ++j) {
        const int c = qj + LPR * j;
        if (c < NCH) r.chunk(st + q_row * L::kStride + c * CH * ESZ, kr[j]);
      }
      float ksc = 1.f;
      if constexpr (Rows::kScaled) ksc = reinterpret_cast<const float*>(st + 2 * L::kKV)[q_row];
      const bool ok = q_row < n_rows;
#pragma unroll 2
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < KCH; ++j) {
          const int c = qj + LPR * j;
          if (c < NCH) {
            const float4 a = *reinterpret_cast<const float4*>(qg + c * CH);
            const float4 a2 = *reinterpret_cast<const float4*>(qg + c * CH + 4);
            s = fmaf(a.x, kr[j][0], s);
            s = fmaf(a.y, kr[j][1], s);
            s = fmaf(a.z, kr[j][2], s);
            s = fmaf(a.w, kr[j][3], s);
            s = fmaf(a2.x, kr[j][4], s);
            s = fmaf(a2.y, kr[j][5], s);
            s = fmaf(a2.z, kr[j][6], s);
            s = fmaf(a2.w, kr[j][7], s);
          }
        }
#pragma unroll
        for (int o = RPW; o < 32; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (qj == g % LPR) sc[g * (BT + 1) + q_row] = ok ? s * ksc : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax, a warp a query row, lane = tile row
      float vsc = 1.f;
      if constexpr (Rows::kScaled)
        vsc = reinterpret_cast<const float*>(st + 2 * L::kKV)[BT + lane];
      for (int g = warp; g < G; g += NT / 32) {
        const float s = sc[g * (BT + 1) + lane];
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, repro::warp_max(s));
        const float p = (s > 0.5f * kNegInf) ? expf(s - m_new) : 0.f;
        const float psum = repro::warp_sum(p);
        pt[lane * PT + g] = p * vsc;
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_s[g] = corr;
          l_s[g] = l_s[g] * corr + psum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();

    if (pv_on) {  // P.V into this thread's GQ x 8 block
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        const float corr = c_s[pgb * GQ + g];
#pragma unroll
        for (int d = 0; d < CH; ++d) acc[g][d] *= corr;
      }
      for (int t = pr; t < n_rows; t += R) {
        float vr[CH];
        r.chunk(st + L::kKV + t * L::kStride + pc * CH * ESZ, vr);
        float p[GQ];
#pragma unroll
        for (int g = 0; g < GQ; g += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pt + t * PT + pgb * GQ + g);
          p[g] = p4.x;
          p[g + 1] = p4.y;
          p[g + 2] = p4.z;
          p[g + 3] = p4.w;
        }
#pragma unroll
        for (int g = 0; g < GQ; ++g)
#pragma unroll
          for (int d = 0; d < CH; ++d) acc[g][d] = fmaf(p[g], vr[d], acc[g][d]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the row groups' blocks, summed in row-group order
  const int Gp = nGB * GQ;
  float* red = reinterpret_cast<float*>(smem);  // [R][Gp][D]
  if (pv_on) {
    float* dst = red + ((size_t)pr * Gp + pgb * GQ) * D + pc * CH;
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      reinterpret_cast<float4*>(dst + g * D)[0] =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      reinterpret_cast<float4*>(dst + g * D)[1] =
          make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  const int n_split = gridDim.x;
  const int PD = D + 4;  // a partial row: acc[D], m, l and two pad floats (16-byte rows)
  float* pp = part + (((size_t)b * KVr + h) * n_split + split) * G * PD;
  for (int e = tid; e < GD; e += NT) {
    float a = red[e];
    for (int rg = 1; rg < R; ++rg) a += red[rg * Gp * D + e];
    const int g = e / D;
    if (n_live == 1)
      o[e] = a / fmaxf(l_s[g], 1e-30f);
    else
      pp[g * PD + e - g * D] = a;
  }
  if (n_live == 1) return;
  if (tid < G) {
    pp[tid * PD + D] = m_s[tid];
    pp[tid * PD + D + 1] = l_s[tid];
  }
}

// Merge the live splits' partials of one (slot, kv head, query row) in
// split order: out = sum_s acc_s exp(m_s - M) / sum_s l_s exp(m_s - M),
// M = max_s m_s.  Thread (split lane sl, column quad q) sums the splits
// [sl k, (sl + 1) k) in order; the split lanes' sums are then added in
// lane order, so the merge is a fixed function of the slot's length.  A
// slot with at most one live split was written by decode_kernel.
template <int D>
__global__ void __launch_bounds__(NTC)
combine_kernel(const float* __restrict__ part, const int* __restrict__ nvalid,
               const int* __restrict__ active, float* __restrict__ out, int T, int KVr,
               int G) {
  constexpr int W = Split<D>::W;
  constexpr int PD = D + 4;
  constexpr int NQ = D / 4;    // column quads of a query row
  constexpr int SL = NTC / NQ;  // split lanes
  __shared__ float4 lane_o[SL][NQ];
  __shared__ float lane_m[SL], lane_l[SL];
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = active[b] != 0 ? max(min(nvalid[b], T), 0) : 0;
  const int n_live = (nv + W - 1) / W;
  if (n_live <= 1) return;
  const int tid = threadIdx.x, q = tid % NQ, sl = tid / NQ;
  const bool on = sl < SL;
  const int k = (n_live + SL - 1) / SL;
  const int s0 = min(sl * k, n_live), s1 = min(s0 + k, n_live);
  const float* pg = part + (((size_t)b * KVr + h) * ((T + W - 1) / W) * G + g) * PD;
  const size_t step = (size_t)G * PD;  // floats between splits
  float m = kNegInf;
  if (on) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) m = fmaxf(m, pg[s * step + D]);
    if (q == 0) lane_m[sl] = m;
  }
  __syncthreads();
  float M = kNegInf;
  for (int i = 0; i < SL; ++i) M = fmaxf(M, lane_m[i]);
  if (on) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float* ps = pg + s * step;
      const float2 ml = *reinterpret_cast<const float2*>(ps + D);
      const float4 a = *reinterpret_cast<const float4*>(ps + 4 * q);
      const float w = expf(ml.x - M);
      o.x = fmaf(a.x, w, o.x);
      o.y = fmaf(a.y, w, o.y);
      o.z = fmaf(a.z, w, o.z);
      o.w = fmaf(a.w, w, o.w);
      l = fmaf(ml.y, w, l);
    }
    lane_o[sl][q] = o;
    if (q == 0) lane_l[sl] = l;
  }
  __syncthreads();
  if (sl == 0) {
    float4 o = lane_o[0][q];
    float l = lane_l[0];
    for (int i = 1; i < SL; ++i) {
      o.x += lane_o[i][q].x;
      o.y += lane_o[i][q].y;
      o.z += lane_o[i][q].z;
      o.w += lane_o[i][q].w;
      l += lane_l[i];
    }
    const float inv = fmaxf(l, 1e-30f);
    reinterpret_cast<float4*>(out + (((size_t)b * KVr + h) * G + g) * D)[q] =
        make_float4(o.x / inv, o.y / inv, o.z / inv, o.w / inv);
  }
}

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

// decode_kernel over the (split, kv head, slot) grid, then, when a slot can
// have more than one live split, combine_kernel over (query row, kv head,
// slot), both on `stream`.
template <typename Rows, int D, int GQ>
int launch(const Rows& rows, const void* q, const int* nvalid, const int* active, float* out,
           float* part, int B, int T, int KVr, int G, float scale, cudaStream_t stream) {
  static bool ready[64] = {};
  constexpr int smem = Tile<Rows, D, GQ>::kSmem;
  const int err = allow_smem(decode_kernel<Rows, D, GQ>, smem, ready);
  if (err != 0) return err;
  const int n_split = (T + Split<D>::W - 1) / Split<D>::W;
  decode_kernel<Rows, D, GQ><<<dim3(n_split, KVr, B), Threads<GQ>::kN, smem, stream>>>(
      rows, static_cast<const float*>(q), nvalid, active, out, part, T, KVr, G, scale);
  if (n_split > 1)
    combine_kernel<D><<<dim3(G, KVr, B), NTC, 0, stream>>>(part, nvalid, active, out, T, KVr, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename Rows, int D>
int launch(const Rows& rows, const void* q, const void* nvalid, const void* active, void* out,
           void* part, int B, int T, int KVr, int G, float scale, cudaStream_t stream) {
  auto nv = static_cast<const int*>(nvalid);
  auto act = static_cast<const int*>(active);
  auto o = static_cast<float*>(out);
  auto pp = static_cast<float*>(part);
  if constexpr (gq_for(D, 1) == 4) {
    if (G <= 4) return launch<Rows, D, 4>(rows, q, nv, act, o, pp, B, T, KVr, G, scale, stream);
  }
  return launch<Rows, D, 8>(rows, q, nv, act, o, pp, B, T, KVr, G, scale, stream);
}

bool bad_shape(int B, int T, int KVr, int G, int D) {
  return B <= 0 || T <= 0 || KVr <= 0 || G <= 0 || G > MAXG || G * D > max_gd(D);
}

}  // namespace

// Cache rows a split at head dim D (the partial scratch holds ceil(T / W)
// splits); -1 for a head dim the kernel does not take.
extern "C" int flash_decode_split_width(int D) {
  const int w = with_head_dim<true>(D, [](auto dim) { return Split<decltype(dim)::value>::W; });
  return w == static_cast<int>(cudaErrorInvalidValue) ? -1 : w;
}

// Dynamic shared memory of one decode_kernel block for a cache of `kind`
// (0 f32, 1 bf16, 2 int8) at head dim D and group size G; -1 for a head dim
// or kind the kernel does not take.
extern "C" int flash_decode_smem_bytes(int D, int kind, int G) {
  if (kind < 0 || kind > 2 || G <= 0 || G > MAXG || (kind == 2 && D > 128)) return -1;
  const int bytes = with_head_dim<true>(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    if (gq_for(kD, G) == 4)
      return kind == repro::kF32    ? Tile<FloatRows<float>, kD, 4>::kSmem
             : kind == repro::kBF16 ? Tile<FloatRows<__nv_bfloat16>, kD, 4>::kSmem
                                    : Tile<Int8Rows, kD, 4>::kSmem;
    return kind == repro::kF32    ? Tile<FloatRows<float>, kD, 8>::kSmem
           : kind == repro::kBF16 ? Tile<FloatRows<__nv_bfloat16>, kD, 8>::kSmem
                                  : Tile<Int8Rows, kD, 8>::kSmem;
  });
  return bytes == static_cast<int>(cudaErrorInvalidValue) ? -1 : bytes;
}

// part: f32 scratch (B, KVr, ceil(T / W), G, D + 4), 16-byte aligned.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* nvalid, const void* active, void* out,
                                   void* part, int B, int T, int KVr, int G, int D,
                                   int kv_dtype, float scale, void* stream) {
  if (bad_shape(B, T, KVr, G, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto kb = static_cast<const unsigned char*>(k);
  auto vb = static_cast<const unsigned char*>(v);
  if (kv_dtype == repro::kBF16) {
    return with_head_dim<true>(D, [&](auto dim) {
      return launch<FloatRows<__nv_bfloat16>, decltype(dim)::value>(
          {kb, vb}, q, nvalid, active, out, part, B, T, KVr, G, scale, s);
    });
  }
  if (kv_dtype == repro::kF32) {
    return with_head_dim<true>(D, [&](auto dim) {
      return launch<FloatRows<float>, decltype(dim)::value>(
          {kb, vb}, q, nvalid, active, out, part, B, T, KVr, G, scale, s);
    });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_decode_quant_launch(const void* q, const void* k, const void* ks,
                                         const void* v, const void* vs, const void* nvalid,
                                         const void* active, const void* ebits, void* out,
                                         void* part, int B, int T, int KVr, int G, int D,
                                         float scale, void* stream) {
  if (bad_shape(B, T, KVr, G, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Int8Rows rows{static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
                      static_cast<const float*>(ks), static_cast<const float*>(vs),
                      static_cast<const int*>(ebits), 0};
  return with_head_dim<false>(D, [&](auto dim) {
    return launch<Int8Rows, decltype(dim)::value>(rows, q, nvalid, active, out, part, B, T,
                                                   KVr, G, scale,
                                                   static_cast<cudaStream_t>(stream));
  });
}
