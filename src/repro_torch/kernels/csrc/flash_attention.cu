// flash_attention — full-sequence (prefill) attention forward: causal,
// dense, or causal with a sliding window.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (launched in flash_attention), on all three of its schedules: "dense",
// "tri" (causal) and "band" (causal with a sliding window).
//
//   o[b, s, h] = softmax_j(q[b, s, h] . k[b, j, h/G] / sqrt(D), mask) @ v[b, j, h/G]
//   mask: j < S_real, j <= s when causal, and j > s - window when a window
//   is given (window = 0: none).
//
// What bounds it here: at the serving path's bucketed prompt lengths (S <=
// 4096) the causal work is ~2 S^2 D flops per head against 8 S D bytes of
// q, k, v and o per head; at the sliding-window arch's long prompts (S up
// to 8192, window 4096) the band schedules ~4 S (band blk) D flops per head.
// Past a few hundred tokens both are bound by operations (below, by the
// bytes), so the bf16 body runs its two products on the tensor cores.
//
// Schedules (both bodies).  One block per (q block of `blk` rows,
// batch*head).  The block visits kv blocks 0..i on the "tri" schedule
// (never the upper triangle), all n of them on "dense", or the `band`
// blocks j = max(i - (band - 1), 0) + jj, jj < band, on "band" (as the
// reference, the first band - 1 q blocks also visit upper-triangle blocks,
// which the causal mask empties).  Each kv block is walked in chunks of a
// width fixed per body; a chunk that the mask empties for every row of the
// block is not loaded or computed (it still belongs to its block step).
// The all-masked-row guard (p forced to 0 while the running max is still
// the sentinel) makes a fully masked chunk leave the state untouched
// anyway (corr = exp(0) = 1, p = 0), and the chunks come in the same order
// on every schedule, so every schedule gives bit-identical rows: "dense"
// with a window is the oracle of "band".  Padded query rows and kv columns
// past S are masked in the kernel; nothing is padded or copied.  K/V are
// indexed by kv head h / G straight from the model's grouped (B, S, KVr, D)
// layout, so the caller never repeats K/V to all heads.  With a non-null
// `steps` pointer, thread 0 of each block counts the (q block, kv block)
// pairs its loop visits and adds them atomically, so the count equals the
// reference's planned_grid_steps.
//
// The launcher picks the body by dtype:
//
// bf16 (the serving dtype): tensor cores, FlashAttention-2's design.  Each
// warp owns 16 query rows (ceil(blk / 16) warps; rows at or past the block
// or S are masked).  Its Q tile goes global -> shared once by cp.async and
// stays there for the whole walk; each chunk re-reads it as mma
// A-fragments (ldmatrix.x4) rather than holding them in registers, which
// keeps the body at <= 128 registers (D = 80 included) with no spill, so
// two blocks (16 warps) share an SM; held in registers, they cost ~20 more
// and left one block per SM, which measured slower (PERF.md).  K/V
// stream through shared memory in chunks of CH = 64 kv rows (32 at D = 128,
// below), copied by cp.async.cg in 16-byte pieces straight from the strided
// view and double-buffered (chunk c+1's copy is in flight during chunk c's
// math); rows are padded to D + 8 elements so ldmatrix is free of bank
// conflicts, and rows past the chunk are zero-filled.  S = Q K^T by
// mma.sync.m16n8k16 bf16 -> f32 (K fragments by ldmatrix); the scores are
// scaled by scale * log2(e) and masked per fragment element from its
// (row, col); the online softmax runs in f32 with ex2.approx, row max across the
// quad by shuffles.  P is rounded to bf16 in registers, where its
// accumulator fragment is already the A-fragment of P V (V fragments by
// ldmatrix.trans), and the row sum l adds up the same rounded values, so
// o = (P V) / l stays a weighted mean of V rows (its error scales with
// |v - o|, not |v|); O stays in f32 registers and is written once as bf16.
// The wrapper checks 16-byte alignment of the pointers and strides.
// Dynamic shared memory: (16 * warps + 4 * CH) * (D + 8) * 2 bytes (67,584
// at D = 80 and blk = 128), raised past 48 KB once per instantiation.
// D = 128 (TcTile<128>): O alone is 64 f32 registers a thread, so its
// chunks are 32 kv rows (the scores take 16 registers, not 32), which keeps
// two blocks per SM at <= 128 registers with no spill; 69,632 bytes of
// shared memory at blk = 128.  D = 256 (TcTile<256>): O is 128 registers a
// thread, which no 128-register budget holds; the block keeps its 16-row
// warps and 32-row chunks and runs alone on its SM (__launch_bounds__ min
// blocks 1: up to 255 registers a thread), with 135,168 bytes of shared
// memory at blk = 128.
//
// f32 (the parity mode of the tests): CUDA cores, f32 dots, one thread per
// query row holding its accumulator in registers (D floats), K/V staged as
// f32 in 16-row chunks.  At D = 256 a row takes two neighbouring threads,
// each holding the accumulator of one half of D (D floats would pass the
// 255-register limit): each sums its half of a score, the pair adds the two
// halves by a shuffle (the same sum in both), and each writes its half.  The block's scaled q rows sit in dynamic shared
// memory, d-major so that a warp's 32 rows read 32 banks (q and O both in
// registers would take 256 floats at D = 128, over the 255-register
// limit); the dots run d-outer over the chunk's 16 columns, one fmaf chain
// per score in d order.  bf16 or TF32 tensor-core inputs could not meet its
// 1e-4 tolerance.
//
// Not yet used: wgmma warpgroup tiles, TMA with mbarriers, warp
// specialisation (FlashAttention-3's shape).

#include <type_traits>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;
using repro::from_f32;

constexpr int KT = 16;          // kv rows per shared chunk
constexpr int MAXBLK = 128;     // q/kv block bound (threads per block)

// Schedule codes passed through the C interface.
enum Sched : int { kDense = 0, kTri = 1, kBand = 2 };

struct Strides {
  long long b, s, h;            // element strides of a (B, S, heads, D) view
};

struct Plan {
  int S, H, G, blk, causal, sched, band, window;
};

// Threads a query row of the f32 body: 2 at D = 256, where one thread's D
// accumulators would pass the 255-register limit; 1 below.
__host__ __device__ constexpr int fwd_split(int D) { return D > 128 ? 2 : 1; }

// Query rows of one f32-body block of `blk` rows (its threads, a multiple of
// 32, over the threads a row).
__host__ __device__ constexpr int fwd_rows(int D, int blk) {
  return (blk * fwd_split(D) + 31) / 32 * 32 / fwd_split(D);
}

template <typename T, int D>
__global__ void __launch_bounds__(MAXBLK * fwd_split(D))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int* __restrict__ steps,
                 Plan p, Strides qs_, Strides ks_, Strides os_, float scale) {
  constexpr int R = fwd_split(D);        // threads a query row
  constexpr int DH = D / R;              // accumulators a thread
  __shared__ float ksm[KT][D + 1];
  __shared__ float vsm[KT][D];
  extern __shared__ float qsm[];         // scaled q rows, [D][nrow]

  const int S = p.S, blk = p.blk, window = p.window;
  const int i = blockIdx.x;              // q block
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int tid = threadIdx.x, nrow = blockDim.x / R;
  const int ri = tid / R, d0 = (tid % R) * DH;   // the row, the first column held
  const int row = i * blk + ri;
  const bool live = ri < blk && row < S;
  const int n = (S + blk - 1) / blk;
  const int r_lo = i * blk, r_hi = min(r_lo + blk, S) - 1;   // the block's rows
  int j0 = 0, visits = n;
  if (p.sched == kTri) {
    visits = i + 1;
  } else if (p.sched == kBand) {
    j0 = max(i - (p.band - 1), 0);
    visits = p.band;
  }

  float acc[DH];
  float m = kNegInf, l = 0.f;
  const T* qp = q + b * qs_.b + (long long)min(row, S - 1) * qs_.s + h * qs_.h + d0;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qsm[(d0 + d) * nrow + ri] = live ? to_f32(qp[d]) * scale : 0.f;   // read by this thread only
    acc[d] = 0.f;
  }
  const T* kbase = k + b * ks_.b + kvh * ks_.h;
  const T* vbase = v + b * ks_.b + kvh * ks_.h;

  for (int jj = 0; jj < visits; ++jj) {
    const int j = j0 + jj;
    if (steps != nullptr && tid == 0) atomicAdd(steps, 1);
    for (int c0 = 0; c0 < blk; c0 += KT) {
      // block-uniform: skip a chunk that the mask empties for every row
      const int c_lo = j * blk + c0;
      const int c_hi = min(j * blk + min(c0 + KT, blk), S) - 1;
      if (c_lo >= S || (p.causal && c_lo > r_hi) ||
          (window > 0 && c_hi <= r_lo - window))
        continue;
      __syncthreads();  // the previous chunk is fully consumed
      for (int e = tid; e < KT * D; e += blockDim.x) {
        const int c = e / D, d = e % D;
        const int col = c_lo + c;
        const bool ok = (c0 + c) < blk && col < S;
        ksm[c][d] = ok ? to_f32(kbase[(long long)col * ks_.s + d]) : 0.f;
        vsm[c][d] = ok ? to_f32(vbase[(long long)col * ks_.s + d]) : 0.f;
      }
      __syncthreads();
      // a split row's pair meets in the shuffle below: no thread leaves early
      if (R == 1 && !live) continue;
      float s[KT];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KT; ++c) s[c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        const float qd = qsm[(d0 + d) * nrow + ri];
#pragma unroll
        for (int c = 0; c < KT; ++c) s[c] = fmaf(qd, ksm[c][d0 + d], s[c]);
      }
      if constexpr (R == 2) {
#pragma unroll
        for (int c = 0; c < KT; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
      }
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const int col = c_lo + c;
        const bool ok = (c0 + c) < blk && col < S && (!p.causal || col <= row) &&
                        (window == 0 || col > row - window);
        s[c] = ok ? s[c] : kNegInf;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        s[c] = (s[c] > 0.5f * kNegInf) ? expf(s[c] - m_new) : 0.f;
        psum += s[c];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        float pv = 0.f;
#pragma unroll
        for (int c = 0; c < KT; ++c) pv = fmaf(s[c], vsm[c][d0 + d], pv);
        acc[d] = acc[d] * corr + pv;
      }
    }
  }
  if (!live) return;
  T* op = o + b * os_.b + (long long)row * os_.s + h * os_.h + d0;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DH; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

// Dynamic shared memory of one f32-body block: the scaled q rows.
__host__ __device__ constexpr int fwd_smem_bytes(int D, int blk) {
  return D * fwd_rows(D, blk) * 4;
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int* steps, int B,
           const Plan& p, Strides qs_, Strides ks_, Strides os_, float scale,
           cudaStream_t stream) {
  static bool ready[64] = {};
  const int err = allow_smem(flash_fwd_kernel<T, D>, fwd_smem_bytes(D, MAXBLK), ready);
  if (err != 0) return err;
  const int n = (p.S + p.blk - 1) / p.blk;
  const dim3 grid(n, B * p.H);
  const int threads = fwd_rows(D, p.blk) * fwd_split(D);
  flash_fwd_kernel<T, D><<<grid, threads, fwd_smem_bytes(D, p.blk), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), steps, p, qs_, ks_, os_, scale);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, D>{}) for an instantiated head dim D;
// cudaErrorInvalidValue for any other (the wrapper's _HEAD_DIMS).
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores (mma.sync m16n8k16), cp.async K/V chunks
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WROWS = 16;           // query rows per warp (one mma M tile)
constexpr int MAXWARPS = MAXBLK / WROWS;

// The bf16 body's kv rows per shared chunk, fixed per D so that every
// schedule and every padded length sees the same chunks, and its blocks an
// SM (__launch_bounds__ below): two cap a thread at 65536 / (2 * 256) = 128
// registers, one at 255.
template <int D>
struct TcTile {
  static constexpr int kCh = 64;
  static constexpr int kBlocks = 2;
};

// D = 128: O alone is 64 f32 registers a thread.  64-row chunks (32 score
// registers) spill under the 128-register cap; 32-row chunks (16) fit with
// no spill, at a cost of 6-7% in time against the spilling build (PERF.md,
// tools/tune_flash_tile.py).
template <>
struct TcTile<128> {
  static constexpr int kCh = 32;
  static constexpr int kBlocks = 2;
};

// D = 256: O alone is 128 f32 registers a thread, the whole of a two-block
// budget; one block an SM gives the body 255 (O, 16 score registers of a
// 32-row chunk, the P fragments and the addressing), with no spill.
template <>
struct TcTile<256> {
  static constexpr int kCh = 32;
  static constexpr int kBlocks = 1;
};

__host__ __device__ constexpr int tc_row_elems(int D) { return D + 8; }

__host__ __device__ constexpr int tc_warps(int blk) {
  return blk <= WROWS ? 1 : (blk + WROWS - 1) / WROWS;
}

// Dynamic shared memory of one block: the warps' Q tiles and two stages of
// K and V chunks, rows padded to D + 8 bf16.
template <int D>
__host__ __device__ constexpr int tc_smem_bytes(int blk) {
  return (WROWS * tc_warps(blk) + 4 * TcTile<D>::kCh) * tc_row_elems(D) * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (2 ulp; 2^(-huge) = +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one bf16x2 register (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The two bf16 halves of a packed register as f32.
__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  A holds rows
// g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; the f32 C/D tile
// holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(MAXWARPS * 32, TcTile<D>::kBlocks)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int* __restrict__ steps,
                Plan p, Strides qs_, Strides ks_, Strides os_, float scale_log2) {
  constexpr int CH = TcTile<D>::kCh;   // kv rows per chunk
  constexpr int LD = tc_row_elems(D);  // shared row stride (elements)
  constexpr int KS = D / 16;           // k-steps of Q K^T
  constexpr int NT = D / 8;            // n-tiles of O
  constexpr int NC = CH / 8;           // n-tiles of a chunk's scores
  constexpr int PK = CH / 16;          // k-steps of P V
  constexpr int DP = D / 8;            // 16-byte pieces per row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int S = p.S, blk = p.blk, window = p.window;
  const int nthreads = blockDim.x, nw = nthreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n = (S + blk - 1) / blk;
  const int i = n - 1 - static_cast<int>(blockIdx.y);   // the longest rows first
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int r_lo = i * blk, r_end = min(r_lo + blk, S);  // the block's rows
  const int w_lo = r_lo + w * WROWS;                     // this warp's rows
  const bool w_live = w_lo < r_end;
  int j0 = 0, visits = n;
  if (p.sched == kTri) {
    visits = i + 1;
  } else if (p.sched == kBand) {
    j0 = max(i - (p.band - 1), 0);
    visits = p.band;
  }
  const int cpb = (blk + CH - 1) / CH;                   // chunks per kv block
  const int total = visits * cpb;

  bf16* qsm = reinterpret_cast<bf16*>(smem_raw) + w * WROWS * LD;
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw) + nw * WROWS * LD;   // [2][CH][LD]
  bf16* vsm = ksm + 2 * CH * LD;
  const bf16* kbase = k + b * ks_.b + kvh * ks_.h;
  const bf16* vbase = v + b * ks_.b + kvh * ks_.h;

  // chunk t: kv columns [lo, end) of kv block j0 + t / cpb
  auto chunk_lo = [&](int t) { return (j0 + t / cpb) * blk + (t % cpb) * CH; };
  auto chunk_end = [&](int t) {
    return min((j0 + t / cpb) * blk + min((t % cpb) * CH + CH, blk), S);
  };
  // block-uniform: the next chunk at or after t that the mask does not
  // empty for every row of the block
  auto next_live = [&](int t) {
    for (; t < total; ++t) {
      const int lo = chunk_lo(t), end = chunk_end(t);
      if (lo < end && !(p.causal && lo > r_end - 1) &&
          !(window > 0 && end - 1 <= r_lo - window))
        break;
    }
    return t;
  };
  auto load_chunk = [&](int t, int st) {
    const int lo = chunk_lo(t), width = chunk_end(t) - lo;
    bf16* kd = ksm + st * CH * LD;
    bf16* vd = vsm + st * CH * LD;
    for (int e = tid; e < CH * DP; e += nthreads) {
      const int r = e / DP, c = (e % DP) * 8;
      const bool ok = r < width;
      const long long off = (long long)(ok ? lo + r : lo) * ks_.s + c;
      cp_async16(kd + r * LD + c, kbase + off, ok ? 16 : 0);
      cp_async16(vd + r * LD + c, vbase + off, ok ? 16 : 0);
    }
  };

  // this warp's Q tile (rows past the block or S zero-filled) and the
  // first live chunk: one copy group
  for (int e = lane; e < WROWS * DP; e += 32) {
    const int r = e / DP, c = (e % DP) * 8;
    const int row = w_lo + r;
    const bool ok = row < r_end;
    cp_async16(qsm + r * LD + c,
               q + b * qs_.b + (long long)(ok ? row : r_lo) * qs_.s + h * qs_.h + c,
               ok ? 16 : 0);
  }
  int cur = next_live(0);
  if (cur < total) load_chunk(cur, 0);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  const int row0 = w_lo + g, row1 = row0 + 8;
  int nsteps = 0, st = 0;

  for (int t = 0; t < total; ++t) {
    if (t % cpb == 0) ++nsteps;          // a (q block, kv block) pair
    if (t != cur) continue;              // emptied for the whole block
    cp_async_wait<0>();                  // chunk t (and the Q tile) landed
    __syncthreads();                     // ... for all; stage st ^ 1 is free
    const int nxt = next_live(t + 1);
    if (nxt < total) load_chunk(nxt, st ^ 1);   // in flight during chunk t
    cp_async_commit();
    const int lo = chunk_lo(t), end = chunk_end(t);
    // warp-uniform: skip a chunk the mask empties for all of this warp's rows
    const bool w_skip = !w_live || (p.causal && lo > w_lo + WROWS - 1) ||
                        (window > 0 && end - 1 <= w_lo - window);
    if (!w_skip) {
      const bf16* kt = ksm + st * CH * LD;
      const bf16* vt = vsm + st * CH * LD;
      float s[NC][4];
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) s[nc][0] = s[nc][1] = s[nc][2] = s[nc][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned qa[4];                  // Q's A fragment, re-read from shared
        ldmatrix_x4(qa, qsm + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          unsigned kb[4];
          ldmatrix_x4(kb, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // scale into log2 units; mask per element unless the chunk is full
      // and wholly inside every row's causal window
      const bool full = end - lo == CH && (!p.causal || lo + CH - 1 <= w_lo) &&
                        (window == 0 || lo > w_lo + WROWS - 1 - window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nc][e] * scale_log2;
          if (!full) {
            const int col = lo + nc * 8 + 2 * t4 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool ok = col < end && (!p.causal || col <= row) &&
                            (window == 0 || col > row - window);
            x = ok ? x : kNegInf;
          }
          s[nc][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nc][0], s[nc][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nc][2], s[nc][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = fast_exp2(m0 - mn0), corr1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
      unsigned pa[PK][4];
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        // the guard: masked entries (and rows still at the sentinel) give 0
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nc][e] = s[nc][e] > 0.5f * kNegInf ? fast_exp2(s[nc][e] - (e < 2 ? mn0 : mn1))
                                               : 0.f;
        // the scores' C fragment is P V's A fragment: n-tiles 2kk, 2kk + 1;
        // l sums the same bf16-rounded P, so o is a weighted mean of V
        const unsigned p01 = pack_bf16(s[nc][0], s[nc][1]);
        const unsigned p23 = pack_bf16(s[nc][2], s[nc][3]);
        pa[nc / 2][(nc & 1) * 2] = p01;
        pa[nc / 2][(nc & 1) * 2 + 1] = p23;
        ps0 += bf16_lo(p01) + bf16_hi(p01);
        ps1 += bf16_lo(p23) + bf16_hi(p23);
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= corr0;
        acc[nt][1] *= corr0;
        acc[nt][2] *= corr1;
        acc[nt][3] *= corr1;
      }
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa[kk], vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();
  if (steps != nullptr && tid == 0) atomicAdd(steps, nsteps);
  if (!w_live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* obase = o + b * os_.b + h * os_.h + 2 * t4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (row0 < r_end)
      *reinterpret_cast<unsigned*>(obase + (long long)row0 * os_.s + nt * 8) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (row1 < r_end)
      *reinterpret_cast<unsigned*>(obase + (long long)row1 * os_.s + nt * 8) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int* steps, int B,
              const Plan& p, Strides qs_, Strides ks_, Strides os_, float scale,
              cudaStream_t stream) {
  // the largest block's shared memory, allowed once per device
  static bool ready[64] = {};
  const int err = allow_smem(flash_tc_kernel<D>, tc_smem_bytes<D>(MAXBLK), ready);
  if (err != 0) return err;
  const int n = (p.S + p.blk - 1) / p.blk;
  const dim3 grid(B * p.H, n);
  const float log2e = 1.4426950408889634f;
  flash_tc_kernel<D><<<grid, tc_warps(p.blk) * 32, tc_smem_bytes<D>(p.blk), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), steps, p, qs_, ks_, os_, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o: (B, S, H, D) views, k/v: (B, S, H/G, D) views, given by element
// strides (batch, seq, head); D is contiguous.  sched: 0 dense, 1 tri,
// 2 band (visiting `band` kv blocks per q block); window: the sliding
// window in tokens, 0 for none.  bf16 takes the tensor-core body (16-byte
// aligned pointers and strides), f32 the CUDA-core body.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, void* steps, int B, int S, int H, int G,
                                      int D, int blk, int causal, int sched, int band,
                                      int window,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      int dtype, float scale, void* stream) {
  const int n = (blk > 0) ? (S + blk - 1) / blk : 0;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || blk <= 0 || blk > MAXBLK ||
      sched < kDense || sched > kBand || window < 0 ||
      (sched == kBand && (band <= 0 || band > n)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{S, H, G, blk, causal, sched, band, window};
  const Strides qs_{q_sb, q_ss, q_sh}, ks_{k_sb, k_ss, k_sh}, os_{o_sb, o_ss, o_sh};
  auto st = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<int*>(steps);
  if (dtype != repro::kBF16 && dtype != repro::kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return dtype == repro::kBF16
               ? launch_tc<kD>(q, k, v, o, sp, B, p, qs_, ks_, os_, scale, st)
               : launch<float, kD>(q, k, v, o, sp, B, p, qs_, ks_, os_, scale, st);
  });
}

// Dynamic shared memory the launcher gives one block of the body that
// `dtype` takes; -1 for a block size or head dim the kernel does not take.
extern "C" int flash_attention_smem_bytes(int D, int blk, int dtype) {
  if (blk <= 0 || blk > MAXBLK) return -1;
  const int bytes = with_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return dtype == repro::kBF16 ? tc_smem_bytes<kD>(blk) : fwd_smem_bytes(kD, blk);
  });
  return bytes == static_cast<int>(cudaErrorInvalidValue) ? -1 : bytes;
}
