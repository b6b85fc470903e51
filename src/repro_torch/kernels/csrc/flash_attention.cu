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
// to 8192, window 4096) the band schedules ~4 S (band blk) D flops per head
// and is bound by operations.  This kernel does its dots on the CUDA cores
// in f32, so its own time is set by instruction throughput, well above
// either bound.  Design: one block per (q block of `blk` rows, batch*head),
// one thread per query row holding its scaled q row and f32 accumulator in
// registers.  The block visits kv blocks 0..i on the "tri" schedule (never
// the upper triangle), all n of them on "dense", or the `band` blocks
// j = max(i - (band - 1), 0) + jj, jj < band, on "band" (as the reference,
// the first band - 1 q blocks also visit upper-triangle blocks, which the
// causal mask empties).  Each kv block is staged through shared memory in
// 16-row chunks shared by all rows of the q block, with an f32 online
// softmax.  A chunk that the mask empties for every row of the block is
// not loaded or computed (it still belongs to its block step); the
// all-masked-row guard (p forced to 0 while the running max is still the
// sentinel) makes a fully masked chunk leave the state untouched anyway,
// so every schedule gives bit-identical rows: "dense" with a window is
// the oracle of "band".  Padded query rows and kv columns past S are
// masked in the kernel; nothing is padded or copied.  K/V are indexed by
// kv head h / G straight from the model's grouped (B, S, KVr, D) layout,
// so the caller never repeats K/V to all heads.  With a non-null `steps`
// pointer, thread 0 of each block atomically adds one per visited
// (q block, kv block) pair, so the count equals the reference's
// planned_grid_steps.
// Register state per thread is 2 x D floats (q row and accumulator): 160
// at D = 80, before indices and the chunk's 16 scores.
// Not yet used: tensor-core (wgmma / mma.sync) tiles, TMA, bf16 MMA inputs.

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

template <typename T, int D>
__global__ void __launch_bounds__(MAXBLK)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int* __restrict__ steps,
                 Plan p, Strides qs_, Strides ks_, Strides os_, float scale) {
  __shared__ float ksm[KT][D + 1];
  __shared__ float vsm[KT][D];

  const int S = p.S, blk = p.blk, window = p.window;
  const int i = blockIdx.x;              // q block
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int tid = threadIdx.x;
  const int row = i * blk + tid;
  const bool live = tid < blk && row < S;
  const int n = (S + blk - 1) / blk;
  const int r_lo = i * blk, r_hi = min(r_lo + blk, S) - 1;   // the block's rows
  int j0 = 0, visits = n;
  if (p.sched == kTri) {
    visits = i + 1;
  } else if (p.sched == kBand) {
    j0 = max(i - (p.band - 1), 0);
    visits = p.band;
  }

  float qr[D], acc[D];
  float m = kNegInf, l = 0.f;
  const T* qp = q + b * qs_.b + (long long)min(row, S - 1) * qs_.s + h * qs_.h;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(qp[d]) * scale : 0.f;
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
      if (!live) continue;
      float s[KT];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const int col = c_lo + c;
        const bool ok = (c0 + c) < blk && col < S && (!p.causal || col <= row) &&
                        (window == 0 || col > row - window);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ksm[c][d], dot);
        s[c] = ok ? dot : kNegInf;
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
      for (int d = 0; d < D; ++d) {
        float pv = 0.f;
#pragma unroll
        for (int c = 0; c < KT; ++c) pv = fmaf(s[c], vsm[c][d], pv);
        acc[d] = acc[d] * corr + pv;
      }
    }
  }
  if (!live) return;
  T* op = o + b * os_.b + (long long)row * os_.s + h * os_.h;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int* steps, int B,
            const Plan& p, Strides qs_, Strides ks_, Strides os_, float scale,
            cudaStream_t stream) {
  const int n = (p.S + p.blk - 1) / p.blk;
  const dim3 grid(n, B * p.H);
  const int threads = ((p.blk + 31) / 32) * 32;
  flash_fwd_kernel<T, D><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), steps, p, qs_, ks_, os_, scale);
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* o, int* steps, int B,
           int D, const Plan& p, Strides qs_, Strides ks_, Strides os_, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, steps, B, p, qs_, ks_, os_, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, o, steps, B, p, qs_, ks_, os_, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, steps, B, p, qs_, ks_, os_, scale, stream); break;
    case 80: launch<T, 80>(q, k, v, o, steps, B, p, qs_, ks_, os_, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o: (B, S, H, D) views, k/v: (B, S, H/G, D) views, given by element
// strides (batch, seq, head); D is contiguous.  sched: 0 dense, 1 tri,
// 2 band (visiting `band` kv blocks per q block); window: the sliding
// window in tokens, 0 for none.
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
  if (dtype == repro::kBF16)
    return by_dim<__nv_bfloat16>(q, k, v, o, sp, B, D, p, qs_, ks_, os_, scale, st);
  if (dtype == repro::kF32)
    return by_dim<float>(q, k, v, o, sp, B, D, p, qs_, ks_, os_, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
