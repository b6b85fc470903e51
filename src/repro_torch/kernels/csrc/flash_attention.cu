// flash_attention — full-sequence (prefill) attention forward, causal or dense.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (launched in flash_attention), on its "tri" (causal) and "dense" schedules.
//
//   o[b, s, h] = softmax_j(q[b, s, h] . k[b, j, h/G] / sqrt(D), mask) @ v[b, j, h/G]
//   mask: j < S_real, and j <= s when causal.
//
// What bounds it here: at the serving path's prompt lengths (S <= 512,
// D = 64) the causal work is ~2 S^2 D flops per head against 8 S D bytes
// of q, k, v and o per head, below the card's bf16 flops-per-byte balance
// point, so the least time is set by bytes.  This first kernel does its
// dots on the CUDA cores in f32, so its own time is set by instruction
// throughput, well above that bound.  Design: one block per
// (q block of `blk` rows, batch*head), one thread per query row holding
// its scaled q row and f32 accumulator in registers.  The block visits kv
// blocks 0..i on the causal schedule (never the upper triangle) or all of
// them on the dense one, staging each kv block through shared memory in
// 16-row chunks shared by all rows of the q block, with an f32 online
// softmax.  The all-masked-row guard (p forced to 0 while the running max is
// still the sentinel) makes a fully masked chunk leave the state untouched,
// so both schedules give bit-identical rows.  Padded query rows and kv
// columns past S are masked in the kernel; nothing is padded or copied.
// K/V are indexed by kv head h / G straight from the model's grouped
// (B, S, KVr, D) layout, so the caller never repeats K/V to all heads.
// With a non-null `steps` pointer, thread 0 of each block atomically adds
// one per visited (q block, kv block) pair.
// Not yet used: tensor-core (wgmma / mma.sync) tiles, TMA, bf16 MMA inputs.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;
using repro::from_f32;

constexpr int KT = 16;          // kv rows per shared chunk
constexpr int MAXBLK = 128;     // q/kv block bound (threads per block)

struct Strides {
  long long b, s, h;            // element strides of a (B, S, heads, D) view
};

template <typename T, int D>
__global__ void __launch_bounds__(MAXBLK)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int* __restrict__ steps,
                 int S, int H, int G, int blk, int causal, int tri, Strides qs_,
                 Strides ks_, Strides os_, float scale) {
  __shared__ float ksm[KT][D + 1];
  __shared__ float vsm[KT][D];

  const int i = blockIdx.x;              // q block
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int tid = threadIdx.x;
  const int row = i * blk + tid;
  const bool live = tid < blk && row < S;
  const int n = (S + blk - 1) / blk;
  const int j_end = tri ? i + 1 : n;

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

  for (int j = 0; j < j_end; ++j) {
    if (steps != nullptr && tid == 0) atomicAdd(steps, 1);
    for (int c0 = 0; c0 < blk; c0 += KT) {
      __syncthreads();  // the previous chunk is fully consumed
      for (int e = tid; e < KT * D; e += blockDim.x) {
        const int c = e / D, d = e % D;
        const int col = j * blk + c0 + c;
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
        const int col = j * blk + c0 + c;
        const bool ok = (c0 + c) < blk && col < S && (!causal || col <= row);
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
            int S, int H, int G, int blk, int causal, int tri, Strides qs_,
            Strides ks_, Strides os_, float scale, cudaStream_t stream) {
  const int n = (S + blk - 1) / blk;
  const dim3 grid(n, B * H);
  const int threads = ((blk + 31) / 32) * 32;
  flash_fwd_kernel<T, D><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), steps, S, H, G, blk, causal, tri, qs_, ks_, os_, scale);
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* o, int* steps, int B,
           int S, int H, int G, int D, int blk, int causal, int tri, Strides qs_,
           Strides ks_, Strides os_, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, steps, B, S, H, G, blk, causal, tri, qs_, ks_, os_, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, o, steps, B, S, H, G, blk, causal, tri, qs_, ks_, os_, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, steps, B, S, H, G, blk, causal, tri, qs_, ks_, os_, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o: (B, S, H, D) views, k/v: (B, S, H/G, D) views, given by element
// strides (batch, seq, head); D is contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, void* steps, int B, int S, int H, int G,
                                      int D, int blk, int causal, int tri,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || blk <= 0 || blk > MAXBLK)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs_{q_sb, q_ss, q_sh}, ks_{k_sb, k_ss, k_sh}, os_{o_sb, o_ss, o_sh};
  auto st = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<int*>(steps);
  if (dtype == repro::kBF16)
    return by_dim<__nv_bfloat16>(q, k, v, o, sp, B, S, H, G, D, blk, causal, tri, qs_,
                                 ks_, os_, scale, st);
  if (dtype == repro::kF32)
    return by_dim<float>(q, k, v, o, sp, B, S, H, G, D, blk, causal, tri, qs_, ks_,
                         os_, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
