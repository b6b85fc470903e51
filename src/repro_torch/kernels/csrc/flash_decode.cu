// flash_decode — one-token GQA attention against the serving KV cache.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// (launched in flash_decode).
//
//   out[b, h, g] = softmax_t(q[b, h, g] . k[b, t, h] / sqrt(D)) @ v[b, t, h]
//   over t < nvalid[b]; slots with active[b] == 0 write exact zeros.
//
// What bounds it here: each query row meets each cached K/V row once, so
// the kernel reads the slot's valid cache prefix (2 x nvalid x D bf16 per
// kv head) and does ~4 flops per byte: it is bound by device-memory bytes.
// Design: one block per (kv head, slot) walks that slot's cache in 32-token
// tiles up to nvalid[b], which it reads from device memory, so tiles past a
// slot's length are never read (the computation-skipping pillar keyed on
// per-slot serving state).  All G query heads of the group share each K/V
// tile staged in shared memory.  Scores, the online softmax (with the
// reference's guard: masked entries contribute exact zeros) and the output
// accumulator stay in f32; the ragged last tile is masked and its V rows
// are zero-filled, so lanes past the length never poison the sum.  The new
// token's K/V is written into the cache by the wrapper before the launch.
// Not yet used: wider vector loads, more slots' tiles in flight per SM.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;

constexpr int NTHREADS = 128;
constexpr int BT = 32;        // cache rows per tile
constexpr int MAXD = 128;     // head_dim bound of the static shared buffers
constexpr int MAXGD = 2048;   // G * D bound
constexpr int MAXG = 32;
constexpr int ACC = MAXGD / NTHREADS;

template <typename KV>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const float* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, const int* __restrict__ nvalid,
              const int* __restrict__ active, float* __restrict__ out,
              int T, int KVr, int G, int D, float scale) {
  __shared__ float qs[MAXGD];
  __shared__ float ks[BT][MAXD + 1];
  __shared__ float vs[BT][MAXD];
  __shared__ float ps[MAXG][BT];
  __shared__ float m_s[MAXG], l_s[MAXG], c_s[MAXG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int GD = G * D;
  float* o = out + ((size_t)b * KVr + h) * GD;

  if (active[b] == 0) {  // free slot: exact zeros, nothing read
    for (int e = tid; e < GD; e += NTHREADS) o[e] = 0.f;
    return;
  }
  const int nv = min(nvalid[b], T);
  const float* qb = q + ((size_t)b * KVr + h) * GD;
  for (int e = tid; e < GD; e += NTHREADS) qs[e] = qb[e] * scale;
  for (int g = tid; g < G; g += NTHREADS) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const size_t row_stride = (size_t)KVr * D;
  const KV* kb = k + ((size_t)b * T * KVr + h) * D;
  const KV* vb = v + ((size_t)b * T * KVr + h) * D;
  const int warp = tid / 32, lane = tid % 32;

  for (int t0 = 0; t0 < nv; t0 += BT) {
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < BT * D; e += NTHREADS) {
      const int t = e / D, d = e % D;
      const bool ok = t0 + t < nv;
      ks[t][d] = ok ? to_f32(kb[(size_t)(t0 + t) * row_stride + d]) : 0.f;
      vs[t][d] = ok ? to_f32(vb[(size_t)(t0 + t) * row_stride + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < G * BT; e += NTHREADS) {
      const int g = e / BT, t = e % BT;
      float s = kNegInf;
      if (t0 + t < nv) {
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qs[g * D + d], ks[t][d], s);
      }
      ps[g][t] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NTHREADS / 32) {  // online softmax, warp per row
      const float s = ps[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, repro::warp_max(s));
      const float p = (s > 0.5f * kNegInf) ? expf(s - m_new) : 0.f;
      const float psum = repro::warp_sum(p);
      ps[g][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < GD) {
        const int g = e / D, d = e % D;
        float pv = 0.f;
        for (int t = 0; t < BT; ++t) pv = fmaf(ps[g][t], vs[t][d], pv);
        acc[i] = acc[i] * c_s[g] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * NTHREADS;
    if (e < GD) o[e] = acc[i] / fmaxf(l_s[e / D], 1e-30f);
  }
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* nvalid, const void* active, void* out,
                                   int B, int T, int KVr, int G, int D, int kv_dtype,
                                   float scale, void* stream) {
  if (B <= 0 || T <= 0 || KVr <= 0 || G <= 0 || G > MAXG || D <= 0 || D > MAXD ||
      G * D > MAXGD)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KVr, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto nvp = static_cast<const int*>(nvalid);
  auto ap = static_cast<const int*>(active);
  auto op = static_cast<float*>(out);
  if (kv_dtype == repro::kBF16) {
    decode_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, s>>>(
        qf, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        nvp, ap, op, T, KVr, G, D, scale);
  } else if (kv_dtype == repro::kF32) {
    decode_kernel<float><<<grid, NTHREADS, 0, s>>>(
        qf, static_cast<const float*>(k), static_cast<const float*>(v), nvp, ap, op, T,
        KVr, G, D, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
