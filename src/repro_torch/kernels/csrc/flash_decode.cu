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
// What bounds it here: each query row meets each cached K/V row once, so
// the kernel reads the slot's valid cache prefix (2 x nvalid x D bf16, or
// int8 plus one f32 scale per row, per kv head) and does ~4 flops per
// (bf16) byte: it is bound by device-memory bytes.  The int8 cache halves
// those bytes.
// Design: one block per (kv head, slot) walks that slot's cache in 32-token
// tiles up to nvalid[b], which it reads from device memory, so tiles past a
// slot's length are never read (the computation-skipping pillar keyed on
// per-slot serving state).  A tile is staged in shared memory as f32: the
// bf16 rows converted, the int8 rows read as 4-byte words (four codes),
// degraded with degrade4 at the shift read from the device degree operand
// (a QoS rung move never rebuilds anything), and multiplied by their row's
// scale.  All G query heads of the group share each staged tile.  Scores,
// the online softmax (with the reference's guard: masked entries contribute
// exact zeros) and the output accumulator stay in f32; the ragged last tile
// is masked and its V rows are zero-filled, so lanes past the length never
// poison the sum.  The new token's K/V is written into the cache by the
// wrapper before the launch.
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

// Rows of a bf16/f32 cache: (B, T, KVr, D).
template <typename KV>
struct FloatRows {
  const KV* k;
  const KV* v;

  // this block's (slot b, kv head h) view
  __device__ FloatRows at(int b, int h, int T, int KVr, int D) const {
    const size_t off = ((size_t)b * T * KVr + h) * D;
    return {k + off, v + off};
  }

  // Stage rows t0 .. t0 + BT - 1 as f32; rows at or past nv are zeros.
  __device__ void stage(int t0, int nv, int KVr, int D, float (*ks)[MAXD + 1],
                        float (*vs)[MAXD]) const {
    const size_t stride = (size_t)KVr * D;
    for (int e = threadIdx.x; e < BT * D; e += NTHREADS) {
      const int t = e / D, d = e % D;
      const bool ok = t0 + t < nv;
      ks[t][d] = ok ? to_f32(k[(size_t)(t0 + t) * stride + d]) : 0.f;
      vs[t][d] = ok ? to_f32(v[(size_t)(t0 + t) * stride + d]) : 0.f;
    }
  }
};

// Rows of an int8 cache: codes (B, T, KVr, D) int8, scales (B, T, KVr) f32,
// degraded by shift = max(8 - *ebits, 0) low bits before dequantization.
struct Int8Rows {
  const int8_t* k;
  const int8_t* v;
  const float* ksc;
  const float* vsc;
  const int* ebits;  // the runtime degree, read on the device
  int shift;

  __device__ Int8Rows at(int b, int h, int T, int KVr, int D) const {
    const size_t off = (size_t)b * T * KVr + h;
    return {k + off * D, v + off * D, ksc + off, vsc + off, ebits, max(8 - *ebits, 0)};
  }

  __device__ void stage(int t0, int nv, int KVr, int D, float (*ks)[MAXD + 1],
                        float (*vs)[MAXD]) const {
    const int W = D / 4;  // 4-byte words per row (the wrapper checks D % 4)
    for (int e = threadIdx.x; e < BT * W; e += NTHREADS) {
      const int t = e / W, w = e % W;
      int kw = 0, vw = 0;
      float sk = 0.f, sv = 0.f;
      if (t0 + t < nv) {
        const size_t row = (size_t)(t0 + t) * KVr;
        kw = repro::degrade4(reinterpret_cast<const int*>(k + row * D)[w], shift);
        vw = repro::degrade4(reinterpret_cast<const int*>(v + row * D)[w], shift);
        sk = ksc[row];
        sv = vsc[row];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ks[t][4 * w + i] = static_cast<float>(static_cast<signed char>((kw >> (8 * i)) & 0xff)) * sk;
        vs[t][4 * w + i] = static_cast<float>(static_cast<signed char>((vw >> (8 * i)) & 0xff)) * sv;
      }
    }
  }
};

template <typename Rows>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(Rows rows, const float* __restrict__ q, const int* __restrict__ nvalid,
              const int* __restrict__ active, float* __restrict__ out, int T, int KVr,
              int G, int D, float scale) {
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

  const Rows r = rows.at(b, h, T, KVr, D);
  const int warp = tid / 32, lane = tid % 32;

  for (int t0 = 0; t0 < nv; t0 += BT) {
    __syncthreads();  // the previous tile is fully consumed
    r.stage(t0, nv, KVr, D, ks, vs);
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

bool bad_shape(int B, int T, int KVr, int G, int D) {
  return B <= 0 || T <= 0 || KVr <= 0 || G <= 0 || G > MAXG || D <= 0 || D > MAXD ||
         G * D > MAXGD;
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* nvalid, const void* active, void* out,
                                   int B, int T, int KVr, int G, int D, int kv_dtype,
                                   float scale, void* stream) {
  if (bad_shape(B, T, KVr, G, D)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KVr, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto nvp = static_cast<const int*>(nvalid);
  auto ap = static_cast<const int*>(active);
  auto op = static_cast<float*>(out);
  if (kv_dtype == repro::kBF16) {
    using R = FloatRows<__nv_bfloat16>;
    decode_kernel<R><<<grid, NTHREADS, 0, s>>>(
        R{static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v)}, qf,
        nvp, ap, op, T, KVr, G, D, scale);
  } else if (kv_dtype == repro::kF32) {
    using R = FloatRows<float>;
    decode_kernel<R><<<grid, NTHREADS, 0, s>>>(
        R{static_cast<const float*>(k), static_cast<const float*>(v)}, qf, nvp, ap, op, T,
        KVr, G, D, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_decode_quant_launch(const void* q, const void* k, const void* ks,
                                         const void* v, const void* vs, const void* nvalid,
                                         const void* active, const void* ebits, void* out,
                                         int B, int T, int KVr, int G, int D, float scale,
                                         void* stream) {
  if (bad_shape(B, T, KVr, G, D) || D % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KVr, B);
  const Int8Rows rows{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                      static_cast<const float*>(ks), static_cast<const float*>(vs),
                      static_cast<const int*>(ebits), 0};
  decode_kernel<Int8Rows><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, static_cast<const float*>(q), static_cast<const int*>(nvalid),
      static_cast<const int*>(active), static_cast<float*>(out), T, KVr, G, D, scale);
  return static_cast<int>(cudaGetLastError());
}
