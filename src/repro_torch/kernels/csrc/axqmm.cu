// axqmm / axqmm_gated — block-quantized, runtime-degradable int8 GEMMs.
//
// Replaces the TPU kernels repro/kernels/axqmm.py::_axqmm_kernel (launched in
// _axqmm_call) and ::_axqmm_gated_kernel (launched in _axqmm_gated_call).
//
//   y[m, n] = sum_kb dot(degrade(qx[m, kb]), degrade(qw[n, kb])) * sx[m, kb] * sw[n, kb]
//             (+ bias[n]) (+ residual[m, n])
//   gated:    act(x @ w_gate) * (x @ w_up), both GEMMs on one staged x tile.
//
// What bounds it here: on the serving path M is the slot count at decode
// (8) or a prompt length at prefill (<= 512), so the int8 weight bytes
// (N x K) dominate and the kernel is bound by device-memory bytes, far from
// the int8 tensor-core rate.  Design: one block owns a BM x 64 output tile
// and walks the whole K extent itself (blocks cannot carry a sum across
// grid steps as the TPU grid does).  Each 64-byte k-chunk of x and w is
// loaded with 16-byte vector loads, degraded once on its way into shared
// memory (the shift is read from a device int32, never a host value or a
// template parameter), and reduced with exact __dp4a int32 dots; at every
// quantization-block boundary the int32 partials are scaled by sx * sw into
// f32 accumulators in block order, the order of the plain version, with
// explicitly rounded ops so nothing is contracted into an FMA.  The next
// chunk's loads start before the current chunk's dots, to keep bytes in
// flight.  Ragged M and N edges are masked in the kernel (zero loads, no
// stores); nothing is padded or copied.  The epilogue adds bias and
// residual (or applies the gate) in f32 before the single write.
// Not yet used: wgmma int8 tensor-core tiles, TMA, split-K for small N.

#include "common.cuh"

namespace {

using repro::degrade4;

constexpr int KC = 64;             // k-chunk staged per step (bytes)
constexpr int BN = 64;             // output columns per block
constexpr int NTHREADS = 256;
constexpr int ROWW = KC / 4 + 1;   // int32 words per shared row, padded

__device__ __forceinline__ float act_apply(float g, int act) {
  if (act == 0) return g / (1.0f + expf(-g));                       // silu
  if (act == 1) {                                                   // gelu (tanh form)
    const float c = 0.7978845608028654f;                            // sqrt(2/pi)
    return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return fmaxf(g, 0.0f);                                            // relu
}

// TM x TN outputs per thread; threads laid out (BM/TM) x (BN/TN).
template <int BM, int TM, int TN, bool GATED>
__global__ void __launch_bounds__(NTHREADS)
axqmm_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
             const int8_t* __restrict__ qw, const float* __restrict__ sw,
             const int8_t* __restrict__ qg, const float* __restrict__ sg,
             const float* __restrict__ bias, const float* __restrict__ res,
             const int* __restrict__ ebits, float* __restrict__ out,
             int M, int N, int K, int bk, int act) {
  constexpr int TCOLS = BN / TN;
  static_assert((BM / TM) * TCOLS == NTHREADS, "thread layout must cover the tile");
  __shared__ int xs[BM][ROWW];
  __shared__ int ws[BN][ROWW];
  __shared__ int gs[GATED ? BN : 1][ROWW];

  const int tid = threadIdx.x;
  const int tr = tid / TCOLS;
  const int tc = tid % TCOLS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int shift = max(8 - ebits[0], 0);
  const int nb = K / bk;

  // one 16-byte vector of the w tile (64 rows x 64 bytes) per thread
  const int wr = tid >> 2, wc = (tid & 3) * 16;
  const bool w_ok = (n0 + wr) < N;
  // the x tile (BM rows x 64 bytes) takes the first BM*4 threads
  const bool x_load = tid < BM * 4;
  const bool x_ok = x_load && (m0 + wr) < M;

  int4 wv = make_int4(0, 0, 0, 0), gv = wv, xv = wv;
  auto fetch = [&](int k0) {
    if (w_ok) {
      wv = *reinterpret_cast<const int4*>(qw + (size_t)(n0 + wr) * K + k0 + wc);
      if constexpr (GATED) gv = *reinterpret_cast<const int4*>(qg + (size_t)(n0 + wr) * K + k0 + wc);
    }
    if (x_ok) xv = *reinterpret_cast<const int4*>(qx + (size_t)(m0 + wr) * K + k0 + wc);
  };

  float facc[TM][TN];
  float gacc[TM][TN];
  int iacc[TM][TN];
  int igac[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      facc[i][j] = 0.f; gacc[i][j] = 0.f; iacc[i][j] = 0; igac[i][j] = 0;
    }

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk's dots are done with shared memory
    {
      const int c = wc / 4;
      ws[wr][c + 0] = degrade4(wv.x, shift);
      ws[wr][c + 1] = degrade4(wv.y, shift);
      ws[wr][c + 2] = degrade4(wv.z, shift);
      ws[wr][c + 3] = degrade4(wv.w, shift);
      if constexpr (GATED) {
        gs[wr][c + 0] = degrade4(gv.x, shift);
        gs[wr][c + 1] = degrade4(gv.y, shift);
        gs[wr][c + 2] = degrade4(gv.z, shift);
        gs[wr][c + 3] = degrade4(gv.w, shift);
      }
      if (x_load) {
        xs[wr][c + 0] = degrade4(xv.x, shift);
        xs[wr][c + 1] = degrade4(xv.y, shift);
        xs[wr][c + 2] = degrade4(xv.z, shift);
        xs[wr][c + 3] = degrade4(xv.w, shift);
      }
    }
    __syncthreads();
    if (k0 + KC < K) fetch(k0 + KC);  // next chunk in flight during the dots

#pragma unroll
    for (int w = 0; w < KC / 4; ++w) {
      int xw[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xw[i] = xs[tr * TM + i][w];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int wwv = ws[tc + j * TCOLS][w];
#pragma unroll
        for (int i = 0; i < TM; ++i) iacc[i][j] = __dp4a(xw[i], wwv, iacc[i][j]);
        if constexpr (GATED) {
          const int gwv = gs[tc + j * TCOLS][w];
#pragma unroll
          for (int i = 0; i < TM; ++i) igac[i][j] = __dp4a(xw[i], gwv, igac[i][j]);
        }
      }
    }

    if ((k0 + KC) % bk == 0) {  // quantization-block boundary: scale and fold
      const int kb = (k0 + KC) / bk - 1;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + tr * TM + i;
        const float sxv = (m < M) ? sx[(size_t)m * nb + kb] : 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tc + j * TCOLS;
          const float swv = (n < N) ? sw[(size_t)n * nb + kb] : 0.f;
          facc[i][j] = __fadd_rn(facc[i][j],
                                 __fmul_rn((float)iacc[i][j], __fmul_rn(sxv, swv)));
          iacc[i][j] = 0;
          if constexpr (GATED) {
            const float sgv = (n < N) ? sg[(size_t)n * nb + kb] : 0.f;
            gacc[i][j] = __fadd_rn(gacc[i][j],
                                   __fmul_rn((float)igac[i][j], __fmul_rn(sxv, sgv)));
            igac[i][j] = 0;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tr * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tc + j * TCOLS;
      if (n >= N) continue;
      float y;
      if constexpr (GATED) {
        y = __fmul_rn(act_apply(gacc[i][j], act), facc[i][j]);
      } else {
        y = facc[i][j];
        if (bias != nullptr) y = __fadd_rn(y, bias[n]);
        if (res != nullptr) y = __fadd_rn(y, res[(size_t)m * N + n]);
      }
      out[(size_t)m * N + n] = y;
    }
  }
}

template <int BM, int TM, int TN, bool GATED>
void launch(const int8_t* qx, const float* sx, const int8_t* qw, const float* sw,
            const int8_t* qg, const float* sg, const float* bias, const float* res,
            const int* ebits, float* out, int M, int N, int K, int bk, int act,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  axqmm_kernel<BM, TM, TN, GATED><<<grid, NTHREADS, 0, stream>>>(
      qx, sx, qw, sw, qg, sg, bias, res, ebits, out, M, N, K, bk, act);
}

template <bool GATED>
int dispatch(const void* qx, const void* sx, const void* qw, const void* sw,
             const void* qg, const void* sg, const void* bias, const void* res,
             const void* ebits, void* out, int M, int N, int K, int bk, int act,
             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || bk % KC != 0 || K % bk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto a = static_cast<const int8_t*>(qx);
  auto b = static_cast<const float*>(sx);
  auto c = static_cast<const int8_t*>(qw);
  auto d = static_cast<const float*>(sw);
  auto e = static_cast<const int8_t*>(qg);
  auto f = static_cast<const float*>(sg);
  auto g = static_cast<const float*>(bias);
  auto h = static_cast<const float*>(res);
  auto eb = static_cast<const int*>(ebits);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 8)
    launch<8, 1, 2, GATED>(a, b, c, d, e, f, g, h, eb, o, M, N, K, bk, act, s);
  else if (M <= 32)
    launch<32, 2, 4, GATED>(a, b, c, d, e, f, g, h, eb, o, M, N, K, bk, act, s);
  else
    launch<64, 4, 4, GATED>(a, b, c, d, e, f, g, h, eb, o, M, N, K, bk, act, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int axqmm_launch(const void* qx, const void* sx, const void* qw,
                            const void* sw, const void* bias, const void* res,
                            const void* ebits, void* out, int M, int N, int K,
                            int bk, void* stream) {
  return dispatch<false>(qx, sx, qw, sw, nullptr, nullptr, bias, res, ebits, out,
                         M, N, K, bk, 0, stream);
}

extern "C" int axqmm_gated_launch(const void* qx, const void* sx, const void* qu,
                                  const void* su, const void* qg, const void* sg,
                                  const void* ebits, void* out, int M, int N, int K,
                                  int bk, int act, void* stream) {
  return dispatch<true>(qx, sx, qu, su, qg, sg, nullptr, nullptr, ebits, out,
                        M, N, K, bk, act, stream);
}
