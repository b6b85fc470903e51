// axmult_elem — the DyFXU perforation + rounding (PR) product, elementwise.
//
// Replaces the TPU kernel repro/kernels/axmult_elem.py::_pr_kernel (launched
// in pr_multiply).  For int32 lanes holding n-bit operands A and B:
//
//   out = round_r(A) * perforate_p(B)
//   round_r(A)     = ((A >> r) + a_{r-1}) << r                 (r = 0: A)
//   perforate_p(B) = B - (u mod 2^{2p}) + 2^{2p} * u_{2p-1}     (p = 0: B)
//   with u = B & (2^n - 1) the unsigned n-bit view,
//
// the Ch. 5 circuit's shift/mask/add bit surgery, with (p, r) the DyFXU
// configuration registers.  They are read from a device int32[2] by address,
// once per thread, so a QoS rung move (a new (p, r) written on the device)
// rebuilds, re-specialises and syncs nothing.
//
// Integer semantics are the reference's (XLA's) exactly: the left shift and
// the add/multiply wrap in two's complement (done on uint32, so nothing is
// undefined in C++17); the right shift of a signed value is arithmetic
// (an explicit sign-preserving shift, not the implementation-defined >> of a
// negative int); shifts by 32 or more give 0 (left, logical) or the sign
// fill (arithmetic), as XLA's do.  The guards max(r - 1, 0) and
// max(2p - 1, 0) are kept as the reference has them.
//
// What bounds it here: 12 bytes per element (two int32 reads, one write)
// for a few integer operations: device-memory bytes.
// Design: one grid-stride loop over the flat array; where all three pointers
// are 16-byte aligned, each step loads and stores four lanes as one int4,
// and a guarded scalar loop finishes a ragged tail (numel not a multiple of
// four).  The grid is a few blocks per SM, enough to keep the loads in
// flight.  This computes the function, not the Pallas block layout: no
// (rows, 128) tiles and no zero padding to a block multiple.
// Not yet used: fusing the FIR/conv product-sum (the taps broadcast along
// the signal and the window planes would never be materialised).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// Arithmetic right shift, defined for every int32 (sign fill at s >= 32).
__device__ __forceinline__ int32_t sar(int32_t x, int s) {
  if (s >= 32) return x < 0 ? -1 : 0;
  return x < 0 ? ~(~x >> s) : (x >> s);
}

// Two's-complement left shift (0 at s >= 32).
__device__ __forceinline__ uint32_t shl(uint32_t x, int s) { return s >= 32 ? 0u : x << s; }

// Logical right shift of an unsigned value (0 at s >= 32).
__device__ __forceinline__ uint32_t shr(uint32_t x, int s) { return s >= 32 ? 0u : x >> s; }

struct Knobs {
  int p, r;
  uint32_t nmask;   // 2^n - 1
  uint32_t two_p;   // 2^{2p}
  int cshift;       // max(2p - 1, 0)
};

__device__ __forceinline__ Knobs make_knobs(const int32_t* __restrict__ pr, int n) {
  Knobs k;
  k.p = pr[0];
  k.r = pr[1];
  k.nmask = (n >= 32) ? 0xffffffffu : ((1u << n) - 1u);
  // 2p saturates at 32 (2^{2p} is then 0 and bit 2p - 1 of u is 0, as in
  // XLA for any larger p), so 2 * p never overflows
  const int p2 = 2 * min(k.p, 16);
  k.two_p = (k.p > 0) ? shl(1u, p2) : 1u;
  k.cshift = max(p2 - 1, 0);
  return k;
}

__device__ __forceinline__ int32_t pr_one(int32_t a, int32_t b, const Knobs& k) {
  uint32_t ar = static_cast<uint32_t>(a);
  if (k.r > 0) {
    const int32_t rbit = sar(a, k.r - 1) & 1;
    ar = shl(static_cast<uint32_t>(sar(a, k.r) + rbit), k.r);
  }
  uint32_t bp = static_cast<uint32_t>(b);
  if (k.p > 0) {
    const uint32_t u = bp & k.nmask;
    const uint32_t low = u & (k.two_p - 1u);
    const uint32_t cbit = shr(u, k.cshift) & 1u;
    bp = bp - low + cbit * k.two_p;
  }
  return static_cast<int32_t>(ar * bp);
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
pr_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ out, const int32_t* __restrict__ pr,
          long long numel, int n) {
  const Knobs k = make_knobs(pr, n);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (VEC) {
    const long long n4 = numel >> 2;
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const int4 x = __ldg(a4 + i);
      const int4 y = __ldg(b4 + i);
      int4 z;
      z.x = pr_one(x.x, y.x, k);
      z.y = pr_one(x.y, y.y, k);
      z.z = pr_one(x.z, y.z, k);
      z.w = pr_one(x.w, y.w, k);
      o4[i] = z;
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < numel; i += stride) {
    out[i] = pr_one(__ldg(a + i), __ldg(b + i), k);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

}  // namespace

// a, b, out: int32[numel] on the device; pr: int32[2] = (p, r) on the device.
extern "C" int pr_multiply_launch(const void* a, const void* b, void* out, const void* pr,
                                  long long numel, int n, void* stream) {
  if (numel <= 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long work = vec ? (numel + 3) / 4 : numel;
  long long blocks = (work + NTHREADS - 1) / NTHREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  const auto* ppr = static_cast<const int32_t*>(pr);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    pr_kernel<true><<<(unsigned)blocks, NTHREADS, 0, st>>>(pa, pb, po, ppr, numel, n);
  } else {
    pr_kernel<false><<<(unsigned)blocks, NTHREADS, 0, st>>>(pa, pb, po, ppr, numel, n);
  }
  return (int)cudaGetLastError();
}
