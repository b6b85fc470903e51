// axmult_elem — the DyFXU perforation + rounding (PR) product: elementwise,
// and as the product-sums of the Ch. 7 FIR and 2D convolution stages.
//
// Replaces the TPU kernel repro/kernels/axmult_elem.py::_pr_kernel (launched
// in pr_multiply) and the product-sum forms the reference builds around it
// (repro/kernels/dsp.py: fir_frames, conv2d_pr).  For int32 lanes holding
// n-bit operands A and B:
//
//   out = round_r(A) * perforate_p(B)
//   round_r(A)     = ((A >> r) + a_{r-1}) << r                 (r = 0: A)
//   perforate_p(B) = B - (u mod 2^{2p}) + 2^{2p} * u_{2p-1}     (p = 0: B)
//   with u = B & (2^n - 1) the unsigned n-bit view,
//
// the Ch. 5 circuit's shift/mask/add bit surgery, with (p, r) the DyFXU
// configuration registers.  They are read by address, once per thread, from
// a device int32[2] or (the product-sums) from the site's device int32
// degree, mapped on the device as dsp.degree_to_pr maps it; so a QoS rung
// move (a new value written on the device) rebuilds, re-specialises and
// syncs nothing, and a captured graph replays at any rung.
//
// Integer semantics are the reference's (XLA's) exactly: the left shift and
// the add/multiply wrap in two's complement (done on uint32, so nothing is
// undefined in C++17); the right shift of a signed value is arithmetic
// (an explicit sign-preserving shift, not the implementation-defined >> of a
// negative int); shifts by 32 or more give 0 (left, logical) or the sign
// fill (arithmetic), as XLA's do.  The guards max(r - 1, 0) and
// max(2p - 1, 0) are kept as the reference has them.
//
// pr_kernel (elementwise): 12 bytes per element (two int32 reads, one
// write) for a few integer operations: device-memory bytes.  One
// grid-stride loop over the flat array; where all three pointers are
// 16-byte aligned, each step loads and stores four lanes as one int4, and a
// guarded scalar loop finishes a ragged tail.  The grid is a few blocks per
// SM, enough to keep the loads in flight.
//
// pr_fir_kernel / pr_conv2d_kernel (the stream path's stages): the
// reference stacks T (or kh*kw) shifted copies of the signal into operand
// planes and broadcasts the weights to the same shape, because its Pallas
// kernel takes lane-aligned flat blocks; then it sums the planes.  Here a
// block loads its output tile and the (T - 1) or (kh - 1, kw - 1) halo into
// shared memory once, perforating each sample on the way in (perforate_p
// depends on the sample alone), and rounds each weight once (round_r
// depends on the weight alone); each thread then forms one output's
// product-sum from shared memory.  The products and the int32 sum wrap
// modulo 2^32, so the factored sum equals the planes' sum bit for bit in
// any order.  At the stream shapes a stage moves ~70 KB: one launch and one
// DRAM round trip bound it, not bytes; the point is one launch a stage
// where the planes took ~20 operations.

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

__device__ __forceinline__ Knobs make_knobs(int p, int r, int n) {
  Knobs k;
  k.p = p;
  k.r = r;
  k.nmask = (n >= 32) ? 0xffffffffu : ((1u << n) - 1u);
  // 2p saturates at 32 (2^{2p} is then 0 and bit 2p - 1 of u is 0, as in
  // XLA for any larger p), so 2 * p never overflows
  const int p2 = 2 * min(p, 16);
  k.two_p = (p > 0) ? shl(1u, p2) : 1u;
  k.cshift = max(p2 - 1, 0);
  return k;
}

// (p, r) read by address: from a device int32[2], or (is_degree) from the
// device int32 degree e, mapped as dsp.degree_to_pr maps it (d = max(8 - e,
// 0), p = d / 2, r = 2d, in the reference's wrapping int32).
__device__ __forceinline__ Knobs read_knobs(const int32_t* __restrict__ knob, int is_degree,
                                            int n) {
  if (!is_degree) return make_knobs(knob[0], knob[1], n);
  const int32_t d = max(static_cast<int32_t>(8u - static_cast<uint32_t>(knob[0])), 0);
  return make_knobs(d >> 1, static_cast<int32_t>(2u * static_cast<uint32_t>(d)), n);
}

// round_r(A): the weight operand's rounding.
__device__ __forceinline__ uint32_t round_r(int32_t a, const Knobs& k) {
  if (k.r <= 0) return static_cast<uint32_t>(a);
  const int32_t rbit = sar(a, k.r - 1) & 1;
  return shl(static_cast<uint32_t>(sar(a, k.r) + rbit), k.r);
}

// perforate_p(B): the sample operand's perforation.
__device__ __forceinline__ uint32_t perforate_p(int32_t b, const Knobs& k) {
  const uint32_t bp = static_cast<uint32_t>(b);
  if (k.p <= 0) return bp;
  const uint32_t u = bp & k.nmask;
  const uint32_t low = u & (k.two_p - 1u);
  const uint32_t cbit = shr(u, k.cshift) & 1u;
  return bp - low + cbit * k.two_p;
}

__device__ __forceinline__ int32_t pr_one(int32_t a, int32_t b, const Knobs& k) {
  return static_cast<int32_t>(round_r(a, k) * perforate_p(b, k));
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
pr_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ out, const int32_t* __restrict__ pr,
          long long numel, int n) {
  const Knobs k = make_knobs(pr[0], pr[1], n);
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

// ---------------------------------------------------------------------------
// the product-sums of the stream path's stages
// ---------------------------------------------------------------------------

// Limits the wrappers check before a launch (kernels/axmult_elem.py holds
// the same numbers): the shared-memory arrays below are sized by them.
constexpr int FIR_TILE = 256;       // outputs a block, one a thread
constexpr int FIR_MAX_TAPS = 256;
constexpr int CONV_TILE = 16;       // a 16 x 16 output tile a block, one a thread
constexpr int CONV_MAX_K = 16;      // kh, kw <= 16
constexpr int CONV_SPAN = CONV_TILE + CONV_MAX_K - 1;
constexpr int MAX_GRID_YZ = 65535;  // B rides the grid's y (FIR) or z (conv)

// y[b, j] = (sum_i round_r(taps[i]) * perforate_p(ext[b, i + j])) >> shift
// and new_tail[b, m] = ext[b, L + m], with ext = cat(tail, frames) (B, T-1+L).
// Block (tile, b) loads ext[b, j0 .. j0 + tile + T - 2]; the last tile of a
// row holds every position >= L and writes the raw tail (with L < T - 1 the
// new tail reaches back into the old one).
__global__ void __launch_bounds__(FIR_TILE)
pr_fir_kernel(const int32_t* __restrict__ frames, const int32_t* __restrict__ tail,
              const int32_t* __restrict__ taps, int32_t* __restrict__ y,
              int32_t* __restrict__ new_tail, const int32_t* __restrict__ knob,
              int is_degree, int L, int T, int n, int shift) {
  __shared__ uint32_t xs[FIR_TILE + FIR_MAX_TAPS - 1];
  __shared__ uint32_t ws[FIR_MAX_TAPS];
  const Knobs k = read_knobs(knob, is_degree, n);
  const int H = T - 1;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * FIR_TILE;
  const int span = min(FIR_TILE, L - j0) + H;
  const bool last = j0 + FIR_TILE >= L;
  const int32_t* frow = frames + (long long)b * L;
  const int32_t* trow = tail + (long long)b * H;
  int32_t* nrow = new_tail + (long long)b * H;
  for (int i = threadIdx.x; i < span; i += FIR_TILE) {
    const int pos = j0 + i;
    const int32_t v = pos < H ? __ldg(trow + pos) : __ldg(frow + pos - H);
    xs[i] = perforate_p(v, k);
    if (last && pos >= L) nrow[pos - L] = v;
  }
  for (int i = threadIdx.x; i < T; i += FIR_TILE) ws[i] = round_r(__ldg(taps + i), k);
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= L) return;
  uint32_t acc = 0;
#pragma unroll 8
  for (int i = 0; i < T; ++i) acc += ws[i] * xs[threadIdx.x + i];
  y[(long long)b * L + j] = sar(static_cast<int32_t>(acc), shift);
}

// Same-size 2D correlation: out[b, y, x] = (sum_{dy,dx} round_r(kern[dy, dx])
// * perforate_p(ext[b, y + dy, x + dx])) >> shift, with ext the image padded
// by kh/2 rows (kw/2 columns) before and the rest after; edge padding clamps
// the source index, zero padding loads 0 (perforate_p(0) = 0).  Block (tx,
// ty, b) loads its 16 x 16 tile with the (kh - 1, kw - 1) halo.
__global__ void __launch_bounds__(CONV_TILE * CONV_TILE)
pr_conv2d_kernel(const int32_t* __restrict__ img, const int32_t* __restrict__ kern,
                 int32_t* __restrict__ out, const int32_t* __restrict__ knob, int is_degree,
                 int H, int W, int kh, int kw, int edge, int n, int shift) {
  __shared__ uint32_t xs[CONV_SPAN * CONV_SPAN];
  __shared__ uint32_t ws[CONV_MAX_K * CONV_MAX_K];
  const Knobs k = read_knobs(knob, is_degree, n);
  const int x0 = blockIdx.x * CONV_TILE, y0 = blockIdx.y * CONV_TILE;
  const int ph = kh / 2, pw = kw / 2;
  const int sh = CONV_TILE + kh - 1, sw = CONV_TILE + kw - 1;
  const long long plane = (long long)H * W;
  const int32_t* src = img + blockIdx.z * plane;
  const int tid = threadIdx.y * CONV_TILE + threadIdx.x;
  for (int i = tid; i < sh * sw; i += CONV_TILE * CONV_TILE) {
    const int r = i / sw, c = i - r * sw;
    int yy = y0 + r - ph, xx = x0 + c - pw;
    int32_t v = 0;
    if (edge) {
      yy = min(max(yy, 0), H - 1);
      xx = min(max(xx, 0), W - 1);
      v = __ldg(src + (long long)yy * W + xx);
    } else if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      v = __ldg(src + (long long)yy * W + xx);
    }
    xs[i] = perforate_p(v, k);
  }
  for (int i = tid; i < kh * kw; i += CONV_TILE * CONV_TILE) ws[i] = round_r(__ldg(kern + i), k);
  __syncthreads();
  const int oy = y0 + threadIdx.y, ox = x0 + threadIdx.x;
  if (oy >= H || ox >= W) return;
  uint32_t acc = 0;
  for (int dy = 0; dy < kh; ++dy) {
    const uint32_t* row = xs + (threadIdx.y + dy) * sw + threadIdx.x;
    const uint32_t* wr = ws + dy * kw;
#pragma unroll 4
    for (int dx = 0; dx < kw; ++dx) acc += wr[dx] * row[dx];
  }
  out[blockIdx.z * plane + (long long)oy * W + ox] = sar(static_cast<int32_t>(acc), shift);
}

// An empty kernel: its graph-replay time is the floor one launch costs, the
// yardstick for launches whose byte bound is far below it.
__global__ void launch_floor_kernel() {}

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

// frames (B, L), tail (B, T-1), taps (T,), y (B, L), new_tail (B, T-1): int32
// on the device; knob: the device int32[2] (p, r), or with is_degree the
// device int32 degree.  Sizes past the limits above return
// cudaErrorInvalidValue without a launch.
extern "C" int pr_fir_launch(const void* frames, const void* tail, const void* taps, void* y,
                             void* new_tail, const void* knob, int is_degree, int B, int L,
                             int T, int n, int shift, void* stream) {
  if (T < 1 || T > FIR_MAX_TAPS || B > MAX_GRID_YZ || L < 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || L == 0) return 0;
  const dim3 grid((unsigned)((L + FIR_TILE - 1) / FIR_TILE), (unsigned)B);
  pr_fir_kernel<<<grid, FIR_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), static_cast<const int32_t*>(tail),
      static_cast<const int32_t*>(taps), static_cast<int32_t*>(y),
      static_cast<int32_t*>(new_tail), static_cast<const int32_t*>(knob), is_degree, L, T, n,
      shift);
  return (int)cudaGetLastError();
}

// img, out (B, H, W), kern (kh, kw): int32 on the device; knob as for
// pr_fir_launch; edge: 1 replicates the border, 0 pads with zeros.
extern "C" int pr_conv2d_launch(const void* img, const void* kern, void* out, const void* knob,
                                int is_degree, int B, int H, int W, int kh, int kw, int edge,
                                int n, int shift, void* stream) {
  if (kh < 1 || kw < 1 || kh > CONV_MAX_K || kw > CONV_MAX_K || B > MAX_GRID_YZ ||
      H < 0 || W < 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H == 0 || W == 0) return 0;
  const dim3 grid((unsigned)((W + CONV_TILE - 1) / CONV_TILE),
                  (unsigned)((H + CONV_TILE - 1) / CONV_TILE), (unsigned)B);
  const dim3 block(CONV_TILE, CONV_TILE);
  pr_conv2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(img), static_cast<const int32_t*>(kern),
      static_cast<int32_t*>(out), static_cast<const int32_t*>(knob), is_degree, H, W, kh, kw,
      edge, n, shift);
  return (int)cudaGetLastError();
}

// One empty launch on the stream (chip_smoke.py's launch floor).
extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
