// Kernel B1: element-wise HGQ fake-quant with integer (f, i) bit-widths.
//
// Replaces the TPU kernel repro/kernels/fake_quant.py::fake_quant_fused
// (body _fq_kernel, src/repro/kernels/fake_quant.py:23; pallas_call at :82
// per-channel and :120 flat).
//
//   out[k] = quantize(x[k / E], f[k % P], i[k % P])      (fq.cuh)
//
// x is read through a source of n / E elements: E = 1 for a contiguous x,
// E = x.shape[-1] for an x whose last axis has stride 0 (the expand that
// LUTDense._cells builds), so that view is read once and never copied.
// The widths are never broadcast to x's size: one scalar pair (P = 1), or a
// small array that repeats with period P (per-channel, trailing shape), or
// per-element widths (P = n) that stream beside x.
//
// Bound: bytes.  Each output element costs 4 bytes written plus 4 / E read
// (8 more for per-element widths); the arithmetic is ~10 instructions an
// element.  What the design does about it:
//  * The column path.  Let Pc = lcm(P, E, 4) and Q = Pc / 4.  A thread owns
//    one float4 column c < Q of every Pc-element row of the output and walks
//    down the rows, so its four width pairs and source offsets are fixed:
//    they are turned into constants (Width below) once per thread and held
//    in registers (one pair only, for per-tensor widths).  No index is divided per element; neighbouring threads
//    store neighbouring float4s.  Bytes in flight: a contiguous x is read
//    two float4 rows ahead (double-buffered); where a float4 of the output
//    expands one source float (the expand view with E % 4 == 0), a thread
//    loads up to 32 rows' floats at once, one register each.  The last
//    n % Pc elements, if any, go through the per-element code of the
//    general path.  (Chosen on the H100 among 2-8 rows ahead, capped
//    registers, block-owned row bands and streaming stores: PERF.md.)
//  * The general path (per-element widths, or a period too long for one
//    column per thread): a grid-stride loop that builds each element's
//    constants from f[k % P] and i[k % P] (k itself when P = n).
//  * 32-bit indices wherever n < 2^30, a 64-bit instantiation beyond.
//  * The grid is what the card holds at once: cudaDevAttrMultiProcessorCount
//    times the kernel's resident blocks per SM (occupancy query, cached).
//
// The arithmetic.  The output is bit for bit fq::quantize's, which is the
// plain version's; fq::quantize stays the fallback.  Two shortcuts, each
// taken only where it provably gives the same bits:
//  * x * 2^f in place of x / 2^-f: both powers are normal floats for
//    |f| <= 126, the exact quotient and the exact product are one real
//    number, and both operations round it once, to nearest even.
//  * WRAP on the integer code c = rint(x * 2^f):
//      lo_c + ((c - lo_c) & (2^w - 1)),  w = f + i + signed,
//    then one multiply by 2^-f.  fq::quantize's floor-mod reaches the same
//    value when each of its float steps is exact, which holds when
//      1 <= w <= 24, -103 <= f <= 126, |i| <= 126 and |c| <= 2^24 - |lo_c|:
//    every quantity it forms (q, hi, span, q - lo, the remainder, lo + r)
//    is then an integer multiple m of 2^-f with |m| <= 2^24 and magnitude
//    below 2^128, hence a float.  A zero result is +0 on both sides.
//    Anything else (NaN, inf, large |x|, wide or non-integer widths) takes
//    fq::quantize unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsFloat4 = 2;     // float4 rows in flight a thread, double-buffered
constexpr int kRowsOneSource = 32; // rows in flight when a float4 expands one float

// 2^e for an integer e in [-126, 127]: a normal float, built exactly.
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

// One width pair turned into the constants of its fast path.
struct Width {
  float mul, scale;    // 2^f and 2^-f
  float lo, hi;        // SAT bounds, as fq::quantize forms them
  float climit;        // WRAP: the code guard 2^24 - |lo_c|
  int lo_c;            // WRAP: the lowest code
  unsigned mask;       // WRAP: 2^w - 1
  bool live, fast;
};

template <bool SIGNED, bool WRAP>
__device__ __forceinline__ Width make_width(float f, float i) {
  Width w;
  const float width = __fadd_rn(__fadd_rn(i, f), SIGNED ? 1.0f : 0.0f);
  w.live = width > 0.0f;
  const bool integral = fabsf(f) <= 126.0f && fabsf(i) <= 126.0f &&
                        f == truncf(f) && i == truncf(i);
  const int fi = integral ? static_cast<int>(f) : 0;
  const int ii = integral ? static_cast<int>(i) : 0;
  w.mul = pow2(fi);
  w.scale = pow2(-fi);
  const float top = pow2(ii);
  w.hi = __fsub_rn(top, w.scale);
  w.lo = SIGNED ? -top : 0.0f;
  const int bits = fi + ii + (SIGNED ? 1 : 0);
  w.fast = WRAP ? (integral && w.live && bits <= 24 && fi >= -103) : integral;
  const int b = (WRAP && w.fast) ? bits : 1;
  w.lo_c = SIGNED ? -(1 << (b - 1)) : 0;
  w.mask = (1u << b) - 1u;
  w.climit = static_cast<float>(16777216 + w.lo_c);
  return w;
}

// fq::quantize out of line: the hot loop stays a few dozen instructions
// instead of carrying an inlined copy of the rare path for every lane.
template <bool SIGNED, bool WRAP>
__device__ __noinline__ float quantize_slow(float x, float f, float i) {
  return fq::quantize(x, f, i, SIGNED, WRAP);
}

// The fast path: false where the element needs quantize_slow instead.
template <bool SIGNED, bool WRAP>
__device__ __forceinline__ bool quant_fast(float x, const Width& w, float& q) {
  if (!w.live) {
    q = 0.0f;
    return true;
  }
  if (!w.fast) return false;
  const float c = rintf(__fmul_rn(x, w.mul));
  if (!WRAP) {
    const float v = __fmul_rn(c, w.scale);
    q = isnan(v) ? v : fminf(fmaxf(v, w.lo), w.hi);
    return true;
  }
  if (!(fabsf(c) <= w.climit)) return false;
  const unsigned r = static_cast<unsigned>(__float2int_rn(c) - w.lo_c) & w.mask;
  q = __fmul_rn(static_cast<float>(w.lo_c + static_cast<int>(r)), w.scale);
  return true;
}

// Output elements [k0, n) one at a time, grid-stride, from thread t of T.
template <bool SIGNED, bool WRAP, typename I>
__device__ __forceinline__ void elementwise(const float* __restrict__ x,
                                            const float* __restrict__ f,
                                            const float* __restrict__ i,
                                            float* __restrict__ out, I k0, I n,
                                            I period, I expand, I t, I T) {
  for (I k = k0 + t; k < n; k += T) {
    const I p = period == n ? k : k % period;
    const float v = __ldg(x + (expand == 1 ? k : k / expand));
    const float fv = __ldg(f + p), iv = __ldg(i + p);
    float q;
    if (!quant_fast<SIGNED, WRAP>(v, make_width<SIGNED, WRAP>(fv, iv), q))
      q = quantize_slow<SIGNED, WRAP>(v, fv, iv);
    out[k] = q;
  }
}

// The column path.  VEC: x is the contiguous output-shaped array, 16-byte
// aligned, read as float4; otherwise x is read one element per lane at
// source offsets fixed per thread (the expand view, or an unaligned x).
// UNIFORM: one width pair for all (P = 1), held once.  The thread's width
// pairs are loaded first and become constants only after its first rows'
// loads are issued, so the two latencies overlap.
template <bool SIGNED, bool WRAP, bool VEC, bool UNIFORM, typename I>
__global__ void __launch_bounds__(kThreads)
fq_column_kernel(const float* __restrict__ x, const float* __restrict__ f,
                 const float* __restrict__ i, float* __restrict__ out, I n,
                 I period, I expand, I cols, I rows, I active) {
  constexpr int NW = UNIFORM ? 1 : 4;          // width pairs a thread holds
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < active) {
    const I col = t % cols;
    const I step = active / cols;                // rows between visits
    const I src_row = 4 * cols / expand;         // source elements a row
    Width w[NW];
    float fw[NW], iw[NW];
    I off[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const I k = 4 * col + l;
      if (l < NW) {
        fw[l] = __ldg(f + k % period);
        iw[l] = __ldg(i + k % period);
      }
      off[l] = k / expand;
    }
    auto make_widths = [&] {
#pragma unroll
      for (int l = 0; l < NW; ++l) w[l] = make_width<SIGNED, WRAP>(fw[l], iw[l]);
    };
    // lane l of a float4: the fast path, or fq::quantize on the pair reloaded
    auto lane = [&](int l, float v) {
      float q;
      if (!quant_fast<SIGNED, WRAP>(v, w[UNIFORM ? 0 : l], q)) {
        const I p = UNIFORM ? 0 : (4 * col + l) % period;
        q = quantize_slow<SIGNED, WRAP>(v, __ldg(f + p), __ldg(i + p));
      }
      return q;
    };
    float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
    auto store = [&](I r, float4 a) {
      o4[r * cols + col] = make_float4(lane(0, a.x), lane(1, a.y), lane(2, a.z),
                                       lane(3, a.w));
    };
    I row = t / cols;
    if (!VEC && off[0] == off[3]) {
      // the float4 expands one source float (the path's expand view): a
      // register a row, so all of a thread's rows are loaded at once
      const float* s = x + off[0];
      for (bool first = true; row < rows; row += kRowsOneSource * step, first = false) {
        float v[kRowsOneSource];
#pragma unroll
        for (int u = 0; u < kRowsOneSource; ++u)
          if (row + u * step < rows) v[u] = __ldg(s + (row + u * step) * src_row);
        if (first) make_widths();
#pragma unroll
        for (int u = 0; u < kRowsOneSource; ++u)
          if (row + u * step < rows) store(row + u * step, make_float4(v[u], v[u], v[u], v[u]));
      }
    } else {
      // double-buffered: the next rows' loads are in flight during the stores
      const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
      auto load = [&](I r) {
        if constexpr (VEC) {
          return __ldg(x4 + r * cols + col);
        } else {
          const float* s = x + r * src_row;
          return make_float4(__ldg(s + off[0]), __ldg(s + off[1]), __ldg(s + off[2]),
                             __ldg(s + off[3]));
        }
      };
      float4 a[kRowsFloat4];
#pragma unroll
      for (int u = 0; u < kRowsFloat4; ++u)
        if (row + u * step < rows) a[u] = load(row + u * step);
      make_widths();
      for (; row < rows; row += kRowsFloat4 * step) {
        float4 cur[kRowsFloat4];
#pragma unroll
        for (int u = 0; u < kRowsFloat4; ++u) cur[u] = a[u];
#pragma unroll
        for (int u = 0; u < kRowsFloat4; ++u)
          if (row + (kRowsFloat4 + u) * step < rows)
            a[u] = load(row + (kRowsFloat4 + u) * step);
#pragma unroll
        for (int u = 0; u < kRowsFloat4; ++u)
          if (row + u * step < rows) store(row + u * step, cur[u]);
      }
    }
  }
  // the ragged end: n % (4 * cols) elements
  elementwise<SIGNED, WRAP, I>(x, f, i, out, rows * 4 * cols, n, period, expand, t,
                               static_cast<I>(gridDim.x) * kThreads);
}

template <bool SIGNED, bool WRAP, typename I>
__global__ void __launch_bounds__(kThreads)
fq_general_kernel(const float* __restrict__ x, const float* __restrict__ f,
                  const float* __restrict__ i, float* __restrict__ out, I n,
                  I period, I expand) {
  elementwise<SIGNED, WRAP, I>(x, f, i, out, 0, n, period, expand,
                               static_cast<I>(blockIdx.x) * kThreads + threadIdx.x,
                               static_cast<I>(gridDim.x) * kThreads);
}

long long gcd(long long a, long long b) {
  while (b != 0) {
    const long long r = a % b;
    a = b;
    b = r;
  }
  return a;
}

long long lcm(long long a, long long b) { return a / gcd(a, b) * b; }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return sms > 0 ? sms : 1;
}

// The most blocks of `kernel` the card holds at once: SMs x resident blocks.
long long grid_cap(const void* kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess || per_sm < 1)
    per_sm = 1;
  return static_cast<long long>(sm_count()) * per_sm;
}

template <bool SIGNED, bool WRAP, typename I>
void launch(const float* x, const float* f, const float* i, float* out,
            long long n, long long period, long long expand, bool x_aligned,
            cudaStream_t stream) {
  using Column = void (*)(const float*, const float*, const float*, float*, I, I, I, I,
                          I, I);
  // [uniform][vec]: the four instantiations, each with its grid cap
  static const Column columns[2][2] = {
      {fq_column_kernel<SIGNED, WRAP, false, false, I>,
       fq_column_kernel<SIGNED, WRAP, true, false, I>},
      {fq_column_kernel<SIGNED, WRAP, false, true, I>,
       fq_column_kernel<SIGNED, WRAP, true, true, I>}};
  static const long long caps[2][2] = {
      {grid_cap(reinterpret_cast<const void*>(columns[0][0])),
       grid_cap(reinterpret_cast<const void*>(columns[0][1]))},
      {grid_cap(reinterpret_cast<const void*>(columns[1][0])),
       grid_cap(reinterpret_cast<const void*>(columns[1][1]))}};
  auto* general = fq_general_kernel<SIGNED, WRAP, I>;
  static const long long cap_general = grid_cap(reinterpret_cast<const void*>(general));
  const int uniform = period == 1, use_vec = expand == 1 && x_aligned;
  const Column column = columns[uniform][use_vec];
  const long long cap = caps[uniform][use_vec];
  const long long pc = lcm(lcm(period, expand), 4);
  const long long cols = pc / 4, rows = n / pc;
  if (rows > 0 && cols <= cap * kThreads) {
    const long long per_block = static_cast<long long>(kThreads) * kRowsFloat4;
    long long blocks = (rows * cols + per_block - 1) / per_block;
    const long long min_blocks = (cols + kThreads - 1) / kThreads;
    if (blocks < min_blocks) blocks = min_blocks;
    if (blocks > cap) blocks = cap;
    const long long active = blocks * kThreads / cols * cols;
    column<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, f, i, out, n, period, expand, cols, rows, active);
    return;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > cap_general) blocks = cap_general;
  general<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, f, i, out, n, period, expand);
}

template <bool SIGNED, bool WRAP>
void launch_sized(const float* x, const float* f, const float* i, float* out,
                  long long n, long long period, long long expand, bool x_aligned,
                  cudaStream_t stream) {
  // 32-bit indices leave room for a row index past n and a grid's stride
  if (n < (1LL << 30))
    launch<SIGNED, WRAP, int>(x, f, i, out, n, period, expand, x_aligned, stream);
  else
    launch<SIGNED, WRAP, long long>(x, f, i, out, n, period, expand, x_aligned, stream);
}

}  // namespace

// out: n contiguous float32.  x: n / expand contiguous float32, out[k]
// reading x[k / expand] (expand >= 1 divides n).  f, i: `period` float32
// each (period >= 1 divides n), out[k] taking widths k % period.
extern "C" int fake_quant_forward(const void* x, const void* f, const void* i,
                                  void* out, long long n, long long period,
                                  long long expand, int is_signed, int wrap,
                                  void* stream) {
  if (n == 0) return 0;
  if (period < 1 || expand < 1 || n % period != 0 || n % expand != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool x_aligned = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const float* xp = static_cast<const float*>(x);
  const float* fp = static_cast<const float*>(f);
  const float* ip = static_cast<const float*>(i);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_signed && wrap) launch_sized<true, true>(xp, fp, ip, op, n, period, expand, x_aligned, s);
  else if (is_signed) launch_sized<true, false>(xp, fp, ip, op, n, period, expand, x_aligned, s);
  else if (wrap) launch_sized<false, true>(xp, fp, ip, op, n, period, expand, x_aligned, s);
  else launch_sized<false, false>(xp, fp, ip, op, n, period, expand, x_aligned, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fake_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
