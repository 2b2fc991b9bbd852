// Kernel B4: the whole packed LUT stage chain of a serving engine in ONE
// launch, on Hopper.
//
// Replaces the TPU kernel repro/kernels/lut_serve_pallas.py::pallas_runner
// (pl.pallas_call at src/repro/kernels/lut_serve_pallas.py:391, body from
// _make_kernel, constants from _const_arrays).  It computes what
// _make_kernel computes, stage for stage, in int32 or int64 two's-complement
// arithmetic (a template parameter), bit for bit.
//
// Layout: at pack time (kernels/lut_serve_cuda.py) the PackedStages chain is
// lowered to one flat int64 descriptor array (NF fields per stage, below),
// one constants buffer in the compute dtype (gathers, biases, in-shifts,
// masks, sum coefficients, epilogue parameters, output columns) and one
// table buffer per lane dtype (int8 / int16 / int32 / int64).  The kernel
// interprets the descriptors; nothing is generated at run time.
//
// Execution: one block per tile of TB batch rows.  The tile's inter-stage
// vector lives in shared memory (two TB x width buffers, ping-pong), with a
// __syncthreads() between stages, so only the input codes, the output codes
// and the tables touch device memory.  Per stage each thread computes one
// (row, site, co) output at a time: loop over J, gather the column (index
// n_cols is the implicit all-zero column, the im2col pad), round-half-even
// in-shift, mask, look up the lane table and sign-extend, sum; add the bias;
// apply the REQUANT (SAT/WRAP with width, signed and apply flags) or CMUL
// epilogue ops.  "sum" stages multiply by their coefficient instead.
//
// Bound: at the JSC-HLF chain (16 -> 20 -> 5) a row costs about 420 table
// lookups and reads 64 bytes and writes 20; the call is bound by the
// dependent gather loads (L2 latency), far above both the byte and the
// operation bound.  The tables (215 KB there) are read through L2, where they
// stay resident: the 8 MB residency budget that pack_stages keeps from the
// reference is, on this card, a bound that keeps tables well inside the
// 50 MB L2, not a shared-memory bound.  Staging them in shared memory is
// later work.
//
// Exactness: C++ leaves signed overflow and left shifts of negative values
// undefined, so adds, multiplies and left shifts go through the unsigned
// type (two's-complement wrap, as jnp/XLA).  Shift amounts outside
// [0, bits) give 0 (left) or the sign fill (arithmetic right), as XLA.  A
// table index past the (range-narrowed) table is clamped to its last entry,
// as XLA clamps an out-of-range gather; in-contract inputs never reach it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// stage descriptor fields (kernels/lut_serve_cuda.py writes the same order)
enum Field : int {
  F_KIND = 0,   // 0 = lut, 1 = sum
  F_S,          // sites
  F_J,          // gathered columns per site
  F_CO,         // outputs per site
  F_NCOLS,      // incoming width (row stride of the stage input)
  F_E,          // table entries per cell
  F_GATHER,     // consts offset of the (S, J) gather
  F_BIAS,       // consts offset of the (S, co) bias
  F_INSHIFT,    // consts offset of the (J, co) in-shift, -1 when all zero
  F_MASK,       // consts offset of the (J, co) index mask
  F_COEF,       // consts offset of the (S, J) sum coefficients
  F_LANE,       // table lane: 0 int8, 1 int16, 2 int32, 3 int64
  F_TOFF,       // element offset of the (J, co, E) table in its lane buffer
  F_NEPI,       // epilogue ops
  F_EPI0        // per op: kind (0 REQUANT, 1 CMUL), mode (0 SAT, 1 WRAP), offset
};
constexpr int kMaxEpi = 4;
constexpr int kNF = F_EPI0 + 3 * kMaxEpi;
constexpr int kThreads = 256;

template <typename T> struct Unsigned;
template <> struct Unsigned<int32_t> { using type = uint32_t; };
template <> struct Unsigned<int64_t> { using type = uint64_t; };

template <typename T>
__device__ __forceinline__ T wadd(T a, T b) {
  using U = typename Unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}
template <typename T>
__device__ __forceinline__ T wsub(T a, T b) {
  using U = typename Unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) - static_cast<U>(b));
}
template <typename T>
__device__ __forceinline__ T wmul(T a, T b) {
  using U = typename Unsigned<T>::type;
  return static_cast<T>(static_cast<U>(a) * static_cast<U>(b));
}
template <typename T>
__device__ __forceinline__ T shl(T v, T s) {
  using U = typename Unsigned<T>::type;
  constexpr T kBits = static_cast<T>(sizeof(T) * 8);
  if (s < 0 || s >= kBits) return 0;
  return static_cast<T>(static_cast<U>(v) << s);
}
template <typename T>
__device__ __forceinline__ T sar(T v, T s) {
  constexpr T kBits = static_cast<T>(sizeof(T) * 8);
  if (s < 0 || s >= kBits) return v < 0 ? static_cast<T>(-1) : static_cast<T>(0);
  return v >> s;   // arithmetic on signed operands (nvcc), as jnp
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// v * 2**shift with round-half-to-even on dropped bits (lut_serve._shift_round)
template <typename T>
__device__ __forceinline__ T shift_round(T v, T shift) {
  const T one = 1;
  const T up = shl(v, tmax<T>(shift, 0));
  const T s = tmax<T>(-shift, 0);
  const T fl = sar(v, s);
  const T rem = wsub(v, shl(fl, s));
  const T half = sar(shl(one, tmax<T>(s, 1)), one);
  T down;
  if (rem > half) down = wadd(fl, one);
  else if (rem < half) down = fl;
  else down = wadd(fl, static_cast<T>(fl & one));
  return shift >= 0 ? up : down;
}

// lut_serve._requant_cols for one value
template <typename T>
__device__ __forceinline__ T requant(T v, T shift, T width, bool is_signed, bool wrap) {
  const T one = 1;
  const T code = shift_round(v, shift);
  const T n = shl(one, tmax<T>(width, 0));
  const T lo = is_signed ? wsub(static_cast<T>(0), sar(n, one)) : static_cast<T>(0);
  const T hi = wsub(wadd(lo, n), one);
  T out;
  if (!wrap) {
    out = code < lo ? lo : code;   // max then min, as jnp.clip
    out = out > hi ? hi : out;
  } else {
    out = wadd(lo, static_cast<T>(wsub(code, lo) & wsub(n, one)));
  }
  return width > 0 ? out : static_cast<T>(0);
}

template <typename T>
__device__ __forceinline__ T lane_load(int lane, long long at, const int8_t* t8,
                                       const int16_t* t16, const int32_t* t32,
                                       const int64_t* t64) {
  switch (lane) {            // sign-extends from the lane dtype
    case 0: return static_cast<T>(t8[at]);
    case 1: return static_cast<T>(t16[at]);
    case 2: return static_cast<T>(t32[at]);
    default: return static_cast<T>(t64[at]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lut_serve_chain_kernel(
    const T* __restrict__ x, T* __restrict__ out, int batch, int n_in, int n_out,
    const int64_t* __restrict__ desc, int n_stages, const T* __restrict__ consts,
    long long out_cols_off, const int8_t* __restrict__ t8,
    const int16_t* __restrict__ t16, const int32_t* __restrict__ t32,
    const int64_t* __restrict__ t64, int tb, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf_in = reinterpret_cast<T*>(smem_raw);
  T* buf_out = buf_in + static_cast<long long>(tb) * width;
  const long long row0 = static_cast<long long>(blockIdx.x) * tb;
  const int rows = static_cast<int>(min(static_cast<long long>(tb), batch - row0));

  // the tile's input codes; rows past the batch compute on zeros, unstored
  for (int t = threadIdx.x; t < tb * n_in; t += blockDim.x) {
    buf_in[t] = t < rows * n_in ? x[row0 * n_in + t] : static_cast<T>(0);
  }
  __syncthreads();

  int n_cur = n_in;
  for (int st = 0; st < n_stages; ++st) {
    const int64_t* d = desc + static_cast<long long>(st) * kNF;
    const int kind = static_cast<int>(d[F_KIND]);
    const int S = static_cast<int>(d[F_S]);
    const int J = static_cast<int>(d[F_J]);
    const int co = static_cast<int>(d[F_CO]);
    const int n_cols = static_cast<int>(d[F_NCOLS]);
    const T e_last = static_cast<T>(d[F_E] - 1);
    const T* gather = consts + d[F_GATHER];
    const T* bias = consts + d[F_BIAS];
    const T* in_shift = d[F_INSHIFT] >= 0 ? consts + d[F_INSHIFT] : nullptr;
    const T* mask = consts + d[F_MASK];
    const T* coef = consts + d[F_COEF];
    const int lane = static_cast<int>(d[F_LANE]);
    const long long toff = d[F_TOFF];
    const int n_epi = static_cast<int>(d[F_NEPI]);
    const int w_out = S * co;

    for (int t = threadIdx.x; t < tb * w_out; t += blockDim.x) {
      const int r = t / w_out;
      const int k = t - r * w_out;
      const int s = k / co;
      const int c = k - s * co;
      const T* v_row = buf_in + static_cast<long long>(r) * n_cols;
      T acc = 0;
      for (int j = 0; j < J; ++j) {
        const T col = gather[s * J + j];
        const T v = col >= n_cols ? static_cast<T>(0) : v_row[col];
        if (kind == 0) {
          const int cell = j * co + c;
          const T code = in_shift ? shift_round(v, in_shift[cell]) : v;
          T idx = code & mask[cell];
          idx = idx > e_last ? e_last : (idx < 0 ? static_cast<T>(0) : idx);
          const long long at = toff + static_cast<long long>(cell) * (e_last + 1) + idx;
          acc = wadd(acc, lane_load<T>(lane, at, t8, t16, t32, t64));
        } else {
          acc = wadd(acc, wmul(v, coef[s * J + j]));
        }
      }
      acc = wadd(acc, bias[k]);
      for (int m = 0; m < n_epi; ++m) {
        const int op = static_cast<int>(d[F_EPI0 + 3 * m]);
        const bool wrap = d[F_EPI0 + 3 * m + 1] != 0;
        const long long off = d[F_EPI0 + 3 * m + 2];
        if (op == 0) {
          const T* p = consts + off + 4LL * k;     // (shift, width, signed, apply)
          const T res = requant(acc, p[0], p[1], p[2] != 0, wrap);
          if (p[3] != 0) acc = res;
        } else {
          acc = wmul(acc, consts[off + k]);
        }
      }
      buf_out[t] = acc;
    }
    __syncthreads();
    T* tmp = buf_in;
    buf_in = buf_out;
    buf_out = tmp;
    n_cur = w_out;
  }

  const T* cols = consts + out_cols_off;
  for (int t = threadIdx.x; t < rows * n_out; t += blockDim.x) {
    const int r = t / n_out;
    const int k = t - r * n_out;
    out[row0 * n_out + t] = buf_in[static_cast<long long>(r) * n_cur + cols[k]];
  }
}

template <typename T>
int launch(const void* x, void* out, int batch, int n_in, int n_out, const void* desc,
           int n_stages, const void* consts, long long out_cols_off, const void* t8,
           const void* t16, const void* t32, const void* t64, int tb, int width,
           void* stream) {
  if (batch == 0) return 0;
  const size_t smem = 2ull * tb * width * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(lut_serve_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((batch + tb - 1) / tb);
  lut_serve_chain_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), batch, n_in, n_out,
      static_cast<const int64_t*>(desc), n_stages, static_cast<const T*>(consts),
      out_cols_off, static_cast<const int8_t*>(t8), static_cast<const int16_t*>(t16),
      static_cast<const int32_t*>(t32), static_cast<const int64_t*>(t64), tb, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lut_serve_descriptor_fields() { return kNF; }

extern "C" int lut_serve_max_epilogue() { return kMaxEpi; }

extern "C" int lut_serve_chain(int is64, const void* x, void* out, int batch, int n_in,
                               int n_out, const void* desc, int n_stages,
                               const void* consts, long long out_cols_off,
                               const void* t8, const void* t16, const void* t32,
                               const void* t64, int tb, int width, void* stream) {
  if (is64) {
    return launch<int64_t>(x, out, batch, n_in, n_out, desc, n_stages, consts,
                           out_cols_off, t8, t16, t32, t64, tb, width, stream);
  }
  return launch<int32_t>(x, out, batch, n_in, n_out, desc, n_stages, consts,
                         out_cols_off, t8, t16, t32, t64, tb, width, stream);
}

extern "C" const char* lut_serve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
