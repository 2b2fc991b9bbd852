// Kernel B4: the whole packed LUT stage chain of a serving engine in ONE
// launch, on Hopper.
//
// Replaces the TPU kernel repro/kernels/lut_serve_pallas.py::pallas_runner
// (pl.pallas_call at src/repro/kernels/lut_serve_pallas.py:391, body from
// _make_kernel, constants from _const_arrays).  It computes what
// _make_kernel computes, stage for stage, in int32 or int64 two's-complement
// arithmetic (a template parameter), bit for bit.
//
// Layout: at pack time (kernels/lut_serve_cuda.py::lower_chain) the
// PackedStages chain is lowered to one flat int64 descriptor array (a header
// of kNH fields, kNF fields per stage, then kCopyFields per bulk copy), one
// constants buffer in the compute dtype (gathers, biases, in-shifts, masks,
// sum coefficients, epilogue parameters, output columns) and one table
// buffer per lane dtype (int8 / int16 / int32 / int64), each stage's segment
// padded to 16 bytes.  The planner there (launch_plan) lays the block's
// shared memory out once per chain and writes it into the descriptors; the
// kernel obeys them and decides nothing.  Nothing is generated at run time.
//
// Bound: at the JSC-HLF chain (16 -> 20 -> 5) a row costs 420 table lookups
// and reads 64 bytes and writes 20, so the byte bound (0.48 us at B = 16600
// on the H100's 3.35 TB/s) is far below what one launch costs; latency sets
// the time.  The first port read the tables through L2 with one thread per
// output walking a dependent chain per term (gather index, row value, mask,
// entry, add), in one 256-thread block per 128-row tile: 8 blocks on 132 SMs
// at B = 1024, and 0.05 ms at both B = 1024 and 16600 (NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md).  The TPU kernel keeps the tables resident in VMEM
// for the whole grid; here:
//  * Tables resident in shared memory, staged by the Tensor Memory
//    Accelerator.  Where the constants and a stage's tables fit beside the
//    tile buffers (232,448 bytes a block in all), the block copies each with
//    one cp.async.bulk that completes its own mbarrier, started by the last
//    warp, a lane a copy, while the others load their first tile; a stage's
//    warps wait for its barrier once.  JSC-HLF's 215,040 table bytes fit.  A
//    stage whose tables do not fit keeps the global path (__ldg), in the same
//    kernel, chosen by its descriptor; so do constants that do not fit.
//  * A persistent grid: at most SMs x resident blocks, each staging its
//    tables once and walking the row tiles blockIdx, blockIdx + grid, ...;
//    the tile rows come from the batch (kernels/lut_serve_cuda.py::
//    tile_plan), so B = 1024 runs 32 blocks, not 8.
//  * Warp-uniform constants: a warp takes one unit (32 rows, one site s, CC
//    consecutive outputs c) and its lanes the 32 rows, so the gather column,
//    masks, in-shifts, bias and epilogue parameters of a step are one
//    address for every lane (a shared-memory broadcast), and each row value
//    read serves CC lookups.  The j loop takes 4 rows of j at a time with no
//    branch inside (4 x CC independent lookups in flight); the lane type,
//    the residency and the in-shift are template parameters chosen once per
//    stage, not per load.
//  * A fast lookup where the lowering proves it exact (no in-shift, one
//    mask for every cell inside the table, contiguous gathers, as in every
//    JSC-HLF stage): the row value is read and masked once per j, and no
//    gather index, mask or clamp is spent per term.
//  * Tile buffers of odd row stride, so the 32 rows a warp reads of one
//    column fall in 32 banks, with one column past the widest row that holds
//    zero: the gather's implicit zero column (index n_cols) is an ordinary
//    read.  The lookups of 32 lanes in one table still meet in banks when
//    their indices do; that depends on the data.
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

// chain header fields (kernels/lut_serve_cuda.py writes the same order)
enum Header : int {
  H_NSTAGES = 0,  // stages
  H_NIN,          // input width
  H_NOUT,         // output width
  H_OUTCOLS,      // consts offset of the output columns
  H_CSOFF,        // shared byte offset of the constants (-1: read from global memory)
  H_NCOPIES,      // bulk copies that stage the constants and the resident tables
  H_BARSOFF,      // shared byte offset of the mbarriers
  H_NBAR,         // mbarriers, one a copy
  H_BUFSOFF,      // shared byte offset of tile buffer A (B follows it)
  H_STRIDEA,      // row strides of the tile buffers, odd, in elements
  H_STRIDEB,
  H_CONSTS,       // device address of the constants
  H_T8,           // device addresses of the lane table buffers
  H_T16,
  H_T32,
  H_T64,
  kNH
};

// stage descriptor fields
enum Field : int {
  F_KIND = 0,   // 0 = lut, 1 = sum
  F_S,          // sites
  F_J,          // gathered columns per site
  F_CO,         // outputs per site
  F_E,          // table entries per cell
  F_GATHER,     // consts offset of the (S, J) gather
  F_BIAS,       // consts offset of the (S, co) bias
  F_INSHIFT,    // consts offset of the (J, co) in-shift, -1 when all zero
  F_MASK,       // consts offset of the (J, co) index mask
  F_COEF,       // consts offset of the (S, J) sum coefficients
  F_LANE,       // table lane: 0 int8, 1 int16, 2 int32, 3 int64
  F_TOFF,       // element offset of the (J, co, E) table in its lane buffer
  F_SOFF,       // shared byte offset of the table, -1 when read from global memory
  F_BAR,        // mbarrier its bulk copy completes
  F_FASTMASK,   // the stage's one mask where the fast lookup applies (lut_stage), else -1
  F_NEPI,       // epilogue ops
  F_EPI0        // per op: kind (0 REQUANT, 1 CMUL), mode (0 SAT, 1 WRAP), offset
};
constexpr int kMaxEpi = 4;
constexpr int kNF = F_EPI0 + 3 * kMaxEpi;
// after the stage rows, one row per bulk copy: shared byte offset, device
// address of the source, bytes (a multiple of 16), mbarrier
constexpr int kCopyFields = 4;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int CC = 4;                       // outputs c of a warp's unit
constexpr int SMEM_MAX = 232448;            // shared memory a block may use (227 KB)

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

// ----------------------------------------------------------------- mbarriers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1) : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait until the barrier's first phase has completed (each is used once)
__device__ __forceinline__ void bar_wait(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n\t"
      "@!P1 bra WAIT;\n\t"
      "}\n" ::"r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ stages
// a descriptor field, through the read-only cache
__device__ __forceinline__ long long ldd(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

struct Stage {
  int S, J, co, E, bar, n_epi;
  long long gather, bias, in_shift, mask, coef, toff, soff, fast_mask;
};

__device__ __forceinline__ Stage read_stage(const int64_t* __restrict__ d) {
  Stage st;
  st.S = static_cast<int>(ldd(d + F_S));
  st.J = static_cast<int>(ldd(d + F_J));
  st.co = static_cast<int>(ldd(d + F_CO));
  st.E = static_cast<int>(ldd(d + F_E));
  st.bar = static_cast<int>(ldd(d + F_BAR));
  st.n_epi = static_cast<int>(ldd(d + F_NEPI));
  st.gather = ldd(d + F_GATHER);
  st.bias = ldd(d + F_BIAS);
  st.in_shift = ldd(d + F_INSHIFT);
  st.mask = ldd(d + F_MASK);
  st.coef = ldd(d + F_COEF);
  st.toff = ldd(d + F_TOFF);
  st.soff = ldd(d + F_SOFF);
  st.fast_mask = ldd(d + F_FASTMASK);
  return st;
}

// bias and epilogue ops of output k (a warp-uniform k)
template <typename T>
__device__ __forceinline__ T finish_output(T acc, int k, const Stage& st,
                                           const int64_t* __restrict__ d,
                                           const T* __restrict__ cst) {
  acc = wadd(acc, cst[st.bias + k]);
  for (int m = 0; m < st.n_epi; ++m) {
    const int op = static_cast<int>(ldd(d + F_EPI0 + 3 * m));
    const bool wrap = ldd(d + F_EPI0 + 3 * m + 1) != 0;
    const long long off = ldd(d + F_EPI0 + 3 * m + 2);
    if (op == 0) {
      const T* p = cst + off + 4LL * k;     // (shift, width, signed, apply)
      const T res = requant(acc, p[0], p[1], p[2] != 0, wrap);
      if (p[3] != 0) acc = res;
    } else {
      acc = wmul(acc, cst[off + k]);
    }
  }
  return acc;
}

template <bool RES, typename L>
__device__ __forceinline__ L table_load(const L* __restrict__ tab, int at) {
  if constexpr (RES) return tab[at];
  else if constexpr (sizeof(L) == 8)
    return static_cast<L>(__ldg(reinterpret_cast<const long long*>(tab) + at));
  else return __ldg(tab + at);
}

// One lookup of row value v in cell `cell`: the in-shift, the mask, the clamp
// to the table, the entry sign-extended.
template <typename T, typename L, bool RES, bool SHIFT>
__device__ __forceinline__ T lookup(T v, int cell, const T* __restrict__ cst,
                                    long long in_shift, long long mask, T e_last,
                                    const L* __restrict__ tab, int E) {
  T code = v;
  if constexpr (SHIFT) code = shift_round(v, cst[in_shift + cell]);
  T idx = code & cst[mask + cell];
  idx = idx > e_last ? e_last : (idx < 0 ? static_cast<T>(0) : idx);
  return static_cast<T>(table_load<RES>(tab, cell * E + static_cast<int>(idx)));
}

// A "lut" stage over the tile: warp units (row group, site, CC outputs),
// lanes over rows.  L is the lane dtype (sign-extended on read); RES: the
// tables are in shared memory at tab (waited for once); SHIFT: the
// stage has in-shifts; FAST: the stage has none, one mask for every cell that
// no index passes the table's end through (so no clamp), and a contiguous
// gather, so a row value read and masked once serves the CC lookups of its j
// and neither a gather index nor a mask is read per term.  The j loop runs 4
// rows of j at a time with no branch inside: a unit short of CC outputs
// repeats its last cell and stores only its own, so all 4 x CC lookups are
// independent loads in flight.
template <typename T, typename L, bool RES, bool SHIFT, bool FAST>
__device__ __forceinline__ void lut_stage(const Stage& st, const int64_t* __restrict__ d,
                                          const T* __restrict__ cst, const L* __restrict__ tab,
                                          const uint64_t* bars, const T* vin, int sin, T* vout,
                                          int sout, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int n_rg = (n_rows + 31) / 32;
  const int n_cc = (st.co + CC - 1) / CC;
  const int n_units = n_rg * st.S * n_cc;
  const T e_last = static_cast<T>(st.E - 1);
  const T fmask = static_cast<T>(st.fast_mask);
  for (int u = threadIdx.x >> 5; u < n_units; u += kWarps) {
    const int rg = u % n_rg;
    const int t = u / n_rg;
    const int cc = t % n_cc;
    const int s = t / n_cc;
    const int r = rg * 32 + lane;
    if (r >= n_rows) continue;               // the tile's last row group may be short
    const int c0 = cc * CC;
    const int cn = min(CC, st.co - c0);
    int cq[CC];                              // the unit's cells of j = 0
#pragma unroll
    for (int q = 0; q < CC; ++q) cq[q] = c0 + min(q, cn - 1);
    const T* gat = cst + st.gather + static_cast<long long>(s) * st.J;
    const T* vrow = vin + r * sin;
    if constexpr (FAST) vrow += static_cast<int>(gat[0]);   // columns gat[0] + j
    T acc[CC];
#pragma unroll
    for (int q = 0; q < CC; ++q) acc[q] = 0;
    if constexpr (RES) bar_wait(smem_addr(bars + st.bar));   // the stage's tables have landed
    int j = 0;
    for (; j + 4 <= st.J; j += 4) {
      T v[4], e[4][CC];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = FAST ? static_cast<T>(vrow[j + k] & fmask) : vrow[static_cast<int>(gat[j + k])];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < CC; ++q) {
          const int cell = (j + k) * st.co + cq[q];
          e[k][q] = FAST ? static_cast<T>(table_load<RES>(tab, cell * st.E + static_cast<int>(v[k])))
                         : lookup<T, L, RES, SHIFT>(v[k], cell, cst, st.in_shift, st.mask, e_last,
                                                    tab, st.E);
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < CC; ++q) acc[q] = wadd(acc[q], e[k][q]);
    }
    for (; j < st.J; ++j) {
      const T v = FAST ? static_cast<T>(vrow[j] & fmask) : vrow[static_cast<int>(gat[j])];
#pragma unroll
      for (int q = 0; q < CC; ++q) {
        const int cell = j * st.co + cq[q];
        acc[q] = wadd(acc[q],
                      FAST ? static_cast<T>(table_load<RES>(tab, cell * st.E + static_cast<int>(v)))
                           : lookup<T, L, RES, SHIFT>(v, cell, cst, st.in_shift, st.mask, e_last,
                                                      tab, st.E));
      }
    }
#pragma unroll
    for (int q = 0; q < CC; ++q) {
      if (q < cn) {
        const int k = s * st.co + c0 + q;
        vout[r * sout + k] = finish_output(acc[q], k, st, d, cst);
      }
    }
  }
}

// A "sum" stage: warp units (row group, site), lanes over rows; its co
// outputs share the sum and differ in bias and epilogue.
template <typename T>
__device__ __forceinline__ void sum_stage(const Stage& st, const int64_t* __restrict__ d,
                                          const T* __restrict__ cst, const T* vin, int sin,
                                          T* vout, int sout, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int n_rg = (n_rows + 31) / 32;
  const int n_units = n_rg * st.S;
  for (int u = threadIdx.x >> 5; u < n_units; u += kWarps) {
    const int rg = u % n_rg;
    const int s = u / n_rg;
    const int r = rg * 32 + lane;
    if (r >= n_rows) continue;
    const T* vrow = vin + r * sin;
    const T* gat = cst + st.gather + static_cast<long long>(s) * st.J;
    const T* coef = cst + st.coef + static_cast<long long>(s) * st.J;
    T acc = 0;
#pragma unroll 4
    for (int j = 0; j < st.J; ++j) acc = wadd(acc, wmul(vrow[static_cast<int>(gat[j])], coef[j]));
    for (int c = 0; c < st.co; ++c) {
      const int k = s * st.co + c;
      vout[r * sout + k] = finish_output(acc, k, st, d, cst);
    }
  }
}

template <typename T, typename L>
__device__ __forceinline__ void lut_stage_for(const Stage& st, const int64_t* d,
                                              const T* cst, const L* global_tab,
                                              unsigned char* smem, const uint64_t* bars,
                                              const T* vin, int sin, T* vout, int sout,
                                              int n_rows) {
  const bool shift = st.in_shift >= 0;
  if (st.soff >= 0) {
    const L* tab = reinterpret_cast<const L*>(smem + st.soff);
    if (st.fast_mask >= 0)
      lut_stage<T, L, true, false, true>(st, d, cst, tab, bars, vin, sin, vout, sout, n_rows);
    else if (shift)
      lut_stage<T, L, true, true, false>(st, d, cst, tab, bars, vin, sin, vout, sout, n_rows);
    else
      lut_stage<T, L, true, false, false>(st, d, cst, tab, bars, vin, sin, vout, sout, n_rows);
  } else {
    const L* tab = global_tab + st.toff;
    if (shift)
      lut_stage<T, L, false, true, false>(st, d, cst, tab, bars, vin, sin, vout, sout, n_rows);
    else
      lut_stage<T, L, false, false, false>(st, d, cst, tab, bars, vin, sin, vout, sout, n_rows);
  }
}

// The chain over the tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
// tile_rows rows; CST: the constants are in shared memory.
template <typename T, bool CST>
__global__ void __launch_bounds__(kThreads) lut_serve_chain_kernel(
    const T* __restrict__ x, T* __restrict__ out, int batch,
    const int64_t* __restrict__ desc, int tile_rows, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_stages = static_cast<int>(ldd(desc + H_NSTAGES));
  const int n_in = static_cast<int>(ldd(desc + H_NIN));
  const int n_out = static_cast<int>(ldd(desc + H_NOUT));
  const long long out_cols = ldd(desc + H_OUTCOLS);
  const int n_bar = static_cast<int>(ldd(desc + H_NBAR));
  const int stride_a = static_cast<int>(ldd(desc + H_STRIDEA));
  const int stride_b = static_cast<int>(ldd(desc + H_STRIDEB));
  const T* g_consts = reinterpret_cast<const T*>(ldd(desc + H_CONSTS));
  const void* lanes[4] = {reinterpret_cast<const void*>(ldd(desc + H_T8)),
                          reinterpret_cast<const void*>(ldd(desc + H_T16)),
                          reinterpret_cast<const void*>(ldd(desc + H_T32)),
                          reinterpret_cast<const void*>(ldd(desc + H_T64))};
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ldd(desc + H_BARSOFF));
  const T* cst = CST ? reinterpret_cast<const T*>(smem + ldd(desc + H_CSOFF)) : g_consts;
  T* buf_a = reinterpret_cast<T*>(smem + ldd(desc + H_BUFSOFF));
  T* buf_b = buf_a + tile_rows * stride_a;
  const int64_t* sdesc = desc + kNH;

  // stage the constants and the resident tables once, by the copy list the
  // planner wrote: the last warp (which computes least) starts every bulk
  // copy, a lane a copy, while the others load their first tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kWarps - 1) {
    for (int b = lane; b < n_bar; b += 32) bar_init(smem_addr(bars + b));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are initialised before anyone waits
  if (warp == kWarps - 1) {
    const int n_copies = static_cast<int>(ldd(desc + H_NCOPIES));
    const int64_t* copies = sdesc + static_cast<long long>(n_stages) * kNF;
    for (int c = lane; c < n_copies; c += 32) {
      const int64_t* cp = copies + kCopyFields * c;
      bulk_load(smem_addr(smem + ldd(cp)), reinterpret_cast<const void*>(ldd(cp + 1)),
                static_cast<uint32_t>(ldd(cp + 2)), smem_addr(bars + ldd(cp + 3)));
    }
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * tile_rows;
    const int n_rows = static_cast<int>(min(static_cast<long long>(tile_rows), batch - row0));
    // the tile's input codes and the zero column
    for (int t = threadIdx.x; t < n_rows * n_in; t += kThreads) {
      const int r = t / n_in;
      buf_a[r * stride_a + (t - r * n_in)] = x[row0 * n_in + t];
    }
    for (int r = threadIdx.x; r < n_rows; r += kThreads) buf_a[r * stride_a + n_in] = 0;
    if (CST) bar_wait(smem_addr(bars));
    __syncthreads();

    T* vin = buf_a;
    T* vout = buf_b;
    int sin = stride_a, sout = stride_b;
    for (int k = 0; k < n_stages; ++k) {
      const int64_t* d = sdesc + static_cast<long long>(k) * kNF;
      const Stage st = read_stage(d);
      if (ldd(d + F_KIND) == 0) {
        switch (ldd(d + F_LANE)) {
          case 0:
            lut_stage_for<T>(st, d, cst, static_cast<const int8_t*>(lanes[0]), smem, bars,
                             vin, sin, vout, sout, n_rows);
            break;
          case 1:
            lut_stage_for<T>(st, d, cst, static_cast<const int16_t*>(lanes[1]), smem, bars,
                             vin, sin, vout, sout, n_rows);
            break;
          case 2:
            lut_stage_for<T>(st, d, cst, static_cast<const int32_t*>(lanes[2]), smem, bars,
                             vin, sin, vout, sout, n_rows);
            break;
          default:
            lut_stage_for<T>(st, d, cst, static_cast<const int64_t*>(lanes[3]), smem, bars,
                             vin, sin, vout, sout, n_rows);
        }
      } else {
        sum_stage<T>(st, d, cst, vin, sin, vout, sout, n_rows);
      }
      const int w_out = st.S * st.co;
      for (int r = threadIdx.x; r < n_rows; r += kThreads) vout[r * sout + w_out] = 0;
      __syncthreads();
      T* tmp = vin;
      vin = vout;
      vout = tmp;
      const int ts = sin;
      sin = sout;
      sout = ts;
    }

    const T* cols = cst + out_cols;
    for (int t = threadIdx.x; t < n_rows * n_out; t += kThreads) {
      const int r = t / n_out;
      out[row0 * n_out + t] = vin[r * sin + static_cast<int>(cols[t - r * n_out])];
    }
    __syncthreads();   // the tile is read before the next one overwrites it
  }
  // no bulk copy may still be landing when the block exits
  for (int b = threadIdx.x; b < n_bar; b += kThreads) bar_wait(smem_addr(bars + b));
}

// variant = 2 * (int64 compute) + (constants in shared memory)
const void* kernel_for(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(lut_serve_chain_kernel<int32_t, false>);
    case 1: return reinterpret_cast<const void*>(lut_serve_chain_kernel<int32_t, true>);
    case 2: return reinterpret_cast<const void*>(lut_serve_chain_kernel<int64_t, false>);
    case 3: return reinterpret_cast<const void*>(lut_serve_chain_kernel<int64_t, true>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int lut_serve_header_fields() { return kNH; }

extern "C" int lut_serve_descriptor_fields() { return kNF; }

extern "C" int lut_serve_copy_fields() { return kCopyFields; }

extern "C" int lut_serve_max_epilogue() { return kMaxEpi; }

extern "C" int lut_serve_threads() { return kThreads; }

extern "C" int lut_serve_outputs_per_warp() { return CC; }

// Resident blocks an SM holds of `variant` on the current device by threads
// and registers (the occupancy query; shared memory is the planner's
// count), 0 for an invalid variant.  Also lets the variant take up to
// SMEM_MAX bytes of dynamic shared memory: call it once per device before
// the first launch, outside any stream capture.
extern "C" int lut_serve_blocks_per_sm(int variant) {
  const void* f = kernel_for(variant);
  if (f == nullptr) return 0;
  int per_sm = 0;
  if (cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, kThreads, 0) != cudaSuccess)
    return 0;
  return per_sm;
}

// x (batch, n_in) and out (batch, n_out) in the compute dtype; desc the
// chain's descriptors (a header, a row per stage, a row per bulk copy) on the
// device; the grid of `grid` blocks walks n_tiles tiles of tile_rows rows with
// `smem` bytes of dynamic shared memory each (kernels/lut_serve_cuda.py::
// tile_plan plans them).
extern "C" int lut_serve_chain(int variant, const void* x, void* out, int batch,
                               const void* desc, int tile_rows, int n_tiles, int grid,
                               int smem, void* stream) {
  if (batch == 0) return 0;
  if (kernel_for(variant) == nullptr || batch < 0 || tile_rows < 1 || grid < 1 ||
      grid > n_tiles || smem < 0 || smem > SMEM_MAX ||
      static_cast<long long>(n_tiles) * tile_rows < batch ||
      static_cast<long long>(n_tiles - 1) * tile_rows >= batch)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &batch, &desc, &tile_rows, &n_tiles};
  return static_cast<int>(cudaLaunchKernel(kernel_for(variant), dim3(grid), dim3(kThreads), args,
                                           static_cast<size_t>(smem),
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" const char* lut_serve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
