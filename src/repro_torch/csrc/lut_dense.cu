// Kernel B2: the eval-mode LUT-Dense forward (paper Eq. 1, one hidden tanh
// layer) on Hopper.
//
// Replaces the TPU kernel repro/kernels/lut_dense.py::lut_dense_fused (body
// _lut_dense_kernel, src/repro/kernels/lut_dense.py:60; pallas_call at :114).
//
//   out[b, o] = sum_j SAT( sum_h w_out[j,h,o] * tanh(WRAP(x[b,j]) * w0[j,h,o]
//                                                  + b0[j,h,o]) + b_out[j,o] )
//
// Bound: operations.  At the JSC shapes (B = 16600, 16 -> 20 and 20 -> 5,
// H = 8) the call moves at most 2.4 MB (x, weights, out) but evaluates 42.5
// M (16 -> 20) or 13.3 M (20 -> 5) tanhf, each about 16 instructions, two of
// them on the SFU: some 220 instructions per (b, j, o) in all, which the
// card issues at one warp instruction a clock on each of its 4 x 132
// schedulers.  So what costs issue slots or leaves schedulers idle is what
// the design removes:
//  * One balanced wave.  Block (s, c) owns the batch rows [s*R, (s+1)*R)
//    and the outputs [c*O, (c+1)*O) with G x O warps: warp (g, o) takes
//    output o, and its lane l the rows 32 g + l, 32 (g + G) + l, ... of the
//    block, so every lane of a warp reads the same cell.  R (a multiple of
//    32 G), G and O are chosen by the caller (kernels/lut_dense.py::
//    launch_plan) so that the grid fits the blocks the card holds at once
//    (SMs x the occupancy of this instantiation at G x O warps,
//    lut_dense_forward_blocks_per_sm) and the busiest SM gets the fewest
//    rows, with the fewest blocks that does it: at 20 -> 5, 130 blocks of
//    4 x 5 warps, one an SM, each staging its constants once for 128 rows.
//    The ragged batch edge is a shorter last block, never padding in memory.
//  * H is a template parameter, 1..16, so the H tanhf chains of a cell are
//    unrolled and interleave, and four cells of a row are in flight at once
//    (the j loop unrolled by 4); any other H runs the instantiation H = 0,
//    the same kernel with a runtime loop over h and the weights read from
//    global memory (every lane of a warp reads the same address).
//  * Constants staged once per block in (dynamic) shared memory: each cell's
//    quantizer constants (lut_cell.cuh's make_cell, B3's definition), the
//    weights as float4 (w0, b0, w_out, 0) per (j, o, h), and the block's x
//    tile, loaded with coalesced reads into rows of odd stride, so that the
//    32 rows a warp reads at once fall in 32 banks.  Every lane of a warp
//    reads the same cell and weights: a shared-memory broadcast.  Channels
//    past the shared-memory budget are staged a chunk of j at a time, the
//    running sum kept in the output between chunks.
//  * fq.cuh's fast path: the input WRAP on the integer code of x * 2^f_in
//    and the output rounding y * 2^f_out, no division and no fmodf inside
//    its guard; anything outside the guard takes fq::quantize out of line.
//
// Exactness: the kernel runs the plain version's (kernels/ref.py::
// lut_dense_ref) float32 operations in its order, so the two agree bit for
// bit: tanhf (no tanh.approx, no --use_fast_math); __fmul_rn / __fadd_rn so
// nvcc cannot contract into FMAs the plain version does not do; the sum over
// h in index order from its first product, then + b_out, then SAT, then the
// sum over j in index order in one register, from 0.  Two launches give the
// same bits: no atomics, and no order that depends on scheduling.
#include <cuda_runtime.h>
#include <math.h>

#include "fq.cuh"
#include "lut_cell.cuh"

namespace {

constexpr int MAX_H = 16;
constexpr int MAX_WARPS = 32;   // warps of a block, as kernels/lut_dense.py plans them
constexpr int SMEM_MAX = 227 * 1024;           // dynamic shared memory a block may use
constexpr int CELL_F4 = sizeof(lut::Cell) / sizeof(float4);
static_assert(sizeof(lut::Cell) % sizeof(float4) == 0, "cells are staged as float4s");
// kernels/lut_dense.py plans blocks with this size (CELL_BYTES) and checks
// its plan against lut_dense_forward_smem once per shape on the card
static_assert(sizeof(lut::Cell) == 64, "update CELL_BYTES in kernels/lut_dense.py");

// One (b, j, o) before its output quantizer: sum_h w_out * tanh(WRAP(x) *
// w0 + b0) + b_out of cell c.  H > 0: the cell's weights are ws[0..H); H ==
// 0: hidden of them in global memory from index w, c_out apart.
template <int H>
__device__ __forceinline__ float cell_raw(float xv, const lut::Cell& c,
                                          const float4* __restrict__ ws,
                                          const float* __restrict__ w0,
                                          const float* __restrict__ b0,
                                          const float* __restrict__ wo, int w,
                                          int hidden, int c_out) {
  float xq;
  if (!fq::quant_fast<true, true>(xv, c.in, xq))
    xq = fq::quantize_slow<true, true>(xv, c.f_in, c.i_in);
  float y;
  if constexpr (H > 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float4 wh = ws[h];
      const float p = __fmul_rn(tanhf(__fadd_rn(__fmul_rn(xq, wh.x), wh.y)), wh.z);
      y = h == 0 ? p : __fadd_rn(y, p);
    }
  } else {
    for (int h = 0; h < hidden; ++h, w += c_out) {
      const float p = __fmul_rn(
          tanhf(__fadd_rn(__fmul_rn(xq, __ldg(w0 + w)), __ldg(b0 + w))), __ldg(wo + w));
      y = h == 0 ? p : __fadd_rn(y, p);
    }
  }
  return __fadd_rn(y, c.bias);
}

// One (b, j, o): SAT(cell_raw) on cell c's output grid.
template <int H>
__device__ __forceinline__ float cell_value(float xv, const lut::Cell& c,
                                            const float4* __restrict__ ws,
                                            const float* __restrict__ w0,
                                            const float* __restrict__ b0,
                                            const float* __restrict__ wo, int w,
                                            int hidden, int c_out) {
  return lut::sat_out(cell_raw<H>(xv, c, ws, w0, b0, wo, w, hidden, c_out), c);
}

template <int H>
__global__ void __launch_bounds__(MAX_WARPS * 32) lut_dense_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, float* __restrict__ out, int batch, int c_in,
    int hidden, int c_out, int block_rows, int j_chunk, int o_chunk, int groups) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp / o_chunk;                // warp (g, ol): output ol, rows 32 g + lane, ...
  const int ol = warp - g * o_chunk;
  const int row0 = blockIdx.x * block_rows;
  const int n_rows = min(block_rows, batch - row0);
  const int o0 = blockIdx.y * o_chunk;
  const int o_n = min(o_chunk, c_out - o0);
  const int xstride = j_chunk | 1;             // odd: a warp's 32 rows in 32 banks
  lut::Cell* csm = reinterpret_cast<lut::Cell*>(smem);               // [j][o]
  float4* wsm = smem + j_chunk * o_chunk * CELL_F4;                  // [j][o][h]
  float* xs = reinterpret_cast<float*>(wsm + j_chunk * o_chunk * H); // [row][j]

  for (int j0 = 0; j0 < c_in; j0 += j_chunk) {
    const int jn = min(j_chunk, c_in - j0);
    if (j0 > 0) __syncthreads();               // the previous chunk is read
    for (int e = threadIdx.x; e < jn * o_n; e += blockDim.x) {
      const int jl = e / o_n, oc = e - jl * o_n;
      const int cell = (j0 + jl) * c_out + o0 + oc;
      csm[jl * o_chunk + oc] = lut::make_cell(__ldg(fi + cell), __ldg(ii + cell),
                                              __ldg(fo + cell), __ldg(io + cell),
                                              __ldg(bo + cell));
    }
    if constexpr (H > 0) {
      for (int e = threadIdx.x; e < jn * H * o_n; e += blockDim.x) {
        const int t = e / o_n, oc = e - t * o_n;        // t = jl * H + h
        const int w = (j0 * H + t) * c_out + o0 + oc;
        wsm[((t / H) * o_chunk + oc) * H + t % H] =
            make_float4(__ldg(w0 + w), __ldg(b0 + w), __ldg(wo + w), 0.0f);
      }
    }
    for (int e = threadIdx.x; e < n_rows * jn; e += blockDim.x) {
      const int r = e / jn, jl = e - r * jn;
      xs[r * xstride + jl] = __ldg(x + static_cast<long long>(row0 + r) * c_in + j0 + jl);
    }
    __syncthreads();
    if (ol >= o_n) continue;                   // the last chunk of o may be short
    const int o = o0 + ol;
    for (int r = 32 * g + lane; r < n_rows; r += 32 * groups) {
      float* dst = out + static_cast<long long>(row0 + r) * c_out + o;
      float acc = j0 == 0 ? 0.0f : *dst;       // the sum so far, in index order
      const float* xr = xs + r * xstride;
#pragma unroll 4                               // four cells of a row in flight
      for (int jl = 0; jl < jn; ++jl) {
        const int cw = jl * o_chunk + ol;
        acc = __fadd_rn(acc, cell_value<H>(xr[jl], csm[cw], wsm + cw * H, w0, b0, wo,
                                           (j0 + jl) * hidden * c_out + o, hidden,
                                           c_out));
      }
      *dst = acc;
    }
  }
}

using Kernel = decltype(&lut_dense_forward_kernel<0>);

// kernels[H] is the instantiation for H = 1..MAX_H, kernels[0] the generic one
const Kernel kernels[MAX_H + 1] = {
    lut_dense_forward_kernel<0>,  lut_dense_forward_kernel<1>,
    lut_dense_forward_kernel<2>,  lut_dense_forward_kernel<3>,
    lut_dense_forward_kernel<4>,  lut_dense_forward_kernel<5>,
    lut_dense_forward_kernel<6>,  lut_dense_forward_kernel<7>,
    lut_dense_forward_kernel<8>,  lut_dense_forward_kernel<9>,
    lut_dense_forward_kernel<10>, lut_dense_forward_kernel<11>,
    lut_dense_forward_kernel<12>, lut_dense_forward_kernel<13>,
    lut_dense_forward_kernel<14>, lut_dense_forward_kernel<15>,
    lut_dense_forward_kernel<16>};

Kernel kernel_for(int hidden) { return kernels[hidden <= MAX_H ? hidden : 0]; }

// Dynamic shared memory of a block, as lut_dense_forward_kernel lays it out:
// j_chunk x o_chunk cells and their weights (none for the generic
// instantiation), then block_rows rows of x of odd stride.
long long forward_smem(int block_rows, int j_chunk, int o_chunk, int hidden) {
  const int h = hidden <= MAX_H ? hidden : 0;
  return static_cast<long long>(j_chunk) * o_chunk * (CELL_F4 + h) * sizeof(float4) +
         static_cast<long long>(block_rows) * (j_chunk | 1) * sizeof(float);
}

// ---------------------------------------------------------------------------
// The batch statistics of train-mode batch-norm on the cell outputs: for
// every cell (j, o), the mean and the population variance over the batch of
//   y[b, j, o] = sum_h w_out * tanh(WRAP(x[b, j]) * w0 + b0) + b_out,
// cell_raw above, B2's cell before its SAT.  The caller folds them into B2's
// output projection (core/lut_layers.py); nothing of size (B, C_in, C_out)
// is written.
//  * B3's grid (kernels/lut_dense_bwd.py::launch_plan): n_split x C_in
//    blocks, block (s, j) owning input channel j and the batch rows
//    [s*R, (s+1)*R).  A thread holds its rows tid, tid + 256, ... (at most
//    STATS_ROWS of them) in registers: x once, then y of one o at a time.
//  * The variance from deviations about a mean, never as sum(y^2)/B -
//    mean^2: a thread forms its rows' (count, mean, M2) in two passes over
//    its registers; a warp merges its lanes' by Chan's formula down a fixed
//    shuffle tree, the block its warps' in index order into one partial per
//    (split, j, o), and the last block of j to finish (a ticket, as B3)
//    merges the n_split partials in split order.  No float atomics and no
//    order that depends on scheduling: two launches give the same bits.
//  * Per chunk of o (all of C_out at the JSC shapes) the cells' input
//    constants and weights are staged once for the block in shared memory,
//    as B3 stages them; H = 0 is the generic instantiation (any H > 16),
//    the weights read from global memory.
constexpr int STATS_THREADS = 256;
constexpr int STATS_WARPS = STATS_THREADS / 32;
constexpr int STATS_ROWS = 8;                      // rows a thread holds
constexpr int STATS_MAX_SPLIT_ROWS = STATS_THREADS * STATS_ROWS;
constexpr int STATS_O_CHUNK = 32;

struct Moments {
  int n;                                           // rows
  float mean, m2;                                  // their mean, sum of squared deviations
};

// Chan, Golub and LeVeque's pairwise update: the moments of a's rows and b's
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0) return a;
  if (a.n == 0) return b;
  const int n = a.n + b.n;
  const float fb = static_cast<float>(b.n) / static_cast<float>(n);
  const float delta = b.mean - a.mean;
  return {n, fmaf(delta, fb, a.mean),
          a.m2 + b.m2 + delta * delta * static_cast<float>(a.n) * fb};
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int off) {
  return {__shfl_down_sync(0xffffffffu, m.n, off), __shfl_down_sync(0xffffffffu, m.mean, off),
          __shfl_down_sync(0xffffffffu, m.m2, off)};
}

template <int H>
__global__ void __launch_bounds__(STATS_THREADS) lut_bn_stats_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, float* __restrict__ mean, float* __restrict__ var,
    float* __restrict__ partial, unsigned* __restrict__ tickets, int batch, int c_in,
    int hidden, int c_out, int n_split, int split_rows) {
  __shared__ float4 wsm[STATS_O_CHUNK * (H > 0 ? H : 1)];   // (w0, b0, w_out) by (o, h)
  __shared__ lut::Cell csm[STATS_O_CHUNK];
  __shared__ Moments slot[STATS_WARPS][STATS_O_CHUNK];
  __shared__ bool last;
  const int split = blockIdx.x % n_split;
  const int j = blockIdx.x / n_split;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = split * split_rows;
  const int n_rows = min(split_rows, batch - row0);

  float xr[STATS_ROWS];
  int n_mine = 0;                                  // rows k < n_mine are this thread's
#pragma unroll
  for (int k = 0; k < STATS_ROWS; ++k) {
    const int r = threadIdx.x + k * STATS_THREADS;
    xr[k] = r < n_rows ? __ldg(x + static_cast<long long>(row0 + r) * c_in + j) : 0.0f;
    n_mine += r < n_rows;
  }

  for (int o0 = 0; o0 < c_out; o0 += STATS_O_CHUNK) {
    const int o_n = min(STATS_O_CHUNK, c_out - o0);
    if (o0 > 0) __syncthreads();                   // the previous chunk is read
    if constexpr (H > 0) {
      for (int e = threadIdx.x; e < o_n * H; e += STATS_THREADS) {
        const int ol = e / H, h = e - ol * H;
        const int w = (j * H + h) * c_out + o0 + ol;
        wsm[ol * H + h] = make_float4(__ldg(w0 + w), __ldg(b0 + w), __ldg(wo + w), 0.0f);
      }
    }
    for (int e = threadIdx.x; e < o_n; e += STATS_THREADS) {
      const int cell = j * c_out + o0 + e;         // the output grid is not used
      csm[e] = lut::make_cell(__ldg(fi + cell), __ldg(ii + cell), 0.0f, 0.0f,
                              __ldg(bo + cell));
    }
    __syncthreads();
    for (int ol = 0; ol < o_n; ++ol) {
      const int o = o0 + ol;
      const lut::Cell cl = csm[ol];
      float y[STATS_ROWS];
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < STATS_ROWS; ++k) {
        if (k < n_mine) {
          y[k] = cell_raw<H>(xr[k], cl, wsm + ol * H, w0, b0, wo, j * hidden * c_out + o,
                             hidden, c_out);
          s = k == 0 ? y[k] : s + y[k];
        }
      }
      Moments m = {n_mine, 0.0f, 0.0f};
      if (n_mine > 0) {
        m.mean = s / static_cast<float>(n_mine);
#pragma unroll
        for (int k = 0; k < STATS_ROWS; ++k) {
          if (k < n_mine) {
            const float d = y[k] - m.mean;
            m.m2 = fmaf(d, d, m.m2);
          }
        }
      }
      // lane 0 ends with the warp's rows (the other lanes' ends are unused)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
      if (lane == 0) slot[warp][ol] = m;
    }
    // the chunk's partials: the warps' moments merged in index order
    __syncthreads();
    for (int ol = threadIdx.x; ol < o_n; ol += STATS_THREADS) {
      Moments m = slot[0][ol];
#pragma unroll
      for (int w = 1; w < STATS_WARPS; ++w) m = merge(m, slot[w][ol]);
      float* p = partial + (static_cast<long long>(split) * c_in + j) * 2 * c_out + o0 + ol;
      p[0] = m.mean;
      p[c_out] = m.m2;
    }
  }

  // the last block of j to finish merges the partials in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + j, 1u) == static_cast<unsigned>(n_split - 1);
  __syncthreads();
  if (!last) return;
  const long long stride = static_cast<long long>(c_in) * 2 * c_out;   // one split
  for (int o = threadIdx.x; o < c_out; o += STATS_THREADS) {
    const float* p = partial + static_cast<long long>(j) * 2 * c_out + o;
    Moments m = {0, 0.0f, 0.0f};
    for (int t = 0; t < n_split; t += 8) {         // 8 splits' loads in flight
      float a[8], b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        a[u] = t + u < n_split ? __ldcg(p + (t + u) * stride) : 0.0f;
        b[u] = t + u < n_split ? __ldcg(p + (t + u) * stride + c_out) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (t + u < n_split)
          m = merge(m, {min(split_rows, batch - (t + u) * split_rows), a[u], b[u]});
    }
    mean[j * c_out + o] = m.mean;
    var[j * c_out + o] = m.m2 / static_cast<float>(batch);
  }
  if (threadIdx.x == 0) tickets[j] = 0u;
}

using StatsKernel = decltype(&lut_bn_stats_kernel<0>);

// stats_kernels[H] is the instantiation for H = 1..MAX_H, [0] the generic one
const StatsKernel stats_kernels[MAX_H + 1] = {
    lut_bn_stats_kernel<0>,  lut_bn_stats_kernel<1>,  lut_bn_stats_kernel<2>,
    lut_bn_stats_kernel<3>,  lut_bn_stats_kernel<4>,  lut_bn_stats_kernel<5>,
    lut_bn_stats_kernel<6>,  lut_bn_stats_kernel<7>,  lut_bn_stats_kernel<8>,
    lut_bn_stats_kernel<9>,  lut_bn_stats_kernel<10>, lut_bn_stats_kernel<11>,
    lut_bn_stats_kernel<12>, lut_bn_stats_kernel<13>, lut_bn_stats_kernel<14>,
    lut_bn_stats_kernel<15>, lut_bn_stats_kernel<16>};

StatsKernel stats_kernel_for(int hidden) { return stats_kernels[hidden <= MAX_H ? hidden : 0]; }

}  // namespace

// The dynamic shared memory in bytes that lut_dense_forward gives a block
// of these arguments; the launch planner (kernels/lut_dense.py) checks its
// own count against it.
extern "C" long long lut_dense_forward_smem(int block_rows, int j_chunk, int o_chunk,
                                            int hidden) {
  return forward_smem(block_rows, j_chunk, o_chunk, hidden);
}

// Resident blocks of `warps` warps an SM holds of the instantiation for
// `hidden` on the current device, before shared memory limits them (the
// occupancy query); 0 for invalid arguments.  Also lets that instantiation
// take up to SMEM_MAX bytes of dynamic shared memory: call it before the
// first launch on a device, outside any stream capture.
extern "C" int lut_dense_forward_blocks_per_sm(int hidden, int warps) {
  if (hidden < 1 || warps < 1 || warps > MAX_WARPS) return 0;
  const void* k = reinterpret_cast<const void*>(kernel_for(hidden));
  int per_sm = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32 * warps, 0) !=
          cudaSuccess)
    return 0;
  return per_sm;
}

// x (batch, c_in); w0, b0, wo (c_in, hidden, c_out); bo and the integer-
// valued widths fi, ii, fo, io (c_in, c_out); out (batch, c_out); all
// float32, contiguous.  Blocks of block_rows rows (the last may be shorter)
// by o_chunk outputs, groups x o_chunk warps, j_chunk input channels staged
// at a time.
extern "C" int lut_dense_forward(const void* x, const void* w0, const void* b0,
                                 const void* wo, const void* bo, const void* fi,
                                 const void* ii, const void* fo, const void* io,
                                 void* out, int batch, int c_in, int hidden,
                                 int c_out, int block_rows, int j_chunk,
                                 int o_chunk, int groups, void* stream) {
  if (batch < 0 || c_in < 1 || hidden < 1 || c_out < 0 || block_rows < 1 ||
      j_chunk < 1 || o_chunk < 1 || groups < 1 || o_chunk * groups > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || c_out == 0) return 0;
  const int h = hidden <= MAX_H ? hidden : 0;
  const long long smem = forward_smem(block_rows, j_chunk, o_chunk, hidden);
  const long long n_row = (static_cast<long long>(batch) + block_rows - 1) / block_rows;
  const long long n_o = (static_cast<long long>(c_out) + o_chunk - 1) / o_chunk;
  if (smem > SMEM_MAX || n_row > 0x7fffffffLL || n_o > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernels[h]<<<dim3(static_cast<unsigned>(n_row), static_cast<unsigned>(n_o)),
               32 * o_chunk * groups, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(fi),
      static_cast<const float*>(ii), static_cast<const float*>(fo),
      static_cast<const float*>(io), static_cast<float*>(out), batch, c_in, hidden,
      c_out, block_rows, j_chunk, o_chunk, groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lut_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int lut_bn_stats_max_split_rows() { return STATS_MAX_SPLIT_ROWS; }

// Resident blocks an SM holds of the statistics kernel for `hidden` on the
// current device (the occupancy query); 0 for an invalid hidden.
extern "C" int lut_bn_stats_blocks_per_sm(int hidden) {
  if (hidden < 1) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(stats_kernel_for(hidden)), STATS_THREADS,
          0) != cudaSuccess)
    return 0;
  return per_sm;
}

// x (batch, c_in); w0, b0, wo (c_in, hidden, c_out); bo and the integer-
// valued input widths fi, ii (c_in, c_out); mean, var (c_in, c_out) out;
// all float32, contiguous.  partial: n_split * c_in * 2 * c_out floats of
// scratch; tickets: c_in zeros, left zero.  Split s covers the batch rows
// [s * split_rows, min((s + 1) * split_rows, batch)), none of them empty.
extern "C" int lut_bn_stats(const void* x, const void* w0, const void* b0, const void* wo,
                            const void* bo, const void* fi, const void* ii, void* mean,
                            void* var, void* partial, void* tickets, int batch, int c_in,
                            int hidden, int c_out, int n_split, int split_rows,
                            void* stream) {
  if (batch < 1 || hidden < 1 || c_in < 0 || c_out < 0 || n_split < 1 || split_rows < 1 ||
      split_rows > STATS_MAX_SPLIT_ROWS ||
      static_cast<long long>(n_split) * split_rows < batch ||
      static_cast<long long>(n_split - 1) * split_rows >= batch ||
      static_cast<long long>(n_split) * c_in > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c_in == 0 || c_out == 0) return 0;
  stats_kernel_for(hidden)<<<n_split * c_in, STATS_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(fi),
      static_cast<const float*>(ii), static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<float*>(partial), static_cast<unsigned*>(tickets), batch, c_in, hidden,
      c_out, n_split, split_rows);
  return static_cast<int>(cudaGetLastError());
}
