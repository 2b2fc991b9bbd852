// Kernel B3: the recompute backward of the LUT-Dense forward (kernel B2),
// with the surrogate gradients of the HGQ quantizers.
//
// Replaces the TPU kernel repro/kernels/lut_dense_bwd.py::lut_dense_bwd_fused
// (body _lut_dense_bwd_kernel, src/repro/kernels/lut_dense_bwd.py:45;
// pallas_call at :170).
//
// For every (b, j, o) it recomputes the forward from x and the weights,
//   xq = WRAP(x[b,j]);  h_k = tanh(xq*w0 + b0);  y = sum_k h_k*w_out + b_out
// and applies the VJPs of repro_torch/core/quant.py::_fq_bwd and of the tiny
// MLP to the cotangent g[b,o]:
//   dx      sum over o of the alive cells' gxq (identity STE through WRAP)
//   dw0, db0, dw_out, db_out        the MLP's weight gradients
//   df_in   ln2*(x - round(x))*gxq where alive
//   df_out  ln2*(y - round(y))*g inside, ln2*2^-f clipped high, 0 clipped low
//   di_out  +-ln2*2^i at the saturation boundaries
// di_in is identically zero under WRAP and is made by the caller.  Nothing
// of shape (B, C_in, H, C_out) is written: the hidden activations live in
// registers, where the einsum VJP materialises that tensor twice.
//
// Bound: operations.  At 20 -> 5, H = 8, B = 16600 the call reads x, g and a
// few KB of weights and writes dx (about 2.3 MB in all), but evaluates 13 M
// tanh and ~40 FP32 operations per (b, j, o, h): some 300 instructions per
// (b, j, o), 1.66 M of them.  So the card's issue rate bounds it, and what
// costs issue slots or leaves SMs idle is what the design removes:
//  * One launch, one wave.  The TPU kernel accumulates the weight gradients
//    across a sequential batch grid axis in VMEM; CUDA blocks run in no
//    order.  The grid is n_split x C_in blocks: block (s, j) owns input
//    channel j and the batch rows [s*R, (s+1)*R), and n_split is chosen by
//    the caller (kernels/lut_dense_bwd.py::launch_plan) so that the grid
//    fills the blocks the card holds at once (SMs x the occupancy of this
//    instantiation, lut_dense_backward_blocks_per_sm) in one wave.  Each
//    block writes one partial per (q, o) of its j; the last block of j to
//    finish (an integer ticket taken after a __threadfence) sums the n_split
//    partials in split order and writes the gradients, then resets the
//    ticket for the next launch, so a CUDA graph can replay the call.  No
//    float atomics: two launches on the same inputs give the same bits.
//  * A thread walks the block's rows tid, tid + 256, ... (a runtime count)
//    for one o at a time, with h, the weights of (j, o) and the 3H+4
//    gradient sums in registers (H is a template parameter, 1..16; 126
//    registers and no spills at H = 8, two blocks an SM; any other H runs
//    lut_dense_bwd_generic, below).  Its rows' x and
//    their dx, summed over o, live in shared memory that only this thread
//    touches; the x loads are all issued at once, and dx is stored during
//    the last o, while other rows still compute.  The ragged batch edge is a
//    shorter last split, never padding in memory.
//  * Per chunk of o (all of C_out at the JSC shapes), the weights and each
//    cell's quantizer constants (lut_cell.cuh's make_cell, which B2 uses
//    too) are formed once for the block in shared memory, not by every
//    thread for every o.
//  * One block barrier per chunk, not two per o.  After each o a warp folds
//    its 3H+4 sums over its 32 lanes by recursive halving (31 shuffles for
//    H = 8, where a butterfly per sum takes 140) into its own slot of shared
//    memory; after the chunk the block sums the slots warp by warp in index
//    order into the partials.
//  * No division and no fmodf per element inside the guard of fq.cuh:
//    c = rint(x * 2^f_in) once gives both round(x) (c * 2^-f_in) for df_in
//    and the input WRAP on the integer code; y * 2^f_out rounds the output.
//    Anything outside the guard takes fq::quantize out of line.
// Exactness against the plain version (kernels/ref.py::lut_dense_bwd_ref):
// the forward recompute runs B2's float32 operations in B2's order (tanhf,
// __fmul_rn / __fadd_rn, no FMA contraction; the shortcuts above give the
// same bits) on B2's cell constants and output rounding (lut_cell.cuh), so
// every quantizer decision is the plain version's.  The
// backward's products are fused into its sums (FMA, one rounding where the
// plain version rounds twice), and the sums over the batch run in another
// order: within 1e-4 of the plain version's largest gradient.
//
// The backward of train-mode batch-norm's batch statistics (the mean and
// population variance of y over the batch, csrc/lut_dense.cu's
// lut_bn_stats_kernel) is this kernel too, in its BN mode
// (lut_bn_stats_grad_kernel, lut_bn_stats_grad_generic): the same grid,
// scratch, recompute and sums, with the row's cotangent of y set by the
// cell's (mean, g_mean, g_var) in place of the output quantizer's surrogate
// of g, so it has no dfo and no dio.  Its plain version is
// kernels/ref.py::lut_bn_stats_grad_ref.
//
// Any H > 16 runs lut_dense_bwd_generic: the same grid, partials and
// tickets, the forward recomputed in the same operations, but H a runtime
// count that cannot size register arrays.  Per o, a first pass over the
// block's rows recomputes y over every h (the SAT mask needs all of them)
// and keeps the row's output cotangent gy in shared memory; then the hidden
// units run in chunks of HC = 16 with their 3 HC sums in registers, adding
// each row's share of gxq into shared memory; a last pass forms df_in and
// dx from it.  One o at a time, so no sum array grows with H or C_out; it
// recomputes each tanh twice and spills, and is not timed.
#include <cuda_runtime.h>
#include <math.h>

#include "fq.cuh"
#include "lut_cell.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;                 // resident blocks an SM: at most 128 registers
constexpr int MAX_H = 16;
constexpr int MAX_SPLIT_ROWS = 2048;          // rows of one block: x and dx in shared memory
constexpr int SLOT_FLOATS = 6144;             // per-warp sums of one chunk of o (24 KB)
constexpr float LN2 = 0.693147180559945309f;  // float32(log 2), as the plain version
constexpr int HC = 16;                        // hidden units of a chunk of the generic kernel

// BN: the batch-statistics backward (lut_bn_stats_grad_kernel), which has
// no output quantizer and so no dfo, dio
template <int H, bool BN>
struct Sums {
  static constexpr int NQ = 3 * H + (BN ? 2 : 4);   // dw0[H] db0[H] dwo[H] dbo dfi [dfo dio]
  static constexpr int M = (NQ + 31) / 32;    // sums a lane holds after the fold
  static constexpr int O_CHUNK = SLOT_FLOATS / (WARPS * NQ) < 32
                                     ? SLOT_FLOATS / (WARPS * NQ) : 32;
};

// acc + a * b for the backward's sums over h and the batch.  The plain
// version rounds the product first; the FMA rounds once, which moves each
// term by at most half an ulp, far inside the tolerance of sums whose order
// differs anyway.  The forward recompute never contracts.
__device__ __forceinline__ float madd(float a, float b, float acc) { return fmaf(a, b, acc); }

// The input quantizer off its fast path: fq::quantize's WRAP, and round(x)
// by IEEE division.  Out of line, returned in registers.
__device__ __noinline__ float2 wrap_in_slow(float x, float f, float i) {
  const float scale = ldexpf(1.0f, -static_cast<int>(f));
  return make_float2(fq::quantize(x, f, i, true, true),
                     __fmul_rn(rintf(__fdiv_rn(x, scale)), scale));
}

// One step of the warp fold: lanes with bit S keep the upper half of v and
// send the lower, the others the reverse; each adds what its partner sent.
template <int S, int N>
__device__ __forceinline__ void fold_half(float (&v)[N], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int k = 0; k < N / 32 * S; ++k) {
    const float send = upper ? v[k] : v[k + N / 32 * S];
    const float keep = upper ? v[k + N / 32 * S] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, S));
  }
}

// The generic kernel's end, the unrolled one's with H at run time (kept
// apart so that the unrolled kernels compile to the code they had): the last
// block of j to finish sums the partials of its (q, o) in split order and
// writes the gradients, then resets j's ticket for the next launch.
__device__ __forceinline__ void finish(
    float* __restrict__ dw0, float* __restrict__ db0, float* __restrict__ dwo,
    float* __restrict__ dbo, float* __restrict__ dfi, float* __restrict__ dfo,
    float* __restrict__ dio, const float* __restrict__ partial,
    unsigned* __restrict__ tickets, bool& last, int j, int c_in, int c_out, int n_split,
    int hidden, bool bn) {
  const int NQ = 3 * hidden + (bn ? 2 : 4);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + j, 1u) == static_cast<unsigned>(n_split - 1);
  __syncthreads();
  if (!last) return;
  const long long stride = static_cast<long long>(c_in) * NQ * c_out;   // one split
  for (int e = threadIdx.x; e < NQ * c_out; e += THREADS) {
    const int q = e / c_out, o = e - q * c_out;
    const float* p = partial + (static_cast<long long>(j) * NQ + q) * c_out + o;
    float s = 0.0f;
    for (int t = 0; t < n_split; t += 16) {       // 16 loads in flight, summed in order
      float a[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) a[u] = t + u < n_split ? __ldcg(p + (t + u) * stride) : 0.0f;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (t + u < n_split) s = __fadd_rn(s, a[u]);
    }
    const int cell = j * c_out + o;
    const int H = hidden;
    if (q < H) dw0[(j * H + q) * c_out + o] = s;
    else if (q < 2 * H) db0[(j * H + q - H) * c_out + o] = s;
    else if (q < 3 * H) dwo[(j * H + q - 2 * H) * c_out + o] = s;
    else if (q == 3 * H) dbo[cell] = s;
    else if (q == 3 * H + 1) dfi[cell] = s;
    else if (q == 3 * H + 2) dfo[cell] = s;
    else dio[cell] = s;
  }
  if (threadIdx.x == 0) tickets[j] = 0u;
}

// The body of lut_dense_bwd_kernel (BN false) and of lut_bn_stats_grad_kernel
// (BN true).  With BN, fo, io and g carry each cell's batch mean, g_mean
// and g_var, all (C_in, C_out), and the cotangent of a row's raw cell
// output y is g_mean / B + (2 g_var / B) (y - mean), the VJP of the mean
// and population variance; dfo and dio are not written.
template <int H, bool BN>
__device__ __forceinline__ void bwd_body(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int batch, int c_in, int c_out, int n_split,
    int split_rows) {
  constexpr int NQ = Sums<H, BN>::NQ, M = Sums<H, BN>::M, O_CHUNK = Sums<H, BN>::O_CHUNK;
  __shared__ float xs[MAX_SPLIT_ROWS];
  __shared__ float dxs[MAX_SPLIT_ROWS];
  __shared__ float slot[WARPS][O_CHUNK][NQ];
  __shared__ float4 wsm[O_CHUNK][H];         // the chunk's (w0, b0, w_out) by (o, h)
  __shared__ lut::Cell csm[O_CHUNK];
  __shared__ float4 bsm[BN ? O_CHUNK : 1];   // BN: (mean, g_mean / B, 2 g_var / B)
  __shared__ bool last;
  const int split = blockIdx.x % n_split;
  const int j = blockIdx.x / n_split;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = split * split_rows;
  const int n_rows = min(split_rows, batch - row0);

  // this thread's rows: tid, tid + THREADS, ... < n_rows, all loads in flight at once
  {
    constexpr int MAX_ROWS = MAX_SPLIT_ROWS / THREADS;
    float xr[MAX_ROWS];
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k) {
      const int r = threadIdx.x + k * THREADS;
      if (r < n_rows) xr[k] = __ldg(x + static_cast<long long>(row0 + r) * c_in + j);
    }
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k) {
      const int r = threadIdx.x + k * THREADS;
      if (r < n_rows) {
        xs[r] = xr[k];
        dxs[r] = 0.0f;
      }
    }
  }

  for (int o0 = 0; o0 < c_out; o0 += O_CHUNK) {
    const int o_n = min(O_CHUNK, c_out - o0);
    // the chunk's weights and cell constants, staged once for the block
    if (o0 > 0) __syncthreads();
    for (int e = threadIdx.x; e < o_n * H; e += THREADS) {
      const int ol = e / H, h = e - ol * H;
      const int w = (j * H + h) * c_out + o0 + ol;
      wsm[ol][h] = make_float4(__ldg(w0 + w), __ldg(b0 + w), __ldg(wo + w), 0.0f);
    }
    for (int e = threadIdx.x; e < o_n; e += THREADS) {
      const int cell = j * c_out + o0 + e;
      if constexpr (BN) {                    // the output grid is not used
        csm[e] = lut::make_cell(__ldg(fi + cell), __ldg(ii + cell), 0.0f, 0.0f,
                                __ldg(bo + cell));
        const float n = static_cast<float>(batch);
        bsm[e] = make_float4(__ldg(fo + cell), __fdiv_rn(__ldg(io + cell), n),
                             __fdiv_rn(__fmul_rn(2.0f, __ldg(g + cell)), n), 0.0f);
      } else {
        csm[e] = lut::make_cell(__ldg(fi + cell), __ldg(ii + cell), __ldg(fo + cell),
                           __ldg(io + cell), __ldg(bo + cell));
      }
    }
    __syncthreads();
    for (int ol = 0; ol < o_n; ++ol) {
      const int o = o0 + ol;
      const lut::Cell cl = csm[ol];
      const fq::Width& wi = cl.in;
      const float4 bn = bsm[BN ? ol : 0];
      const bool last_o = o == c_out - 1;
      float w0h[H], b0h[H], woh[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 w = wsm[ol][h];
        w0h[h] = w.x;
        b0h[h] = w.y;
        woh[h] = w.z;
      }
      float acc[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;

      for (int r = threadIdx.x; r < n_rows; r += THREADS) {
        const float xv = xs[r];
        const float gv = BN ? 0.0f : __ldg(g + static_cast<long long>(row0 + r) * c_out + o);
        // the input quantizer: one product x * 2^f gives round(x) and WRAP(x)
        float xq = 0.0f, r_in = 0.0f;
        if (wi.fast) {
          const float c = rintf(__fmul_rn(xv, wi.mul));
          r_in = __fmul_rn(c, wi.scale);
          if (!fq::wrap_code(c, wi, xq)) xq = fq::quantize_slow<true, true>(xv, cl.f_in, cl.i_in);
        } else if (wi.live) {
          const float2 s = wrap_in_slow(xv, cl.f_in, cl.i_in);
          xq = s.x;
          r_in = s.y;
        }
        // the forward, as kernel B2 runs it
        float hv[H];
        float y = 0.0f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          hv[h] = tanhf(__fadd_rn(__fmul_rn(xq, w0h[h]), b0h[h]));
          y = __fadd_rn(y, __fmul_rn(hv[h], woh[h]));
        }
        y = __fadd_rn(y, cl.bias);
        float gy;
        if constexpr (BN) {                  // the statistics' VJP
          gy = __fadd_rn(bn.y, __fmul_rn(bn.z, __fsub_rn(y, bn.x)));
        } else {
          const float r_out = lut::round_out(y, cl);
          // the quantizers' surrogates and the MLP's VJP
          const bool chi = r_out > cl.hi;
          const bool clo = r_out < -cl.p2;
          gy = (cl.alive_o && !chi && !clo) ? gv : 0.0f;
          const float dfo_s = chi ? __fmul_rn(LN2, cl.scale_o)
                                  : (clo ? 0.0f : __fmul_rn(LN2, __fsub_rn(y, r_out)));
          const float dio_s = chi ? __fmul_rn(LN2, cl.p2)
                                  : (clo ? __fmul_rn(-LN2, cl.p2) : 0.0f);
          acc[3 * H + 2] = cl.alive_o ? madd(dfo_s, gv, acc[3 * H + 2]) : acc[3 * H + 2];
          acc[3 * H + 3] = cl.alive_o ? madd(dio_s, gv, acc[3 * H + 3]) : acc[3 * H + 3];
        }
        acc[3 * H] = __fadd_rn(acc[3 * H], gy);
        float gxq = 0.0f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          acc[2 * H + h] = madd(hv[h], gy, acc[2 * H + h]);
          const float gz = __fmul_rn(__fmul_rn(gy, woh[h]), madd(-hv[h], hv[h], 1.0f));
          acc[H + h] = __fadd_rn(acc[H + h], gz);
          acc[h] = madd(gz, xq, acc[h]);
          gxq = madd(gz, w0h[h], gxq);
        }
        const float dfi_s = __fmul_rn(__fmul_rn(LN2, __fsub_rn(xv, r_in)), gxq);
        acc[3 * H + 1] = __fadd_rn(acc[3 * H + 1], wi.live ? dfi_s : 0.0f);
        const float d = __fadd_rn(dxs[r], wi.live ? gxq : 0.0f);
        if (last_o)              // dx is final: stored while the other rows compute
          dx[static_cast<long long>(row0 + r) * c_in + j] = d;
        else
          dxs[r] = d;
      }

      // fold the warp's sums by recursive halving: lane l ends holding the
      // sums q = l*M .. l*M + M - 1
      float v[32 * M];
#pragma unroll
      for (int q = 0; q < 32 * M; ++q) v[q] = q < NQ ? acc[q] : 0.0f;
      fold_half<16>(v, lane);
      fold_half<8>(v, lane);
      fold_half<4>(v, lane);
      fold_half<2>(v, lane);
      fold_half<1>(v, lane);
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (lane * M + k < NQ) slot[warp][ol][lane * M + k] = v[k];
    }

    // the chunk's partials: the warps' slots summed in index order
    __syncthreads();
    for (int e = threadIdx.x; e < o_n * NQ; e += THREADS) {
      const int ol = e / NQ, q = e - ol * NQ;
      float s = slot[0][ol][q];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, slot[w][ol][q]);
      partial[((static_cast<long long>(split) * c_in + j) * NQ + q) * c_out + o0 + ol] = s;
    }
  }

  // the last block of j to finish sums the partials in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + j, 1u) == static_cast<unsigned>(n_split - 1);
  __syncthreads();
  if (!last) return;
  const long long stride = static_cast<long long>(c_in) * NQ * c_out;   // one split
  for (int e = threadIdx.x; e < NQ * c_out; e += THREADS) {
    const int q = e / c_out, o = e - q * c_out;
    const float* p = partial + (static_cast<long long>(j) * NQ + q) * c_out + o;
    float s = 0.0f;
    for (int t = 0; t < n_split; t += 16) {       // 16 loads in flight, summed in order
      float a[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) a[u] = t + u < n_split ? __ldcg(p + (t + u) * stride) : 0.0f;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (t + u < n_split) s = __fadd_rn(s, a[u]);
    }
    const int cell = j * c_out + o;
    if (q < H) dw0[(j * H + q) * c_out + o] = s;
    else if (q < 2 * H) db0[(j * H + q - H) * c_out + o] = s;
    else if (q < 3 * H) dwo[(j * H + q - 2 * H) * c_out + o] = s;
    else if (q == 3 * H) dbo[cell] = s;
    else if (q == 3 * H + 1) dfi[cell] = s;
    else if (q == 3 * H + 2) dfo[cell] = s;
    else dio[cell] = s;
  }
  if (threadIdx.x == 0) tickets[j] = 0u;
}

// H > 16: the body above with H a runtime count (the note at the top).
template <bool BN>
__device__ __forceinline__ void generic_body(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int batch, int c_in, int c_out, int n_split,
    int split_rows, int hidden) {
  constexpr int M = (3 * HC + 31) / 32;      // sums a lane holds after the fold
  constexpr int TAIL = BN ? 2 : 4;           // the cell's sums: dbo dfi [dfo dio]
  __shared__ float xs[MAX_SPLIT_ROWS];
  __shared__ float dxs[MAX_SPLIT_ROWS];
  __shared__ float gys[MAX_SPLIT_ROWS];      // the row's output cotangent, this o
  __shared__ float gxs[MAX_SPLIT_ROWS];      // the row's gxq so far, this o
  __shared__ float slot[WARPS][3 * HC];
  __shared__ lut::Cell csm;
  __shared__ float4 bsm;                     // BN: (mean, g_mean / B, 2 g_var / B)
  __shared__ bool last;
  const int split = blockIdx.x % n_split;
  const int j = blockIdx.x / n_split;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = split * split_rows;
  const int n_rows = min(split_rows, batch - row0);
  const int NQ = 3 * hidden + TAIL;

  // a row's slots in xs, dxs, gys and gxs are touched by its thread alone
  for (int r = threadIdx.x; r < n_rows; r += THREADS) {
    xs[r] = __ldg(x + static_cast<long long>(row0 + r) * c_in + j);
    dxs[r] = 0.0f;
  }
  for (int o = 0; o < c_out; ++o) {
    __syncthreads();                         // the previous o is done with csm
    if (threadIdx.x == 0) {
      const int cell = j * c_out + o;
      if constexpr (BN) {
        csm = lut::make_cell(__ldg(fi + cell), __ldg(ii + cell), 0.0f, 0.0f,
                             __ldg(bo + cell));
        const float n = static_cast<float>(batch);
        bsm = make_float4(__ldg(fo + cell), __fdiv_rn(__ldg(io + cell), n),
                          __fdiv_rn(__fmul_rn(2.0f, __ldg(g + cell)), n), 0.0f);
      } else {
        csm = lut::make_cell(__ldg(fi + cell), __ldg(ii + cell), __ldg(fo + cell),
                             __ldg(io + cell), __ldg(bo + cell));
      }
    }
    __syncthreads();
    const lut::Cell cl = csm;
    const float4 bn = bsm;
    const fq::Width& wi = cl.in;
    const float* w0o = w0 + static_cast<long long>(j) * hidden * c_out + o;  // h at h * c_out
    const float* b0o = b0 + static_cast<long long>(j) * hidden * c_out + o;
    const float* woo = wo + static_cast<long long>(j) * hidden * c_out + o;
    float* part = partial + (static_cast<long long>(split) * c_in + j) * NQ * c_out + o;
    // the input quantizer, as the kernel above: xq and round(x)
    auto quant_in = [&](float xv, float& xq, float& r_in) {
      xq = 0.0f;
      r_in = 0.0f;
      if (wi.fast) {
        const float c = rintf(__fmul_rn(xv, wi.mul));
        r_in = __fmul_rn(c, wi.scale);
        if (!fq::wrap_code(c, wi, xq)) xq = fq::quantize_slow<true, true>(xv, cl.f_in, cl.i_in);
      } else if (wi.live) {
        const float2 s = wrap_in_slow(xv, cl.f_in, cl.i_in);
        xq = s.x;
        r_in = s.y;
      }
    };

    // pass 1: the forward over every h, in kernel B2's order, and the cell's sums
    float s_dbo = 0.0f, s_dfo = 0.0f, s_dio = 0.0f;
    for (int r = threadIdx.x; r < n_rows; r += THREADS) {
      const float xv = xs[r];
      const float gv = BN ? 0.0f : __ldg(g + static_cast<long long>(row0 + r) * c_out + o);
      float xq, r_in;
      quant_in(xv, xq, r_in);
      float y = 0.0f;
      for (int h = 0; h < hidden; ++h) {
        const float p = __fmul_rn(
            tanhf(__fadd_rn(__fmul_rn(xq, __ldg(w0o + h * c_out)), __ldg(b0o + h * c_out))),
            __ldg(woo + h * c_out));
        y = h == 0 ? p : __fadd_rn(y, p);
      }
      y = __fadd_rn(y, cl.bias);
      float gy;
      if constexpr (BN) {
        gy = __fadd_rn(bn.y, __fmul_rn(bn.z, __fsub_rn(y, bn.x)));
      } else {
        const float r_out = lut::round_out(y, cl);
        const bool chi = r_out > cl.hi;
        const bool clo = r_out < -cl.p2;
        gy = (cl.alive_o && !chi && !clo) ? gv : 0.0f;
        const float dfo_s = chi ? __fmul_rn(LN2, cl.scale_o)
                                : (clo ? 0.0f : __fmul_rn(LN2, __fsub_rn(y, r_out)));
        const float dio_s = chi ? __fmul_rn(LN2, cl.p2) : (clo ? __fmul_rn(-LN2, cl.p2) : 0.0f);
        s_dfo = cl.alive_o ? madd(dfo_s, gv, s_dfo) : s_dfo;
        s_dio = cl.alive_o ? madd(dio_s, gv, s_dio) : s_dio;
      }
      s_dbo = __fadd_rn(s_dbo, gy);
      gys[r] = gy;
      gxs[r] = 0.0f;
    }

    // pass 2: the MLP's VJP, HC hidden units at a time
    for (int h0 = 0; h0 < hidden; h0 += HC) {
      const int hn = min(HC, hidden - h0);
      float w0h[HC], b0h[HC], woh[HC], acc[3 * HC];
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        const bool in = h < hn;
        w0h[h] = in ? __ldg(w0o + (h0 + h) * c_out) : 0.0f;
        b0h[h] = in ? __ldg(b0o + (h0 + h) * c_out) : 0.0f;
        woh[h] = in ? __ldg(woo + (h0 + h) * c_out) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 3 * HC; ++q) acc[q] = 0.0f;
      for (int r = threadIdx.x; r < n_rows; r += THREADS) {
        float xq, r_in;
        quant_in(xs[r], xq, r_in);
        const float gy = gys[r];
        float gxq = 0.0f;
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          if (h < hn) {
            const float hv = tanhf(__fadd_rn(__fmul_rn(xq, w0h[h]), b0h[h]));
            acc[2 * HC + h] = madd(hv, gy, acc[2 * HC + h]);
            const float gz = __fmul_rn(__fmul_rn(gy, woh[h]), madd(-hv, hv, 1.0f));
            acc[HC + h] = __fadd_rn(acc[HC + h], gz);
            acc[h] = madd(gz, xq, acc[h]);
            gxq = madd(gz, w0h[h], gxq);
          }
        }
        gxs[r] = __fadd_rn(gxs[r], gxq);
      }
      float v[32 * M];
#pragma unroll
      for (int q = 0; q < 32 * M; ++q) v[q] = q < 3 * HC ? acc[q] : 0.0f;
      fold_half<16>(v, lane);
      fold_half<8>(v, lane);
      fold_half<4>(v, lane);
      fold_half<2>(v, lane);
      fold_half<1>(v, lane);
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (lane * M + k < 3 * HC) slot[warp][lane * M + k] = v[k];
      __syncthreads();
      for (int e = threadIdx.x; e < 3 * hn; e += THREADS) {
        const int t = e / hn, h = e - t * hn;   // t: 0 dw0, 1 db0, 2 dw_out
        float s = slot[0][t * HC + h];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, slot[w][t * HC + h]);
        part[static_cast<long long>(t * hidden + h0 + h) * c_out] = s;
      }
      __syncthreads();                       // slot is read before the next chunk
    }

    // pass 3: the input quantizer's surrogate and dx
    float s_dfi = 0.0f;
    const bool last_o = o == c_out - 1;
    for (int r = threadIdx.x; r < n_rows; r += THREADS) {
      const float xv = xs[r];
      float xq, r_in;
      quant_in(xv, xq, r_in);
      const float gxq = gxs[r];
      const float dfi_s = __fmul_rn(__fmul_rn(LN2, __fsub_rn(xv, r_in)), gxq);
      s_dfi = __fadd_rn(s_dfi, wi.live ? dfi_s : 0.0f);
      const float d = __fadd_rn(dxs[r], wi.live ? gxq : 0.0f);
      if (last_o)
        dx[static_cast<long long>(row0 + r) * c_in + j] = d;
      else
        dxs[r] = d;
    }
    float v[32] = {s_dbo, s_dfi, s_dfo, s_dio};   // q = 3H .. 3H + 3
    fold_half<16>(v, lane);
    fold_half<8>(v, lane);
    fold_half<4>(v, lane);
    fold_half<2>(v, lane);
    fold_half<1>(v, lane);
    if (lane < TAIL) slot[warp][lane] = v[0];
    __syncthreads();
    if (threadIdx.x < TAIL) {
      float s = slot[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, slot[w][threadIdx.x]);
      part[static_cast<long long>(3 * hidden + threadIdx.x) * c_out] = s;
    }
  }

  finish(dw0, db0, dwo, dbo, dfi, dfo, dio, partial, tickets, last, j, c_in, c_out,
         n_split, hidden, BN);
}

template <int H>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) lut_dense_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int batch, int c_in, int c_out, int n_split,
    int split_rows) {
  bwd_body<H, false>(x, w0, b0, wo, bo, fi, ii, fo, io, g, dx, dw0, db0, dwo, dbo, dfi, dfo,
                     dio, partial, tickets, batch, c_in, c_out, n_split, split_rows);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) lut_dense_bwd_generic(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int batch, int c_in, int c_out, int n_split,
    int split_rows, int hidden) {
  generic_body<false>(x, w0, b0, wo, bo, fi, ii, fo, io, g, dx, dw0, db0, dwo, dbo, dfi, dfo,
                      dio, partial, tickets, batch, c_in, c_out, n_split, split_rows, hidden);
}

// The backward of the batch statistics (csrc/lut_dense.cu's
// lut_bn_stats_kernel) to (g_mean, g_var): B3's grid, scratch and sums
// with the cotangent of bwd_body's BN mode.  mean, g_mean and g_var are
// (C_in, C_out); dfo and dio are not written (nullptr).
template <int H>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) lut_bn_stats_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ mean,
    const float* __restrict__ g_mean, const float* __restrict__ g_var,
    float* __restrict__ dx, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int batch, int c_in, int c_out, int n_split,
    int split_rows) {
  bwd_body<H, true>(x, w0, b0, wo, bo, fi, ii, mean, g_mean, g_var, dx, dw0, db0, dwo, dbo,
                    dfi, dfo, dio, partial, tickets, batch, c_in, c_out, n_split, split_rows);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) lut_bn_stats_grad_generic(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ mean,
    const float* __restrict__ g_mean, const float* __restrict__ g_var,
    float* __restrict__ dx, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int batch, int c_in, int c_out, int n_split,
    int split_rows, int hidden) {
  generic_body<true>(x, w0, b0, wo, bo, fi, ii, mean, g_mean, g_var, dx, dw0, db0, dwo, dbo,
                     dfi, dfo, dio, partial, tickets, batch, c_in, c_out, n_split, split_rows,
                     hidden);
}

using Kernel = decltype(&lut_dense_bwd_kernel<1>);

// kernels[H - 1] is the instantiation for H
const Kernel kernels[MAX_H] = {
    lut_dense_bwd_kernel<1>,  lut_dense_bwd_kernel<2>,  lut_dense_bwd_kernel<3>,
    lut_dense_bwd_kernel<4>,  lut_dense_bwd_kernel<5>,  lut_dense_bwd_kernel<6>,
    lut_dense_bwd_kernel<7>,  lut_dense_bwd_kernel<8>,  lut_dense_bwd_kernel<9>,
    lut_dense_bwd_kernel<10>, lut_dense_bwd_kernel<11>, lut_dense_bwd_kernel<12>,
    lut_dense_bwd_kernel<13>, lut_dense_bwd_kernel<14>, lut_dense_bwd_kernel<15>,
    lut_dense_bwd_kernel<16>};

const void* kernel_for(int hidden) {
  return hidden <= MAX_H ? reinterpret_cast<const void*>(kernels[hidden - 1])
                         : reinterpret_cast<const void*>(lut_dense_bwd_generic);
}

// bn_kernels[H - 1] is the statistics backward's instantiation for H
const Kernel bn_kernels[MAX_H] = {
    lut_bn_stats_grad_kernel<1>,  lut_bn_stats_grad_kernel<2>,  lut_bn_stats_grad_kernel<3>,
    lut_bn_stats_grad_kernel<4>,  lut_bn_stats_grad_kernel<5>,  lut_bn_stats_grad_kernel<6>,
    lut_bn_stats_grad_kernel<7>,  lut_bn_stats_grad_kernel<8>,  lut_bn_stats_grad_kernel<9>,
    lut_bn_stats_grad_kernel<10>, lut_bn_stats_grad_kernel<11>, lut_bn_stats_grad_kernel<12>,
    lut_bn_stats_grad_kernel<13>, lut_bn_stats_grad_kernel<14>, lut_bn_stats_grad_kernel<15>,
    lut_bn_stats_grad_kernel<16>};

const void* bn_kernel_for(int hidden) {
  return hidden <= MAX_H ? reinterpret_cast<const void*>(bn_kernels[hidden - 1])
                         : reinterpret_cast<const void*>(lut_bn_stats_grad_generic);
}

// The checks both entry points make of a launch's arguments.
bool valid_launch(int batch, int c_in, int hidden, int n_split, int split_rows) {
  return !(hidden < 1 || n_split < 1 || split_rows < 0 || split_rows > MAX_SPLIT_ROWS ||
           static_cast<long long>(n_split) * split_rows < batch ||
           (n_split > 1 && static_cast<long long>(n_split - 1) * split_rows >= batch) ||
           static_cast<long long>(n_split) * c_in > 0x7fffffffLL);
}

}  // namespace

extern "C" int lut_dense_backward_max_split_rows() { return MAX_SPLIT_ROWS; }

// Resident blocks an SM holds of the instantiation for `hidden` on the
// current device (the occupancy query); 0 for an invalid hidden.
extern "C" int lut_dense_backward_blocks_per_sm(int hidden) {
  if (hidden < 1) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(hidden), THREADS, 0) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

// Inputs as lut_dense_forward plus g (batch, c_out); outputs dx (batch,
// c_in), dw0/db0/dwo (c_in, hidden, c_out), dbo/dfi/dfo/dio (c_in, c_out).
// partial: n_split * c_in * (3*hidden + 4) * c_out floats of scratch;
// tickets: c_in zeros, left zero.  Split s covers the batch rows
// [s * split_rows, min((s + 1) * split_rows, batch)), none of them empty.
extern "C" int lut_dense_backward(
    const void* x, const void* w0, const void* b0, const void* wo,
    const void* bo, const void* fi, const void* ii, const void* fo,
    const void* io, const void* g, void* dx, void* dw0, void* db0, void* dwo,
    void* dbo, void* dfi, void* dfo, void* dio, void* partial, void* tickets,
    int batch, int c_in, int hidden, int c_out, int n_split, int split_rows,
    void* stream) {
  if (!valid_launch(batch, c_in, hidden, n_split, split_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c_in == 0 || c_out == 0) return 0;
  // the generic kernel takes `hidden` as one more argument
  void* args[] = {&x,  &w0,  &b0,  &wo,      &bo,      &fi,    &ii,   &fo,    &io,
                  &g,  &dx,  &dw0, &db0,     &dwo,     &dbo,   &dfi,  &dfo,   &dio,
                  &partial, &tickets, &batch, &c_in, &c_out, &n_split, &split_rows, &hidden};
  return static_cast<int>(cudaLaunchKernel(kernel_for(hidden), dim3(n_split * c_in),
                                           dim3(THREADS), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// Resident blocks an SM holds of the statistics backward for `hidden`.
extern "C" int lut_bn_stats_backward_blocks_per_sm(int hidden) {
  if (hidden < 1) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_kernel_for(hidden), THREADS,
                                                    0) != cudaSuccess)
    return 0;
  return per_sm;
}

// The backward of lut_bn_stats: inputs as lut_bn_stats plus its mean and
// the cotangents g_mean, g_var (c_in, c_out); outputs dx (batch, c_in),
// dw0/db0/dwo (c_in, hidden, c_out), dbo/dfi (c_in, c_out).  partial:
// n_split * c_in * (3*hidden + 2) * c_out floats; tickets and splits as
// lut_dense_backward.
extern "C" int lut_bn_stats_backward(
    const void* x, const void* w0, const void* b0, const void* wo, const void* bo,
    const void* fi, const void* ii, const void* mean, const void* g_mean,
    const void* g_var, void* dx, void* dw0, void* db0, void* dwo, void* dbo, void* dfi,
    void* partial, void* tickets, int batch, int c_in, int hidden, int c_out, int n_split,
    int split_rows, void* stream) {
  if (!valid_launch(batch, c_in, hidden, n_split, split_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c_in == 0 || c_out == 0) return 0;
  void* none = nullptr;                      // dfo, dio
  void* args[] = {&x,   &w0,  &b0,      &wo,      &bo,    &fi,   &ii,    &mean,
                  &g_mean, &g_var, &dx, &dw0, &db0, &dwo, &dbo, &dfi, &none, &none,
                  &partial, &tickets, &batch, &c_in, &c_out, &n_split, &split_rows, &hidden};
  return static_cast<int>(cudaLaunchKernel(bn_kernel_for(hidden), dim3(n_split * c_in),
                                           dim3(THREADS), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" const char* lut_dense_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
