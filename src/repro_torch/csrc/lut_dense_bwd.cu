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
// Design.  The TPU kernel accumulates the weight gradients across a
// sequential batch grid axis in VMEM.  CUDA blocks run in no order, so the
// reduction over the batch is split in two deterministic passes and uses no
// float atomics (two launches on the same inputs give the same bits):
//  1. grid (batch tiles of TILE_ROWS rows, C_in); a block owns one j and
//     loops over o.  Each of its 256 threads takes ROWS rows, keeps h and
//     the 3H+4 per-cell gradient sums in registers, and the block sums them
//     with a warp butterfly and then warp by warp in index order into one
//     partial per (tile, j, o).  A thread holds all of C_out for its rows,
//     so dx[b, j] is finished in registers, summed over o in index order.
//     The ragged batch edge is masked here, not padded in memory.
//  2. one thread per gradient element sums the partials over the tiles in
//     tile order and writes dw0, db0, dw_out, db_out, df_in, df_out, di_out.
// H is a template parameter (1..16) so the per-h arrays stay in registers.
//
// Bound: operations.  At 20 -> 5, H = 8, B = 16600 the call reads x, g and a
// few KB of weights and writes dx (about 2.3 MB in all), but evaluates 13 M
// tanh and ~40 FP32 operations per (b, j, o, h).  Exactness against the
// plain version (kernels/ref.py::lut_dense_bwd_ref): the forward recompute
// and every per-element term run the same float32 operations in the same
// order (fq.cuh, __fmul_rn / __fadd_rn, no FMA contraction); only the sums
// over the batch run in another order.
#include <cuda_runtime.h>
#include <math.h>

#include "fq.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;                       // rows per thread in pass 1
constexpr int TILE_ROWS = THREADS * ROWS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_H = 16;
constexpr float LN2 = 0.693147180559945309f;  // float32(log 2), as the plain version

template <int H>
__global__ void __launch_bounds__(THREADS) lut_dense_bwd_tile_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ partial, int batch, int c_in,
    int c_out) {
  constexpr int NQ = 3 * H + 4;              // dw0[H] db0[H] dwo[H] dbo dfi dfo dio
  __shared__ float red[WARPS * NQ];
  const int tile = blockIdx.x;
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float xr[ROWS], dxacc[ROWS];
  bool valid[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = tile * TILE_ROWS + r * THREADS + threadIdx.x;
    valid[r] = b < batch;
    xr[r] = valid[r] ? x[static_cast<long long>(b) * c_in + j] : 0.0f;
    dxacc[r] = 0.0f;
  }

  for (int o = 0; o < c_out; ++o) {
    const int cell = j * c_out + o;
    const float f_in = fi[cell], i_in = ii[cell];
    const float f_out = fo[cell], i_out = io[cell];
    const float bias = bo[cell];
    float w0h[H], b0h[H], woh[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int w = (j * H + h) * c_out + o;
      w0h[h] = w0[w];
      b0h[h] = b0[w];
      woh[h] = wo[w];
    }
    const float scale_i = ldexpf(1.0f, -static_cast<int>(f_in));
    const bool alive_i = __fadd_rn(__fadd_rn(f_in, i_in), 1.0f) > 0.0f;
    const float scale_o = ldexpf(1.0f, -static_cast<int>(f_out));
    const float p2 = ldexpf(1.0f, static_cast<int>(i_out));
    const float hi = __fsub_rn(p2, scale_o);
    const bool alive_o = __fadd_rn(__fadd_rn(f_out, i_out), 1.0f) > 0.0f;

    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!valid[r]) continue;
      const int b = tile * TILE_ROWS + r * THREADS + threadIdx.x;
      const float xv = xr[r];
      const float r_in = __fmul_rn(rintf(__fdiv_rn(xv, scale_i)), scale_i);
      const float xq = fq::wrap(xv, f_in, i_in);
      float hv[H];
      float y = 0.0f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        hv[h] = tanhf(__fadd_rn(__fmul_rn(xq, w0h[h]), b0h[h]));
        y = __fadd_rn(y, __fmul_rn(hv[h], woh[h]));
      }
      y = __fadd_rn(y, bias);
      const float r_out = __fmul_rn(rintf(__fdiv_rn(y, scale_o)), scale_o);
      const bool chi = r_out > hi;
      const bool clo = r_out < -p2;
      const float gv = g[static_cast<long long>(b) * c_out + o];
      const float gy = (alive_o && !chi && !clo) ? gv : 0.0f;
      const float dfo_s = chi ? __fmul_rn(LN2, scale_o)
                              : (clo ? 0.0f : __fmul_rn(LN2, __fsub_rn(y, r_out)));
      const float dio_s = chi ? __fmul_rn(LN2, p2) : (clo ? __fmul_rn(-LN2, p2) : 0.0f);
      acc[3 * H + 2] = __fadd_rn(acc[3 * H + 2], alive_o ? __fmul_rn(dfo_s, gv) : 0.0f);
      acc[3 * H + 3] = __fadd_rn(acc[3 * H + 3], alive_o ? __fmul_rn(dio_s, gv) : 0.0f);
      acc[3 * H] = __fadd_rn(acc[3 * H], gy);
      float gxq = 0.0f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        acc[2 * H + h] = __fadd_rn(acc[2 * H + h], __fmul_rn(hv[h], gy));
        const float gz = __fmul_rn(__fmul_rn(gy, woh[h]),
                                   __fsub_rn(1.0f, __fmul_rn(hv[h], hv[h])));
        acc[H + h] = __fadd_rn(acc[H + h], gz);
        acc[h] = __fadd_rn(acc[h], __fmul_rn(gz, xq));
        gxq = __fadd_rn(gxq, __fmul_rn(gz, w0h[h]));
      }
      const float dfi_s = __fmul_rn(__fmul_rn(LN2, __fsub_rn(xv, r_in)), gxq);
      acc[3 * H + 1] = __fadd_rn(acc[3 * H + 1], alive_i ? dfi_s : 0.0f);
      dxacc[r] = __fadd_rn(dxacc[r], alive_i ? gxq : 0.0f);
    }

    // block sum: warp butterfly, then the warps in index order
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float v = acc[q];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
      if (lane == 0) red[warp * NQ + q] = v;
    }
    __syncthreads();
    if (threadIdx.x < NQ) {
      float v = red[threadIdx.x];
      for (int w = 1; w < WARPS; ++w) v = __fadd_rn(v, red[w * NQ + threadIdx.x]);
      partial[((static_cast<long long>(tile) * c_in + j) * NQ + threadIdx.x) * c_out + o] = v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = tile * TILE_ROWS + r * THREADS + threadIdx.x;
    if (valid[r]) dx[static_cast<long long>(b) * c_in + j] = dxacc[r];
  }
}

__global__ void lut_dense_bwd_reduce_kernel(
    const float* __restrict__ partial, int n_tiles, int c_in, int hidden,
    int c_out, float* __restrict__ dw0, float* __restrict__ db0,
    float* __restrict__ dwo, float* __restrict__ dbo, float* __restrict__ dfi,
    float* __restrict__ dfo, float* __restrict__ dio) {
  const int nq = 3 * hidden + 4;
  const long long per_tile = static_cast<long long>(c_in) * nq * c_out;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= per_tile) return;
  float v = 0.0f;
  for (int t = 0; t < n_tiles; ++t) v = __fadd_rn(v, partial[t * per_tile + e]);
  const int j = static_cast<int>(e / (static_cast<long long>(nq) * c_out));
  const int rem = static_cast<int>(e - static_cast<long long>(j) * nq * c_out);
  const int q = rem / c_out;
  const int o = rem - q * c_out;
  const int cell = j * c_out + o;
  if (q < hidden) dw0[(j * hidden + q) * c_out + o] = v;
  else if (q < 2 * hidden) db0[(j * hidden + q - hidden) * c_out + o] = v;
  else if (q < 3 * hidden) dwo[(j * hidden + q - 2 * hidden) * c_out + o] = v;
  else if (q == 3 * hidden) dbo[cell] = v;
  else if (q == 3 * hidden + 1) dfi[cell] = v;
  else if (q == 3 * hidden + 2) dfo[cell] = v;
  else dio[cell] = v;
}

template <int H>
void launch_tiles(dim3 grid, cudaStream_t s, const float* x, const float* w0,
                  const float* b0, const float* wo, const float* bo,
                  const float* fi, const float* ii, const float* fo,
                  const float* io, const float* g, float* dx, float* partial,
                  int batch, int c_in, int c_out) {
  lut_dense_bwd_tile_kernel<H><<<grid, THREADS, 0, s>>>(
      x, w0, b0, wo, bo, fi, ii, fo, io, g, dx, partial, batch, c_in, c_out);
}

}  // namespace

extern "C" int lut_dense_backward_tile_rows() { return TILE_ROWS; }

extern "C" int lut_dense_backward_max_hidden() { return MAX_H; }

// Inputs as lut_dense_forward plus g (batch, c_out); outputs dx (batch,
// c_in), dw0/db0/dwo (c_in, hidden, c_out), dbo/dfi/dfo/dio (c_in, c_out);
// partial: ceil(batch / TILE_ROWS) * c_in * (3*hidden + 4) * c_out floats.
extern "C" int lut_dense_backward(
    const void* x, const void* w0, const void* b0, const void* wo,
    const void* bo, const void* fi, const void* ii, const void* fo,
    const void* io, const void* g, void* dx, void* dw0, void* db0, void* dwo,
    void* dbo, void* dfi, void* dfo, void* dio, void* partial, int batch,
    int c_in, int hidden, int c_out, void* stream) {
  if (hidden < 1 || hidden > MAX_H) return static_cast<int>(cudaErrorInvalidValue);
  if (c_in == 0 || c_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (batch + TILE_ROWS - 1) / TILE_ROWS;
  const float* args[10] = {static_cast<const float*>(x), static_cast<const float*>(w0),
                           static_cast<const float*>(b0), static_cast<const float*>(wo),
                           static_cast<const float*>(bo), static_cast<const float*>(fi),
                           static_cast<const float*>(ii), static_cast<const float*>(fo),
                           static_cast<const float*>(io), static_cast<const float*>(g)};
  float* px = static_cast<float*>(dx);
  float* pp = static_cast<float*>(partial);
  if (n_tiles > 0) {
    const dim3 grid(n_tiles, c_in);
#define B3_CASE(HH)                                                            \
  case HH:                                                                     \
    launch_tiles<HH>(grid, s, args[0], args[1], args[2], args[3], args[4],     \
                     args[5], args[6], args[7], args[8], args[9], px, pp,      \
                     batch, c_in, c_out);                                      \
    break;
    switch (hidden) {
      B3_CASE(1) B3_CASE(2) B3_CASE(3) B3_CASE(4) B3_CASE(5) B3_CASE(6)
      B3_CASE(7) B3_CASE(8) B3_CASE(9) B3_CASE(10) B3_CASE(11) B3_CASE(12)
      B3_CASE(13) B3_CASE(14) B3_CASE(15) B3_CASE(16)
    }
#undef B3_CASE
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_tile = static_cast<long long>(c_in) * (3 * hidden + 4) * c_out;
  const int threads = 256;
  lut_dense_bwd_reduce_kernel<<<static_cast<unsigned>((per_tile + threads - 1) / threads),
                                threads, 0, s>>>(
      pp, n_tiles, c_in, hidden, c_out, static_cast<float*>(dw0),
      static_cast<float*>(db0), static_cast<float*>(dwo), static_cast<float*>(dbo),
      static_cast<float*>(dfi), static_cast<float*>(dfo), static_cast<float*>(dio));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lut_dense_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
