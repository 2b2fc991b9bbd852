// Kernel B2: the eval-mode LUT-Dense forward (paper Eq. 1, one hidden tanh
// layer) on Hopper.
//
// Replaces the TPU kernel repro/kernels/lut_dense.py::lut_dense_fused (body
// _lut_dense_kernel, src/repro/kernels/lut_dense.py:60).
//
//   out[b, o] = sum_j SAT( sum_h w_out[j,h,o] * tanh(WRAP(x[b,j]) * w0[j,h,o]
//                                                  + b0[j,h,o]) + b_out[j,o] )
//
// Design: one thread per (b, o) output.  It loops over j and h, so the
// (B, C_in, H, C_out) hidden tensor exists only in registers.  Weights are
// (C_in, H, C_out): neighbouring threads of a warp take neighbouring o and
// read neighbouring weight addresses, and the few KB of weights stay in L1/L2
// across the batch.
//
// Bound: at the JSC shapes (B = 16600, 16 -> 20, H = 8) the call moves about
// 2.4 MB (x, weights, out) but evaluates 42.5 M tanh, each a sequence of
// FP32 instructions, so it is bound by operations, not bytes.  Nothing here
// trades exactness for speed: the point of this kernel is to agree with the
// plain PyTorch version (kernels/ref.py::lut_dense_ref) code for code.
//
// Exactness rules:
//  * rintf (round half to even, as jnp.round / torch.round), not roundf;
//  * WRAP is a floor-mod (jnp.mod / torch.remainder): fmodf, then shift a
//    remainder whose sign differs from the divisor's by one span;
//  * powers of two come from ldexpf, exact for integer exponents;
//  * x / scale is an IEEE division (no --use_fast_math, whose approximate
//    tanhf would also move table-boundary codes);
//  * products and sums use __fmul_rn / __fadd_rn so nvcc cannot contract
//    them into FMAs the plain version does not do, and the sums run in the
//    plain version's order: sum over h, then + b_out, then SAT, then += over j.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float fq_wrap(float x, float f, float i) {
  const float scale = ldexpf(1.0f, -static_cast<int>(f));
  const float lo = -ldexpf(1.0f, static_cast<int>(i));
  const float span = ldexpf(1.0f, static_cast<int>(i) + 1);
  float q = __fmul_rn(rintf(__fdiv_rn(x, scale)), scale);
  float r = fmodf(__fsub_rn(q, lo), span);
  if (r != 0.0f && ((r < 0.0f) != (span < 0.0f))) r = __fadd_rn(r, span);
  q = __fadd_rn(lo, r);
  return (f + i + 1.0f > 0.0f) ? q : 0.0f;
}

__device__ __forceinline__ float fq_sat(float x, float f, float i) {
  const float scale = ldexpf(1.0f, -static_cast<int>(f));
  const float hi = __fsub_rn(ldexpf(1.0f, static_cast<int>(i)), scale);
  const float lo = -ldexpf(1.0f, static_cast<int>(i));
  float q = __fmul_rn(rintf(__fdiv_rn(x, scale)), scale);
  q = q < lo ? lo : q;          // max then min, as jnp.clip
  q = q > hi ? hi : q;
  return (f + i + 1.0f > 0.0f) ? q : 0.0f;
}

__global__ void lut_dense_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ fi,
    const float* __restrict__ ii, const float* __restrict__ fo,
    const float* __restrict__ io, float* __restrict__ out,
    int batch, int c_in, int hidden, int c_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(batch) * c_out) return;
  const int b = static_cast<int>(t / c_out);
  const int o = static_cast<int>(t - static_cast<long long>(b) * c_out);
  float acc = 0.0f;
  for (int j = 0; j < c_in; ++j) {
    const int cell = j * c_out + o;
    const float xq = fq_wrap(x[static_cast<long long>(b) * c_in + j], fi[cell], ii[cell]);
    float y = 0.0f;
    for (int h = 0; h < hidden; ++h) {
      const int w = (j * hidden + h) * c_out + o;
      const float a = tanhf(__fadd_rn(__fmul_rn(xq, w0[w]), b0[w]));
      y = __fadd_rn(y, __fmul_rn(a, wo[w]));
    }
    y = __fadd_rn(y, bo[cell]);
    acc = __fadd_rn(acc, fq_sat(y, fo[cell], io[cell]));
  }
  out[t] = acc;
}

}  // namespace

extern "C" int lut_dense_forward(const void* x, const void* w0, const void* b0,
                                 const void* wo, const void* bo, const void* fi,
                                 const void* ii, const void* fo, const void* io,
                                 void* out, int batch, int c_in, int hidden,
                                 int c_out, void* stream) {
  const long long n = static_cast<long long>(batch) * c_out;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  lut_dense_forward_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(fi),
      static_cast<const float*>(ii), static_cast<const float*>(fo),
      static_cast<const float*>(io), static_cast<float*>(out), batch, c_in,
      hidden, c_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lut_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
