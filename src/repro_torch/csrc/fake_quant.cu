// Kernel B1: element-wise HGQ fake-quant with integer (f, i) bit-widths.
//
// Replaces the TPU kernel repro/kernels/fake_quant.py::fake_quant_fused
// (body _fq_kernel, src/repro/kernels/fake_quant.py:23; pallas_call at :82
// per-channel and :120 flat).
//
//   out[k] = quantize(x[k], f[k % P], i[k % P])      (fq.cuh)
//
// The widths come in two forms, both without being broadcast to x's size:
// one scalar pair (per-tensor, P = 1), or a small array that repeats along
// x with period P = numel(widths) -- a per-channel vector of x's last axis
// or widths of shape x.shape[-r:] (the LUT-Dense layer's per-cell widths
// over a (B, C_in, C_out) batch).  The TPU kernel streams per-element widths
// at x's full size; here they are a few KB that stay in L1/L2.
//
// Bound: bytes.  The call reads x once and writes out once, 8 bytes an
// element, against ~15 FP32 operations an element, so HBM at 3.35 TB/s
// bounds it.  The design is one grid-stride pass with 16-byte (float4)
// loads and stores where x and out are 16-byte aligned, a scalar tail, and
// no shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

namespace {

template <bool SIGNED, bool WRAP, bool SCALAR>
__device__ __forceinline__ float quant_at(float x, const float* __restrict__ f,
                                          const float* __restrict__ i,
                                          long long k, long long period) {
  const long long w = SCALAR ? 0 : k % period;
  return fq::quantize(x, f[w], i[w], SIGNED, WRAP);
}

template <bool SIGNED, bool WRAP, bool SCALAR>
__global__ void fake_quant_kernel(const float* __restrict__ x,
                                  const float* __restrict__ f,
                                  const float* __restrict__ i,
                                  float* __restrict__ out, long long n,
                                  long long n_vec, long long period) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
  for (long long v = t0; v < n_vec; v += stride) {
    const float4 a = x4[v];
    const long long k = 4 * v;
    float4 q;
    q.x = quant_at<SIGNED, WRAP, SCALAR>(a.x, f, i, k, period);
    q.y = quant_at<SIGNED, WRAP, SCALAR>(a.y, f, i, k + 1, period);
    q.z = quant_at<SIGNED, WRAP, SCALAR>(a.z, f, i, k + 2, period);
    q.w = quant_at<SIGNED, WRAP, SCALAR>(a.w, f, i, k + 3, period);
    o4[v] = q;
  }
  for (long long k = 4 * n_vec + t0; k < n; k += stride)
    out[k] = quant_at<SIGNED, WRAP, SCALAR>(x[k], f, i, k, period);
}

template <bool SIGNED, bool WRAP>
void launch(const float* x, const float* f, const float* i, float* out,
            long long n, long long n_vec, long long period, unsigned blocks,
            cudaStream_t stream) {
  if (period == 1)
    fake_quant_kernel<SIGNED, WRAP, true><<<blocks, 256, 0, stream>>>(
        x, f, i, out, n, n_vec, period);
  else
    fake_quant_kernel<SIGNED, WRAP, false><<<blocks, 256, 0, stream>>>(
        x, f, i, out, n, n_vec, period);
}

}  // namespace

// x, out: n contiguous float32; f, i: `period` float32 each (period >= 1).
extern "C" int fake_quant_forward(const void* x, const void* f, const void* i,
                                  void* out, long long n, long long period,
                                  int is_signed, int wrap, void* stream) {
  if (n == 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long n_vec = aligned ? n / 4 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond 16 per SM
  const float* xp = static_cast<const float*>(x);
  const float* fp = static_cast<const float*>(f);
  const float* ip = static_cast<const float*>(i);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  if (is_signed && wrap) launch<true, true>(xp, fp, ip, op, n, n_vec, period, b, s);
  else if (is_signed) launch<true, false>(xp, fp, ip, op, n, n_vec, period, b, s);
  else if (wrap) launch<false, true>(xp, fp, ip, op, n, n_vec, period, b, s);
  else launch<false, false>(xp, fp, ip, op, n, n_vec, period, b, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fake_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
