// The HGQ quantizer grid, one definition for kernels B1, B2 and B3.
//
// It computes what repro_torch/core/quant.py::_fq_eval computes, operation
// for operation, so a kernel and its plain PyTorch version agree bit for bit:
//  * rintf rounds half to even, as torch.round / jnp.round;
//  * powers of two come from ldexpf, exact for integer exponents (exp2f is
//    not guaranteed exact there); the widths are integer-valued floats;
//  * x / scale is an IEEE division (no --use_fast_math);
//  * WRAP is a floor-mod (torch.remainder / jnp.mod): fmodf, then shift a
//    remainder whose sign differs from the divisor's by one span;
//  * SAT is max then min, as torch.minimum(torch.maximum(q, lo), hi) runs on
//    the card: NaN propagates, and fmaxf / fminf order two zeros (max gives
//    +0, min gives -0), where the CPU's std::max / std::min keep the first
//    operand; the values are the same either way, the sign of a zero is not;
//  * __fadd_rn / __fsub_rn / __fmul_rn keep nvcc from contracting into FMAs
//    that the plain version does not do.
#pragma once

#include <math.h>

namespace fq {

// Fake-quantize x on the (f, i) grid; 0 where f + i + signed <= 0.
__device__ __forceinline__ float quantize(float x, float f, float i,
                                          bool is_signed, bool wrap) {
  const float scale = ldexpf(1.0f, -static_cast<int>(f));
  const float top = ldexpf(1.0f, static_cast<int>(i));
  const float hi = __fsub_rn(top, scale);
  const float lo = is_signed ? -top : 0.0f;
  float q = __fmul_rn(rintf(__fdiv_rn(x, scale)), scale);
  if (wrap) {
    const float span = __fadd_rn(__fsub_rn(hi, lo), scale);
    float r = fmodf(__fsub_rn(q, lo), span);
    if (r != 0.0f && ((r < 0.0f) != (span < 0.0f))) r = __fadd_rn(r, span);
    q = __fadd_rn(lo, r);
  } else {
    q = isnan(q) ? q : fminf(fmaxf(q, lo), hi);
  }
  const float width = __fadd_rn(__fadd_rn(i, f), is_signed ? 1.0f : 0.0f);
  return width > 0.0f ? q : 0.0f;
}

// The paper's LUT-Dense quantizers: signed WRAP on inputs, signed SAT on
// outputs.
__device__ __forceinline__ float wrap(float x, float f, float i) {
  return quantize(x, f, i, true, true);
}

__device__ __forceinline__ float sat(float x, float f, float i) {
  return quantize(x, f, i, true, false);
}

}  // namespace fq
