// The HGQ quantizer grid, one definition for kernels B1, B2 and B3.
//
// fq::quantize computes what repro_torch/core/quant.py::_fq_eval computes,
// operation for operation, so a kernel and its plain PyTorch version agree
// bit for bit:
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
//
// The fast path (Width, make_width, quant_fast, wrap_code; B1 and B3) gives
// the same bits as fq::quantize with two shortcuts, each taken only where it
// provably gives the same bits; fq::quantize, out of line (quantize_slow),
// takes everything else:
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

// WRAP of the code c = rint(x * 2^f) of a fast Width: false past the guard,
// where the element needs quantize_slow instead.
__device__ __forceinline__ bool wrap_code(float c, const Width& w, float& q) {
  if (!(fabsf(c) <= w.climit)) return false;
  const unsigned r = static_cast<unsigned>(__float2int_rn(c) - w.lo_c) & w.mask;
  q = __fmul_rn(static_cast<float>(w.lo_c + static_cast<int>(r)), w.scale);
  return true;
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
  return wrap_code(c, w, q);
}

}  // namespace fq
