// One LUT-Dense cell's quantizer constants, one definition for kernels B2
// (the forward, csrc/lut_dense.cu) and B3 (its recompute backward,
// csrc/lut_dense_bwd.cu), so that B3's forward recompute forms every
// quantizer constant exactly as B2 does.
//
// A cell (j, o) WRAPs its input on the (f_in, i_in) grid and SATs its
// output on the (f_out, i_out) grid, both signed.  make_cell forms, once per
// cell and block, what each element would otherwise re-form from the widths:
// fq.cuh's fast-path Width of the input WRAP, and the output grid 2^f_out,
// 2^-f_out, 2^i_out, the SAT bound hi = 2^i_out - 2^-f_out and whether the
// cell is alive (f_out + i_out + 1 > 0).  round_out rounds y on the output
// grid: y * 2^f_out where |f_out| <= 126 and f_out is an integer (the same
// bits as fq::quantize's y / 2^-f_out, fq.cuh's note), an IEEE division out
// of line elsewhere.
#pragma once

#include <math.h>

#include "fq.cuh"

namespace lut {

struct Cell {
  fq::Width in;                  // the input WRAP's fast path (fq.cuh)
  float f_in, i_in, bias;
  float mul_o, scale_o, p2, hi;  // the output SAT: 2^f, 2^-f, 2^i, 2^i - 2^-f
  bool fast_o, alive_o;
};

__device__ __forceinline__ Cell make_cell(float f_in, float i_in, float f_out,
                                          float i_out, float bias) {
  Cell c;
  c.in = fq::make_width<true, true>(f_in, i_in);
  c.f_in = f_in;
  c.i_in = i_in;
  c.bias = bias;
  c.fast_o = fabsf(f_out) <= 126.0f && f_out == truncf(f_out);
  c.mul_o = fq::pow2(c.fast_o ? static_cast<int>(f_out) : 0);
  c.scale_o = ldexpf(1.0f, -static_cast<int>(f_out));
  c.p2 = ldexpf(1.0f, static_cast<int>(i_out));
  c.hi = __fsub_rn(c.p2, c.scale_o);
  c.alive_o = __fadd_rn(__fadd_rn(f_out, i_out), 1.0f) > 0.0f;
  return c;
}

__device__ __noinline__ float round_slow(float y, float scale) {
  return __fmul_rn(rintf(__fdiv_rn(y, scale)), scale);
}

// y rounded half to even on the cell's output grid (not yet clipped)
__device__ __forceinline__ float round_out(float y, const Cell& c) {
  return c.fast_o ? __fmul_rn(rintf(__fmul_rn(y, c.mul_o)), c.scale_o)
                  : round_slow(y, c.scale_o);
}

// SAT(y) on the cell's output grid, as fq::quantize(y, f_out, i_out, true,
// false): NaN propagates, a dead cell gives 0
__device__ __forceinline__ float sat_out(float y, const Cell& c) {
  const float r = round_out(y, c);
  const float q = isnan(r) ? r : fminf(fmaxf(r, -c.p2), c.hi);
  return c.alive_o ? q : 0.0f;
}

}  // namespace lut
