// The quadrature demodulator's sample: gain * atan2 of x[k] * conj(x[k-1])
// with the reference's LUT arctangent, shared by the front end (front.cu,
// B1) and the fused step (step.cu, B7), so both give the same bits.
//
// Every product and sum is taken with a round-to-nearest intrinsic in the
// order of the plain version (ops/front.py:quad_demod_plain,
// dsp/elementwise.py:fast_atan2), so nvcc contracts nothing into an FMA
// whatever the including file's -fmad setting.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kAtanTableSize = 257;

// The reference LUT arctangent (src/math/fast_atan2f.c:87-150), with the
// operations, their order and their NaN behaviour of the plain version.
__device__ __forceinline__ float fast_atan2(float y, float x, const float* table) {
  const float y_abs = fabsf(y), x_abs = fabsf(x);
  if (!(y_abs > 0.f || x_abs > 0.f)) return 0.f;
  if (isnan(y_abs) || isnan(x_abs)) return NAN;  // torch.maximum propagates NaN
  const float denom = fmaxf(fmaxf(y_abs, x_abs), 1e-45f);
  const float z = __fdiv_rn(fminf(y_abs, x_abs), denom);
  const float alpha = __fmul_rn(z, 255.f);
  const int index = min(max((int)alpha, 0), 255);
  const float frac = __fsub_rn(alpha, (float)index);
  const float t0 = table[index];
  const float t1 = table[index + 1];
  const float interp = __fadd_rn(t0, __fmul_rn(__fsub_rn(t1, t0), frac));
  const float base = z < 0.003921569f ? z : interp;
  const float kPi = 3.14159265358979f;
  const float kHalfPi = 1.57079632679490f;
  if (x_abs > y_abs) {
    if (x >= 0.f) return y >= 0.f ? base : -base;
    return y >= 0.f ? __fsub_rn(kPi, base) : __fsub_rn(base, kPi);
  }
  if (y >= 0.f) return x >= 0.f ? __fsub_rn(kHalfPi, base) : __fadd_rn(kHalfPi, base);
  return x >= 0.f ? __fsub_rn(base, kHalfPi) : __fsub_rn(-kHalfPi, base);
}

// (re, im) of (i + jq) * conj(si + jsq): the current row (i, q) against the
// previous one (si, sq).
__device__ __forceinline__ void conj_product(float i, float q, float si, float sq, float& re,
                                             float& im) {
  re = __fadd_rn(__fmul_rn(i, si), __fmul_rn(q, sq));
  im = __fsub_rn(__fmul_rn(q, si), __fmul_rn(i, sq));
}

// gain * atan2(im, re) of the conjugate product, with the table.
__device__ __forceinline__ float quad_demod_sample(float i, float q, float si, float sq,
                                                   const float* table, float gain) {
  float re, im;
  conj_product(i, q, si, sq, re, im);
  return __fmul_rn(gain, fast_atan2(im, re, table));
}

// The same sample with atan2f in place of the table (the pipeline's "atan2"
// modes, on the banded front only), with the table's (0, 0) -> 0 rule, as
// dsp/elementwise.py:atan2_dispatch takes torch.atan2.
__device__ __forceinline__ float quad_demod_sample_atan2(float i, float q, float si, float sq,
                                                         float gain) {
  float re, im;
  conj_product(i, q, si, sq, re, im);
  const float angle = (fabsf(im) > 0.f || fabsf(re) > 0.f) ? atan2f(im, re) : 0.f;
  return __fmul_rn(gain, angle);
}

}  // namespace
