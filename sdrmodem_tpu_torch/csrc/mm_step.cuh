// One Mueller & Mueller symbol step, shared by the clock kernels of
// clock.cu (B2's chunked walk and B4's ragged walk) and the fused step
// (step.cu, B7), so every clock of the port advances a lane with the same
// device code in the same order.
//
// The step is the reference's (src/dsp/clock_recovery_mm.c:78-139) as
// sdrmodem_tpu/dsp/clock_recovery.py:282-314 writes it: the 8-tap MMSE
// interpolator from the 129x8 bank in shared memory, indexed by
// rint(mu * 128) and summed in tap order; the branchless omega clip; the
// floor(mu) stride; and the NaN branch (emit 0, stride floor(omega), keep
// mu / omega / last).  Every f32 product and sum is taken with a
// round-to-nearest intrinsic in the order of the plain version
// (ops/clock.py:_mm_step_plain), so no multiply and add is contracted
// into an FMA, which would change the chaotic M&M trajectory, whatever
// the including file's -fmad setting: clock.cu builds with -fmad=false,
// step.cu with the front end's default flags.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMmTaps = 8;
constexpr int kMmSteps = 128;
constexpr int kMmBankSize = (kMmSteps + 1) * kMmTaps;

struct MmParams {
  float omega_mid;
  float omega_lim;
  float gain_omega;
  float gain_mu;
};

// A lane's carried state: omega, mu, the last symbol and the read position.
struct MmLane {
  float omega;
  float mu;
  float last;
  long long ii;
};

// The symbol at the lane's read position, from samples sample(max(ii, 0)
// + j), j < 8, and the lane advanced past it.  Returns 0 on a NaN window.
template <typename Sample>
__device__ __forceinline__ float mm_step(const float* s_bank, const MmParams& p, MmLane& s,
                                         const Sample& sample) {
  int imu = (int)rintf(__fmul_rn(s.mu, (float)kMmSteps));
  imu = min(max(imu, 0), kMmSteps);
  const float* taps = s_bank + imu * kMmTaps;
  const long long base = s.ii < 0 ? 0 : s.ii;
  float y = __fmul_rn(sample(base), taps[0]);
  for (int j = 1; j < kMmTaps; ++j) y = __fadd_rn(y, __fmul_rn(sample(base + j), taps[j]));

  const bool is_nan = isnan(y);
  const float out = is_nan ? 0.f : y;
  const float sgn_last = s.last < 0.f ? -1.f : 1.f;
  const float sgn_out = out < 0.f ? -1.f : 1.f;
  const float mm = __fsub_rn(__fmul_rn(sgn_last, out), __fmul_rn(sgn_out, s.last));
  float omega_n = __fadd_rn(s.omega, __fmul_rn(p.gain_omega, mm));
  const float dev = __fsub_rn(omega_n, p.omega_mid);
  omega_n = __fadd_rn(p.omega_mid, __fmul_rn(0.5f, __fsub_rn(fabsf(__fadd_rn(dev, p.omega_lim)),
                                                             fabsf(__fsub_rn(dev, p.omega_lim)))));
  float mu_n = __fadd_rn(__fadd_rn(s.mu, omega_n), __fmul_rn(p.gain_mu, mm));
  const float stride = floorf(mu_n);
  mu_n = __fsub_rn(mu_n, stride);

  if (is_nan) {
    s.ii += (long long)floorf(s.omega);
  } else {
    s.omega = omega_n;
    s.mu = mu_n;
    s.last = out;
    s.ii += (long long)stride;
  }
  return out;
}

// The bank into shared memory, by every thread of the block.
__device__ __forceinline__ void mm_load_bank(float* s_bank, const float* __restrict__ bank) {
  for (int j = threadIdx.x; j < kMmBankSize; j += blockDim.x) s_bank[j] = bank[j];
  __syncthreads();
}

}  // namespace
