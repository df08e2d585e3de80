// One Mueller & Mueller symbol step, shared by the clock kernels of
// clock.cu (B2's chunked walk and B4's ragged walk), so every clock of the
// port advances a lane with the same device code in the same order.
//
// The step is the reference's (src/dsp/clock_recovery_mm.c:78-139) as
// sdrmodem_tpu/dsp/clock_recovery.py:282-314 writes it: the 8-tap MMSE
// interpolator from the 129x8 bank in shared memory, indexed by
// rint(mu * 128) and summed in tap order; the branchless omega clip; the
// floor(mu) stride; and the NaN branch (emit 0, stride floor(omega), keep
// mu / omega / last).  The including file is compiled with -fmad=false, so
// no f32 multiply and add are contracted into an FMA, which would change
// the chaotic M&M trajectory.

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
  int imu = (int)rintf(s.mu * (float)kMmSteps);
  imu = min(max(imu, 0), kMmSteps);
  const float* taps = s_bank + imu * kMmTaps;
  const long long base = s.ii < 0 ? 0 : s.ii;
  float y = 0.f;
  for (int j = 0; j < kMmTaps; ++j) {
    const float v = sample(base + j);
    y = j == 0 ? v * taps[0] : y + v * taps[j];
  }

  const bool is_nan = isnan(y);
  const float out = is_nan ? 0.f : y;
  const float sgn_last = s.last < 0.f ? -1.f : 1.f;
  const float sgn_out = out < 0.f ? -1.f : 1.f;
  const float mm = sgn_last * out - sgn_out * s.last;
  float omega_n = s.omega + p.gain_omega * mm;
  const float dev = omega_n - p.omega_mid;
  omega_n = p.omega_mid + 0.5f * (fabsf(dev + p.omega_lim) - fabsf(dev - p.omega_lim));
  float mu_n = s.mu + omega_n + p.gain_mu * mm;
  const float stride = floorf(mu_n);
  mu_n = mu_n - stride;

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
