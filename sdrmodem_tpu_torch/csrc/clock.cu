// Mueller & Mueller clock recovery over one full block, every lane on its
// own, in the chunk partition of the JAX package.
//
// Replaces the TPU kernel sdrmodem_tpu/ops/pallas_clock.py:_mm_chunked_kernel
// (wrapper clock_mm_chunked_tpu).  The step is the reference's
// (src/dsp/clock_recovery_mm.c:78-139) as sdrmodem_tpu/dsp/clock_recovery.py
// :282-314 writes it: the 8-tap MMSE interpolator indexed by rint(mu * 128),
// the branchless omega clip, floor(mu) strides, and the NaN branch (emit 0,
// stride floor(omega), keep mu / omega / last).
//
// Bound on an H100: at 128 lanes x 2^19 decimated samples it reads y3 once
// (256 MiB) and writes the f32 symbol slots (~70 MB), ~0.1 ms of memory
// traffic; the arithmetic is a few tens of operations a symbol.  What bounds
// it is neither: each lane is one chain of ~105k dependent symbols (the
// next read position depends on this symbol's floor(mu)), so its time is the
// chain's length times one step's latency.
//
// Design: a plain first version.  One thread owns one lane for the whole
// block and walks it in order with omega, mu, last and the read position in
// registers; the 129x8 bank sits in shared memory.  The chunks of the JAX
// kernel are kept as output rows only: a chunk closes when the read
// position passes its end, which continues the stream exactly as the JAX
// suffix hand-off does (clock_recovery.py:540-547), so one pass gives the
// JAX symbols, counts and final resid.  Symbols are stored time-major,
// (n_chunks, K, C), so neighbouring lanes store to neighbouring words.  The
// file is compiled with -fmad=false so no f32 multiply and add are
// contracted into an FMA, which would change the chaotic M&M trajectory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTaps = 8;
constexpr int kSteps = 128;
constexpr int kBankSize = (kSteps + 1) * kTaps;
constexpr int kThreads = 32;

__global__ void mm_clock_kernel(const float* __restrict__ y3, int n, int lanes,
                                const float* __restrict__ suffix, int sfx,
                                const float* __restrict__ omega_in,
                                const float* __restrict__ mu_in,
                                const float* __restrict__ last_in,
                                const int* __restrict__ resid_in,
                                const float* __restrict__ bank, int chunk,
                                int n_chunks, int k_max, float omega_mid,
                                float omega_lim, float gain_omega, float gain_mu,
                                float* __restrict__ outs, int* __restrict__ counts,
                                float* __restrict__ omega_out, float* __restrict__ mu_out,
                                float* __restrict__ last_out, int* __restrict__ resid_out) {
  __shared__ float s_bank[kBankSize];
  for (int j = threadIdx.x; j < kBankSize; j += blockDim.x) s_bank[j] = bank[j];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float omega = omega_in[lane];
  float mu = mu_in[lane];
  float last = last_in[lane];
  // read position in the stream [suffix | y3]
  long long ii = (long long)sfx - resid_in[lane];
  const long long total = (long long)sfx + n;
  int t = 0;    // current chunk
  int cnt = 0;  // symbols emitted in it
  long long end = sfx + min((long long)chunk, (long long)n);  // its end in the stream

  for (;;) {
    // close every chunk the read position has passed (or whose K slots are
    // full: the JAX hand-off then clips the carried resid to sfx - 1)
    while (t < n_chunks && (ii > end - kTaps || cnt >= k_max)) {
      if (cnt >= k_max && ii < end - (sfx - 1)) ii = end - (sfx - 1);
      counts[(long long)t * lanes + lane] = cnt;
      for (int k = cnt; k < k_max; ++k) outs[((long long)t * k_max + k) * lanes + lane] = 0.f;
      ++t;
      cnt = 0;
      end = sfx + min((long long)(t + 1) * chunk, (long long)n);
    }
    if (t == n_chunks) break;

    int imu = (int)rintf(mu * (float)kSteps);
    imu = min(max(imu, 0), kSteps);
    const float* taps = s_bank + imu * kTaps;
    const long long base = ii < 0 ? 0 : ii;
    float y = 0.f;
    for (int j = 0; j < kTaps; ++j) {
      const long long row = base + j;
      const float v = row < sfx ? suffix[row * lanes + lane] : y3[(row - sfx) * lanes + lane];
      y = j == 0 ? v * taps[0] : y + v * taps[j];
    }

    const bool is_nan = isnan(y);
    const float out = is_nan ? 0.f : y;
    const float sgn_last = last < 0.f ? -1.f : 1.f;
    const float sgn_out = out < 0.f ? -1.f : 1.f;
    const float mm = sgn_last * out - sgn_out * last;
    float omega_n = omega + gain_omega * mm;
    const float dev = omega_n - omega_mid;
    omega_n = omega_mid + 0.5f * (fabsf(dev + omega_lim) - fabsf(dev - omega_lim));
    float mu_n = mu + omega_n + gain_mu * mm;
    const float stride = floorf(mu_n);
    mu_n = mu_n - stride;

    outs[((long long)t * k_max + cnt) * lanes + lane] = out;
    ++cnt;
    if (is_nan) {
      ii += (long long)floorf(omega);
    } else {
      omega = omega_n;
      mu = mu_n;
      last = out;
      ii += (long long)stride;
    }
  }

  omega_out[lane] = omega;
  mu_out[lane] = mu;
  last_out[lane] = last;
  const long long resid = total - ii;
  resid_out[lane] = (int)(resid < sfx - 1 ? resid : sfx - 1);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y3 (n, C) and suffix (sfx, C) time-major; per-lane state vectors (C,);
// bank (129, 8).  Writes outs (n_chunks, k_max, C), counts (n_chunks, C) and
// the final per-lane state.  Returns cudaGetLastError() after the launch.
extern "C" int clock_forward(const float* y3, int n, int lanes, const float* suffix, int sfx,
                             const float* omega_in, const float* mu_in,
                             const float* last_in, const int* resid_in,
                             const float* bank, int chunk, int n_chunks, int k_max,
                             float omega_mid, float omega_lim, float gain_omega,
                             float gain_mu, float* outs, int* counts, float* omega_out,
                             float* mu_out, float* last_out, int* resid_out,
                             void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int grid = (lanes + kThreads - 1) / kThreads;
  mm_clock_kernel<<<grid, kThreads, 0, stream>>>(
      y3, n, lanes, suffix, sfx, omega_in, mu_in, last_in, resid_in, bank, chunk,
      n_chunks, k_max, omega_mid, omega_lim, gain_omega, gain_mu, outs, counts,
      omega_out, mu_out, last_out, resid_out);
  return cudaGetLastError();
}
