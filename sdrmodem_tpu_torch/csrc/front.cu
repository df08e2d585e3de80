// GMSK demodulator front end: LPF1 -> quadrature demod -> LPF2 (decimating)
// -> DC blocker, over one full block of time-major f32 IQ.
//
// Replaces the TPU kernel sdrmodem_tpu/ops/pallas_front.py:_front_kernel
// (wrapper fused_front_call), without its optional Doppler mix.
//
// Bound on an H100: at 128 lanes x 2^20 samples with the lucky7 taps
// (157 / 57) the function needs ~46 G multiply-adds (LPF1 and LPF2; the DC
// blocker is four running sums, ~13 operations a sample) against ~1.1 GB
// of compulsory traffic (the IQ block read once, y3 written once), so it
// is bound by the f32 CUDA cores (~1.4 ms at 67 TFLOP/s), not by memory
// (~0.4 ms at 3.35 TB/s).  Taking the DC blocker as its (4L-3) = 637-tap
// FIR, as this kernel does, adds ~43 G multiply-adds beyond that bound.
//
// Design: a plain first version.  One time-major FIR kernel, one thread per
// (output row, lane), neighbouring threads on neighbouring lanes so every
// load is coalesced, taps in shared memory and one fmaf per tap.  It runs
// three times (LPF1 over the I and Q lanes, LPF2 with stride d, the DC FIR);
// the carried history is read through its own pointer, so [history | block]
// is never copied.  A quadrature-demod kernel runs once in between, with the
// reference's 257-entry arctangent table in shared memory.  Every FMA waits
// on a load from L1, so the FIR runs at the load rate, not the FMA rate;
// intermediates make round trips through device memory.  Fusing the stages
// into one launch and register-blocking rows are the next steps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanesPerBlock = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kAtanTableSize = 257;

// y[k, l] = sum_j taps[j] * work[k * stride + j, l], work = [hist | x]
// (hist has ntaps - 1 rows).  rev_taps are the filter taps reversed.
__global__ void fir_tm_kernel(const float* __restrict__ hist,
                              const float* __restrict__ x, int lanes,
                              const float* __restrict__ rev_taps, int ntaps,
                              int stride, int n_out, float* __restrict__ y) {
  extern __shared__ float s_taps[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int j = tid; j < ntaps; j += blockDim.x * blockDim.y) s_taps[j] = rev_taps[j];
  __syncthreads();

  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  const long long k = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (lane >= lanes || k >= n_out) return;
  const long long hist_rows = ntaps - 1;
  const long long r0 = k * stride;  // first row of [hist | x] under the window
  const int j_hist = (int)(r0 >= hist_rows ? 0 : min((long long)ntaps, hist_rows - r0));
  float acc = 0.f;
  if (j_hist > 0) {
    const float* hp = hist + r0 * lanes + lane;
    for (int j = 0; j < j_hist; ++j, hp += lanes) acc = fmaf(s_taps[j], *hp, acc);
  }
  if (j_hist < ntaps) {
    const float* xp = x + (r0 + j_hist - hist_rows) * lanes + lane;
    for (int j = j_hist; j < ntaps; ++j, xp += lanes) acc = fmaf(s_taps[j], *xp, acc);
  }
  y[k * lanes + lane] = acc;
}

// The reference LUT arctangent (src/math/fast_atan2f.c:87-150), with the
// operations, their order and their NaN behaviour of the plain version
// (dsp/elementwise.py:fast_atan2); the _rn intrinsics keep nvcc from
// contracting a multiply and an add into an FMA.
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

// yq[k, c] = gain * atan2(im, re) of y1[k] * conj(y1[k-1]); y1 is (rows, 2C)
// with I in lanes [0, C) and Q in [C, 2C); y1[-1] is prev (the carried row).
__global__ void quad_demod_kernel(const float* __restrict__ y1,
                                  const float* __restrict__ prev, int rows,
                                  int lanes, const float* __restrict__ table,
                                  float gain, float* __restrict__ yq) {
  __shared__ float s_table[kAtanTableSize];
  for (int j = threadIdx.x; j < kAtanTableSize; j += blockDim.x) s_table[j] = table[j];
  __syncthreads();

  const long long n = (long long)rows * lanes;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long k = idx / lanes;
    const int c = (int)(idx - k * lanes);
    const float* cur = y1 + k * 2 * lanes;
    const float* prv = k == 0 ? prev : cur - 2 * lanes;
    const float i = cur[c], q = cur[lanes + c];
    const float si = prv[c], sq = prv[lanes + c];
    const float re = __fadd_rn(__fmul_rn(i, si), __fmul_rn(q, sq));
    const float im = __fsub_rn(__fmul_rn(q, si), __fmul_rn(i, sq));
    yq[idx] = __fmul_rn(gain, fast_atan2(im, re, s_table));
  }
}

cudaError_t launch_fir(const float* hist, const float* x, int lanes,
                       const float* rev_taps, int ntaps, int stride, int n_out,
                       float* y, cudaStream_t stream) {
  const dim3 block(kLanesPerBlock, kRowsPerBlock);
  const dim3 grid((n_out + kRowsPerBlock - 1) / kRowsPerBlock,
                  (lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  fir_tm_kernel<<<grid, block, ntaps * sizeof(float), stream>>>(
      hist, x, lanes, rev_taps, ntaps, stride, n_out, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One full block through the front end.  x is (block, 2C); the hists are
// (taps - 1, lanes) in the DemodStateFull layout; the taps are reversed.
// y1 (block, 2C), yq (block, C) and y2 (block / decim, C) are scratch; y3
// (block / decim, C) is the output.  With dc_taps == 0 LPF2 writes y3 and
// y2 is unused.  *launched counts the kernels started (4, or 3 without the
// DC stage).  Returns cudaGetLastError() after the launches.
extern "C" int front_forward(const float* x, int block, int lanes,
                             const float* lpf1_hist, const float* lpf1_taps, int t1,
                             const float* quad_prev, float quad_gain,
                             const float* atan_table,
                             const float* lpf2_hist, const float* lpf2_taps, int t2,
                             int decim,
                             const float* dc_hist, const float* dc_taps, int t3,
                             float* y1, float* yq, float* y2, float* y3,
                             void* stream_handle, int* launched) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int n2 = block / decim;
  *launched = 0;
  cudaError_t err = launch_fir(lpf1_hist, x, 2 * lanes, lpf1_taps, t1, 1, block, y1, stream);
  if (err != cudaSuccess) return err;
  ++*launched;

  const long long n = (long long)block * lanes;
  const long long want = (n + 255) / 256;
  const int grid = (int)(want < 4096 ? want : 4096);
  quad_demod_kernel<<<grid, 256, 0, stream>>>(y1, quad_prev, block, lanes, atan_table,
                                              quad_gain, yq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  err = launch_fir(lpf2_hist, yq, lanes, lpf2_taps, t2, decim, n2, t3 > 0 ? y2 : y3, stream);
  if (err != cudaSuccess) return err;
  ++*launched;
  if (t3 == 0) return err;
  err = launch_fir(dc_hist, y2, lanes, dc_taps, t3, 1, n2, y3, stream);
  if (err == cudaSuccess) ++*launched;
  return err;
}
