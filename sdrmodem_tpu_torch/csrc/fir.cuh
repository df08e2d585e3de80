// Time-major strided FIR, shared by the front end (front.cu, B1) and the
// standalone FIRs (fir.cu: B3, its fir_tpu face B8, and the exact FIR), so
// every FIR of either front is the same device code in the same order and
// the fused and banded fronts agree bit for bit.  The fused step (step.cu,
// B7) sums each output through the same fir_dot.
//
// One thread per (output row, lane), neighbouring threads on neighbouring
// lanes so every load is coalesced, taps in shared memory and one
// multiply-add per tap in tap order into an accumulator of type Acc:
//   - float: fmaf, one rounding a tap (the front's FIRs and B3);
//   - double: fma in float64, where the product of two float32 values is
//     exact, so each tap rounds once whether or not it is fused, and the
//     sum rounds once to float32 at the end (the exact FIR).
// The carried history is read through its own pointer, so [history |
// block] is never copied.  Each multiply-add waits on a load from L1, so
// the kernel runs at the load rate, not the FMA rate.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerBlock = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float fir_mac(float tap, float x, float acc) { return fmaf(tap, x, acc); }

__device__ __forceinline__ double fir_mac(float tap, float x, double acc) {
  return fma((double)tap, (double)x, acc);
}

// One output's multiply-adds over taps [j0, j1) in tap order, continuing
// acc: acc = fir_mac(rev_taps[j], p[(j - j0) * step], acc).  Every FIR of
// the port (this kernel and the fused step, step.cu) sums through it.
template <typename Acc>
__device__ __forceinline__ Acc fir_dot(const float* rev_taps, int j0, int j1, const float* p,
                                       long long step, Acc acc) {
  for (int j = j0; j < j1; ++j, p += step) acc = fir_mac(rev_taps[j], *p, acc);
  return acc;
}

// y[k, l] = sum_j taps[j] * work[k * stride + j, l], work = [hist | x]
// (hist has ntaps - 1 rows).  rev_taps are the filter taps reversed.
template <typename Acc>
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
  Acc acc = 0;
  if (j_hist > 0) acc = fir_dot(s_taps, 0, j_hist, hist + r0 * lanes + lane, lanes, acc);
  if (j_hist < ntaps) {
    acc = fir_dot(s_taps, j_hist, ntaps, x + (r0 + j_hist - hist_rows) * lanes + lane, lanes, acc);
  }
  y[k * lanes + lane] = (float)acc;
}

template <typename Acc = float>
cudaError_t launch_fir(const float* hist, const float* x, int lanes,
                       const float* rev_taps, int ntaps, int stride, int n_out,
                       float* y, cudaStream_t stream) {
  const dim3 block(kLanesPerBlock, kRowsPerBlock);
  const dim3 grid((n_out + kRowsPerBlock - 1) / kRowsPerBlock,
                  (lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  fir_tm_kernel<Acc><<<grid, block, ntaps * sizeof(float), stream>>>(
      hist, x, lanes, rev_taps, ntaps, stride, n_out, y);
  return cudaGetLastError();
}

}  // namespace
