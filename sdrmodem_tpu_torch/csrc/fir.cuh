// Time-major strided FIR, shared by the front end (front.cu, B1) and the
// standalone FIRs (fir.cu: B3, its fir_tpu face B8, and the exact FIR), so
// every FIR of either front sums in the same order and the fused and banded
// fronts agree bit for bit.  The fused step (step.cu, B7) sums each output
// through the same fir_dot.
//
// Every output is acc = fir_mac(rev_taps[j], x, acc) for j = 0 .. t - 1,
// acc starting from 0, in an accumulator of type Acc:
//   - float: fmaf, one rounding a tap (the front's FIRs and B3);
//   - double: fma in float64, where the product of two float32 values is
//     exact, so each tap rounds once whether or not it is fused, and the
//     sum rounds once to float32 at the end (the exact FIR).
//
// Two forms of that sum:
//   - fir_tm_kernel (B3, B8, the exact FIR): one thread an output, one
//     multiply-add a tap, each waiting on a load from L1, so it runs at the
//     load rate, not the FMA rate;
//   - fir_block (B1's three FIRs): one thread R consecutive outputs of a
//     lane, a window of inputs sliding through registers, so each input
//     load feeds R multiply-adds, each output still summed in tap order.
//     fir_blocked_tm_kernel runs it over [history | block] in device
//     memory, for any stride and Acc; B3, B8 and the exact FIR can move
//     onto it.

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

// R consecutive outputs of NC channels (I and Q of one lane, or one), each
// acc[ch][r] = sum over j in tap order of rev_taps[j] * ld(r * D + j, ch),
// from 0: fir_dot's order.  ld(m, ch) is the input m rows past the first
// output's first input.  The window w holds the (R - 1) * D + 1 inputs
// under the R outputs at tap j, kept in a ring whose slots the unrolled
// loop names at compile time: one new load a channel a tap feeds R
// multiply-adds.  D = 0 takes the stride from `stride` at run time and
// loads each output's input (R loads a tap, the tap loaded once).
template <int R, int D, int NC, typename Acc, typename Load>
__device__ __forceinline__ void fir_block(const float* rev_taps, int ntaps, int stride, Load ld,
                                          Acc (&acc)[NC][R]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[ch][r] = 0;
  if constexpr (D == 0) {
    for (int j = 0; j < ntaps; ++j) {
      const float tap = rev_taps[j];
#pragma unroll
      for (int ch = 0; ch < NC; ++ch)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[ch][r] = fir_mac(tap, ld(r * stride + j, ch), acc[ch][r]);
    }
  } else {
    constexpr int NW = (R - 1) * D + 1;
    float w[NC][NW];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
#pragma unroll
      for (int m = 0; m < NW - 1; ++m) w[ch][m] = ld(m, ch);
    // input p lives in slot p % NW; j0 stays a multiple of NW
    int j0 = 0;
    for (; j0 + NW <= ntaps; j0 += NW) {
#pragma unroll
      for (int u = 0; u < NW; ++u) {
        const float tap = rev_taps[j0 + u];
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) {
          w[ch][(u + NW - 1) % NW] = ld(j0 + u + NW - 1, ch);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[ch][r] = fir_mac(tap, w[ch][(u + r * D) % NW], acc[ch][r]);
        }
      }
    }
    const int rem = ntaps - j0;
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      if (u < rem) {
        const float tap = rev_taps[j0 + u];
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) {
          w[ch][(u + NW - 1) % NW] = ld(j0 + u + NW - 1, ch);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[ch][r] = fir_mac(tap, w[ch][(u + r * D) % NW], acc[ch][r]);
        }
      }
    }
  }
}

constexpr int kBlockedRows = 24;  // outputs a thread in fir_blocked_tm_kernel
constexpr int kBlockedWarps = 8;

// y[k, l] = sum_j taps[j] * work[k * stride + j, l], work = [hist | x]
// (hist has ntaps - 1 rows, x has x_rows), as fir_tm_kernel, through
// fir_block: blockIdx.x takes 32 lanes, blockIdx.y a segment of seg_rows
// outputs, and each warp of the block groups of kBlockedRows outputs of the
// segment in turn, so the warps walk it side by side and the rows they
// share stay in L1.  Rows read past the input's end (outputs past n_out)
// are clamped and their outputs not written.
template <typename Acc, int D>
__global__ void __launch_bounds__(32 * kBlockedWarps)
    fir_blocked_tm_kernel(const float* __restrict__ hist, const float* __restrict__ x,
                          int x_rows, int lanes, const float* __restrict__ rev_taps, int ntaps,
                          int stride, int n_out, int seg_rows, float* __restrict__ y) {
  constexpr int R = kBlockedRows;
  extern __shared__ float s_taps[];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int j = tid; j < ntaps; j += 32 * kBlockedWarps) s_taps[j] = rev_taps[j];
  __syncthreads();

  const int lane = blockIdx.x * 32 + threadIdx.x;
  const int c = min(lane, lanes - 1);  // a lane past the last reads the last, writes nothing
  const long long h = ntaps - 1, last = h + x_rows - 1;
  const long long seg0 = (long long)blockIdx.y * seg_rows;
  const long long seg1 = min((long long)n_out, seg0 + seg_rows);
  for (long long k0 = seg0 + (long long)threadIdx.y * R; k0 < seg1; k0 += (long long)kBlockedWarps * R) {
    const long long r0 = k0 * stride;  // the first output's first row of [hist | x]
    Acc acc[1][R];
    if (r0 >= h && r0 + (long long)(R - 1) * stride + ntaps - 1 <= last) {
      const float* p = x + (r0 - h) * lanes + c;
      fir_block<R, D, 1>(s_taps, ntaps, stride, [&](int m, int) { return p[(long long)m * lanes]; }, acc);
    } else {
      fir_block<R, D, 1>(s_taps, ntaps, stride, [&](int m, int) {
        const long long row = min(r0 + m, last);
        return row < h ? hist[row * lanes + c] : x[(row - h) * lanes + c];
      }, acc);
    }
    if (lane < lanes) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (k0 + r < seg1) y[(k0 + r) * lanes + lane] = (float)acc[0][r];
      }
    }
  }
}

// Launches fir_blocked_tm_kernel: D = 1 or 2 slides the window, any other
// stride runs the D = 0 form.  seg_rows (outputs a block) from the caller.
template <typename Acc = float>
cudaError_t launch_fir_blocked(const float* hist, const float* x, int x_rows, int lanes,
                               const float* rev_taps, int ntaps, int stride, int n_out,
                               int seg_rows, float* y, cudaStream_t stream) {
  const dim3 block(32, kBlockedWarps);
  const dim3 grid((lanes + 31) / 32, (n_out + seg_rows - 1) / seg_rows);
  const size_t bytes = ntaps * sizeof(float);
  if (stride == 1) {
    fir_blocked_tm_kernel<Acc, 1><<<grid, block, bytes, stream>>>(hist, x, x_rows, lanes, rev_taps,
                                                                  ntaps, stride, n_out, seg_rows, y);
  } else if (stride == 2) {
    fir_blocked_tm_kernel<Acc, 2><<<grid, block, bytes, stream>>>(hist, x, x_rows, lanes, rev_taps,
                                                                  ntaps, stride, n_out, seg_rows, y);
  } else {
    fir_blocked_tm_kernel<Acc, 0><<<grid, block, bytes, stream>>>(hist, x, x_rows, lanes, rev_taps,
                                                                  ntaps, stride, n_out, seg_rows, y);
  }
  return cudaGetLastError();
}

}  // namespace
