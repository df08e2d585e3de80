// GMSK demodulator front end: [Doppler NCO mix] -> LPF1 -> quadrature demod
// -> LPF2 (decimating) -> DC blocker, over one full block of time-major f32 IQ.
//
// Replaces the TPU kernel sdrmodem_tpu/ops/pallas_front.py:_front_kernel
// (wrapper fused_front_call), with its optional Doppler stage.
//
// Bound on an H100: at 128 lanes x 2^20 samples with the lucky7 taps
// (157 / 57) the function needs ~46 G multiply-adds (LPF1 and LPF2; the DC
// blocker is four running sums, ~13 operations a sample; the Doppler mix
// ~10 a table row and ~46 for the sincos and rotation a lane-sample)
// against ~1.1 GB of compulsory traffic (the IQ block read once, y3
// written once), so it is bound by the f32 CUDA cores (~1.4 ms at 67
// TFLOP/s), not by memory (~0.4 ms at 3.35 TB/s).  Taking the DC blocker
// as its (4L-3) = 637-tap FIR, as this kernel does, adds ~43 G
// multiply-adds beyond that bound.
//
// Design: a plain first version.  The NCO mix (nco.cuh) runs first when
// the wrapper passes Doppler tables and writes the mixed block to scratch.
// One time-major FIR kernel (fir.cuh, shared with fir.cu) runs three times
// (LPF1 over the I and Q lanes, LPF2 with stride d, the DC FIR); the
// carried history is read through its own pointer, so [history | block] is
// never copied.  A quadrature-demod kernel runs once in between, with the
// reference's 257-entry arctangent table in shared memory.  Each stage's
// per-sample device code (nco.cuh, fir.cuh, quad.cuh) is shared with the
// fused step (step.cu, B7), so both give the same bits.  The banded
// front (ops/front.py:banded_front) launches the same NCO, FIR and
// quad-demod kernels one at a time, so both fronts give the same bits.
// Every FMA waits on a load from L1, so the FIR runs at the load rate, not
// the FMA rate; intermediates make round trips through device memory.
// Fusing the stages into one launch and register-blocking rows are the
// next steps.

#include <cuda_runtime.h>
#include <math.h>

#include "fir.cuh"
#include "nco.cuh"
#include "quad.cuh"

namespace {

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
    yq[idx] = quad_demod_sample(cur[c], cur[lanes + c], prv[c], prv[lanes + c], s_table, gain);
  }
}

cudaError_t launch_quad_demod(const float* y1, const float* prev, int rows, int lanes,
                              const float* table, float gain, float* yq,
                              cudaStream_t stream) {
  const long long n = (long long)rows * lanes;
  const long long want = (n + 255) / 256;
  const int grid = (int)(want < 4096 ? want : 4096);
  quad_demod_kernel<<<grid, 256, 0, stream>>>(y1, prev, rows, lanes, table, gain, yq);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One full block through the front end.  x is (block, 2C); the hists are
// (taps - 1, lanes) in the DemodStateFull layout; the taps are reversed.
// dop is the (5, dop_rows, C) NCO table (nco.cuh) or null for no Doppler
// stage; xm (block, 2C) is the mixed block's scratch when dop is given.
// y1 (block, 2C), yq (block, C) and y2 (block / decim, C) are scratch; y3
// (block / decim, C) is the output.  With dc_taps == 0 LPF2 writes y3 and
// y2 is unused.  *launched counts the kernels started (5 with Doppler and
// DC, one fewer without either).  Returns cudaGetLastError() after the
// launches.
extern "C" int front_forward(const float* x, int block, int lanes,
                             const float* dop, int dop_rows, float* xm,
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
  cudaError_t err;
  if (dop != nullptr) {
    err = launch_nco_mix(x, block, lanes, dop, dop_rows, xm, stream);
    if (err != cudaSuccess) return err;
    ++*launched;
    x = xm;
  }
  err = launch_fir(lpf1_hist, x, 2 * lanes, lpf1_taps, t1, 1, block, y1, stream);
  if (err != cudaSuccess) return err;
  ++*launched;

  err = launch_quad_demod(y1, quad_prev, block, lanes, atan_table, quad_gain, yq, stream);
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

// The quad-demod stage alone, for the banded front: yq (rows, C) from y1
// (rows, 2C) and the carried row prev (1, 2C).
extern "C" int quad_demod_forward(const float* y1, const float* prev, int rows, int lanes,
                                  const float* atan_table, float quad_gain, float* yq,
                                  void* stream_handle) {
  return launch_quad_demod(y1, prev, rows, lanes, atan_table, quad_gain, yq,
                           static_cast<cudaStream_t>(stream_handle));
}

// The Doppler NCO stage alone, for the banded front: y (rows, 2C) is x
// mixed by the (5, dop_rows, C) table.
extern "C" int nco_mix_forward(const float* x, int rows, int lanes, const float* dop,
                               int dop_rows, float* y, void* stream_handle) {
  return launch_nco_mix(x, rows, lanes, dop, dop_rows, y,
                        static_cast<cudaStream_t>(stream_handle));
}
