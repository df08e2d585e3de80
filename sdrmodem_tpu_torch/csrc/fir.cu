// Time-major strided FIR over a caller-assembled [history | block] array:
//   out[k, l] = sum_j rev[j] * x_tm[k * stride + col_offset + j, l],  k < n_out.
//
// fir_tm_forward replaces the TPU kernel sdrmodem_tpu/ops/pallas_fir.py:
// _banded_tm_kernel (wrapper conv1d_banded_tm), the banded front's FIR, and
// through it fir_tpu's _fir_kernel / _fir_nodecim (the same FIR with T - 1
// leading zeros).  The TPU kernel is a banded matrix product on the MXU
// with a bf16x3 operand split and 128-row accumulation groups; all three
// exist because the TPU's vector unit has no gathers and its matrix unit is
// the fast path.  None of it is carried over: this is the front end's
// direct f32 FIR (fir.cuh), one fmaf a tap in tap order.
//
// fir_exact_tm_forward is the same FIR with a float64 accumulator, rounded
// once to float32: the exact mode's FIR (sdrmodem_tpu/dsp/fir.py:conv1d,
// exact=True, an XLA convolution in float64 there, no TPU kernel), whose
// promise is a canonical dot product independent of how the backend
// partitions the reduction.  It sums in tap order, so its plain version
// gives the same bits.
//
// Bound on an H100: at the LPF1 shape (2^20 rows x 256 lanes x 157 taps)
// the f32 FIR needs ~42 G multiply-adds (~84 GFLOP, ~1.26 ms at 67 TFLOP/s
// on the f32 cores) against ~2 GiB of compulsory traffic (~0.64 ms at
// 3.35 TB/s), so it is bound by operations.  The kernel reaches neither:
// each FMA waits on a load from L1 (see fir.cuh).  The exact FIR on one
// client's stream (1-2 lanes) leaves 30 of a warp's 32 threads idle; its
// time is the taps' dependent chain, not the float64 rate.
//
// Design: x_tm holds [history | block] contiguously, so the two-pointer
// kernel reads it with hist = x_tm + col_offset rows and x = hist + T - 1
// rows, and needs no code of its own.  The wrapper (ops/fir.py) pads x_tm
// with zero rows where it is shorter than the last window.

#include "fir.cuh"

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x_tm is (rows, lanes) with rows >= (n_out - 1) * stride + col_offset + ntaps;
// y is (n_out, lanes).  Returns cudaGetLastError() after the launch.
extern "C" int fir_tm_forward(const float* x_tm, int lanes, const float* rev_taps,
                              int ntaps, int stride, int col_offset, int n_out, float* y,
                              void* stream_handle) {
  const float* hist = x_tm + (long long)col_offset * lanes;
  const float* x = hist + (long long)(ntaps - 1) * lanes;
  return launch_fir<float>(hist, x, lanes, rev_taps, ntaps, stride, n_out, y,
                           static_cast<cudaStream_t>(stream_handle));
}

// The same with a float64 accumulator.
extern "C" int fir_exact_tm_forward(const float* x_tm, int lanes, const float* rev_taps,
                                    int ntaps, int stride, int col_offset, int n_out, float* y,
                                    void* stream_handle) {
  const float* hist = x_tm + (long long)col_offset * lanes;
  const float* x = hist + (long long)(ntaps - 1) * lanes;
  return launch_fir<double>(hist, x, lanes, rev_taps, ntaps, stride, n_out, y,
                            static_cast<cudaStream_t>(stream_handle));
}
