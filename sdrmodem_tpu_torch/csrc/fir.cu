// Time-major strided FIR over [hist | x]:
//   y[k, l] = sum_j rev[j] * in[k * stride + j, l],  k < n_out,
// in = [hist (h rows, or zeros when hist is null) | x (x_rows rows) | zeros].
//
// fir_tm_forward replaces the TPU kernel sdrmodem_tpu/ops/pallas_fir.py:
// _banded_tm_kernel (wrapper conv1d_banded_tm), the banded front's FIR, and
// through it fir_tpu's _fir_kernel / _fir_nodecim (the same FIR with T - 1
// leading zeros, here a null hist).  The TPU kernel is a banded matrix
// product on the MXU with a bf16x3 operand split and 128-row accumulation
// groups; all three exist because the TPU's vector unit has no gathers and
// its matrix unit is the fast path.  None of it is carried over, nor is a
// tensor-core product taken in its place: the fused and banded fronts, and
// the exact streamer on the card and the CPU, agree bit for bit only while
// every output sums its taps in tap order with one rounding a tap, and TF32
// keeps 10 bits of mantissa.  So this is fir.cuh's direct FIR.
//
// fir_exact_tm_forward is the same FIR with a float64 accumulator, rounded
// once to float32: the exact mode's FIR (sdrmodem_tpu/dsp/fir.py:conv1d,
// exact=True, an XLA convolution in float64 there, no TPU kernel), whose
// promise is a canonical dot product independent of how the backend
// partitions the reduction.  It sums in tap order, so its plain version
// gives the same bits.
//
// Bound on an H100 (operations over 67 TFLOP/s of f32, 34 of f64, or bytes
// over 3.35 TB/s, the larger):
//   - the LPF1 shape, 2^20 + 156 rows x 256 lanes x 157 taps: ~42 G
//     multiply-adds, 1.26 ms of operations against 0.64 ms of bytes;
//   - B8 at 2^20 x 128 lanes, 57 taps, d = 2: 3.8 G multiply-adds, 0.11 ms,
//     against 0.8 GB, 0.24 ms: bound by bytes;
//   - one client's stream (paths (f), (g)): LPF1 on I and Q (2 lanes x
//     262144 x 157), LPF2 (1 x 131072 x 57) and the DC FIR (1 x 131072 x
//     637), ~173 M multiply-adds: ~0.01 ms of float64 work, a few us a
//     launch, so a launch is bound by its start and its few waves.
// Design (fir.cuh), a plan from ops/fir.py:fir_plan:
//   - 32 lanes or more, the wide form: a block takes 32 lanes (a warp's
//     threads on neighbouring lanes, every row read in whole sectors, every
//     tap a broadcast) and a segment of outputs, enough segments for the
//     lane groups to fill the SMs many times over.  It walks the segment
//     in tiles of 8 warps x R outputs; cp.async stages each tile's rows
//     and taps into one of two buffers in shared memory while the warps run
//     fir_block from the other, R = 24 outputs a thread at stride 1 (16 at
//     stride 2), so two shared loads (an input, a tap) feed R
//     multiply-adds and the inner loop is almost only FMAs; where a
//     stage's rows all lie in the input, a thread's copies walk one
//     pointer, a few instructions a row, and only the stages at the
//     input's edges check each row;
//   - fewer lanes, the narrow form: threads over outputs, a block a lane
//     and 128 x R consecutive outputs (R = 15 at stride 1, 7 at stride 2:
//     odd, so a warp's loads meet few bank conflicts), so one stream of
//     262144 outputs makes 137 blocks instead of leaving 30 of a warp's 32
//     threads idle;
//   - both walk long filters in tap parts, each staged in turn and each
//     continuing the same accumulators in tap order, so any tap count runs
//     with the same bits; rows past the input's end read as zeros in the
//     kernel, so the wrapper copies nothing.

#include "fir.cuh"

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory a block of the wide (wide = 1) or narrow form
// takes at this stride and part length (ops/fir.py:fir_plan computes the
// same).
extern "C" int fir_shared_bytes(int wide, int stride, int part) {
  return fir_shared_bytes_of(wide != 0, stride, part);
}

namespace {

template <typename Acc>
int fir_forward(const float* hist, long long h, const float* x, long long x_rows, int lanes,
                const float* rev_taps, int ntaps, int stride, int n_out, int wide, int part, int seg,
                float* y, void* stream_handle) {
  const FirArgs a{hist, x, h, x_rows, lanes, rev_taps, ntaps, stride, n_out, part, seg, y};
  return launch_fir_staged<Acc>(a, wide != 0, static_cast<cudaStream_t>(stream_handle));
}

}  // namespace

// hist (h, lanes) or null for h rows of zeros, x (x_rows, lanes), y (n_out,
// lanes); the plan's form, part and segment (ops/fir.py:fir_plan).
// Returns cudaGetLastError() after the launch.
extern "C" int fir_tm_forward(const float* hist, long long h, const float* x, long long x_rows,
                              int lanes, const float* rev_taps, int ntaps, int stride, int n_out,
                              int wide, int part, int seg, float* y, void* stream_handle) {
  return fir_forward<float>(hist, h, x, x_rows, lanes, rev_taps, ntaps, stride, n_out, wide, part, seg,
                            y, stream_handle);
}

// The same with a float64 accumulator.
extern "C" int fir_exact_tm_forward(const float* hist, long long h, const float* x, long long x_rows,
                                    int lanes, const float* rev_taps, int ntaps, int stride, int n_out,
                                    int wide, int part, int seg, float* y, void* stream_handle) {
  return fir_forward<double>(hist, h, x, x_rows, lanes, rev_taps, ntaps, stride, n_out, wide, part,
                             seg, y, stream_handle);
}
