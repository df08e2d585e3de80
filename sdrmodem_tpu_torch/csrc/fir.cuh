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
// fir_block is that sum for R consecutive outputs of a lane at once, a
// window of inputs sliding through registers, so each input load feeds R
// multiply-adds; fir_block_more continues the sums over a later part of
// the taps in the same order, so a FIR may walk its taps in parts.  Three
// kernels run it:
//   - fir_wide_kernel (any FIR with 32 lanes or more): a block takes 32
//     lanes and a segment of outputs, and walks the segment in tiles of
//     kFirWarps * R outputs, each tile's taps in parts: cp.async stages a
//     part's taps and the tile's rows under it into one of two buffers in
//     shared memory while the warps run fir_block over the other;
//   - fir_narrow_kernel (one client's stream, fewer than 32 lanes): threads
//     go over outputs, not lanes.  A block takes one lane and kNarrowThreads
//     * R consecutive outputs of it, R a thread, and walks the taps in parts
//     staged the same way;
//   - fir_blocked_tm_kernel (B1's DC launch): 32 lanes x a segment, 24
//     outputs a thread, the inputs read from L1.
// Each reads its input as [hist | x] (hist may be null: zeros), rows past
// the end as zeros.

#pragma once

#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

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

// R consecutive outputs of NC channels (I and Q of one lane, or one), each
// continuing acc[ch][r] += rev_taps[j] * ld(r * D + j, ch) over j = 0 ..
// ntaps - 1 in tap order: fir_dot's order.  ld(m, ch) is the input m rows
// past the first output's first input.  The window w holds the (R - 1) * D
// + 1 inputs under the R outputs at tap j, kept in a ring whose slots the
// unrolled loop names at compile time: one new load a channel a tap feeds
// R multiply-adds.  D = 0 takes the stride from `stride` at run time and
// loads each output's input (R loads a tap, the tap loaded once).
template <int R, int D, int NC, typename Acc, typename Load>
__device__ __forceinline__ void fir_block_more(const float* rev_taps, int ntaps, int stride, Load ld,
                                               Acc (&acc)[NC][R]) {
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

template <int NC, int R, typename Acc>
__device__ __forceinline__ void fir_zero(Acc (&acc)[NC][R]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[ch][r] = 0;
}

// fir_block_more from acc = 0: the whole FIR of R outputs.
template <int R, int D, int NC, typename Acc, typename Load>
__device__ __forceinline__ void fir_block(const float* rev_taps, int ntaps, int stride, Load ld,
                                          Acc (&acc)[NC][R]) {
  fir_zero(acc);
  fir_block_more<R, D>(rev_taps, ntaps, stride, ld, acc);
}

// ---- the staged forms (B3, B8, the exact FIR)

constexpr int kFirWarps = 8;           // warps of a wide block, R outputs of the tile each
constexpr int kNarrowThreads = 128;    // threads of a narrow block, R outputs each
constexpr int kFirBufferBytes = 57600;  // one stage buffer: two a block, two blocks an SM
constexpr int kDefaultSharedBytes = 48 * 1024;  // dynamic shared memory a launch gets unasked

// Outputs a thread: the window slides at strides 1 and 2 (24 and 16 in the
// wide form, 96 registers; odd in the narrow form, so the 32 threads of a
// warp, R * stride floats apart, read 32 banks or 16 banks twice); other
// strides take the D = 0 form.
__host__ __device__ constexpr int fir_rows_a_thread(bool wide, int stride) {
  return wide ? (stride == 1 ? 24 : stride == 2 ? 16 : 4) : (stride == 1 ? 15 : stride == 2 ? 7 : 5);
}

__host__ __device__ inline int fir_tile(bool wide, int stride) {
  return (wide ? kFirWarps : kNarrowThreads) * fir_rows_a_thread(wide, stride);
}

// Rows between consecutive outputs' windows in a stage: the stride, except
// in the D = 0 form where a part is shorter than the stride: then each
// output's window is staged alone, `part` rows a window.
__host__ __device__ inline int fir_stage_step(int stride, int part) {
  return stride > 2 && part < stride ? part : stride;
}

// Floats of one stage buffer: a part's taps, then the tile's rows under
// them (32 lanes a row in the wide form, one in the narrow), each rounded
// up to a multiple of 4.
__host__ __device__ inline int fir_buffer_floats(bool wide, int stride, int part) {
  const int rows = (fir_tile(wide, stride) - 1) * fir_stage_step(stride, part) + part;
  return ((part + 3) & ~3) + ((rows * (wide ? 32 : 1) + 3) & ~3);
}

struct FirArgs {
  const float* hist;  // rows [0, h) of the input, or null: zeros
  const float* x;     // rows [h, h + x_rows); rows past them read as zeros
  long long h, x_rows;
  int lanes;
  const float* rev_taps;
  int ntaps, stride, n_out;
  int part;  // taps a part
  int seg;   // outputs a block (wide form; a multiple of its tile)
  float* y;  // (n_out, lanes)
};

// Where input row r of lane c is, or null for a zero.
__device__ __forceinline__ const float* fir_row(const FirArgs& a, long long r, int c) {
  if (r < a.h) return a.hist != nullptr ? a.hist + r * a.lanes + c : nullptr;
  r -= a.h;
  return r < a.x_rows ? a.x + r * a.lanes + c : nullptr;
}

// Stages rows q = first, first + every, ... < n of a stage of lane c whose
// first row is input row r0 into dst + q * pitch, and the part's taps
// [j0, j0 + n_taps) into taps (thread tid of threads).  Where the stage's
// rows are consecutive (step == stride) and all in x, straight from x;
// else each row through fir_row, zeros past the input.
__device__ __forceinline__ void fir_stage(const FirArgs& a, long long r0, int n, int step, int c, bool live,
                                          int first, int every, float* dst, int pitch, float* taps, int j0,
                                          int n_taps, int tid, int threads) {
  stage_elements(n_taps, tid, threads, [&](int j) { return taps + j; }, [&](int j) { return a.rev_taps + j0 + j; });
  const long long x0 = r0 - a.h;
  if (live && step == a.stride && x0 >= 0 && x0 + n <= a.x_rows) {
    const float* src = a.x + (x0 + first) * a.lanes + c;
    const long long skip = (long long)every * a.lanes;
    for (int q = first; q < n; q += every, src += skip) cp_async4(dst + q * pitch, src);
    return;
  }
  stage_elements(n, first, every, [&](int q) { return dst + q * pitch; }, [&](int q) -> const float* {
    if (!live) return nullptr;
    const long long r = step == a.stride ? r0 + q : r0 + (long long)(q / step) * a.stride + q % step;
    return fir_row(a, r, c);
  });
}

// Stages 0 .. n - 1 double-buffered: stage(s, buffer) issues stage s's
// copies, compute(s, buffer) runs on it once they have landed.  Stage s + 1
// is in flight while stage s computes.  n is the same for every thread.
template <typename Stage, typename Compute>
__device__ __forceinline__ void fir_pipeline(int n, float* sm, int buf, Stage stage, Compute compute) {
  if (n > 0) stage(0, sm);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) stage(s + 1, sm + ((s + 1) & 1) * buf);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    compute(s, sm + (s & 1) * buf);
    __syncthreads();
  }
}

// y[k, c] = sum_j rev_taps[j] * in[k * stride + j, c] for 32 lanes
// (blockIdx.x) and the outputs [blockIdx.y * seg, + seg), in tiles of
// kFirWarps * R outputs, warp w taking the tile's outputs [w R, w R + R).
template <typename Acc, int D, int R>
__global__ void __launch_bounds__(32 * kFirWarps, 2) fir_wide_kernel(const FirArgs a) {
  extern __shared__ float4 fir_sm4[];
  float* sm = reinterpret_cast<float*>(fir_sm4);
  constexpr int tile = kFirWarps * R;
  const int lane = threadIdx.x, w = threadIdx.y, tid = w * 32 + lane;
  const int c_raw = blockIdx.x * 32 + lane;
  const bool live = c_raw < a.lanes;
  const int c = live ? c_raw : a.lanes - 1;
  const int parts = (a.ntaps + a.part - 1) / a.part;
  const int step = fir_stage_step(a.stride, a.part), tap_floats = (a.part + 3) & ~3;
  const long long k_a = (long long)blockIdx.y * a.seg;
  const long long k_b = min((long long)a.n_out, k_a + a.seg);
  const int tiles = (int)((k_b - k_a + tile - 1) / tile);
  Acc acc[1][R];
  fir_pipeline(
      tiles * parts, sm, fir_buffer_floats(true, a.stride, a.part),
      [&](int s, float* b) {
        const int t = s / parts, j0 = (s - t * parts) * a.part, n_taps = min(a.part, a.ntaps - j0);
        const long long r0 = (k_a + (long long)t * tile) * a.stride + j0;
        fir_stage(a, r0, (tile - 1) * step + n_taps, step, c, live, w, kFirWarps, b + tap_floats + lane, 32, b,
                  j0, n_taps, tid, 32 * kFirWarps);
      },
      [&](int s, const float* b) {
        const int t = s / parts, p = s - t * parts, j0 = p * a.part;
        if (p == 0) fir_zero(acc);
        const float* src = b + tap_floats + w * R * step * 32 + lane;
        fir_block_more<R, D>(b, min(a.part, a.ntaps - j0), step, [&](int m, int) { return src[m * 32]; }, acc);
        if (p == parts - 1 && live) {
          const long long k0 = k_a + (long long)t * tile + w * R;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (k0 + r < k_b) a.y[(k0 + r) * a.lanes + c] = (float)acc[0][r];
          }
        }
      });
}

// The same sum for lane blockIdx.y and the outputs [blockIdx.x * tile, +
// tile), tile = kNarrowThreads * R, thread t taking [t R, t R + R).
template <typename Acc, int D, int R>
__global__ void __launch_bounds__(kNarrowThreads, 4) fir_narrow_kernel(const FirArgs a) {
  extern __shared__ float4 fir_sm4[];
  float* sm = reinterpret_cast<float*>(fir_sm4);
  constexpr int tile = kNarrowThreads * R;
  const int tid = threadIdx.x, c = blockIdx.y;
  const int parts = (a.ntaps + a.part - 1) / a.part;
  const int step = fir_stage_step(a.stride, a.part), tap_floats = (a.part + 3) & ~3;
  const long long k0 = (long long)blockIdx.x * tile;
  Acc acc[1][R];
  fir_zero(acc);
  fir_pipeline(
      parts, sm, fir_buffer_floats(false, a.stride, a.part),
      [&](int p, float* b) {
        const int j0 = p * a.part, n_taps = min(a.part, a.ntaps - j0);
        fir_stage(a, k0 * a.stride + j0, (tile - 1) * step + n_taps, step, c, true, tid, kNarrowThreads,
                  b + tap_floats, 1, b, j0, n_taps, tid, kNarrowThreads);
      },
      [&](int p, const float* b) {
        const int j0 = p * a.part;
        const float* src = b + tap_floats + tid * R * step;
        fir_block_more<R, D>(b, min(a.part, a.ntaps - j0), step, [&](int m, int) { return src[m]; }, acc);
      });
  const long long first = k0 + (long long)tid * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (first + r < a.n_out) a.y[(first + r) * a.lanes + c] = (float)acc[0][r];
  }
}

// Bytes of shared memory one block of the staged form takes: two buffers.
__host__ __device__ inline int fir_shared_bytes_of(bool wide, int stride, int part) {
  return 2 * (int)sizeof(float) * fir_buffer_floats(wide, stride, part);
}

template <typename Acc, int D>
void (*fir_kernel(bool wide))(FirArgs) {
  constexpr int stride = D == 0 ? 3 : D;  // any stride of the D = 0 form
  if (wide) return fir_wide_kernel<Acc, D, fir_rows_a_thread(true, stride)>;
  return fir_narrow_kernel<Acc, D, fir_rows_a_thread(false, stride)>;
}

// Launches the wide (lanes >= 32 by the plan) or narrow form over a's
// input, taps in parts of a.part, a.seg outputs a wide block (ops/fir.py:
// fir_plan).  Returns cudaGetLastError() after the launch.
template <typename Acc>
cudaError_t launch_fir_staged(const FirArgs& a, bool wide, cudaStream_t stream) {
  const int tile = fir_tile(wide, max(a.stride, 1));
  if (a.lanes < 1 || a.ntaps < 1 || a.stride < 1 || a.n_out < 1 || a.part < 1 || a.h < 0 || a.x_rows < 0 ||
      (long long)(tile - 1) * fir_stage_step(a.stride, a.part) + a.part > kFirBufferBytes) {
    return cudaErrorInvalidValue;
  }
  const int bytes = fir_shared_bytes_of(wide, a.stride, a.part);
  const long long blocks = wide ? (a.n_out + (long long)a.seg - 1) / max(a.seg, 1) : (a.n_out + tile - 1) / tile;
  if (bytes > 2 * kFirBufferBytes || (wide && (a.seg < tile || a.seg % tile != 0 || blocks > 65535)) ||
      (!wide && (a.lanes > 65535 || blocks > 0x7fffffff))) {
    return cudaErrorInvalidValue;
  }
  void (*kernel)(FirArgs) = a.stride == 1 ? fir_kernel<Acc, 1>(wide)
                            : a.stride == 2 ? fir_kernel<Acc, 2>(wide)
                                            : fir_kernel<Acc, 0>(wide);
  if (bytes > kDefaultSharedBytes) {  // above the default, a block's shared memory must be asked for
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  if (wide) {
    kernel<<<dim3((a.lanes + 31) / 32, (unsigned)blocks), dim3(32, kFirWarps), bytes, stream>>>(a);
  } else {
    kernel<<<dim3((unsigned)blocks, a.lanes), kNarrowThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

// ---- B1's DC launch

constexpr int kBlockedRows = 24;  // outputs a thread in fir_blocked_tm_kernel
constexpr int kBlockedWarps = 8;
constexpr int kBlockedMaxTaps = 232448 / 4;  // taps that fit one block's shared memory

// y[k, l] = sum_j taps[j] * work[k * stride + j, l], work = [hist | x]
// (hist has ntaps - 1 rows, x has x_rows), through fir_block: blockIdx.x
// takes 32 lanes, blockIdx.y a segment of seg_rows outputs, and each warp
// of the block groups of kBlockedRows outputs of the segment in turn, so
// the warps walk it side by side and the rows they share stay in L1.  Rows
// read past the input's end (outputs past n_out) are clamped and their
// outputs not written.  The taps sit in shared memory where they fit
// (SharedTaps), else they are read through L1 too.
template <typename Acc, int D, bool SharedTaps>
__global__ void __launch_bounds__(32 * kBlockedWarps)
    fir_blocked_tm_kernel(const float* __restrict__ hist, const float* __restrict__ x,
                          int x_rows, int lanes, const float* __restrict__ rev_taps, int ntaps,
                          int stride, int n_out, int seg_rows, float* __restrict__ y) {
  constexpr int R = kBlockedRows;
  extern __shared__ float s_taps[];
  if constexpr (SharedTaps) {
    const int tid = threadIdx.y * 32 + threadIdx.x;
    for (int j = tid; j < ntaps; j += 32 * kBlockedWarps) s_taps[j] = rev_taps[j];
    __syncthreads();
  }
  const float* taps = SharedTaps ? s_taps : rev_taps;

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
      fir_block<R, D, 1>(taps, ntaps, stride, [&](int m, int) { return p[(long long)m * lanes]; }, acc);
    } else {
      fir_block<R, D, 1>(taps, ntaps, stride, [&](int m, int) {
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
  const bool shared = ntaps <= kBlockedMaxTaps;
  const int bytes = shared ? ntaps * (int)sizeof(float) : 0;
  auto kernel = shared ? (stride == 1   ? fir_blocked_tm_kernel<Acc, 1, true>
                          : stride == 2 ? fir_blocked_tm_kernel<Acc, 2, true>
                                        : fir_blocked_tm_kernel<Acc, 0, true>)
                       : (stride == 1   ? fir_blocked_tm_kernel<Acc, 1, false>
                          : stride == 2 ? fir_blocked_tm_kernel<Acc, 2, false>
                                        : fir_blocked_tm_kernel<Acc, 0, false>);
  if (bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, bytes, stream>>>(hist, x, x_rows, lanes, rev_taps, ntaps, stride, n_out, seg_rows, y);
  return cudaGetLastError();
}

}  // namespace
