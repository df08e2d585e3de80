// Per-lane Doppler NCO multiply over a time-major (rows, 2C) f32 IQ block:
// the device half of Doppler correction, stage 0 of the front end.
//
// Replaces the Doppler stage of the TPU kernel
// sdrmodem_tpu/ops/pallas_front.py:_front_kernel (lines 180-212), which
// computes sdrmodem_tpu/dsp/elementwise.py:nco_mix_pair_tm in-tile.
//
// Bound on an H100: each sample reads its I and Q and writes them back
// (16 bytes a lane-sample).  The table rows are disjoint, so a sample
// needs the ramp of the one row that covers it (~10 operations), a sincos
// (~40) and the rotation (6): ~56 operations against 16 bytes, whatever
// the row count.  The stage is bound by bytes: ~0.16 ms at 128 lanes x
// 2^18 and ~0.64 ms at 2^20 (3.35 TB/s), against ~0.03 and ~0.11 ms of
// operations (67 TFLOP/s).
//
// Design: one thread per (row, lane) element, grid-stride, neighbouring
// threads on neighbouring lanes so the block and the (5, S, C) tables are
// read coalesced.  Each element walks every table row with a compare and a
// select, the TPU kernel's gather-free form: ~10 operations and five table
// loads a row, work beyond the bound that grows with the row count.  Every
// product and sum is taken with a round-to-nearest
// intrinsic in the order of the plain version (dsp/elementwise.py:
// nco_mix_pair_tm), so nvcc contracts nothing into an FMA: a contracted
// ramp would move the phase by an ulp of ~6000 rad (~5e-4).  cos and sin
// are the accurate library functions (no fast math).  A lane with no
// active row gets phase 0 exactly, cos 1 and sin 0, and passes through
// bit for bit.  The banded front runs it as its own launch ahead of LPF1;
// the front (front.cu, B1) and the fused step (step.cu, B7) take the same
// row phase and rotation over only the rows that meet their tile
// (nco_mix_kept).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// One table row's phase at block row nrow, or +0 where the row is not
// active there: ph0 + m * adj + k * stp with nrow - st = k * 4096 + m, every
// product and sum rounded to nearest on its own.
__device__ __forceinline__ float nco_row_phase(float st, float en, float adj, float ph0, float stp,
                                               float nrow) {
  const bool active = nrow >= st && nrow < en;
  const float dd = __fsub_rn(nrow, st);
  const float kq = floorf(__fmul_rn(dd, 1.f / 4096.f));
  const float mq = __fsub_rn(dd, __fmul_rn(kq, 4096.f));
  const float ramp = __fadd_rn(__fadd_rn(ph0, __fmul_rn(mq, adj)), __fmul_rn(kq, stp));
  return active ? ramp : 0.f;
}

// (i, q) rotated by the phase ph.
__device__ __forceinline__ float2 nco_rotate(float ph, float i, float q) {
  const float cs = cosf(ph), sn = sinf(ph);
  return make_float2(__fsub_rn(__fmul_rn(i, cs), __fmul_rn(q, sn)),
                     __fadd_rn(__fmul_rn(i, sn), __fmul_rn(q, cs)));
}

// Lane c's sample (i, q) at block row nrow mixed by the table.  tab is
// (5, S, C): starts, ends, adjs, ph0s and the per-4096 coarse steps
// (float32 of mod(float64(adj) * 4096, 2 pi), computed by the wrapper);
// nrow is exact in float32 (the wrappers keep rows < 2^24).  The phase is
// +0 plus each row's term in row order; a row that is not active adds +0,
// which leaves the sum as it is (it is never -0), so a caller may skip the
// rows that are active nowhere in its range and get the same bits.
__device__ __forceinline__ float2 nco_mix_sample(const float* __restrict__ tab, int s_rows,
                                                 int lanes, int c, float nrow, float i,
                                                 float q) {
  const long long plane = (long long)s_rows * lanes;
  float ph = 0.f;
  for (int s = 0; s < s_rows; ++s) {
    const float* t = tab + (long long)s * lanes + c;
    ph = __fadd_rn(ph, nco_row_phase(t[0], t[plane], t[2 * plane], t[3 * plane], t[4 * plane], nrow));
  }
  return nco_rotate(ph, i, q);
}

// ---- the rows a tile meets: B1 (front.cu) and B7 (step.cu) mix a tile's
// samples by only the table rows active somewhere in it

constexpr int kNcoKeepRows = 4;  // Doppler rows a thread keeps for a tile

// The Doppler rows of one lane that are active somewhere in a tile's rows
// [r0, r1], in row order, up to kNcoKeepRows of them.  Rows that meet none
// of the tile's rows add +0 to every sample's phase, so leaving them out
// keeps the bits.
struct NcoKept {
  float st[kNcoKeepRows], en[kNcoKeepRows], adj[kNcoKeepRows], ph0[kNcoKeepRows], stp[kNcoKeepRows];
  int n;          // rows kept
  bool overflow;  // more than kNcoKeepRows: take every row (nco_mix_sample)
};

__device__ __forceinline__ void nco_keep_none(NcoKept& k) {
  k.n = 0;
  k.overflow = false;
}

// Keep row s of lane c of the (5, S, C) table tab (start st, end en) if it
// meets [r0, r1].  Called in row order.
__device__ __forceinline__ void nco_keep_row(const float* __restrict__ tab, int s_rows, int lanes, int c,
                                             int s, float st, float en, float r0, float r1, NcoKept& k) {
  if (!(st <= r1 && en > r0) || k.overflow) return;
  if (k.n == kNcoKeepRows) {
    k.overflow = true;
    return;
  }
  const long long plane = (long long)s_rows * lanes;
  const float* t = tab + (long long)s * lanes + c;
  const float adj = t[2 * plane], ph0 = t[3 * plane], stp = t[4 * plane];
#pragma unroll
  for (int j = 0; j < kNcoKeepRows; ++j) {  // slot k.n, named at compile time: no local memory
    if (j == k.n) {
      k.st[j] = st;
      k.en[j] = en;
      k.adj[j] = adj;
      k.ph0[j] = ph0;
      k.stp[j] = stp;
    }
  }
  ++k.n;
}

// Every row of lane c's table that meets [r0, r1], scanned from the table.
__device__ __forceinline__ void nco_keep_rows(const float* __restrict__ tab, int s_rows, int lanes, int c,
                                              float r0, float r1, NcoKept& k) {
  nco_keep_none(k);
  const long long plane = (long long)s_rows * lanes;
  for (int s = 0; s < s_rows && !k.overflow; ++s) {
    const float* t = tab + (long long)s * lanes + c;
    nco_keep_row(tab, s_rows, lanes, c, s, t[0], t[plane], r0, r1, k);
  }
}

// Lane c's sample (i, q) at block row nrow mixed by the kept rows, or by
// the whole table where the tile met more rows than a thread keeps: the
// bits of nco_mix_sample either way.
__device__ __forceinline__ float2 nco_mix_kept(const float* __restrict__ tab, int s_rows, int lanes,
                                               const NcoKept& k, int c, float nrow, float i, float q) {
  if (k.overflow) return nco_mix_sample(tab, s_rows, lanes, c, nrow, i, q);
  float ph = 0.f;
#pragma unroll
  for (int s = 0; s < kNcoKeepRows; ++s) {
    if (s < k.n) ph = __fadd_rn(ph, nco_row_phase(k.st[s], k.en[s], k.adj[s], k.ph0[s], k.stp[s], nrow));
  }
  return nco_rotate(ph, i, q);
}

// y (rows, 2C) = x mixed by the (5, S, C) table, one thread an element.
__global__ void nco_mix_tm_kernel(const float* __restrict__ x, int rows, int lanes,
                                  const float* __restrict__ tab, int s_rows,
                                  float* __restrict__ y) {
  const long long n = (long long)rows * lanes;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long k = idx / lanes;
    const int c = (int)(idx - k * lanes);
    const float* in = x + k * 2 * lanes;
    float* out = y + k * 2 * lanes;
    const float2 m = nco_mix_sample(tab, s_rows, lanes, c, (float)k, in[c], in[lanes + c]);
    out[c] = m.x;
    out[lanes + c] = m.y;
  }
}

cudaError_t launch_nco_mix(const float* x, int rows, int lanes, const float* tab,
                           int s_rows, float* y, cudaStream_t stream) {
  const long long n = (long long)rows * lanes;
  const long long want = (n + 255) / 256;
  const int grid = (int)(want < 8192 ? want : 8192);
  nco_mix_tm_kernel<<<grid, 256, 0, stream>>>(x, rows, lanes, tab, s_rows, y);
  return cudaGetLastError();
}

}  // namespace
