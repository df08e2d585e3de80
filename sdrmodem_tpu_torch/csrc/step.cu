// The fused demodulator step (B7): the front end ([Doppler NCO mix] ->
// LPF1 -> quadrature demod -> LPF2 (decimating) -> DC blocker) and the
// Mueller & Mueller clock over one full block of time-major f32 IQ, in one
// launch, with the decimated stream y3 kept in shared memory.
//
// Replaces the TPU kernel sdrmodem_tpu/ops/pallas_step.py:_fused_step_kernel
// (wrapper fused_step_call).  It gives the bits of the front end (front.cu,
// B1) followed by the chunked clock (clock.cu, B2): every stage sums
// through the same device functions (nco.cuh, fir.cuh, quad.cuh,
// mm_step.cuh) in the same order, and it walks each clock chunk through
// B2's own chunk walk (mm_chunk.cuh), in the same partition.
//
// Bound on an H100: the front's bound (front.cu: ~1.5 ms of f32 operations
// at 128 lanes x 2^20 with the lucky7 taps) plus the bytes of the IQ block
// in and the symbols out; y3 never leaves the chip, so it costs nothing.
// The clock adds a few tens of operations a symbol.  What bounds the clock
// is neither: each lane is one chain of dependent symbols.
//
// Design: a plain first version.  One thread block owns one lane for the
// whole block of samples, so blocks never wait on one another and any
// number of lanes works.  The block walks the time tiles of r = d * chunk
// input rows, software-pipelined: in iteration g, eight producer warps run
// the front for tile g into one of two y3 slots in shared memory, while
// one thread of a ninth warp walks the clock over chunk g - 1 in the other
// slot; a __syncthreads swaps them.  The producers order their own stages
// with a named barrier that the clock's warp never waits on.  Each slot
// holds [the previous chunk's last sfx rows | the chunk], the clock's
// window over [suffix | y3].  Every FIR keeps its history in front of its
// tile in shared memory and reads [history | tile] contiguously; after a
// tile, the last (taps - 1) rows move to the front.
//
// Shared memory for one lane at d = 2, chunk 1024 with the lucky7 taps
// (157 / 57 / 637): the mixed input with LPF1's history 2 x 2204 floats,
// LPF1's output 2 x 2048, the quad-demod output with LPF2's history 2104,
// LPF2's output with the DC history 1660, two y3 slots 2 x 1088, the taps
// 851, the clock's 129 x 8 bank 1032 and the arctangent table 257: about
// 66 KB (Layout below), within the 227 KB a block can have.  The nan
// fixture's taps (589 / 289 / 3197, d = 1) take about 74 KB.
//
// Every FIR waits on a shared-memory load a tap for its sample and one for
// its tap; register-blocking rows, and more than one lane a block where
// lanes are many, are the next steps.

#include <cuda_runtime.h>
#include <math.h>

#include "fir.cuh"
#include "mm_chunk.cuh"
#include "nco.cuh"
#include "quad.cuh"

namespace {

constexpr int kProducers = 256;            // the front's threads: 8 warps
constexpr int kThreads = kProducers + 32;  // and one warp whose first thread walks the clock
constexpr int kClockThread = kProducers;
constexpr int kMaxSharedBytes = 232448;  // what one block may have on an H100 (227 KB)

struct StepParams {
  const float* x;
  int block, lanes;
  const float* dop;  // (5, S, C) NCO table, or null
  int dop_rows;
  const float *lpf1_hist, *rev1;
  int t1;
  const float* quad_prev;
  float quad_gain;
  const float* atan_table;
  const float *lpf2_hist, *rev2;
  int t2, decim;
  const float *dc_hist, *rev_dc;  // null with t3 == 0
  int t3;
  const float* suffix;
  int sfx;
  const float *omega, *mu, *last;
  const int* resid;
  const float* bank;
  int chunk, k_max;
  MmParams mm;
  float* outs;  // (n_chunks, k_max, C)
  int* counts;  // (n_chunks, C)
  float *lpf1_out, *quad_out, *lpf2_out, *dc_out;
  float *omega_out, *mu_out, *last_out;
  int* resid_out;
  float* suffix_out;
};

// One lane's shared memory, in floats; the host sizes the launch with it.
struct Layout {
  int bank, table, dop, tap1, tap2, tap3, xi, xq, y1i, y1q, qp, yq, y2, slots, slot_rows, total;

  __host__ __device__ Layout(int t1, int t2, int t3, int d, int chunk, int sfx, int dop_rows) {
    const int r = d * chunk;
    int o = 0;
    bank = o, o += kMmBankSize;
    table = o, o += kAtanTableSize;
    dop = o, o += 5 * dop_rows;
    tap1 = o, o += t1;
    tap2 = o, o += t2;
    tap3 = o, o += t3;
    xi = o, o += t1 - 1 + r;  // [LPF1 history | mixed tile], I and Q
    xq = o, o += t1 - 1 + r;
    y1i = o, o += r;  // LPF1's output
    y1q = o, o += r;
    qp = o, o += 2;        // the carried LPF1 row before the tile
    yq = o, o += t2 - 1 + r;  // [LPF2 history | quad-demod output]
    y2 = o, o += t3 > 0 ? t3 - 1 + chunk : 0;  // [DC history | LPF2 output]
    slot_rows = sfx + chunk;  // [the previous chunk's last sfx rows | y3 of the chunk]
    slots = o, o += 2 * slot_rows;
    total = o;
  }
};

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
}

// buf[0, h) = buf[n, n + h): the last h rows of [history | n new rows]
// become the history.  Strips of n rows, each after the last one's reads.
// The caller syncs after it.
__device__ __forceinline__ void shift_history(float* buf, int h, int n, int pt) {
  for (int base = 0; base < h; base += n) {
    if (base > 0) producers_sync();
    const int m = min(n, h - base);
    for (int i = pt; i < m; i += kProducers) buf[base + i] = buf[base + n + i];
  }
}

// The front end over tile g (input rows [g r, (g + 1) r)) of lane c, y3
// into slot[sfx, sfx + chunk); pt is the producer's index.
__device__ void front_tile(const StepParams& p, const Layout& L, float* sm, int g, int pt) {
  const int c = blockIdx.x, lanes = p.lanes;
  const int d = p.decim, chunk = p.chunk, r = d * chunk, sfx = p.sfx;
  const int h1 = p.t1 - 1, h2 = p.t2 - 1, h3 = p.t3 > 0 ? p.t3 - 1 : 0;
  float *xi = sm + L.xi, *xq = sm + L.xq, *y1i = sm + L.y1i, *y1q = sm + L.y1q;
  float *qp = sm + L.qp, *yq = sm + L.yq, *y2 = sm + L.y2;
  float* slot = sm + L.slots + (g & 1) * L.slot_rows;

  // the tile, mixed by the lane's Doppler rows at its rows of the block
  for (int k = pt; k < r; k += kProducers) {
    const long long row = (long long)g * r + k;
    const float* in = p.x + row * 2 * lanes;
    float i = in[c], q = in[lanes + c];
    if (p.dop != nullptr) {
      const float2 m = nco_mix_sample(sm + L.dop, p.dop_rows, 1, 0, (float)row, i, q);
      i = m.x;
      q = m.y;
    }
    xi[h1 + k] = i;
    xq[h1 + k] = q;
  }
  if (g > 0) {  // the clock's window reaches back sfx rows into chunk g - 1
    const float* prev = sm + L.slots + ((g - 1) & 1) * L.slot_rows;
    for (int k = pt; k < sfx; k += kProducers) slot[k] = prev[chunk + k];
  }
  producers_sync();

  const float* tap1 = sm + L.tap1;
  for (int k = pt; k < r; k += kProducers) {
    y1i[k] = fir_dot(tap1, 0, p.t1, xi + k, 1, 0.f);
    y1q[k] = fir_dot(tap1, 0, p.t1, xq + k, 1, 0.f);
  }
  producers_sync();

  const float* table = sm + L.table;
  for (int k = pt; k < r; k += kProducers) {
    const float si = k == 0 ? qp[0] : y1i[k - 1];
    const float sq = k == 0 ? qp[1] : y1q[k - 1];
    yq[h2 + k] = quad_demod_sample(y1i[k], y1q[k], si, sq, table, p.quad_gain);
  }
  shift_history(xi, h1, r, pt);  // LPF1's reads are done
  shift_history(xq, h1, r, pt);
  producers_sync();

  const float* tap2 = sm + L.tap2;
  float* y2_out = p.t3 > 0 ? y2 + h3 : slot + sfx;
  for (int k = pt; k < chunk; k += kProducers) y2_out[k] = fir_dot(tap2, 0, p.t2, yq + k * d, 1, 0.f);
  if (pt == 0) {  // the next tile's quad demod starts from this tile's last LPF1 row
    qp[0] = y1i[r - 1];
    qp[1] = y1q[r - 1];
  }
  producers_sync();
  shift_history(yq, h2, r, pt);
  if (p.t3 > 0) {
    const float* tap3 = sm + L.tap3;
    for (int k = pt; k < chunk; k += kProducers) slot[sfx + k] = fir_dot(tap3, 0, p.t3, y2 + k, 1, 0.f);
    producers_sync();
    shift_history(y2, h3, chunk, pt);
  }
}

// The clock over chunk t of lane c from the slot that holds its work
// buffer [the previous chunk's last sfx rows | the chunk], walked as B2
// walks it (mm_chunk.cuh), the read position s.ii in the slot's rows.
__device__ void clock_chunk(const StepParams& p, const float* bank, const float* slot, int t,
                            MmLane& s) {
  const int c = blockIdx.x, lanes = p.lanes, k_max = p.k_max;
  float* outs = p.outs + (long long)t * k_max * lanes + c;
  const int cnt = mm_chunk(bank, p.mm, s, slot, p.sfx + p.chunk, p.sfx, k_max, outs, lanes);
  p.counts[(long long)t * lanes + c] = cnt;
  for (int k = cnt; k < k_max; ++k) outs[(long long)k * lanes] = 0.f;
}

__global__ void __launch_bounds__(kThreads) fused_step_kernel(const StepParams p) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, lanes = p.lanes, tid = threadIdx.x;
  const int chunk = p.chunk, sfx = p.sfx, r = p.decim * chunk;
  const int h1 = p.t1 - 1, h2 = p.t2 - 1, h3 = p.t3 > 0 ? p.t3 - 1 : 0;
  const Layout L(p.t1, p.t2, p.t3, p.decim, chunk, sfx, p.dop_rows);
  const int n_tiles = p.block / r;

  // constants, the lane's Doppler rows and the carried state in
  for (int j = tid; j < kAtanTableSize; j += kThreads) sm[L.table + j] = p.atan_table[j];
  for (int j = tid; j < p.t1; j += kThreads) sm[L.tap1 + j] = p.rev1[j];
  for (int j = tid; j < p.t2; j += kThreads) sm[L.tap2 + j] = p.rev2[j];
  for (int j = tid; j < p.t3; j += kThreads) sm[L.tap3 + j] = p.rev_dc[j];
  for (int j = tid; j < 5 * p.dop_rows; j += kThreads) sm[L.dop + j] = p.dop[(long long)j * lanes + c];
  for (int k = tid; k < h1; k += kThreads) {
    sm[L.xi + k] = p.lpf1_hist[(long long)k * 2 * lanes + c];
    sm[L.xq + k] = p.lpf1_hist[(long long)k * 2 * lanes + lanes + c];
  }
  for (int k = tid; k < h2; k += kThreads) sm[L.yq + k] = p.lpf2_hist[(long long)k * lanes + c];
  for (int k = tid; k < h3; k += kThreads) sm[L.y2 + k] = p.dc_hist[(long long)k * lanes + c];
  for (int k = tid; k < sfx; k += kThreads) sm[L.slots + k] = p.suffix[(long long)k * lanes + c];
  if (tid == 0) {
    sm[L.qp] = p.quad_prev[c];
    sm[L.qp + 1] = p.quad_prev[lanes + c];
  }
  mm_load_bank(sm + L.bank, p.bank);  // ends with __syncthreads

  // the read position in chunk 0's slot [suffix | chunk 0]
  MmLane s{p.omega[c], p.mu[c], p.last[c], (long long)sfx - p.resid[c]};
  for (int g = 0; g <= n_tiles; ++g) {
    if (tid < kProducers) {
      if (g < n_tiles) front_tile(p, L, sm, g, tid);
    } else if (tid == kClockThread && g > 0) {
      clock_chunk(p, sm + L.bank, sm + L.slots + ((g - 1) & 1) * L.slot_rows, g - 1, s);
    }
    __syncthreads();
  }

  // the clock state and the front's histories out
  if (tid == kClockThread) {
    p.omega_out[c] = s.omega;
    p.mu_out[c] = s.mu;
    p.last_out[c] = s.last;
    p.resid_out[c] = (int)(sfx - s.ii);  // the last chunk's hand-off
  }
  const float* last_slot = sm + L.slots + ((n_tiles - 1) & 1) * L.slot_rows;
  for (int k = tid; k < sfx; k += kThreads) p.suffix_out[(long long)k * lanes + c] = last_slot[chunk + k];
  for (int k = tid; k < h1; k += kThreads) {
    p.lpf1_out[(long long)k * 2 * lanes + c] = sm[L.xi + k];
    p.lpf1_out[(long long)k * 2 * lanes + lanes + c] = sm[L.xq + k];
  }
  for (int k = tid; k < h2; k += kThreads) p.lpf2_out[(long long)k * lanes + c] = sm[L.yq + k];
  for (int k = tid; k < h3; k += kThreads) p.dc_out[(long long)k * lanes + c] = sm[L.y2 + k];
  if (tid == 0) {
    p.quad_out[c] = sm[L.qp];
    p.quad_out[lanes + c] = sm[L.qp + 1];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory one block takes at these sizes.
extern "C" int step_shared_bytes(int t1, int t2, int t3, int decim, int chunk, int sfx,
                                 int dop_rows) {
  return Layout(t1, t2, t3, decim, chunk, sfx, dop_rows).total * (int)sizeof(float);
}

// One full block, front and clock.  x is (block, 2C) with block a multiple
// of decim * chunk; the histories are (taps - 1, lanes) in the
// DemodStateFull layout and the taps reversed; dop is the (5, S, C) NCO
// table or null; suffix (sfx, C) and the per-lane clock state (C,); bank
// (129, 8).  Writes outs (n_chunks, k_max, C), counts (n_chunks, C), the
// four histories, the clock state and the next suffix (sfx, C).  With t3
// == 0 there is no DC stage and dc_hist, rev_dc and dc_out are unused.
// Returns cudaGetLastError() after the launch.
extern "C" int step_forward(const float* x, int block, int lanes, const float* dop, int dop_rows,
                            const float* lpf1_hist, const float* rev1, int t1,
                            const float* quad_prev, float quad_gain, const float* atan_table,
                            const float* lpf2_hist, const float* rev2, int t2, int decim,
                            const float* dc_hist, const float* rev_dc, int t3,
                            const float* suffix, int sfx, const float* omega, const float* mu,
                            const float* last, const int* resid, const float* bank, int chunk,
                            int k_max, float omega_mid, float omega_lim, float gain_omega,
                            float gain_mu, float* outs, int* counts, float* lpf1_out,
                            float* quad_out, float* lpf2_out, float* dc_out, float* omega_out,
                            float* mu_out, float* last_out, int* resid_out, float* suffix_out,
                            void* stream_handle) {
  if (dop == nullptr) dop_rows = 0;
  const int bytes = step_shared_bytes(t1, t2, t3, decim, chunk, sfx, dop_rows);
  if (bytes > kMaxSharedBytes || lanes < 1 || chunk < sfx || block % (decim * chunk) != 0 ||
      block < decim * chunk) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(fused_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const StepParams p{x, block, lanes, dop, dop_rows,
                     lpf1_hist, rev1, t1, quad_prev, quad_gain, atan_table,
                     lpf2_hist, rev2, t2, decim, dc_hist, rev_dc, t3,
                     suffix, sfx, omega, mu, last, resid, bank, chunk, k_max,
                     MmParams{omega_mid, omega_lim, gain_omega, gain_mu},
                     outs, counts, lpf1_out, quad_out, lpf2_out, dc_out,
                     omega_out, mu_out, last_out, resid_out, suffix_out};
  fused_step_kernel<<<lanes, kThreads, bytes, static_cast<cudaStream_t>(stream_handle)>>>(p);
  return cudaGetLastError();
}
