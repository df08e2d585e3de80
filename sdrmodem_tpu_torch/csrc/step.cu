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
// Bound on an H100: the front's operations (front.cu: ~1.5 ms of f32 work
// at 128 lanes x 2^20 with the lucky7 taps, ~4.3 ms with the DC blocker
// as the 637-tap FIR this kernel runs) plus the bytes of the IQ block in
// and the symbols out; y3 never leaves the chip.  What bounds the whole is
// neither: each lane's clock is one chain of dependent symbol steps
// (~105k a lane at 2^20 rows), so the floor is that chain, B2's time
// alone at the same shape.  The front exists to hide under it.
//
// Design: one thread block owns one lane for the whole block of samples
// (the clock chain runs through it), so blocks never wait on one another
// and any number of lanes works.  The block walks tiles of r = d * chunk
// input rows, software-pipelined: in iteration g, eight producer warps run
// the front for tile g into one of two y3 slots in shared memory while
// thread 0 of warp 3 walks the clock over chunk g - 1 in the other; one
// __syncthreads a tile hands them over.  Each slot holds [the previous
// chunk's last sfx rows | the chunk], the chunk's work buffer.  A block's
// warp w issues from sub-partition (s + w) % 4 of its SM, s fixed for the
// block (step_split.py reads it), and no producer sits on the walker's:
// a walker that shares its sub-partition with busy producer warps waits
// for issue slots at every dependent step, ~0.18-0.21 us a step against
// B2's 0.124.  A second block on the same SM puts its producers there
// (step_split.py at 264 lanes), so past one block an SM the walkers pace
// the kernel.  The producers run the front as B1 and B3 run it:
//   - the tile's raw rows are staged a tile ahead by cp.async into a
//     buffer of their own; each producer mixes the rows it staged by the
//     Doppler rows that meet the tile (nco.cuh: nco_keep_rows), picked
//     from the lane's rows that meet the block, copied once into shared
//     memory (the whole table in device memory past kDopRows of them):
//     the raw rows' 4-byte copies would evict a table read through L1;
//   - LPF1 runs on I and Q together through fir_block (fir.cuh), R1 rows a
//     thread plus the row before them, taps broadcast from shared memory,
//     so each input load feeds R1 + 1 multiply-adds; the quad demod runs
//     on those rows in registers (a group's first row against the row
//     before it, the tile's first against the carried row);
//   - LPF2 at its stride and the DC FIR take kRows outputs a thread the
//     same way.  Every R is odd, so a warp's 32 windows at stride 1 start
//     in 32 different banks.
// Three producer barriers a tile (two without a DC stage).  Every FIR
// keeps its history in front of its tile and reads [history | tile]
// contiguously; the histories move to the front of their buffers as
// float4, LPF1's after its reads, LPF2's and the DC's at the start of the
// next tile.
//
// Shared memory for one lane at d = 2, chunk 1024 with the lucky7 taps
// (157 / 57 / 637): the staged tile 2 x 2048 floats, [history | mixed
// tile] 2 x 2220, [history | quad demod] 2120, [history | LPF2] 1672, two
// y3 slots 2 x 1088, the taps 860, the Doppler rows 164, the clock's
// 129 x 8 bank 1032 and the arctangent table 260: 67,296 bytes (Layout
// below; ops/step.py:step_plan sums the same).  With 96 registers a
// thread, two blocks share an SM where lanes outnumber SMs.

#include <cuda_runtime.h>
#include <math.h>

#include "fir.cuh"
#include "mm_chunk.cuh"
#include "nco.cuh"
#include "quad.cuh"
#include "stage.cuh"

namespace {

constexpr int kMaxSharedBytes = 232448;  // what one block may have on an H100 (227 KB)
constexpr int kPad = 12;                 // rows past LPF1's tile that discarded outputs read
constexpr int kDopRows = 32;             // the lane's Doppler rows kept in shared memory, at most
constexpr int kWalkerWarp = 3;           // the walker's warp, alone on its sub-partition

// Eight producer warps on three sub-partitions (warp w issues from (s + w)
// % 4), the walker in warp 3 and warp 7 idle on the fourth, so the
// walker's dependent steps never queue for an issue slot behind its own
// block's front.
constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kProducers = 256;  // the threads of warps w % 4 != 3
constexpr int kRows = 5;         // LPF2 and DC outputs a thread (odd)

// LPF1 rows a thread, odd: a tile's rows over the producers, about once.
__host__ __device__ constexpr int rows1(int d) { return d == 1 ? 5 : 9; }

// The producer index of thread (warp w, lane), or -1.
__device__ __forceinline__ int producer(int w, int lane) { return w % 4 == 3 ? -1 : (w - (w + 1) / 4) * 32 + lane; }

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

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

// One lane's shared memory, in floats, every region a multiple of 4; the
// host sizes the launch with it (ops/step.py:step_plan sums the same).
struct Layout {
  int bank, table, tap1, tap2, tap3, dop, raw, xi, xq, yq, y2, qp, slots, slot_rows, total;

  __host__ __device__ Layout(int t1, int t2, int t3, int d, int chunk, int sfx) {
    const int r = d * chunk;
    int o = 0;
    bank = o, o += kMmBankSize;
    table = o, o += round4(kAtanTableSize);
    tap1 = o, o += round4(t1);
    tap2 = o, o += round4(t2);
    tap3 = o, o += round4(t3);
    dop = o, o += round4(5 * kDopRows + 1);  // the lane's rows that meet the block, (5, kDopRows), and their count
    raw = o, o += 2 * r;  // the staged tile, I rows then Q rows
    // [the row before | LPF1 history | mixed tile | pad], I and Q; the
    // history starts 4 floats in, so row -1 is addressable and stays aligned
    xi = o, o += round4(4 + t1 - 1 + r + kPad);
    xq = o, o += round4(4 + t1 - 1 + r + kPad);
    yq = o, o += round4(t2 - 1 + r + kRows * d + 4);  // [LPF2 history | quad demod | pad]
    y2 = o, o += t3 > 0 ? round4(t3 - 1 + chunk + kRows + 4) : 0;  // [DC history | LPF2 | pad]
    qp = o, o += 4;  // the LPF1 row before the tile, I and Q, by tile parity
    slot_rows = round4(sfx + chunk);  // [the previous chunk's last sfx rows | y3 of the chunk]
    slots = o, o += 2 * slot_rows;
    total = o;
  }
};

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
}

// buf[0, h) = buf[n, n + h): the last h rows of [history | n new rows]
// become the history, as float4 (buf 16-byte aligned, n a multiple of 4),
// in strips of n rows, each after the last one's reads.  Up to 3 floats
// past h are written too, rows the next tile writes before it reads them.
__device__ __forceinline__ void shift_history(float* buf, int h, int n, int pt) {
  for (int base = 0; base < h; base += n) {
    if (base > 0) producers_sync();
    const int m4 = (min(n, h - base) + 3) >> 2;
    float4* dst = reinterpret_cast<float4*>(buf + base);
    const float4* src = reinterpret_cast<const float4*>(buf + base + n);
    for (int i = pt; i < m4; i += kProducers) dst[i] = src[i];
  }
}

// Stages tile g's raw rows of lane c that producer pt mixes: rows pt,
// pt + kProducers, ... of the tile, I into raw[k] and Q into raw[r + k].
__device__ __forceinline__ void stage_tile(const StepParams& p, float* raw, int g, int r, int pt) {
  const int c = blockIdx.x, lanes = p.lanes;
  asm volatile("" ::: "memory");  // after this thread's reads of the rows it restages
  for (int k = pt; k < r; k += kProducers) {
    const float* in = p.x + ((long long)g * r + k) * 2 * lanes + c;
    cp_async4(raw + k, in);
    cp_async4(raw + r + k, in + lanes);
  }
  cp_async_commit();
}

// The lane's Doppler rows that meet the block, in row order, into dop (all
// zeros) as a (5, kDopRows, 1) table, and after it their count, or -1
// where more than kDopRows meet it (the tiles then read the whole table).
// Rows that meet no row of the block, and the zero rows, add +0 to every
// phase, so the compact table gives the same bits.
__device__ __forceinline__ void keep_block_rows(const StepParams& p, float* dop) {
  const int c = blockIdx.x;
  const long long plane = (long long)p.dop_rows * p.lanes;
  const float last = (float)(p.block - 1);
  int n = 0;
  for (int s = 0; s < p.dop_rows && n >= 0; ++s) {
    const float* t = p.dop + (long long)s * p.lanes + c;
    if (!(t[0] <= last && t[plane] > 0.f)) continue;
    if (n == kDopRows) {
      n = -1;
    } else {
      for (int j = 0; j < 5; ++j) dop[j * kDopRows + n] = t[j * plane];
      ++n;
    }
  }
  dop[5 * kDopRows] = (float)n;
}

// The front end over tile g (input rows [g r, (g + 1) r)) of lane c, y3
// into slot[sfx, sfx + chunk); pt is the producer's index.
template <int D>
__device__ __forceinline__ void front_tile(const StepParams& p, const Layout& L, float* sm, int g,
                                           int n_tiles, int pt) {
  constexpr int R1 = rows1(D), R = kRows, P = kProducers;
  const int c = blockIdx.x;
  const int d = D == 0 ? p.decim : D, chunk = p.chunk, r = d * chunk, sfx = p.sfx;
  const int h1 = p.t1 - 1, h2 = p.t2 - 1, h3 = p.t3 > 0 ? p.t3 - 1 : 0;
  float *raw = sm + L.raw, *xi = sm + L.xi + 4, *xq = sm + L.xq + 4, *yq = sm + L.yq, *y2 = sm + L.y2;
  float* slot = sm + L.slots + (g & 1) * L.slot_rows;
  const float *tap1 = sm + L.tap1, *tap2 = sm + L.tap2, *tap3 = sm + L.tap3, *table = sm + L.table;

  // (1) the last tile's LPF2 and DC inputs become histories; this
  // producer's rows of the staged tile, mixed by the Doppler rows that
  // meet the tile, into [LPF1 history | tile]; the next tile staged into
  // the same rows; the clock's window reaches back sfx rows into chunk g - 1
  if (g > 0) {
    shift_history(yq, h2, r, pt);
    if (p.t3 > 0) shift_history(y2, h3, chunk, pt);
  }
  cp_async_wait_all();
  if (p.dop != nullptr) {
    const long long r0 = (long long)g * r;
    // the compact table in shared memory (its unused rows zeros, active
    // nowhere), or the whole one in device memory
    const bool compact = sm[L.dop + 5 * kDopRows] >= 0.f;
    const float* tab = compact ? sm + L.dop : p.dop;
    const int s_rows = compact ? kDopRows : p.dop_rows, lanes = compact ? 1 : p.lanes, col = compact ? 0 : c;
    NcoKept kept;
    nco_keep_rows(tab, s_rows, lanes, col, (float)r0, (float)(r0 + r - 1), kept);
    for (int k = pt; k < r; k += P) {
      const float2 m = nco_mix_kept(tab, s_rows, lanes, kept, col, (float)(r0 + k), raw[k], raw[r + k]);
      xi[h1 + k] = m.x;
      xq[h1 + k] = m.y;
    }
  } else {
    for (int k = pt; k < r; k += P) {
      xi[h1 + k] = raw[k];
      xq[h1 + k] = raw[r + k];
    }
  }
  if (g + 1 < n_tiles) stage_tile(p, raw, g + 1, r, pt);
  if (g > 0) {
    const float* prev = sm + L.slots + ((g - 1) & 1) * L.slot_rows;
    for (int k = pt; k < sfx; k += P) slot[k] = prev[chunk + k];
  }
  producers_sync();

  // (2) LPF1 on I and Q, rows [s, s + R1] of each group, s = grp R1 - 1,
  // and the quad demod of rows [s + 1, s + R1] in registers; group 0's
  // row before is the carried one
  const float* qp_in = sm + L.qp + 2 * (g & 1);
  float* qp_out = sm + L.qp + 2 * ((g + 1) & 1);
  for (int grp = pt; grp * R1 < r; grp += P) {
    const int s = grp * R1 - 1;
    float acc[2][R1 + 1];
    fir_block<R1 + 1, 1, 2>(tap1, p.t1, 1, [&](int m, int ch) { return (ch == 0 ? xi : xq)[s + m]; }, acc);
    if (grp == 0) {
      acc[0][0] = qp_in[0];
      acc[1][0] = qp_in[1];
    }
#pragma unroll
    for (int u = 1; u <= R1; ++u) {
      const int k = s + u;
      if (k < r) {
        yq[h2 + k] = quad_demod_sample(acc[0][u], acc[1][u], acc[0][u - 1], acc[1][u - 1], table, p.quad_gain);
      }
      if (k == r - 1) {  // the next tile's row before
        qp_out[0] = acc[0][u];
        qp_out[1] = acc[1][u];
      }
    }
  }
  producers_sync();

  // (3) LPF1's history for the next tile; LPF2 at its stride into [DC
  // history | tile] (straight into the slot without a DC stage)
  shift_history(xi, h1, r, pt);
  shift_history(xq, h1, r, pt);
  float* out2 = p.t3 > 0 ? y2 + h3 : slot + sfx;
  for (int grp = pt; grp * R < chunk; grp += P) {
    const int m0 = grp * R;
    float acc[1][R];
    fir_block<R, D, 1>(tap2, p.t2, d, [&](int m, int) { return yq[m0 * d + m]; }, acc);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (m0 + u < chunk) out2[m0 + u] = acc[0][u];
    }
  }
  if (p.t3 == 0) return;
  producers_sync();

  // (4) the DC blocker's FIR into the slot
  for (int grp = pt; grp * R < chunk; grp += P) {
    const int m0 = grp * R;
    float acc[1][R];
    fir_block<R, 1, 1>(tap3, p.t3, 1, [&](int m, int) { return y2[m0 + m]; }, acc);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (m0 + u < chunk) slot[sfx + m0 + u] = acc[0][u];
    }
  }
}

// The clock over chunk t of lane c from the slot that holds its work
// buffer [the previous chunk's last sfx rows | the chunk], walked as B2
// walks it (mm_chunk.cuh), the read position s.ii in the slot's rows.
__device__ __forceinline__ void clock_chunk(const StepParams& p, const float* bank, const float* slot, int t,
                                            MmLane& s) {
  const int c = blockIdx.x, lanes = p.lanes, k_max = p.k_max;
  float* outs = p.outs + (long long)t * k_max * lanes + c;
  const int cnt = mm_chunk(bank, p.mm, s, slot, p.sfx + p.chunk, p.sfx, k_max, outs, lanes);
  p.counts[(long long)t * lanes + c] = cnt;
  for (int k = cnt; k < k_max; ++k) outs[(long long)k * lanes] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) fused_step_kernel(const StepParams p) {
  extern __shared__ float4 step_sm4[];
  float* sm = reinterpret_cast<float*>(step_sm4);
  const int c = blockIdx.x, lanes = p.lanes, tid = threadIdx.x;
  const int pt = producer(tid / 32, tid % 32);
  const bool walker = tid == 32 * kWalkerWarp;
  const int chunk = p.chunk, sfx = p.sfx, r = p.decim * chunk;
  const int h1 = p.t1 - 1, h2 = p.t2 - 1, h3 = p.t3 > 0 ? p.t3 - 1 : 0;
  const Layout L(p.t1, p.t2, p.t3, p.decim, chunk, sfx);
  const int n_tiles = p.block / r;

  // every float defined (discarded outputs read the pads), then tile 0 in
  // flight while the constants and the carried state come in
  for (int j = tid; j < L.total; j += kThreads) sm[j] = 0.f;
  __syncthreads();
  if (pt >= 0) stage_tile(p, sm + L.raw, 0, r, pt);
  if (walker && p.dop != nullptr) keep_block_rows(p, sm + L.dop);
  for (int j = tid; j < kAtanTableSize; j += kThreads) sm[L.table + j] = p.atan_table[j];
  for (int j = tid; j < p.t1; j += kThreads) sm[L.tap1 + j] = p.rev1[j];
  for (int j = tid; j < p.t2; j += kThreads) sm[L.tap2 + j] = p.rev2[j];
  for (int j = tid; j < p.t3; j += kThreads) sm[L.tap3 + j] = p.rev_dc[j];
  for (int k = tid; k < h1; k += kThreads) {
    sm[L.xi + 4 + k] = p.lpf1_hist[(long long)k * 2 * lanes + c];
    sm[L.xq + 4 + k] = p.lpf1_hist[(long long)k * 2 * lanes + lanes + c];
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
    if (pt >= 0) {
      if (g < n_tiles) {
        front_tile<D>(p, L, sm, g, n_tiles, pt);
      } else {  // the last tile's LPF2 and DC inputs become the histories
        shift_history(sm + L.yq, h2, r, pt);
        if (p.t3 > 0) shift_history(sm + L.y2, h3, chunk, pt);
      }
    } else if (walker && g > 0) {
      clock_chunk(p, sm + L.bank, sm + L.slots + ((g - 1) & 1) * L.slot_rows, g - 1, s);
    }
    __syncthreads();
  }

  // the clock state and the front's histories out
  if (walker) {
    p.omega_out[c] = s.omega;
    p.mu_out[c] = s.mu;
    p.last_out[c] = s.last;
    p.resid_out[c] = (int)(sfx - s.ii);  // the last chunk's hand-off
  }
  const float* last_slot = sm + L.slots + ((n_tiles - 1) & 1) * L.slot_rows;
  for (int k = tid; k < sfx; k += kThreads) p.suffix_out[(long long)k * lanes + c] = last_slot[chunk + k];
  for (int k = tid; k < h1; k += kThreads) {
    p.lpf1_out[(long long)k * 2 * lanes + c] = sm[L.xi + 4 + k];
    p.lpf1_out[(long long)k * 2 * lanes + lanes + c] = sm[L.xq + 4 + k];
  }
  for (int k = tid; k < h2; k += kThreads) p.lpf2_out[(long long)k * lanes + c] = sm[L.yq + k];
  for (int k = tid; k < h3; k += kThreads) p.dc_out[(long long)k * lanes + c] = sm[L.y2 + k];
  if (tid == 0) {
    const float* qp = sm + L.qp + 2 * (n_tiles & 1);
    p.quad_out[c] = qp[0];
    p.quad_out[lanes + c] = qp[1];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory one block takes at these sizes.
extern "C" int step_shared_bytes(int t1, int t2, int t3, int decim, int chunk, int sfx) {
  return Layout(t1, t2, t3, decim, chunk, sfx).total * (int)sizeof(float);
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
  const int bytes = step_shared_bytes(t1, t2, t3, decim, chunk, sfx);
  if (bytes > kMaxSharedBytes || lanes < 1 || decim < 1 || t1 < 1 || t2 < 1 || t3 < 0 || chunk % 8 != 0 ||
      chunk < sfx || block % (decim * chunk) != 0 || block < decim * chunk) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decim == 1 ? fused_step_kernel<1> : decim == 2 ? fused_step_kernel<2> : fused_step_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const StepParams p{x, block, lanes, dop, dop_rows,
                     lpf1_hist, rev1, t1, quad_prev, quad_gain, atan_table,
                     lpf2_hist, rev2, t2, decim, dc_hist, rev_dc, t3,
                     suffix, sfx, omega, mu, last, resid, bank, chunk, k_max,
                     MmParams{omega_mid, omega_lim, gain_omega, gain_mu},
                     outs, counts, lpf1_out, quad_out, lpf2_out, dc_out,
                     omega_out, mu_out, last_out, resid_out, suffix_out};
  kernel<<<lanes, kThreads, bytes, static_cast<cudaStream_t>(stream_handle)>>>(p);
  return cudaGetLastError();
}
