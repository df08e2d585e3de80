// GFSK TX: NRZ bits -> polyphase Gaussian FIR (interpolation I, k taps a
// phase) -> VCO phase prefix -> cos/sin, written as interleaved complex64
// samples, with sample n*I + i for NRZ row n and polyphase phase i.
//
// Replaces the TPU kernels sdrmodem_tpu/ops/pallas_tx.py:_tx_folded_kernel
// (B5, wrapper gfsk_tx_call_folded: one stream, the server's TX path) and
// _tx_kernel (B6, wrapper gfsk_tx_call: streams on lanes, time-major).
// The TPU kernels fold the stream across 128 lanes, prefix-sum with
// triangular float32 matrix products and keep the running phase in float32
// (~1e-3 rad off the float64 chain over a 32 KiB payload at I = 60).  None
// of that is carried over: here the phase prefix is float64 throughout,
// kept in [0, 2 pi) before the cast to float32 and the precise sincosf, so
// the kernels follow the float64 chain (dsp/elementwise.py:
// freq_mod_stream_pair) at any length.
//
// Bound on an H100: by bytes.  A sample is written once (8 bytes of
// complex64) from ~2k + 1 flops of FIR and increment, ~40 of sincos and a
// few float64 operations of prefix and wrap, far below the rates; the input
// is 1/8 byte a bit (B5, packed) or 4 bytes a row-lane (B6).  32 KiB at
// I = 60 is 126 MB written, ~38 us at 3.35 TB/s.
//
// What held the first port back (three launches a call, each increment
// computed twice, an integer division, ten global reads and a shuffle scan
// a sample) and what this design does instead (tx_split.py times each
// part on the card):
// - The pattern table (ops/tx.py:pattern_table, built once a configuration
//   on the host and read here through L1): for every pattern p of k +-1
//   rows, pre[p][i] is the float64 sum, in order, of the float32
//   increments of phases 0..i, each tx_inc's chain on those rows (one
//   rounding a tap from m = k - 1 down to 0, then sens * acc), so it holds
//   the same float32 increments as the chain; pre[p][I - 1] is the row's
//   total.  A sample's phase is its row's start plus one table entry, with
//   no chain from sample to sample.  A row whose window is not all +-1 (a
//   zero or loaded history, float NRZ of other values), or every row
//   without a table, runs tx_inc itself, summed in the same order; a row at
//   or after n_valid adds nothing.
// - Runs.  A thread owns a run of `run` consecutive NRZ rows of one stream
//   (ops/tx.py:tx_plan: min(16, max(1, S / I)) rows, S = 4 for B5 and 32
//   for B6) and reads them in one unrolled batch into two bit masks, the
//   rows' signs and which rows are not +-1 (packed bytes: one 32-bit
//   window of four byte loads), so its rows cost one load latency; it
//   walks the I phases of a row in a loop, so no sample divides by I.
// - Stores.  B5 at I >= kRowInterp (a run is one row): a warp writes its 32
//   rows one at a time, each lane a phase, so a store covers 256
//   contiguous bytes (a thread writing its own 480-byte row took six times
//   as long).  B5 at smaller I: a thread writes its run, two samples to a
//   16-byte store.  B6 puts 32 lanes of one stream row on a warp: 256
//   contiguous bytes a sample row.
// - Launches: at most two, every float64 sum in a fixed order, so the same
//   input gives the same bits on every run:
//   1. (only when a stream has more than one tile) one block a tile writes
//      the tile's float64 total: each thread sums its rows' totals, the
//      block adds its threads' sums in a fixed order;
//   2. each block sums launch 1's totals of the tiles before its own, in a
//      fixed order, scans its threads' totals, wraps each
//      thread's start into [0, 2 pi) once and writes the samples, a table
//      sample's phase kept in [0, 2 pi) by a compare each way (the host
//      takes a table only where every entry is within 2 pi), a chained
//      one's by a full wrap where it leaves the range.  The thread that owns
//      the last row writes the carried phase; B6's last tile also exports
//      the last k - 1 NRZ rows as the next history.
// Each increment is computed once, by the thread that writes its sample
// (a table entry, or the chain on a row whose window is not all +-1; such
// a row's increments are computed again for its total).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr double kInvTwoPi = 0.15915494309189533576888376337251;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                  // threads a block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kFoldRunSamples = 4;             // B5: a run holds max(1, this / I) rows (capped)
constexpr int kBatchRunSamples = 32;           // B6
constexpr int kMaxRunRows = 16;                // a run holds at most this many rows
constexpr int kRowInterp = 32;                 // B5 at I >= this: a warp writes a row at a time
constexpr int kBatchLanes = 32;                // B6: lanes a block
constexpr int kBatchRuns = kThreads / kBatchLanes;  // B6: runs a lane a block
constexpr int kTableMaxK = 8;                  // the pattern table takes k <= this
constexpr int kMaxWindow = kTableMaxK - 1 + kMaxRunRows;  // rows a run reads

struct TxFilter {
  const float* taps;    // (k, interp): taps[m * interp + i]
  const double* table;  // (2^k, interp) pattern prefixes (ops/tx.py:pattern_table), or null
  int k;
  int interp;
  float sens;
  int n_valid;  // NRZ rows at or after n_valid add no phase
};

__device__ __forceinline__ double wrap_2pi(double p) {
  double r = p - floor(p * kInvTwoPi) * kTwoPi;
  if (r < 0.0) r += kTwoPi;
  if (r >= kTwoPi) r -= kTwoPi;
  return r;
}

// p in [0, 2 pi): unchanged where it is there already (the common case).
__device__ __forceinline__ double wrapped(double p) {
  return p >= kTwoPi || p < 0.0 ? wrap_2pi(p) : p;
}

// start + d for start in [0, 2 pi) and |d| < 2 pi (a table entry): one
// compare each way, no branch.
__device__ __forceinline__ double add_wrapped(double start, double d) {
  double p = start + d;
  p = p >= kTwoPi ? p - kTwoPi : p;
  return p < 0.0 ? p + kTwoPi : p;
}

__device__ __forceinline__ float2 vco(double phase) {
  float s, c;
  sincosf(static_cast<float>(phase), &s, &c);
  return make_float2(c, s);
}

// The increment of sample (n, i); x(r) is NRZ row r of [history | stream]
// for r >= -(k - 1).
template <class Rows>
__device__ __forceinline__ float tx_inc(const TxFilter& f, const Rows& x, int n, int i) {
  float acc = 0.f;
  for (int m = f.k - 1; m >= 0; --m) acc = fmaf(__ldg(f.taps + m * f.interp + i), x(n - m), acc);
  return __fmul_rn(f.sens, acc);
}

__device__ __forceinline__ int flat_tid() { return threadIdx.y * blockDim.x + threadIdx.x; }

// Rows first .. first + count - 1 (count <= kMaxWindow) as bit masks, the
// last in bit 0: `sign` (row > 0) and `other` (row not +-1).  Every row is
// read by an unconditional load at a clamped address, so the loads issue
// together.
template <class Rows>
__device__ __forceinline__ void load_rows(const Rows& x, int first, int count, unsigned& sign,
                                          unsigned& other) {
  float v[kMaxWindow];
#pragma unroll
  for (int j = 0; j < kMaxWindow; ++j) v[j] = x(min(first + j, first + count - 1));
  sign = other = 0;
#pragma unroll
  for (int j = 0; j < kMaxWindow; ++j) {
    const unsigned bit = j < count ? 1u << (count - 1 - j) : 0u;
    sign |= v[j] > 0.f ? bit : 0u;
    other |= v[j] != 1.f && v[j] != -1.f ? bit : 0u;
  }
}

// Rows n0 - (k - 1) .. n1 - 1 of a run as bit masks, the newest in bit 0:
// `sign` (row > 0) and `other` (row not +-1).  Without the table every row
// counts as other, so every row runs the chain.
struct RunBits {
  unsigned sign = 0, other = kFull, mask = kFull;
  int n1 = 0;
  __device__ __forceinline__ unsigned pattern(int n) const { return (sign >> (n1 - 1 - n)) & mask; }
  __device__ __forceinline__ bool tabled(int n) const {
    return ((other >> (n1 - 1 - n)) & mask) == 0;
  }
};

template <class Rows>
__device__ __forceinline__ RunBits load_run(const TxFilter& f, const Rows& x, int n0, int n1) {
  RunBits b;
  b.n1 = n1;
  if (f.table == nullptr) return b;
  b.mask = (1u << f.k) - 1u;
  x.load(n0 - (f.k - 1), n1 - n0 + f.k - 1, b.sign, b.other);
  return b;
}

// Row n's increments summed (0 at or after n_valid).
template <class Rows>
__device__ __forceinline__ double row_total(const TxFilter& f, const RunBits& b, const Rows& x,
                                            int n) {
  if (n >= f.n_valid) return 0.0;
  if (b.tabled(n)) return __ldg(f.table + (b.pattern(n) + 1) * f.interp - 1);
  double r = 0.0;
  for (int i = 0; i < f.interp; ++i) r += tx_inc(f, x, n, i);
  return r;
}

template <class Rows>
__device__ double run_total(const TxFilter& f, const RunBits& b, const Rows& x, int n0, int n1) {
  double s = 0.0;
  for (int n = n0; n < n1; ++n) s += row_total(f, b, x, n);
  return s;
}

template <class Rows>
__device__ double run_total(const TxFilter& f, const Rows& x, int n0, int n1) {
  return run_total(f, load_run(f, x, n0, n1), x, n0, n1);
}

// A thread writes rows [n0, n1) from `start` (in [0, 2 pi)), the phase
// before row n0; returns the phase after row n1 - 1.
template <class Rows, class Out>
__device__ double write_run(const TxFilter& f, const RunBits& b, const Rows& x, int n0, int n1,
                            double start, Out& out) {
  for (int n = n0; n < n1; ++n) {
    const int s0 = n * f.interp;
    if (n >= f.n_valid) {
      const float2 v = vco(start);
      for (int i = 0; i < f.interp; ++i) out(s0 + i, v);
    } else if (b.tabled(n)) {
      const double* pre = f.table + b.pattern(n) * f.interp;
#pragma unroll 2
      for (int i = 0; i < f.interp; ++i) out(s0 + i, vco(add_wrapped(start, __ldg(pre + i))));
      start = add_wrapped(start, __ldg(pre + f.interp - 1));
    } else {
      double acc = 0.0;
      for (int i = 0; i < f.interp; ++i) {
        acc += tx_inc(f, x, n, i);
        out(s0 + i, vco(wrapped(start + acc)));
      }
      start = wrapped(start + acc);
    }
  }
  return start;
}

// Sum of v over the block, the same value in every thread, in a fixed order.
__device__ double block_sum(double v, double* s_warp) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  const int tid = flat_tid();
  __syncthreads();
  if ((tid & 31) == 0) s_warp[tid >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s += s_warp[w];
  return s;
}

// Exclusive prefix of v over the block's threads in order.
__device__ double block_exclusive_scan(double v, double* s_warp) {
  const int tid = flat_tid();
  const int lane = tid & 31;
  double incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  const double excl = __shfl_up_sync(kFull, incl, 1);
  __syncthreads();
  if (lane == 31) s_warp[tid >> 5] = incl;
  __syncthreads();
  double base = 0.0;
  for (int w = 0; w < (tid >> 5); ++w) base += s_warp[w];
  return lane == 0 ? base : base + excl;
}

// ---------------------------------------------------------------- B5

// One stream: float NRZ, or packed bytes (MSB first, bit 1 -> +1, 0 -> -1).
struct StreamRows {
  const float* nrz;      // (n,), or null when bytes is given
  const uint8_t* bytes;  // (n / 8,), or null
  const float* hist;     // (k - 1,): rows -(k - 1) .. -1
  int km1;
  int n;
  __device__ __forceinline__ float operator()(int r) const {
    if (r < 0) return hist[km1 + r];
    if (bytes != nullptr) return (__ldg(bytes + (r >> 3)) >> (7 - (r & 7))) & 1 ? 1.f : -1.f;
    return __ldg(nrz + r);
  }
  // Payload bits come from one 32-bit window of the bytes, four loads; the
  // history rows of a stream's first run are patched in after.
  __device__ __forceinline__ void load(int first, int count, unsigned& sign, unsigned& other) const {
    if (bytes == nullptr) return load_rows(*this, first, count, sign, other);
    const int h = first < 0 ? -first : 0;  // history rows in the window
    const int b0 = (first + h) >> 3;
    const int last = (n - 1) >> 3;
    unsigned w = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) w = (w << 8) | __ldg(bytes + min(b0 + q, last));
    sign = (w << ((first + h) & 7)) >> (32 - (count - h));
    other = 0;
    for (int j = 0; j < h; ++j) {
      const float v = hist[km1 - h + j];
      const unsigned bit = 1u << (count - 1 - j);
      sign |= v > 0.f ? bit : 0u;
      other |= v != 1.f && v != -1.f ? bit : 0u;
    }
  }
};

// A thread's consecutive samples, two to a 16-byte store.
struct PairOut {
  float2* out;
  float2 held;
  int at = -1;
  __device__ explicit PairOut(float2* o) : out(o) {}
  __device__ __forceinline__ void operator()(int s, float2 v) {
    if ((s & 1) == 0) {
      held = v;
      at = s;
    } else if (at == s - 1) {
      reinterpret_cast<float4*>(out)[s >> 1] = make_float4(held.x, held.y, v.x, v.y);
      at = -1;
    } else {
      out[s] = v;
    }
  }
  __device__ __forceinline__ void flush() {
    if (at >= 0) out[at] = held;
  }
};

// At I >= kRowInterp (a run is one row, row n0 = the thread's, `start`
// the phase before it): the warp writes its 32 rows in turn, lane l the
// phases l, l + 32, ..., so each store covers 256 contiguous bytes.
__device__ void write_rows_by_warp(const TxFilter& f, const RunBits& b, const StreamRows& x, int n,
                                   int n0, double start, float2* out) {
  const int lane = threadIdx.x & 31;
  // 0: no phase added (at or after n_valid), 1: the table, 2: the chain
  const int kind = n0 >= f.n_valid ? 0 : b.tabled(n0) ? 1 : 2;
  const unsigned code = kind == 1 ? (b.pattern(n0) << 2) | 1u : kind;
  for (int j = 0; j < 32; ++j) {
    const int nj = n0 - lane + j;
    if (nj >= n) break;
    const double st = __shfl_sync(kFull, start, j);
    const unsigned cj = __shfl_sync(kFull, code, j);
    float2* row = out + (size_t)nj * f.interp;
    if ((cj & 3) == 0) {
      const float2 v = vco(st);
      for (int i = lane; i < f.interp; i += 32) row[i] = v;
    } else if ((cj & 3) == 1) {
      const double* pre = f.table + (cj >> 2) * f.interp;
      for (int i = lane; i < f.interp; i += 32) row[i] = vco(add_wrapped(st, __ldg(pre + i)));
    } else {
      double acc = 0.0;
      for (int i = 0; i < f.interp; ++i) {
        acc += tx_inc(f, x, nj, i);
        if ((i & 31) == lane) row[i] = vco(wrapped(st + acc));
      }
    }
  }
}

// Launch 1: totals[blockIdx.x] for tiles of kThreads runs of `run` rows.
__global__ void __launch_bounds__(kThreads)
    tx_fold_totals_kernel(StreamRows x, TxFilter f, int n, int run, double* totals) {
  __shared__ double s_warp[kWarps];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * run;
  const double s = block_sum(n0 < n ? run_total(f, x, n0, min(n0 + run, n)) : 0.0, s_warp);
  if (threadIdx.x == 0) totals[blockIdx.x] = s;
}

// Launch 2 (the only one for a stream of one tile): tile blockIdx.x's
// samples, after the totals of the tiles before it.
__global__ void __launch_bounds__(kThreads)
    tx_fold_kernel(StreamRows x, TxFilter f, int n, int run, double phase0, const double* totals,
                   float2* out, double* phase_out) {
  __shared__ double s_warp[kWarps];
  const int tile = blockIdx.x;
  double pre = 0.0;
#pragma unroll 4
  for (int j = threadIdx.x; j < tile; j += kThreads) pre += totals[j];
  pre = block_sum(pre, s_warp);
  const int n0 = (tile * kThreads + threadIdx.x) * run;
  const int n1 = min(n0 + run, n);
  const RunBits b = n0 < n ? load_run(f, x, n0, n1) : RunBits{};
  const double own = n0 < n ? run_total(f, b, x, n0, n1) : 0.0;
  const double start = wrap_2pi(phase0 + pre + block_exclusive_scan(own, s_warp));
  double end;
  if (f.interp >= kRowInterp) {
    write_rows_by_warp(f, b, x, n, n0, start, out);
    end = wrapped(start + own);
  } else {
    if (n0 >= n) return;
    PairOut o(out);
    end = write_run(f, b, x, n0, n1, start, o);
    o.flush();
  }
  if (n0 < n && n1 == n) *phase_out = end;
}

// ---------------------------------------------------------------- B6

// Lane `lane` of the time-major (n, lanes) NRZ and (k - 1, lanes) history.
struct LaneRows {
  const float* nrz_tm;
  const float* hist;
  int lanes;
  int km1;
  int lane;
  __device__ __forceinline__ float operator()(int r) const {
    return __ldg(r >= 0 ? nrz_tm + (size_t)r * lanes + lane : hist + (size_t)(km1 + r) * lanes + lane);
  }
  __device__ __forceinline__ void load(int first, int count, unsigned& sign, unsigned& other) const {
    load_rows(*this, first, count, sign, other);
  }
};

struct LaneOut {
  float2* out;
  int lanes;
  int lane;
  __device__ __forceinline__ void operator()(int s, float2 v) { out[(size_t)s * lanes + lane] = v; }
};

// Block (tile, g): lanes g * 32 + threadIdx.x, runs tile * kBatchRuns +
// threadIdx.y.  Launch 1: totals[tile * lanes + lane].
__global__ void __launch_bounds__(kThreads)
    tx_lanes_totals_kernel(const float* nrz_tm, const float* hist, int lanes, TxFilter f, int n,
                           int run, double* totals) {
  __shared__ double s_run[kBatchRuns][kBatchLanes];
  const int lane = blockIdx.y * kBatchLanes + threadIdx.x;
  const bool live = lane < lanes;
  const LaneRows x{nrz_tm, hist, lanes, f.k - 1, lane};
  const int n0 = (blockIdx.x * kBatchRuns + threadIdx.y) * run;
  s_run[threadIdx.y][threadIdx.x] = live && n0 < n ? run_total(f, x, n0, min(n0 + run, n)) : 0.0;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    double s = 0.0;
    for (int q = 0; q < kBatchRuns; ++q) s += s_run[q][threadIdx.x];
    totals[(size_t)blockIdx.x * lanes + lane] = s;
  }
}

// Launch 2 (the only one for streams of one tile).
__global__ void __launch_bounds__(kThreads)
    tx_lanes_kernel(const float* nrz_tm, const float* hist, int lanes, TxFilter f, int n, int run,
                    int tiles, const double* phase0, const double* totals, float2* out,
                    double* phase_out, float* hist_out) {
  __shared__ double s_pre[kBatchRuns][kBatchLanes];
  __shared__ double s_run[kBatchRuns][kBatchLanes];
  const int tile = blockIdx.x;
  const int lane = blockIdx.y * kBatchLanes + threadIdx.x;
  const bool live = lane < lanes;
  const LaneRows x{nrz_tm, hist, lanes, f.k - 1, lane};
  double pre = 0.0;
  if (live) {
#pragma unroll 8
    for (int j = threadIdx.y; j < tile; j += kBatchRuns) pre += totals[(size_t)j * lanes + lane];
  }
  const int n0 = (tile * kBatchRuns + threadIdx.y) * run;
  const int n1 = min(n0 + run, n);
  const RunBits b = live && n0 < n ? load_run(f, x, n0, n1) : RunBits{};
  s_pre[threadIdx.y][threadIdx.x] = pre;
  s_run[threadIdx.y][threadIdx.x] = live && n0 < n ? run_total(f, b, x, n0, n1) : 0.0;
  __syncthreads();
  if (!live) return;
  if (tile == tiles - 1) {  // the next call's history: the last k - 1 rows of [hist | nrz_tm]
    for (int j = threadIdx.y; j < f.k - 1; j += kBatchRuns)
      hist_out[(size_t)j * lanes + lane] = x(n - (f.k - 1) + j);
  }
  if (n0 >= n) return;
  double p = 0.0, before = 0.0;
  for (int q = 0; q < kBatchRuns; ++q) p += s_pre[q][threadIdx.x];
  for (int q = 0; q < (int)threadIdx.y; ++q) before += s_run[q][threadIdx.x];
  LaneOut o{out, lanes, lane};
  const double ph = write_run(f, b, x, n0, n1, wrap_2pi(phase0[lane] + p + before), o);
  if (n1 == n) phase_out[lane] = ph;
}

// Rows a thread's run, tiles a stream.
struct Plan {
  int run, tiles;
  bool two;
};

Plan plan(int n, int interp, int run_samples, int runs_a_tile) {
  Plan p;
  p.run = run_samples / interp > 1 ? run_samples / interp : 1;
  if (p.run > kMaxRunRows) p.run = kMaxRunRows;
  const int tile = runs_a_tile * p.run;
  p.tiles = (n + tile - 1) / tile;
  p.two = p.tiles > 1;
  return p;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define TX_LAUNCHED()                                  \
  do {                                                 \
    ++*launched;                                       \
    const cudaError_t err = cudaGetLastError();        \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// B5: one stream of n NRZ rows (float nrz, or packed bytes when nrz is
// null), (k - 1,) history, (k, interp) taps; out is (n * interp,) complex64
// as float2, phase_out one float64; sums is n_sums float64 of scratch, one
// a tile when the stream has more than one tile, else none (ops/tx.py
// tx_plan).  n * interp < 2^30.  *launched counts the kernels
// started (1 or 2).  Returns the first CUDA error, or 0;
// cudaErrorInvalidValue, before any launch, if n_sums is not that count.
extern "C" int tx_folded_forward(const float* nrz, const uint8_t* bytes, int n,
                                 const float* hist, const float* taps, const double* table, int k,
                                 int interp, float sens, int n_valid, double phase0, double* sums,
                                 int n_sums, float2* out, double* phase_out,
                                 void* stream_handle, int* launched) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Plan p = plan(n, interp, kFoldRunSamples, kThreads);
  const StreamRows x{nrz, bytes, hist, k - 1, n};
  const TxFilter f{taps, table, k, interp, sens, n_valid};
  *launched = 0;
  if (n_sums != (p.two ? p.tiles : 0) || (table != nullptr && k > kTableMaxK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.two) {
    tx_fold_totals_kernel<<<p.tiles, kThreads, 0, stream>>>(x, f, n, p.run, sums);
    TX_LAUNCHED();
  }
  tx_fold_kernel<<<p.tiles, kThreads, 0, stream>>>(x, f, n, p.run, phase0, sums, out, phase_out);
  TX_LAUNCHED();
  return 0;
}

// B6: (n, lanes) time-major NRZ, (k - 1, lanes) history, (lanes,) float64
// phases; out is (n * interp, lanes) complex64 as float2, phase_out
// (lanes,) float64, hist_out (k - 1, lanes); sums is (tiles, lanes)
// float64 of scratch when a lane has more than one tile, else none; n_sums
// is the tiles, refused as for B5 on another count.
// n * interp < 2^30.
extern "C" int tx_batched_forward(const float* nrz_tm, int n, int lanes, const float* hist,
                                  const float* taps, const double* table, int k, int interp,
                                  float sens, int n_valid, const double* phase0, double* sums,
                                  int n_sums, float2* out, double* phase_out, float* hist_out,
                                  void* stream_handle, int* launched) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Plan p = plan(n, interp, kBatchRunSamples, kBatchRuns);
  const TxFilter f{taps, table, k, interp, sens, n_valid};
  const int groups = (lanes + kBatchLanes - 1) / kBatchLanes;
  const dim3 block(kBatchLanes, kBatchRuns);
  const dim3 grid(p.tiles, groups);
  *launched = 0;
  if (n_sums != (p.two ? p.tiles : 0) || (table != nullptr && k > kTableMaxK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.two) {
    tx_lanes_totals_kernel<<<grid, block, 0, stream>>>(nrz_tm, hist, lanes, f, n, p.run, sums);
    TX_LAUNCHED();
  }
  tx_lanes_kernel<<<grid, block, 0, stream>>>(nrz_tm, hist, lanes, f, n, p.run, p.tiles, phase0,
                                              sums, out, phase_out, hist_out);
  TX_LAUNCHED();
  return 0;
}
