// GFSK TX: NRZ bits -> polyphase Gaussian FIR (interpolation I) -> VCO
// phase prefix -> cos/sin, written as interleaved complex64 samples, with
// sample n*I + i for NRZ row n and polyphase phase i.
//
// Replaces the TPU kernels sdrmodem_tpu/ops/pallas_tx.py:_tx_folded_kernel
// (B5, wrapper gfsk_tx_call_folded: one stream, the server's TX path) and
// _tx_kernel (B6, wrapper gfsk_tx_call: streams on lanes, time-major).
// The TPU kernels fold the stream across 128 lanes, prefix-sum with
// triangular float32 matrix products and keep the running phase in float32
// (~1e-3 rad off the float64 chain over a 32 KiB payload at I = 60).  None
// of that is carried over: here the phase prefix is float64 throughout,
// reduced mod 2 pi in float64 before the cast to float32 and the precise
// sincosf, so the kernels follow the float64 chain
// (dsp/elementwise.py:freq_mod_stream_pair) at any length.
//
// Bound on an H100: by bytes.  A sample is written once (8 bytes of
// complex64) from ~2k + 1 flops of FIR and increment, ~40 of sincos and a
// few float64 operations of prefix and wrap, far below the rates; the input
// is 1/8 byte a bit (B5, packed) or 4 bytes a row-lane (B6).  32 KiB at
// I = 60 is 126 MB written, ~38 us at 3.35 TB/s.
//
// Design.  One device function (tx_inc) computes a sample's increment:
// sens * sum_m taps[m, i] * x[n - m], one fmaf a tap from the oldest row
// (m = k - 1) to the newest, the order in which the JAX package's
// interp_fir_stream sums (its y bit for bit on the CPU), reading the
// carried history for rows before 0; 0 for rows at or after n_valid (so a
// padded block's FIR tail adds no phase).  The prefix is a two-level scan
// in three launches:
//   1. each block sums its tile's increments (float64);
//   2. one block a lane scans the tile sums into each tile's start phase,
//      wrapped mod 2 pi, and the phase after the last sample (B6 also
//      exports the last k - 1 NRZ rows as the next history);
//   3. each block recomputes its increments, scans them from its start
//      phase and writes the samples.
// B5 puts consecutive samples on consecutive threads (warp-shuffle scans
// over rounds of 32 samples, coalesced 256-byte stores); B6 puts lanes on
// threads and walks 16 consecutive samples a thread (a warp's stores are
// 32 neighbouring lanes of one sample row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr double kInvTwoPi = 0.15915494309189533576888376337251;
constexpr unsigned kFull = 0xffffffffu;

struct TxFilter {
  const float* taps;  // (k, interp): taps[m * interp + i]
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

// The increment of sample (n, i); x(r) is NRZ row r of [history | stream]
// for r >= -(k - 1).
template <class Rows>
__device__ __forceinline__ float tx_inc(const TxFilter& f, int n, int i, const Rows& x) {
  if (n >= f.n_valid) return 0.f;
  float acc = 0.f;
  for (int m = f.k - 1; m >= 0; --m) acc = fmaf(__ldg(f.taps + m * f.interp + i), x(n - m), acc);
  return __fmul_rn(f.sens, acc);
}

__device__ __forceinline__ float2 vco(double phase) {
  float s, c;
  sincosf(static_cast<float>(wrap_2pi(phase)), &s, &c);
  return make_float2(c, s);
}

// ---------------------------------------------------------------- B5
constexpr int kFoldWarps = 8;
constexpr int kFoldThreads = 32 * kFoldWarps;
constexpr int kFoldRounds = 16;                          // rounds of 32 samples a warp
constexpr int kFoldTile = kFoldThreads * kFoldRounds;  // samples a block

// One stream: float NRZ, or packed bytes (MSB first, bit 1 -> +1, 0 -> -1).
struct StreamRows {
  const float* nrz;      // (n,), or null when bytes is given
  const uint8_t* bytes;  // (n / 8,), or null
  const float* hist;     // (k - 1,): rows -(k - 1) .. -1
  int km1;
  __device__ __forceinline__ float operator()(int r) const {
    if (r < 0) return hist[km1 + r];
    if (bytes != nullptr) return ((bytes[r >> 3] >> (7 - (r & 7))) & 1) ? 1.f : -1.f;
    return nrz[r];
  }
};

// Warp w of block b owns samples b * kFoldTile + w * 32 * kFoldRounds + [0,
// 32 * kFoldRounds), round j the 32 of them at 32 * j.  kWrite = false:
// sums[b] = the tile's increments summed.  kWrite = true: sums[b] is the
// tile's start phase; write the samples.
template <bool kWrite>
__global__ void __launch_bounds__(kFoldThreads)
    tx_folded_kernel(StreamRows x, TxFilter f, int total, double* sums, float2* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * kFoldTile + warp * (32 * kFoldRounds) + lane;
  float inc[kFoldRounds];
  double part = 0.0;
#pragma unroll
  for (int j = 0; j < kFoldRounds; ++j) {
    const int s = s0 + 32 * j;
    float v = 0.f;
    if (s < total) {
      const int n = s / f.interp;
      v = tx_inc(f, n, s - n * f.interp, x);
    }
    inc[j] = v;
    part += v;
  }
  for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
  __shared__ double s_warp[kFoldWarps];
  if (lane == 0) s_warp[warp] = part;
  __syncthreads();
  if (!kWrite) {
    if (threadIdx.x == 0) {
      double t = 0.0;
      for (int w = 0; w < kFoldWarps; ++w) t += s_warp[w];
      sums[blockIdx.x] = t;
    }
    return;
  }
  double base = sums[blockIdx.x];
  for (int w = 0; w < warp; ++w) base += s_warp[w];
#pragma unroll
  for (int j = 0; j < kFoldRounds; ++j) {
    double v = inc[j];  // inclusive scan over the round's 32 samples
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += t;
    }
    const int s = s0 + 32 * j;
    if (s < total) out[s] = vco(base + v);
    base += __shfl_sync(kFull, v, 31);
  }
}

// ---------------------------------------------------------------- B6
constexpr int kBatchLanes = 32;                        // lanes a block
constexpr int kBatchRows = 8;                          // threads along time
constexpr int kBatchSteps = 16;                        // consecutive samples a thread
constexpr int kBatchTile = kBatchRows * kBatchSteps;  // samples a lane a block

// Lane `lane` of the time-major (n, lanes) NRZ and (k - 1, lanes) history.
struct LaneRows {
  const float* nrz_tm;
  const float* hist;
  int lanes;
  int km1;
  int lane;
  __device__ __forceinline__ float operator()(int r) const {
    return r >= 0 ? nrz_tm[(size_t)r * lanes + lane] : hist[(size_t)(km1 + r) * lanes + lane];
  }
};

// Block (t, g) owns samples t * kBatchTile + [0, kBatchTile) of lanes g * 32
// + [0, 32); thread y of a lane walks kBatchSteps of them.  sums is (lanes,
// tiles), as for B5.
template <bool kWrite>
__global__ void __launch_bounds__(kBatchLanes * kBatchRows)
    tx_batched_kernel(const float* nrz_tm, const float* hist, int lanes, TxFilter f, int total,
                      int tiles, double* sums, float2* out) {
  const int lane = blockIdx.y * kBatchLanes + threadIdx.x;
  const bool live = lane < lanes;
  const int s0 = blockIdx.x * kBatchTile + threadIdx.y * kBatchSteps;
  const LaneRows x{nrz_tm, hist, lanes, f.k - 1, lane};
  float inc[kBatchSteps];
  double part = 0.0;
#pragma unroll
  for (int j = 0; j < kBatchSteps; ++j) {
    const int s = s0 + j;
    float v = 0.f;
    if (live && s < total) {
      const int n = s / f.interp;
      v = tx_inc(f, n, s - n * f.interp, x);
    }
    inc[j] = v;
    part += v;
  }
  __shared__ double s_part[kBatchRows][kBatchLanes];
  s_part[threadIdx.y][threadIdx.x] = part;
  __syncthreads();
  if (!live) return;
  double* sum = sums + (size_t)lane * tiles + blockIdx.x;
  if (!kWrite) {
    if (threadIdx.y == 0) {
      double t = 0.0;
      for (int q = 0; q < kBatchRows; ++q) t += s_part[q][threadIdx.x];
      *sum = t;
    }
    return;
  }
  double base = *sum;
  for (int q = 0; q < (int)threadIdx.y; ++q) base += s_part[q][threadIdx.x];
#pragma unroll
  for (int j = 0; j < kBatchSteps; ++j) {
    base += inc[j];
    const int s = s0 + j;
    if (s < total) out[(size_t)s * lanes + lane] = vco(base);
  }
}

// ---------------------------------------------------------------- tile scan
constexpr int kScanThreads = 256;

// Block `lane`: sums[lane, :] (tile sums) becomes each tile's start phase,
// wrap(phase0 + the sums before it); phase_out[lane] = wrap(phase0 + all).
// phase0 is phase0s[lane], or phase0 when phase0s is null.  With hist_out,
// also the last km1 rows of [hist | nrz_tm] ((n, lanes) NRZ, (km1, lanes)
// history) as the next (km1, lanes) history.
__global__ void __launch_bounds__(kScanThreads)
    tx_scan_kernel(double* sums, int tiles, const double* phase0s, double phase0,
                   double* phase_out, const float* nrz_tm, const float* hist, float* hist_out,
                   int n, int lanes, int km1) {
  const int lane = blockIdx.x;
  double* row = sums + (size_t)lane * tiles;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min(tiles, (int)threadIdx.x * per);
  const int t1 = min(tiles, t0 + per);
  double part = 0.0;
  for (int t = t0; t < t1; ++t) part += row[t];
  const int l = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  double incl = part;
  for (int d = 1; d < 32; d <<= 1) {
    const double t = __shfl_up_sync(kFull, incl, d);
    if (l >= d) incl += t;
  }
  __shared__ double s_warp[kScanThreads / 32];
  if (l == 31) s_warp[w] = incl;
  __syncthreads();
  double base = phase0s != nullptr ? phase0s[lane] : phase0;
  for (int q = 0; q < w; ++q) base += s_warp[q];
  base += incl - part;
  for (int t = t0; t < t1; ++t) {
    const double v = row[t];
    row[t] = wrap_2pi(base);
    base += v;
  }
  if (threadIdx.x == kScanThreads - 1) phase_out[lane] = wrap_2pi(base);
  if (hist_out != nullptr && (int)threadIdx.x < km1) {
    const int r = n - km1 + (int)threadIdx.x;
    hist_out[(size_t)threadIdx.x * lanes + lane] =
        r >= 0 ? nrz_tm[(size_t)r * lanes + lane] : hist[(size_t)(km1 + r) * lanes + lane];
  }
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
// as float2, phase_out one float64; sums is n_sums float64 of scratch, one a
// tile of kFoldTile samples (ops/tx.py FOLDED_TILE).  n * interp < 2^30.
// *launched counts the kernels started (3).  Returns the first CUDA error,
// or 0; cudaErrorInvalidValue, before any launch, if n_sums is not that
// count of tiles.
extern "C" int tx_folded_forward(const float* nrz, const uint8_t* bytes, int n,
                                 const float* hist, const float* taps, int k, int interp,
                                 float sens, int n_valid, double phase0, double* sums,
                                 int n_sums, float2* out, double* phase_out,
                                 void* stream_handle, int* launched) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int total = n * interp;
  const int tiles = (total + kFoldTile - 1) / kFoldTile;
  const StreamRows x{nrz, bytes, hist, k - 1};
  const TxFilter f{taps, k, interp, sens, n_valid};
  *launched = 0;
  if (tiles != n_sums) return static_cast<int>(cudaErrorInvalidValue);
  tx_folded_kernel<false><<<tiles, kFoldThreads, 0, stream>>>(x, f, total, sums, out);
  TX_LAUNCHED();
  tx_scan_kernel<<<1, kScanThreads, 0, stream>>>(sums, tiles, nullptr, phase0, phase_out,
                                                 nullptr, nullptr, nullptr, 0, 1, 0);
  TX_LAUNCHED();
  tx_folded_kernel<true><<<tiles, kFoldThreads, 0, stream>>>(x, f, total, sums, out);
  TX_LAUNCHED();
  return 0;
}

// B6: (n, lanes) time-major NRZ, (k - 1, lanes) history, (lanes,) float64
// phases; out is (n * interp, lanes) complex64 as float2, phase_out
// (lanes,) float64, hist_out (k - 1, lanes); sums is (lanes, n_sums)
// float64 of scratch, one a tile of kBatchTile samples (ops/tx.py
// BATCHED_TILE), refused as for B5 on another count.  n * interp < 2^30.
extern "C" int tx_batched_forward(const float* nrz_tm, int n, int lanes, const float* hist,
                                  const float* taps, int k, int interp, float sens,
                                  int n_valid, const double* phase0, double* sums, int n_sums,
                                  float2* out, double* phase_out, float* hist_out,
                                  void* stream_handle, int* launched) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int total = n * interp;
  const int tiles = (total + kBatchTile - 1) / kBatchTile;
  const TxFilter f{taps, k, interp, sens, n_valid};
  const dim3 grid(tiles, (lanes + kBatchLanes - 1) / kBatchLanes);
  const dim3 block(kBatchLanes, kBatchRows);
  *launched = 0;
  if (tiles != n_sums) return static_cast<int>(cudaErrorInvalidValue);
  tx_batched_kernel<false><<<grid, block, 0, stream>>>(nrz_tm, hist, lanes, f, total, tiles,
                                                       sums, out);
  TX_LAUNCHED();
  tx_scan_kernel<<<lanes, kScanThreads, 0, stream>>>(sums, tiles, phase0, 0.0, phase_out,
                                                     nrz_tm, hist, hist_out, n, lanes, k - 1);
  TX_LAUNCHED();
  tx_batched_kernel<true><<<grid, block, 0, stream>>>(nrz_tm, hist, lanes, f, total, tiles,
                                                      sums, out);
  TX_LAUNCHED();
  return 0;
}
