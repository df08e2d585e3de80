// Pack the full-block step's symbols into lane order:
//   out = every lane's valid symbols back to back, in (lane, chunk, slot)
//   order, and offsets[l] = where lane l's run starts (offsets[C] = total),
// from symbols (C, n_chunks, K) int8 at any strides and counts (C, n_chunks)
// int32, slot k of chunk t of lane l valid while k < counts[l, t] (a count
// is clamped to [0, K]).
//
// No TPU kernel is replaced: the JAX server gathers each lane's symbols on
// the host, a numpy slice per (lane, chunk).  The step returns its symbols
// time-major (strides (1, K * C, C)), so that loop reads a lane's symbols
// one cache line each; at 128 lanes x 128 chunks x 530 slots a block it
// took ~50 ms of the host's time and held the card idle.  Here the card
// lays them out once, and the host copies one packed buffer and slices it
// a lane.
//
// Bound on an H100: bytes.  At 128 x 128 x 530 the valid symbols are at
// most 8.7 MB read and 8.7 MB written, ~5 us at 3.35 TB/s; the counts and
// offsets are 64 KB and 128 KB.
// Design, two launches:
//   - pack_scan_kernel, a block a lane: the exclusive scan of the lane's
//     chunk counts (its chunks' offsets inside its run) and its total;
//   - pack_kernel, a block a chunk and 32 lanes: the lanes' starts from
//     the totals of the lanes before them, then the tile's symbols in runs
//     of kTileSlots slots: read slot by slot with the lanes on neighbouring
//     threads (neighbouring bytes in the step's layout), transposed in
//     shared memory, written lane by lane with neighbouring threads on
//     neighbouring bytes of a run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 256;
constexpr int kThreads = 256;
constexpr int kTileLanes = 32;
constexpr int kTileSlots = 128;
constexpr int kTilePitch = kTileSlots + 4;  // a lane's row: 33 words, so a slot's lanes hit 32 banks

__device__ inline long long warp_inclusive_scan(long long v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32); every
// thread of the block calls it.  *total is the block's sum.  sums holds 33
// values in shared memory.
__device__ long long block_exclusive_scan(long long v, long long* sums, long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long incl = warp_inclusive_scan(v);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long s = lane < warps ? sums[lane] : 0;
    const long long si = warp_inclusive_scan(s);
    if (lane < warps) sums[lane] = si - s;
    if (lane == 31) sums[32] = si;
  }
  __syncthreads();
  const long long excl = sums[warp] + incl - v;
  *total = sums[32];
  __syncthreads();  // sums is reused by the next call
  return excl;
}

__device__ inline int clamp_count(int c, int k) { return c < 0 ? 0 : (c > k ? k : c); }

__global__ void __launch_bounds__(kScanThreads)
    pack_scan_kernel(const int* __restrict__ counts, long long cl, long long ct, int n_chunks, int k,
                     long long* __restrict__ chunk_off, long long* __restrict__ lane_total) {
  __shared__ long long sums[33];
  const int l = blockIdx.x;
  long long running = 0;
  for (int t0 = 0; t0 < n_chunks; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const long long v = t < n_chunks ? clamp_count(counts[l * cl + t * ct], k) : 0;
    long long total;
    const long long excl = block_exclusive_scan(v, sums, &total);
    if (t < n_chunks) chunk_off[static_cast<long long>(l) * n_chunks + t] = running + excl;
    running += total;
  }
  if (threadIdx.x == 0) lane_total[l] = running;
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const int8_t* __restrict__ sym, long long sl, long long st, long long sk,
                const int* __restrict__ counts, long long cl, long long ct, int lanes, int n_chunks,
                int k, const long long* __restrict__ chunk_off, const long long* __restrict__ lane_total,
                int8_t* __restrict__ out, long long* __restrict__ offsets) {
  __shared__ long long sums[33];
  __shared__ long long base[kTileLanes];
  __shared__ int cnt[kTileLanes];
  __shared__ int most;
  __shared__ int8_t tile[kTileLanes * kTilePitch];
  const int t = blockIdx.x;
  const int l0 = blockIdx.y * kTileLanes;

  // where the tile's first lane starts: the totals of every lane before it
  long long before = 0;
  for (int l = threadIdx.x; l < l0; l += blockDim.x) before += lane_total[l];
  block_exclusive_scan(before, sums, &before);
  if (threadIdx.x < 32) {
    const int l = l0 + threadIdx.x;
    const long long tot = l < lanes ? lane_total[l] : 0;
    const long long end = before + warp_inclusive_scan(tot);  // this lane's run ends here
    int c = 0;
    if (l < lanes) {
      c = clamp_count(counts[l * cl + t * ct], k);
      base[threadIdx.x] = end - tot + chunk_off[static_cast<long long>(l) * n_chunks + t];
      if (t == 0) {
        offsets[l] = end - tot;
        if (l == lanes - 1) offsets[lanes] = end;
      }
    }
    cnt[threadIdx.x] = c;
    int m = c;
    for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (threadIdx.x == 0) most = m;
  }
  __syncthreads();

  const int8_t* src = sym + static_cast<long long>(l0) * sl + static_cast<long long>(t) * st;
  for (int k0 = 0; k0 < most; k0 += kTileSlots) {
    for (int i = threadIdx.x; i < kTileLanes * kTileSlots; i += blockDim.x) {
      const int li = i % kTileLanes;
      const int kk = i / kTileLanes;
      if (k0 + kk < cnt[li]) tile[li * kTilePitch + kk] = src[li * sl + (k0 + kk) * sk];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileLanes * kTileSlots; i += blockDim.x) {
      const int li = i / kTileSlots;
      const int kk = i % kTileSlots;
      if (k0 + kk < cnt[li]) out[base[li] + k0 + kk] = tile[li * kTilePitch + kk];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// symbols (lanes, n_chunks, k) int8 at element strides (sl, st, sk); counts
// (lanes, n_chunks) int32 at (cl, ct); chunk_off (lanes * n_chunks) and
// lane_total (lanes) int64 scratch; out (at least the total) int8; offsets
// (lanes + 1) int64.  lanes, n_chunks and k at least 1.
extern "C" int pack_forward(const int8_t* sym, long long sl, long long st, long long sk,
                            const int* counts, long long cl, long long ct, int lanes, int n_chunks,
                            int k, long long* chunk_off, long long* lane_total, int8_t* out,
                            long long* offsets, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  pack_scan_kernel<<<lanes, kScanThreads, 0, stream>>>(counts, cl, ct, n_chunks, k, chunk_off,
                                                         lane_total);
  const dim3 grid(n_chunks, (lanes + kTileLanes - 1) / kTileLanes);
  pack_kernel<<<grid, kThreads, 0, stream>>>(sym, sl, st, sk, counts, cl, ct, lanes, n_chunks, k,
                                             chunk_off, lane_total, out, offsets);
  return static_cast<int>(cudaGetLastError());
}
