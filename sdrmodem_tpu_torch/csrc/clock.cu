// Mueller & Mueller clock recovery: the chunked full-block walk (B2) and
// the ragged walk (B4), each lane on its own.  Both advance a lane with
// mm_step.cuh's step, and this file is compiled with -fmad=false so no f32
// multiply and add are contracted into an FMA, which would change the
// chaotic M&M trajectory.  Each lane is one chain of dependent symbol
// steps: the next read position depends on this step's floor(mu).
//
// B2 replaces the TPU kernel sdrmodem_tpu/ops/pallas_clock.py:
// _mm_chunked_kernel (wrapper clock_mm_chunked_tpu): every lane over one
// full block, in the chunk partition of the JAX package.  Bound on an
// H100: at 128 lanes x 2^19 decimated samples it reads its input once
// (256 MiB) and writes the f32 symbol slots (~70 MB), ~0.1 ms of memory
// traffic; the arithmetic is a few tens of operations a symbol.  What
// bounds it is neither: the time is the chain's length (~105k symbols a
// lane) times one step's latency.  Design: one thread block a lane, so the
// lanes spread over the SMs, and whole chunks staged in shared memory
// ahead of the walk, so no device-memory read sits on the chain.  Chunk t
// is walked in its own work buffer [the sfx rows before it | the chunk]
// (mm_chunk.cuh, which B7 shares), as the plain version and the JAX scan
// backend walk it.  Slot g holds m whole chunks and their prefix, stream
// rows [g*m*chunk, (g+1)*m*chunk + sfx) of [suffix | y3], so it holds every
// work buffer of its chunks and with them every window the walk can read.
// Warp 0 stages slot g + 1 into one of two buffers while thread 0 of warp
// 1 walks slot g's chunks in the other; one barrier a slot hands them
// over.  The walker writes each chunk's symbols and count; warp 0 writes
// the zero slots past each count after the barrier, from the counts left
// in shared memory.  Every chunk is walked, so the passes are fixed and no
// "done" crosses the barrier.  The time-major staging reads one float of
// a 32-byte sector a row, off the chain.
//
// B4 replaces sdrmodem_tpu/ops/pallas_clock.py:_mm_kernel (wrapper
// clock_mm_tpu): every lane over its own prepared buffer y from ii0,
// frozen once ii > n_valid - 8, with y channel-major (C, L) or time-major
// (L, C).  The TPU kernel's one-hot window ladder and overflow flag, its
// Farrow polynomial bank and its 1e30 NaN sentinel exist because the TPU's
// vector unit has no gathers; this walk reads each lane's window directly
// and indexes the bank table, so none of them is carried over.  Bound on
// an H100: the bytes, 0.100 ms at 128 lanes x 524353 (the input read once,
// the symbol slots written once); the real floor is the chain, the lane's
// symbols times one step from shared memory.  Design: one thread block a
// lane, so the lanes spread over the SMs, and the lane's rows staged in
// shared memory ahead of the walk, so no device-memory read sits on the
// chain.  Warp 0 stages rows into a ring of two slots; thread 0 of warp 1
// walks.  Slot g holds rows [g*S, (g+1)*S + 8) (rows past len as 0), so a
// window starting in [g*S, (g+1)*S) lies wholly in it.  While the walker
// steps through slot g, warp 0 fills slot g + 1 into the other buffer;
// one barrier a slot hands them over, as the fused step (step.cu) hands
// its y3 tiles to its clock thread.  A read position outside the current
// slot (gain_mu * mm is unbounded, so the stride can run backwards or
// jump) reads device memory instead: both paths read the same floats
// through the same mm_step, so the bits never depend on S.  In the
// channel-major layout warp 0 reads a slot as contiguous words; in the
// time-major one each row is one float of a 32-byte sector, ~2 GB of
// sector traffic at 128 x 524353 (~0.7 ms at 3.35 TB/s, off the chain).

#include "mm_chunk.cuh"

namespace {

// Warp 0 stages, thread 0 of warp 1 walks: B2's and B4's blocks.
constexpr int kStagers = 32;
constexpr int kWalker = kStagers;
constexpr int kLaneThreads = 2 * kStagers;
constexpr int kBatch = 8;  // rows a staging thread has in flight
constexpr int kMaxSharedBytes = 232448;  // what one block may have on an H100 (227 KB)

// B2: lane l's stream [suffix | y3] (both time-major) in chunks of `chunk`
// rows of y3, `per_slot` chunks a slot.  Writes symbol k of chunk t to
// outs[(t * k_max + k) * lanes + l] and its count to counts[t * lanes + l].
__global__ void __launch_bounds__(kLaneThreads)
    mm_chunked_kernel(const float* __restrict__ y3, int n, int lanes,
                      const float* __restrict__ suffix, int sfx,
                      const float* __restrict__ omega_in, const float* __restrict__ mu_in,
                      const float* __restrict__ last_in, const int* __restrict__ resid_in,
                      const float* __restrict__ bank, int chunk, int n_chunks, int k_max,
                      int per_slot, MmParams p, float* __restrict__ outs,
                      int* __restrict__ counts, float* __restrict__ omega_out,
                      float* __restrict__ mu_out, float* __restrict__ last_out,
                      int* __restrict__ resid_out) {
  // the bank, two slots of slot_len rows, then two sets of per_slot counts
  extern __shared__ float sm[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const long long span = (long long)per_slot * chunk;  // stream rows from one slot to the next
  const int slot_len = (int)(span < n ? span : n) + sfx;
  int* s_count = reinterpret_cast<int*>(sm + kMmBankSize + 2 * slot_len);
  const int n_slots = (n_chunks + per_slot - 1) / per_slot;

  auto stage = [&](int g) {  // slot g, stream rows [g * span, g * span + slot_len), by warp 0
    float* slot = sm + kMmBankSize + (g & 1) * slot_len;
    const long long lo = g * span - sfx;  // y3's row at the slot's first row
    int j = tid;
    for (; j < slot_len && lo + j < 0; j += kStagers) slot[j] = suffix[(lo + j + sfx) * lanes + lane];
    for (; j + (kBatch - 1) * kStagers < slot_len; j += kBatch * kStagers) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = lo + j + u * kStagers;
        v[u] = r < n ? y3[r * lanes + lane] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) slot[j + u * kStagers] = v[u];
    }
    for (; j < slot_len; j += kStagers) {
      const long long r = lo + j;
      slot[j] = r < n ? y3[r * lanes + lane] : 0.f;
    }
  };
  auto zero_tails = [&](int g) {  // the slots past each count of slot g's chunks, by warp 0
    const int* cnt = s_count + (g & 1) * per_slot;
    for (int j = 0; j < per_slot && g * per_slot + j < n_chunks; ++j) {
      float* o = outs + (long long)(g * per_slot + j) * k_max * lanes + lane;
      for (int k = cnt[j] + tid; k < k_max; k += kStagers) o[(long long)k * lanes] = 0.f;
    }
  };

  if (tid < kStagers) stage(0);
  mm_load_bank(sm, bank);  // ends with __syncthreads

  MmLane s{omega_in[lane], mu_in[lane], last_in[lane], (long long)sfx - resid_in[lane]};
  for (int g = 0; g < n_slots; ++g) {
    if (tid < kStagers) {
      if (g + 1 < n_slots) stage(g + 1);
      if (g > 0) zero_tails(g - 1);
    } else if (tid == kWalker) {
      const float* slot = sm + kMmBankSize + (g & 1) * slot_len;
      for (int j = 0; j < per_slot; ++j) {
        const int t = g * per_slot + j;
        if (t == n_chunks) break;
        const int w = sfx + min(chunk, n - t * chunk);
        const int cnt = mm_chunk(sm, p, s, slot + j * chunk, w, sfx, k_max,
                                 outs + (long long)t * k_max * lanes + lane, lanes);
        counts[(long long)t * lanes + lane] = cnt;
        s_count[(g & 1) * per_slot + j] = cnt;
      }
    }
    __syncthreads();
  }

  if (tid < kStagers) {
    zero_tails(n_slots - 1);
  } else if (tid == kWalker) {
    omega_out[lane] = s.omega;
    mu_out[lane] = s.mu;
    last_out[lane] = s.last;
    resid_out[lane] = (int)(sfx - s.ii);
  }
}

// B4: lane l reads y[row * row_stride + l * lane_stride] for row < len
// (rows past it read as 0) and writes symbol k to
// outs[k * out_k_stride + l * out_lane_stride].  One block a lane.
__global__ void __launch_bounds__(kLaneThreads)
    mm_ragged_kernel(const float* __restrict__ y, long long len, long long row_stride,
                     long long lane_stride, const int* __restrict__ n_valid,
                     const int* __restrict__ ii0, const float* __restrict__ omega_in,
                     const float* __restrict__ mu_in, const float* __restrict__ last_in,
                     const float* __restrict__ bank, int num_symbols, int k_out,
                     long long out_k_stride, long long out_lane_stride, int slot_rows,
                     MmParams p, float* __restrict__ outs, int* __restrict__ counts,
                     float* __restrict__ omega_out, float* __restrict__ mu_out,
                     float* __restrict__ last_out, int* __restrict__ ii_out) {
  extern __shared__ float sm[];  // the bank, then two slots of slot_rows + 8 rows
  __shared__ int s_count;
  float* s_bank = sm;
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int slot_len = slot_rows + kMmTaps;
  const float* yl = y + lane * lane_stride;
  auto stage = [&](long long g) {  // slot g into its buffer, by warp 0
    float* slot = sm + kMmBankSize + (g & 1) * slot_len;
    const long long lo = g * slot_rows;
    for (int j = tid; j < slot_len; j += kStagers)
      slot[j] = lo + j < len ? yl[(lo + j) * row_stride] : 0.f;
  };

  const long long last_row = (long long)n_valid[lane] - kMmTaps;  // the lane freezes past it
  MmLane s{omega_in[lane], mu_in[lane], last_in[lane], (long long)ii0[lane]};
  long long g = (s.ii < 0 ? 0 : s.ii) / slot_rows;  // the slot that holds the first window
  if (tid < kStagers) stage(g);
  mm_load_bank(s_bank, bank);  // ends with __syncthreads

  float* ol = outs + lane * out_lane_stride;
  int k = 0;
  bool done = false;
  if (tid == kWalker) {
    done = num_symbols == 0 || s.ii > last_row;
    s_count = 0;
  }
  auto from_device = [&](long long row) { return row < len ? yl[row * row_stride] : 0.f; };
  // each pass: warp 0 stages slot g + 1 while the walker steps through slot
  // g; the barrier hands slot g + 1 over and tells every thread when the
  // walker is done (frozen, or num_symbols steps)
  for (; !__syncthreads_or(done); ++g) {
    if (tid < kStagers) {
      stage(g + 1);
    } else if (tid == kWalker) {
      const float* slot = sm + kMmBankSize + (g & 1) * slot_len;
      const long long lo = g * slot_rows, hi = lo + slot_rows;
      auto staged = [&](long long row) { return slot[row - lo]; };
      while (!done) {
        const long long base = s.ii < 0 ? 0 : s.ii;
        if (base >= hi) break;  // a later slot holds the window
        ol[k * out_k_stride] =
            base >= lo ? mm_step(s_bank, p, s, staged) : mm_step(s_bank, p, s, from_device);
        ++k;
        done = k == num_symbols || s.ii > last_row;
      }
      s_count = k;
    }
  }

  const int count = s_count;
  if (tid < kStagers) {
    for (int j = count + tid; j < k_out; j += kStagers) ol[j * out_k_stride] = 0.f;
  } else if (tid == kWalker) {
    counts[lane] = count;
    omega_out[lane] = s.omega;
    mu_out[lane] = s.mu;
    last_out[lane] = s.last;
    ii_out[lane] = (int)s.ii;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y3 (n, C) and suffix (sfx, C) time-major; per-lane state vectors (C,);
// bank (129, 8); per_slot chunks staged at a time.  Writes outs (n_chunks,
// k_max, C), counts (n_chunks, C) and the final per-lane state.  Returns
// cudaErrorInvalidValue where a slot does not fit a block's shared memory,
// else cudaGetLastError() after the launch.
extern "C" int clock_forward(const float* y3, int n, int lanes, const float* suffix, int sfx,
                             const float* omega_in, const float* mu_in,
                             const float* last_in, const int* resid_in,
                             const float* bank, int chunk, int n_chunks, int k_max, int per_slot,
                             float omega_mid, float omega_lim, float gain_omega,
                             float gain_mu, float* outs, int* counts, float* omega_out,
                             float* mu_out, float* last_out, int* resid_out,
                             void* stream_handle) {
  const long long span = (long long)per_slot * chunk;
  const long long slot_len = (span < n ? span : n) + sfx;
  const long long smem = sizeof(float) * (kMmBankSize + 2 * slot_len) + sizeof(int) * 2 * per_slot;
  if (lanes < 1 || per_slot < 1 || smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mm_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const MmParams p{omega_mid, omega_lim, gain_omega, gain_mu};
  mm_chunked_kernel<<<lanes, kLaneThreads, smem, static_cast<cudaStream_t>(stream_handle)>>>(
      y3, n, lanes, suffix, sfx, omega_in, mu_in, last_in, resid_in, bank, chunk, n_chunks,
      k_max, per_slot, p, outs, counts, omega_out, mu_out, last_out, resid_out);
  return cudaGetLastError();
}

// B4 over y with per-lane n_valid, ii0, omega, mu and last (C,); at most
// num_symbols steps a lane, k_out >= num_symbols symbol slots, rows staged
// slot_rows at a time.  Writes outs, counts (C,) and the final omega, mu,
// last and read position (C,).  Returns cudaGetLastError() after the
// launch.
extern "C" int clock_ragged_forward(const float* y, long long len, int lanes,
                                    long long row_stride, long long lane_stride,
                                    const int* n_valid, const int* ii0, const float* omega_in,
                                    const float* mu_in, const float* last_in, const float* bank,
                                    int num_symbols, int k_out, long long out_k_stride,
                                    long long out_lane_stride, int slot_rows, float omega_mid,
                                    float omega_lim, float gain_omega, float gain_mu,
                                    float* outs, int* counts, float* omega_out, float* mu_out,
                                    float* last_out, int* ii_out, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const size_t smem = sizeof(float) * (kMmBankSize + 2 * (size_t)(slot_rows + kMmTaps));
  const MmParams p{omega_mid, omega_lim, gain_omega, gain_mu};
  mm_ragged_kernel<<<lanes, kLaneThreads, smem, stream>>>(
      y, len, row_stride, lane_stride, n_valid, ii0, omega_in, mu_in, last_in, bank,
      num_symbols, k_out, out_k_stride, out_lane_stride, slot_rows, p, outs, counts,
      omega_out, mu_out, last_out, ii_out);
  return cudaGetLastError();
}
