// GMSK demodulator front end: [Doppler NCO mix] -> LPF1 -> quadrature demod
// -> LPF2 (decimating) -> DC blocker, over one full block of time-major f32 IQ.
//
// Replaces the TPU kernel sdrmodem_tpu/ops/pallas_front.py:_front_kernel
// (wrapper fused_front_call), with its optional Doppler stage.
//
// Bound on an H100: at 128 lanes x 2^20 samples with the lucky7 taps
// (157 / 57) the function needs ~46 G multiply-adds (LPF1 and LPF2; the DC
// blocker is four running sums, ~13 operations a sample; the Doppler mix
// ~56 operations a lane-sample) against ~1.1 GB of compulsory traffic (the
// IQ block read once, y3 written once), so it is bound by the f32 CUDA
// cores (~1.5 ms at 67 TFLOP/s), not by memory (~0.4 ms at 3.35 TB/s).
// Taking the DC blocker as its (4L-3) = 637-tap FIR, as this kernel does
// so that every gate stays bit for bit, adds ~43 G multiply-adds: ~2.8 ms
// of f32 work for this design.
//
// Design: two launches.
//   1. front_kernel: NCO -> LPF1 -> quad demod -> LPF2 in one pass.  A
//      thread block takes 32 lanes (a warp's threads on neighbouring lanes,
//      so every row of the time-major block is read in whole 32-byte
//      sectors and every tap is a broadcast) and one segment of the block's
//      rows, so lane groups x segments fill the SMs.  It walks its segment
//      in tiles of `tile` rows held in shared memory: cp.async stages the
//      tile's raw rows, and each thread mixes the rows it staged by the
//      Doppler rows that meet the tile (nco.cuh's row phase and rotation,
//      so the same bits as the row loop over the whole table; the table is
//      scanned once a segment for the rows that meet it, and each tile
//      picks its rows from those).  LPF1 runs through fir_block (fir.cuh)
//      on I and Q together, 16 rows a thread; the quad demod runs on the
//      LPF1 rows in registers (each 16-row group's first row after a
//      barrier, from the group before); LPF2 runs through fir_block with
//      its stride into y2 (y3 without a DC stage) in device memory.  After
//      a tile the last (taps - 1) rows of the mixed input
//      and of the quad-demod output move to the front of their buffers as
//      the next tile's histories.  The first segment starts from the
//      carried histories; a later one first recomputes `lead` rows before
//      its own from x (the mixed input's history loaded as it is), and
//      since every stage is a pure function of its inputs those rows give
//      the same bits.  The segment holding the block's last row writes the
//      four tails but the DC history.  y1, yq and the mixed block never
//      reach device memory.
//   2. dc_fir_forward: the DC blocker as a FIR over [dc_hist | y2]
//      (fir.cuh: fir_blocked_tm_kernel), 24 outputs a thread, the inputs
//      read from L1; the wrapper takes the DC history from y2.
// Every output of every FIR is summed in tap order from 0 with one fmaf a
// tap, as fir_dot sums it, so this front gives the bits of the banded
// front (the NCO, B3 and quad-demod kernels one at a time) and of the
// fused step (step.cu, B7).  The FIRs' inner loops issue almost only
// FMAs; what keeps the front above its bound is the DC blocker's FIR
// form, the quad demod's division and table lookups, the NCO's sin and
// cos, and the barriers between a tile's stages (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

#include "fir.cuh"
#include "nco.cuh"
#include "quad.cuh"
#include "stage.cuh"

namespace {

constexpr int kGroupLanes = 32;    // lanes a thread block, one a thread of each warp
constexpr int kRows1 = 16;         // LPF1 rows a thread
constexpr int kMaxWarps = 8;
constexpr int kSegRows = 8;        // Doppler rows a lane keeps for its segment
constexpr int kMaxSharedBytes = 232448;  // what one block may have on an H100 (227 KB)

struct FrontParams {
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
  int tile, seg_rows, lead;
  float* y;  // (block / decim, C): y2, or y3 without a DC stage
  float *lpf1_out, *quad_out, *lpf2_out;
};

// One block's shared memory, in floats; the host sizes the launch with it
// (ops/front.py:front_plan computes the same sum).
struct Layout {
  int table, tap1, tap2, xi, xq, yq, first, last, qp, dst, den, dix, dn, total;

  __host__ __device__ Layout(int t1, int t2, int tile) {
    const int g = kGroupLanes, groups = tile / kRows1;
    int o = 0;
    table = o, o += (kAtanTableSize + 3) & ~3;
    tap1 = o, o += (t1 + 3) & ~3;
    tap2 = o, o += (t2 + 3) & ~3;
    xi = o, o += (t1 - 1 + tile) * g;  // [LPF1 history | mixed tile], I and Q
    xq = o, o += (t1 - 1 + tile) * g;
    yq = o, o += (t2 - 1 + tile) * g;  // [LPF2 history | quad-demod output]
    first = o, o += 2 * groups * g;    // each LPF1 group's first row, I and Q
    last = o, o += 2 * groups * g;     // and its last
    qp = o, o += 2 * g;                // the LPF1 row before the tile
    dst = o, o += kSegRows * g;        // each lane's Doppler rows that meet its segment:
    den = o, o += kSegRows * g;        // start, end and row index (a float, exact),
    dix = o, o += kSegRows * g;
    dn = o, o += g;                    // and how many (-1: more than kSegRows)
    total = o;
  }
};

// The last h1, h1 and h2 rows of [history | n new rows] in xi, xq and yq
// (rows of kGroupLanes floats) become their histories: buf[0, h) = buf[n,
// n + h), as float4, in strips of n rows, each after the last one's reads.
// The caller syncs after it.
__device__ __forceinline__ void shift_histories(float* xi, float* xq, float* yq, int h1, int h2,
                                                int n, int tid, int threads) {
  constexpr int q = kGroupLanes / 4;  // float4 a row
  for (int base = 0; base < max(h1, h2); base += n) {
    if (base > 0) __syncthreads();
    const int m1 = max(0, min(n, h1 - base)) * q, m2 = max(0, min(n, h2 - base)) * q;
    float4* di = reinterpret_cast<float4*>(xi + base * kGroupLanes);
    float4* dq = reinterpret_cast<float4*>(xq + base * kGroupLanes);
    float4* dy = reinterpret_cast<float4*>(yq + base * kGroupLanes);
    for (int i = tid; i < 2 * m1 + m2; i += threads) {
      float4* dst = i < m1 ? di + i : i < 2 * m1 ? dq + (i - m1) : dy + (i - 2 * m1);
      *dst = dst[n * q];
    }
  }
}

// The rows for a tile [r0, r1], from the lane's segment list in shared
// memory (dst, den, dix; dn rows), or from the whole table where the
// segment met more than kSegRows.
__device__ __forceinline__ void keep_rows(const FrontParams& p, const float* sm, const Layout& L,
                                          int lane, int c, float r0, float r1, NcoKept& k) {
  const int n = (int)sm[L.dn + lane];
  if (n < 0) {
    nco_keep_rows(p.dop, p.dop_rows, p.lanes, c, r0, r1, k);
    return;
  }
  nco_keep_none(k);
  for (int j = 0; j < n; ++j) {
    const int at = j * kGroupLanes + lane;
    nco_keep_row(p.dop, p.dop_rows, p.lanes, c, (int)sm[L.dix + at], sm[L.dst + at], sm[L.den + at], r0,
                 r1, k);
  }
}

// LPF2 over the tile: output m of the tile reads yq rows [m d, m d + t2).
template <int D>
__device__ __forceinline__ void lpf2_tile(const FrontParams& p, const float* tap2, const float* yq,
                                          long long r, long long a, long long b, int lane, int c,
                                          bool live) {
  constexpr int R = D == 1 ? 16 : D == 2 ? 8 : 1;
  const int d = p.decim, n_out = p.tile / d;
  for (int g = threadIdx.y; g * R < n_out; g += blockDim.y) {
    float acc[1][R];
    const float* src = yq + (long long)g * R * d * kGroupLanes + lane;
    fir_block<R, D, 1>(tap2, p.t2, d, [&](int m, int) { return src[m * kGroupLanes]; }, acc);
    if (live) {
      const long long k0 = r / d + g * R;  // the group's first output of the block
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const long long row = (k0 + k) * d;  // the output's input row
        if (row >= a && row < b) p.y[(k0 + k) * p.lanes + c] = acc[0][k];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kGroupLanes * kMaxWarps, 2) front_kernel(const FrontParams p) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x, w = threadIdx.y, warps = blockDim.y;
  const int tid = w * kGroupLanes + lane, threads = kGroupLanes * warps;
  const int c_raw = blockIdx.x * kGroupLanes + lane;
  const bool live = c_raw < p.lanes;
  const int c = live ? c_raw : p.lanes - 1;
  const int lanes = p.lanes, tile = p.tile, groups = tile / kRows1;
  const int h1 = p.t1 - 1, h2 = p.t2 - 1;
  const long long block = p.block;
  const Layout L(p.t1, p.t2, tile);
  float *xi = sm + L.xi, *xq = sm + L.xq, *yq = sm + L.yq;
  float *first = sm + L.first, *last = sm + L.last, *qp = sm + L.qp;
  const float *tap1 = sm + L.tap1, *tap2 = sm + L.tap2, *table = sm + L.table;

  // this block's rows [a, b); the walk starts `lead` rows before a (a
  // multiple of decim), or at the block's first row with the carried state
  const long long a = (long long)blockIdx.y * p.seg_rows;
  const long long b = min(block, a + p.seg_rows);
  long long r = a > p.lead ? a - p.lead : 0;

  for (int j = tid; j < kAtanTableSize; j += threads) sm[L.table + j] = p.atan_table[j];
  for (int j = tid; j < p.t1; j += threads) sm[L.tap1 + j] = p.rev1[j];
  for (int j = tid; j < p.t2; j += threads) sm[L.tap2 + j] = p.rev2[j];
  // the mixed input's history: rows [r - h1, r), the carried rows before 0
  for (int k = w; k < h1; k += warps) {
    const long long row = r - h1 + k;
    float i = 0.f, q = 0.f;
    if (live && row < 0) {
      i = p.lpf1_hist[(h1 + row) * 2 * lanes + c];
      q = p.lpf1_hist[(h1 + row) * 2 * lanes + lanes + c];
    } else if (live) {
      i = p.x[row * 2 * lanes + c];
      q = p.x[row * 2 * lanes + lanes + c];
      if (p.dop != nullptr) {
        const float2 m = nco_mix_sample(p.dop, p.dop_rows, lanes, c, (float)row, i, q);
        i = m.x;
        q = m.y;
      }
    }
    xi[k * kGroupLanes + lane] = i;
    xq[k * kGroupLanes + lane] = q;
  }
  // LPF2's history and the LPF1 row before the walk: carried at row 0;
  // later, rows no output of this block reads
  for (int k = w; k < h2; k += warps) {
    yq[k * kGroupLanes + lane] = (r == 0 && live) ? p.lpf2_hist[(long long)k * lanes + c] : 0.f;
  }
  if (w == 0) {
    qp[lane] = (r == 0 && live) ? p.quad_prev[c] : 0.f;
    qp[kGroupLanes + lane] = (r == 0 && live) ? p.quad_prev[lanes + c] : 0.f;
  }
  if (w == 0 && p.dop != nullptr) {
    // the lane's table rows that meet the rows this walk mixes, in row order
    const float r0 = (float)r, r1 = (float)(min(block, b + tile) - 1);
    const long long plane = (long long)p.dop_rows * lanes;
    int n = 0;
    for (int s = 0; s < p.dop_rows && n >= 0; ++s) {
      const float st = p.dop[(long long)s * lanes + c], en = p.dop[plane + (long long)s * lanes + c];
      if (!(st <= r1 && en > r0)) continue;
      if (n == kSegRows) {
        n = -1;
      } else {
        sm[L.dst + n * kGroupLanes + lane] = st;
        sm[L.den + n * kGroupLanes + lane] = en;
        sm[L.dix + n * kGroupLanes + lane] = (float)s;
        ++n;
      }
    }
    sm[L.dn + lane] = (float)n;
  }
  __syncthreads();

  for (; r < b; r += tile) {
    const int nv = (int)min((long long)tile, block - r);  // rows of the tile inside the block

    // stage the tile's raw rows, then mix the rows this thread staged
    float* xi_t = xi + h1 * kGroupLanes + lane;
    float* xq_t = xq + h1 * kGroupLanes + lane;
    for (int k = w; k < tile; k += warps) {
      if (k < nv && live) {
        const float* in = p.x + (r + k) * 2 * lanes + c;
        cp_async4(xi_t + k * kGroupLanes, in);
        cp_async4(xq_t + k * kGroupLanes, in + lanes);
      } else {
        xi_t[k * kGroupLanes] = 0.f;
        xq_t[k * kGroupLanes] = 0.f;
      }
    }
    cp_async_wait_all();
    if (p.dop != nullptr && live) {
      NcoKept kept;
      keep_rows(p, sm, L, lane, c, (float)r, (float)(r + nv - 1), kept);
      for (int k = w; k < nv; k += warps) {
        const float2 m = nco_mix_kept(p.dop, p.dop_rows, p.lanes, kept, c, (float)(r + k),
                                      xi_t[k * kGroupLanes], xq_t[k * kGroupLanes]);
        xi_t[k * kGroupLanes] = m.x;
        xq_t[k * kGroupLanes] = m.y;
      }
    }
    __syncthreads();

    // LPF1 on I and Q, kRows1 rows a thread, and the quad demod of every row
    // of the group but its first; the LPF1 row nv - 1 becomes the next qp
    float2 qn = make_float2(0.f, 0.f);
    bool has_qn = false;
    for (int g = w; g < groups; g += warps) {
      float acc[2][kRows1];
      const float* src_i = xi + g * kRows1 * kGroupLanes + lane;
      const float* src_q = xq + g * kRows1 * kGroupLanes + lane;
      fir_block<kRows1, 1, 2>(tap1, p.t1, 1, [&](int m, int ch) {
        return (ch == 0 ? src_i : src_q)[m * kGroupLanes];
      }, acc);
      float* out = yq + (h2 + g * kRows1) * kGroupLanes + lane;
#pragma unroll
      for (int k = 1; k < kRows1; ++k) {
        out[k * kGroupLanes] = quad_demod_sample(acc[0][k], acc[1][k], acc[0][k - 1], acc[1][k - 1],
                                                 table, p.quad_gain);
      }
      first[g * kGroupLanes + lane] = acc[0][0];
      first[(groups + g) * kGroupLanes + lane] = acc[1][0];
      last[g * kGroupLanes + lane] = acc[0][kRows1 - 1];
      last[(groups + g) * kGroupLanes + lane] = acc[1][kRows1 - 1];
#pragma unroll
      for (int k = 0; k < kRows1; ++k) {
        if (g * kRows1 + k == nv - 1) {
          qn = make_float2(acc[0][k], acc[1][k]);
          has_qn = true;
        }
      }
    }
    __syncthreads();
    // each group's first row, against the row before it
    for (int g = w; g < groups; g += warps) {
      const float si = g == 0 ? qp[lane] : last[(g - 1) * kGroupLanes + lane];
      const float sq = g == 0 ? qp[kGroupLanes + lane] : last[(groups + g - 1) * kGroupLanes + lane];
      yq[(h2 + g * kRows1) * kGroupLanes + lane] =
          quad_demod_sample(first[g * kGroupLanes + lane], first[(groups + g) * kGroupLanes + lane], si,
                            sq, table, p.quad_gain);
    }
    __syncthreads();
    if (has_qn) {
      qp[lane] = qn.x;
      qp[kGroupLanes + lane] = qn.y;
    }

    lpf2_tile<D>(p, tap2, yq, r, a, b, lane, c, live);
    __syncthreads();

    if (b == block && r + tile >= block && live) {
      // the block's last tile: the tails are the nv rows' last h1 / h2 rows
      for (int k = w; k < h1; k += warps) {
        p.lpf1_out[(long long)k * 2 * lanes + c] = xi[(nv + k) * kGroupLanes + lane];
        p.lpf1_out[(long long)k * 2 * lanes + lanes + c] = xq[(nv + k) * kGroupLanes + lane];
      }
      for (int k = w; k < h2; k += warps) {
        p.lpf2_out[(long long)k * lanes + c] = yq[(nv + k) * kGroupLanes + lane];
      }
      if (w == 0) {
        p.quad_out[c] = qp[lane];
        p.quad_out[lanes + c] = qp[kGroupLanes + lane];
      }
    }
    if (r + tile < b) {
      shift_histories(xi, xq, yq, h1, h2, tile, tid, threads);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory one block of front_kernel takes at these sizes.
extern "C" int front_shared_bytes(int t1, int t2, int tile) {
  return Layout(t1, t2, tile).total * (int)sizeof(float);
}

// Launch 1 over one full block: NCO, LPF1, quad demod and LPF2.  x is
// (block, 2C); the hists are (taps - 1, lanes) in the DemodStateFull
// layout; the taps are reversed.  dop is the (5, dop_rows, C) NCO table
// (nco.cuh) or null for no Doppler stage.  The plan (ops/front.py:
// front_plan): `tile` rows a tile (a multiple of kRows1 and of decim times
// LPF2's rows a thread), `warps` warps a block, `seg_rows` rows a segment
// and `lead` rows recomputed before a later segment (multiples of decim).
// Writes y (block / decim, C), LPF2's output (y2, or y3 without a DC
// stage), lpf1_out (t1 - 1, 2C), quad_out (1, 2C) and lpf2_out (t2 - 1, C).
// Returns cudaGetLastError() after the launch.
extern "C" int front_forward(const float* x, int block, int lanes, const float* dop, int dop_rows,
                             const float* lpf1_hist, const float* rev1, int t1,
                             const float* quad_prev, float quad_gain, const float* atan_table,
                             const float* lpf2_hist, const float* rev2, int t2, int decim,
                             int tile, int warps, int seg_rows, int lead, float* y,
                             float* lpf1_out, float* quad_out, float* lpf2_out,
                             void* stream_handle) {
  if (dop == nullptr) dop_rows = 0;
  const int bytes = front_shared_bytes(t1, t2, tile);
  const int r2 = decim == 1 ? 16 : decim == 2 ? 8 : 1;
  if (bytes > kMaxSharedBytes || lanes < 1 || block < decim || block % decim != 0 || warps < 1 ||
      warps > kMaxWarps || tile % kRows1 != 0 || tile % (decim * r2) != 0 || seg_rows < 1 ||
      seg_rows % decim != 0 || lead % decim != 0 || lead < t2) {
    return cudaErrorInvalidValue;
  }
  const FrontParams p{x, block, lanes, dop, dop_rows, lpf1_hist, rev1, t1, quad_prev, quad_gain,
                      atan_table, lpf2_hist, rev2, t2, decim, tile, seg_rows, lead,
                      y, lpf1_out, quad_out, lpf2_out};
  const dim3 grid((lanes + kGroupLanes - 1) / kGroupLanes, (block + seg_rows - 1) / seg_rows);
  const dim3 threads(kGroupLanes, warps);
  auto kernel = decim == 1 ? front_kernel<1> : decim == 2 ? front_kernel<2> : front_kernel<0>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream_handle)>>>(p);
  return cudaGetLastError();
}

// Launch 2, the DC blocker's FIR: y3 (n2, C) over [dc_hist (t3 - 1, C) |
// y2 (n2, C)], seg_rows outputs a thread block.  Returns
// cudaGetLastError() after the launch.
extern "C" int dc_fir_forward(const float* dc_hist, const float* y2, int n2, int lanes,
                              const float* rev_dc, int t3, int seg_rows, float* y3,
                              void* stream_handle) {
  if (lanes < 1 || n2 < 1 || t3 < 1 || seg_rows < 1) return cudaErrorInvalidValue;
  return launch_fir_blocked<float>(dc_hist, y2, n2, lanes, rev_dc, t3, 1, n2, seg_rows, y3,
                                   static_cast<cudaStream_t>(stream_handle));
}

namespace {

// yq[k, c] = gain * atan2(im, re) of y1[k] * conj(y1[k-1]); y1 is (rows, 2C)
// with I in lanes [0, C) and Q in [C, 2C); y1[-1] is prev (the carried row).
// kLut: the reference's table arctangent; else atan2f.
template <bool kLut>
__global__ void quad_demod_kernel(const float* __restrict__ y1,
                                  const float* __restrict__ prev, int rows,
                                  int lanes, const float* __restrict__ table,
                                  float gain, float* __restrict__ yq) {
  __shared__ float s_table[kAtanTableSize];
  if (kLut) {
    for (int j = threadIdx.x; j < kAtanTableSize; j += blockDim.x) s_table[j] = table[j];
    __syncthreads();
  }

  const long long n = (long long)rows * lanes;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long k = idx / lanes;
    const int c = (int)(idx - k * lanes);
    const float* cur = y1 + k * 2 * lanes;
    const float* prv = k == 0 ? prev : cur - 2 * lanes;
    yq[idx] = kLut ? quad_demod_sample(cur[c], cur[lanes + c], prv[c], prv[lanes + c], s_table, gain)
                   : quad_demod_sample_atan2(cur[c], cur[lanes + c], prv[c], prv[lanes + c], gain);
  }
}

}  // namespace

// The quad-demod stage alone, for the banded front: yq (rows, C) from y1
// (rows, 2C) and the carried row prev (1, 2C); atan_lut 1 takes the table,
// 0 atan2f.
extern "C" int quad_demod_forward(const float* y1, const float* prev, int rows, int lanes,
                                  const float* atan_table, int atan_lut, float quad_gain,
                                  float* yq, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long n = (long long)rows * lanes;
  const long long want = (n + 255) / 256;
  const int grid = (int)(want < 4096 ? want : 4096);
  auto kernel = atan_lut ? quad_demod_kernel<true> : quad_demod_kernel<false>;
  kernel<<<grid, 256, 0, stream>>>(y1, prev, rows, lanes, atan_table, quad_gain, yq);
  return cudaGetLastError();
}

// The Doppler NCO stage alone, for the banded front: y (rows, 2C) is x
// mixed by the (5, dop_rows, C) table.
extern "C" int nco_mix_forward(const float* x, int rows, int lanes, const float* dop,
                               int dop_rows, float* y, void* stream_handle) {
  return launch_nco_mix(x, rows, lanes, dop, dop_rows, y,
                        static_cast<cudaStream_t>(stream_handle));
}
