// One chunk of the chunked Mueller & Mueller clock, shared by B2
// (clock.cu:mm_chunked_kernel) and the fused step (step.cu, B7), so both
// walk a chunk with the same device code and B7 gives B1 + B2's bits.
//
// Chunk t is walked in the coordinates of its own work buffer, as the plain
// version (ops/clock.py:clock_mm_chunked_plain) and the JAX package's scan
// backend (sdrmodem_tpu/dsp/clock_recovery.py:_clock_full_one) walk it:
// buf[0, w) = [the sfx rows before the chunk | the chunk's rows], the read
// position entering at sfx - resid.  The walk stops once the read position
// passes w - 8 or the k_max symbol slots are full; mm_step clamps a read
// position below 0 (a backward stride: gain_mu * mm is unbounded) to the
// buffer's first row.  So every window lies in buf[0, w), whatever the
// stride does, and a caller that holds the work buffer holds every window.

#pragma once

#include "mm_step.cuh"

namespace {

// Walks one chunk over buf[0, w), the lane's read position s.ii in buf's
// coordinates, and writes its symbols to out[k * out_stride], k < the
// returned count (the caller owns the slots past it).  On return s.ii is
// the next chunk's entry, sfx - resid with resid = min(w - ii, sfx - 1):
// the hand-off clips resid to sfx - 1 when the slots filled first, and a
// negative resid is the last stride's overshoot past the chunk's end.
__device__ __forceinline__ int mm_chunk(const float* s_bank, const MmParams& p, MmLane& s,
                                        const float* buf, int w, int sfx, int k_max, float* out,
                                        long long out_stride) {
  auto sample = [&](long long row) { return buf[row]; };
  int cnt = 0;
  for (; s.ii <= w - kMmTaps && cnt < k_max; ++cnt) out[cnt * out_stride] = mm_step(s_bank, p, s, sample);
  const long long resid = w - s.ii;
  s.ii = sfx - (resid < sfx - 1 ? resid : sfx - 1);
  return cnt;
}

}  // namespace
