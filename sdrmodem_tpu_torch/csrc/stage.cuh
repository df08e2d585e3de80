// Staging rows of device memory into shared memory with cp.async, shared by
// the front end (front.cu, launch 1) and the standalone FIRs (fir.cuh).
//
// A thread issues 4-byte copies: a row of the time-major input holds one
// float a lane, and a group of 32 lanes starts anywhere in it, so 16-byte
// copies would need an alignment the callers cannot promise.  The copies
// of one thread complete in the order they were committed (cp.async's
// groups), so a caller double-buffers by committing a stage, issuing the
// next, and waiting for all but the newest group.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Elements i = first, first + step, ... < n: dst(i) gets *src(i) by
// cp.async, or 0 where src(i) is null (a row past the input's end, a lane
// past the last).  The zeros are plain stores, visible after the caller's
// barrier like the copies after its wait.
template <typename Dst, typename Src>
__device__ __forceinline__ void stage_elements(int n, int first, int step, Dst dst, Src src) {
  for (int i = first; i < n; i += step) {
    float* d = dst(i);
    const float* s = src(i);
    if (s != nullptr) {
      cp_async4(d, s);
    } else {
      *d = 0.f;
    }
  }
}

}  // namespace
