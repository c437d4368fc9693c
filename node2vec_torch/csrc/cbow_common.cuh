// Shared pieces of the two CBOW kernels, K9 cbow_grads (cbow.cu) and K10
// cbow_hs_grads (cbow_hs.cu): the context window of a center, the hidden
// vector h (node2vec_tpu/models/cbow.py:60 _context_mean) and the scatter
// of its gradient back onto the contexts (:94 _scatter_context_grads).
//
// Both kernels hold one walk at a time in shared memory (or their global
// staging slice, staging.cuh): vpos[L] (position
// valid and in the vocabulary), bsh[L] (its shrunk half-window) and cnt[L]
// (its context count), beside [L, D] rows.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace cbow {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// log(sigmoid(x)) = -softplus(-x), in the overflow-safe form
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// offset index o in [0, 2w) -> window offset d in -w..-1, 1..w (the JAX order)
__device__ __forceinline__ int offset_of(int o, int window) {
  return o < window ? o - window : o - window + 1;
}

// position i + d is a context of center i
__device__ __forceinline__ bool in_context(const int* vpos, const int* bsh, int L, int i,
                                           int d) {
  const int j = i + d;
  return vpos[i] && j >= 0 && j < L && vpos[j] && abs(d) <= bsh[i];
}

// cnt[i] = number of contexts of center i, for every position of the walk
__device__ __forceinline__ void context_counts(const int* vpos, const int* bsh, int L,
                                               int window, float* cnt) {
  for (int i = threadIdx.x; i < L; i += kThreads) {
    float c = 0.f;
    for (int o = 0; o < 2 * window; ++o) c += in_context(vpos, bsh, L, i, offset_of(o, window));
    cnt[i] = c;
  }
}

// h[i] = sum of the contexts' rows xin[i + d] (divided by max(cnt[i], 1)
// under cbow_mean), per (position, column), offsets in the JAX order
__device__ __forceinline__ void context_mean(const float* xin, const int* vpos, const int* bsh,
                                             const float* cnt, int L, int D, int window,
                                             bool mean, float* h) {
  for (int e = threadIdx.x; e < L * D; e += kThreads) {
    const int i = e / D, k = e % D;
    float acc = 0.f;
    for (int o = 0; o < 2 * window; ++o) {
      const int d = offset_of(o, window);
      if (in_context(vpos, bsh, L, i, d)) acc += xin[(i + d) * D + k];
    }
    h[e] = mean ? acc / fmaxf(cnt[i], 1.f) : acc;
  }
}

// g_in[j] = sum of gh[c] over the centers c whose context j is, written
// whole for the walk's [L, D] rows of g_in
__device__ __forceinline__ void scatter_context(const float* gh, const int* vpos, const int* bsh,
                                                int L, int D, int window,
                                                float* __restrict__ g_in) {
  for (int e = threadIdx.x; e < L * D; e += kThreads) {
    const int j = e / D, k = e % D;
    float acc = 0.f;
    for (int o = 0; o < 2 * window; ++o) {
      const int d = offset_of(o, window), c = j - d;
      if (c >= 0 && c < L && in_context(vpos, bsh, L, c, d)) acc += gh[c * D + k];
    }
    g_in[e] = acc;
  }
}

}  // namespace cbow
