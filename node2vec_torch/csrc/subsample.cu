// K7 subsample_walks: gensim's frequent-vertex subsampling of a walk corpus.
//
// Replaces node2vec_tpu/models/word2vec.py:37-48 (_subsample_walks): each
// entry v >= 0 of an int32 [N, L+1] corpus survives when u < keep_prob[v]
// and otherwise becomes -1; entries < 0 stay.  The JAX version draws an
// [N, L+1] uniform tensor from jax.random; here u is the counter hash of
// hashrng.cuh keyed on (seed, base + flat position, stream tag), so no
// uniform tensor is written or read, and the plain PyTorch version
// (models/vocab.py: subsample_walks_plain) draws the same bits.  ``base`` is
// the flat position of the tensor's first entry in the corpus it is a slice
// of: a data shard of a corpus passes its first row times L+1 and draws what
// the whole corpus would draw there (the one-device trainers pass 0).  An
// index >= V reads keep_prob[V - 1], as the JAX gather clamps it.
//
// Design: a grid-stride loop, 16 bytes (four entries) per thread and load,
// one 4-byte keep_prob gather per live entry (the [V] table stays in L2),
// four hashes in registers, one 16-byte store.  ``out`` may alias
// ``walks``: every thread reads its four entries before it writes them.
//
// Bound on an H100: bytes, the corpus read once and written once plus the
// keep_prob gathers; the hash is ~20 integer ops an entry.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashrng.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t keep_or_drop(int32_t v, uint32_t pos, uint32_t seed,
                                                uint32_t tag, const float* __restrict__ keep,
                                                int32_t n_vertices) {
  if (v < 0) return v;
  const int32_t safe = v < n_vertices ? v : n_vertices - 1;
  const float u = n2v::hash_uniform(seed, pos, tag);
  return u < __ldg(keep + safe) ? v : -1;
}

__global__ void __launch_bounds__(kThreads)
subsample_kernel(const int32_t* walks, int64_t n, const float* __restrict__ keep,
                 int32_t n_vertices, uint32_t seed, uint32_t tag, uint32_t base,
                 int32_t* out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n4 = n / 4;
  const int4* walks4 = reinterpret_cast<const int4*>(walks);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = tid; i < n4; i += stride) {
    int4 q = walks4[i];
    const uint32_t pos = base + static_cast<uint32_t>(4 * i);
    q.x = keep_or_drop(q.x, pos, seed, tag, keep, n_vertices);
    q.y = keep_or_drop(q.y, pos + 1, seed, tag, keep, n_vertices);
    q.z = keep_or_drop(q.z, pos + 2, seed, tag, keep, n_vertices);
    q.w = keep_or_drop(q.w, pos + 3, seed, tag, keep, n_vertices);
    out4[i] = q;
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride)
    out[i] = keep_or_drop(walks[i], base + static_cast<uint32_t>(i), seed, tag, keep,
                          n_vertices);
}

}  // namespace

extern "C" int n2v_subsample_walks(const int32_t* walks, int64_t n, const float* keep,
                                   int32_t n_vertices, uint32_t seed, uint32_t tag,
                                   int64_t base, int32_t* out, void* stream) {
  if (n < 0 || base < 0 || n + base > (int64_t{1} << 32) || n_vertices < 0 ||
      reinterpret_cast<uintptr_t>(walks) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (n_vertices == 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  const int64_t blocks = want < 1 ? 1 : (want < 16LL * sms ? want : 16LL * sms);
  subsample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(walks, n, keep, n_vertices, seed, tag,
                                                          static_cast<uint32_t>(base), out);
  return static_cast<int>(cudaGetLastError());
}
