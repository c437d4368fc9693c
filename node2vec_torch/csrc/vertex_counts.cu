// K6 vertex_counts: how often each vertex occurs in a walk corpus.
//
// Replaces the device count of node2vec_tpu/models/vocab.py:104-115
// (build_vocab on a device array: a scatter-add of ones over the entries
// >= 0 of the [N, L+1] corpus into an int32 [V] array).  Entries outside
// [0, V) are dropped, as the JAX scatter drops out-of-bounds indices.
// The kernel adds into ``counts`` and never clears it, so the same launch
// is also the per-chunk count of node2vec_tpu/models/word2vec.py:51-79
// (_streaming_counts): the caller keeps one counts array across chunks.
//
// Design: a grid-stride loop, 16 bytes (four entries) per thread and load,
// one atomicAdd into the [V] counts per entry.  A walk visits different
// vertices at neighbouring positions, so warp aggregation finds few equal
// keys, and V is too large (2 MB at V = 524k) for per-block shared-memory
// bins.
//
// Bound on an H100: bytes, the corpus read once plus V*4 written; the
// atomics resolve in L2, so a corpus whose counts fit in L2 (50 MB) runs
// near the read rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void count(int32_t v, int32_t* counts, int32_t n_vertices) {
  if (v >= 0 && v < n_vertices) atomicAdd(counts + v, 1);
}

__global__ void __launch_bounds__(kThreads)
vertex_counts_kernel(const int32_t* __restrict__ walks, int64_t n, int32_t* __restrict__ counts,
                     int32_t n_vertices) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n4 = n / 4;
  const int4* walks4 = reinterpret_cast<const int4*>(walks);
  for (int64_t i = tid; i < n4; i += stride) {
    const int4 q = __ldg(walks4 + i);
    count(q.x, counts, n_vertices);
    count(q.y, counts, n_vertices);
    count(q.z, counts, n_vertices);
    count(q.w, counts, n_vertices);
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) count(__ldg(walks + i), counts, n_vertices);
}

}  // namespace

extern "C" int n2v_vertex_counts(const int32_t* walks, int64_t n, int32_t* counts,
                                 int32_t n_vertices, void* stream) {
  if (n < 0 || n_vertices < 0 || reinterpret_cast<uintptr_t>(walks) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_vertices == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  const int64_t blocks = want < 1 ? 1 : (want < 8LL * sms ? want : 8LL * sms);
  vertex_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(walks, n, counts, n_vertices);
  return static_cast<int>(cudaGetLastError());
}
