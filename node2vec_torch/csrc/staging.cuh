// Where the walk-at-a-time step kernels (K2 sgns.cu, K8 hs.cu, K9 cbow.cu,
// K10 cbow_hs.cu, K13 sgns_pairs.cu, K16 and K17 col_sgns.cu) stage a walk's
// arrays.
//
// Each of those kernels carves every array it keeps for a walk from one
// base pointer.  In shared mode the base is the block's dynamic shared
// memory, as large as the card allows a block (232,448 B on an H100).  A
// shape that needs more (dim 256 at walk length 80, the node2vec paper's
// settings) runs in global mode: the base is the block's slice of a
// workspace in device memory, ws + blockIdx.x * stride, and the launch asks
// for no dynamic shared memory.  The body is the same in both modes (one
// __forceinline__ block function a kernel; __syncthreads() orders a block's
// global writes as it orders its shared ones, and every carved array keeps
// its 4-byte alignment).  The shared-mode kernel keeps its own signature and
// passes its extern __shared__ array, so it compiles as it did before global
// staging existed; the staged kernel takes (ws, stride) after the same
// arguments.
//
// The wrapper (node2vec_torch/_build.py: staging) picks the mode from the
// shape before the launch and sizes the workspace as blocks * stride floats;
// the stride formula below and _build.staging_stride must agree.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace n2v {

// floats of workspace a block stages in: the shared carve rounded up to 128 B
inline int64_t staging_stride(size_t smem_bytes) {
  return static_cast<int64_t>((smem_bytes + 127) / 128 * 32);
}

// Launches shared_kernel(args...) with `smem` bytes of dynamic shared memory
// on as many blocks as fit on the card (at most one a walk) when ws is null;
// otherwise staged_kernel(args..., ws, stride) on min(n_walks, ws_blocks)
// blocks.  Returns the launch's cudaError_t.
template <typename... SharedParams, typename... StagedParams, typename... Args>
int launch_staged(void (*shared_kernel)(SharedParams...),
                  void (*staged_kernel)(StagedParams...),
                  int threads, size_t smem, int n_walks, float* ws, int ws_blocks,
                  cudaStream_t stream, Args... args) {
  if (ws != nullptr) {
    if (ws_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = n_walks < ws_blocks ? n_walks : ws_blocks;
    staged_kernel<<<grid, threads, 0, stream>>>(args..., ws, staging_stride(smem));
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(shared_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shared_kernel, threads,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = n_walks < per_sm * n_sm ? n_walks : per_sm * n_sm;
  shared_kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace n2v
