// The stable bucketing of the graph-sharded walks' home kernels, shared by
// K20 ep_bucket (ep_walk.cu) and K24 epd_bucket (epd_walk.cu): each active
// lane is ranked within its destination in lane order, as JAX's one-hot
// cumsum ranks it, and a lane ranked below the capacity gets the flat slot
// dest * capacity + rank; every other lane gets n_shards * capacity.
//
// Two launches over tiles of kBucketTile lanes, one block a tile.  The
// first calls bucket_tile_count: each tile's active lanes per destination
// (shared atomics), written to tiles[tile][dest].  The second calls
// bucket_tile_rank: it adds the counts of earlier tiles (one thread a
// destination), ranks each lane within its warp by __match_any_sync and
// across the tile's warps by per-warp counts in shared memory.  Both are
// block-wide: every thread of the block calls them (lanes past the end as
// inactive).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace n2v {

constexpr int kBucketTile = 1024;  // lanes a block
constexpr int kBucketTileWarps = kBucketTile / 32;

// Shared memory of the two launches, in bytes.
__host__ __device__ inline size_t bucket_count_smem(int n_shards) {
  return n_shards * sizeof(int32_t);
}
__host__ __device__ inline size_t bucket_rank_smem(int n_shards) {
  return (1 + kBucketTileWarps) * n_shards * sizeof(int32_t);
}

// ``lane(&dest)`` says whether this thread's lane is active and, if so,
// sets its destination; each launch evaluates it once, after its shared
// counters are zeroed.  cnt: bucket_count_smem bytes of shared memory.
template <typename Lane>
__device__ __forceinline__ void bucket_tile_count(const Lane& lane, int n_shards, int32_t* cnt,
                                                  int32_t* __restrict__ tiles) {
  for (int d = threadIdx.x; d < n_shards; d += kBucketTile) cnt[d] = 0;
  __syncthreads();
  int32_t dest;
  if (lane(&dest)) atomicAdd(&cnt[dest], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < n_shards; d += kBucketTile)
    tiles[static_cast<int64_t>(blockIdx.x) * n_shards + d] = cnt[d];
}

// sm: bucket_rank_smem bytes of shared memory.  Returns the lane's flat slot.
template <typename Lane>
__device__ __forceinline__ int64_t bucket_tile_rank(const Lane& lane, int n_shards,
                                                    int64_t capacity,
                                                    const int32_t* __restrict__ tiles,
                                                    int32_t* sm) {
  int32_t* base = sm;  // [n_shards]: active lanes of earlier tiles
  int32_t* wcnt = sm + n_shards;  // [kBucketTileWarps][n_shards]
  for (int d = threadIdx.x; d < n_shards; d += kBucketTile) {
    int32_t s = 0;
    for (int tt = 0; tt < static_cast<int>(blockIdx.x); ++tt)
      s += tiles[static_cast<int64_t>(tt) * n_shards + d];
    base[d] = s;
  }
  for (int j = threadIdx.x; j < kBucketTileWarps * n_shards; j += kBucketTile) wcnt[j] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane_id = threadIdx.x & 31;
  int32_t dest;
  const bool active = lane(&dest);
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, active ? dest : -1);
  const int rank_w = __popc(peers & ((1u << lane_id) - 1u));
  if (active && __ffs(peers) - 1 == lane_id) wcnt[warp * n_shards + dest] = __popc(peers);
  __syncthreads();
  int64_t flat = n_shards * capacity;
  if (active) {
    int64_t off = base[dest] + rank_w;
    for (int w = 0; w < warp; ++w) off += wcnt[w * n_shards + dest];
    if (off < capacity) flat = dest * capacity + off;
  }
  return flat;
}

}  // namespace n2v
