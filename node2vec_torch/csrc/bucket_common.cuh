// The stable bucketing of the graph-sharded walks' home kernels, K20
// ep_bucket (ep_walk.cu) and K24 epd_bucket (epd_walk.cu), and of K18
// route_plan's passes (route.cu): each active lane is ranked within its
// destination in lane order, as JAX's one-hot cumsum ranks it, and a lane
// ranked below the capacity gets the flat slot dest * capacity + rank; every
// other lane gets n_shards * capacity.
//
// K24: two launches over tiles of kBucketTile lanes, one block a tile.  The
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
#include <mutex>

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


// ---- The one-launch grid ranking: K20, and K18's radix passes and owner
// buckets (K24 keeps the two launches above) ----
//
// One cooperative launch of a persistent grid, every block resident (so a
// grid barrier cannot wait on a block that never starts): block b takes the
// contiguous tiles [b * k, min((b + 1) * k, n_tiles)), one item a thread.
// Before a grid barrier each block stores its items' count of each bucket in
// row b of a [grid, stride] array; after it, grid_bases sums those rows
// block-parallel (the rows before the block's own, and all of them), and the
// block ranks its tiles' items in order: within a tile, tile_offset ranks an
// item among the earlier items of its bucket, within its warp by
// __match_any_sync and across the warps by an exclusive scan of the per-warp
// counts (a warp a bucket).  Ranks are stable in item order and no thread
// sums over tiles.  grid_fill writes a value into every row of a bucketed
// buffer past its bucket's count, spread over the grid.  What other blocks
// wrote in the same launch is read with __ldcg (past L1).

constexpr unsigned kBucketFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kBucketFull, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

// The active items of this thread's bucket earlier in the tile (thread
// order), whether or not its own item is active (so an inactive item learns
// how many came before it); the tile's count of each bucket into tt[0 .. S).
// Block-wide; every bucket in [0, S).  wc: S * kThreads / 32 ints; tt: S.
template <int kThreads>
__device__ __forceinline__ int tile_offset(bool active, int bucket, int S, int32_t* wc,
                                           int32_t* tt) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with wc and tt
  for (int j = threadIdx.x; j < S * kWarps; j += kThreads) wc[j] = 0;
  __syncthreads();
  const unsigned peers =
      __match_any_sync(kBucketFull, bucket) & __ballot_sync(kBucketFull, active);
  const int below = __popc(peers & ((1u << lane) - 1u));
  if (active && below == 0) wc[bucket * kWarps + warp] = __popc(peers);
  __syncthreads();
  for (int d = warp; d < S; d += kWarps) {  // [d][warp] -> counts of the warps before
    const int v = lane < kWarps ? wc[d * kWarps + lane] : 0;
    const int incl = warp_inclusive_sum(v);
    if (lane < kWarps) wc[d * kWarps + lane] = incl - v;
    if (lane == 31) tt[d] = incl;
  }
  __syncthreads();
  return wc[bucket * kWarps + warp] + below;
}

__device__ __forceinline__ int warp_total(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kBucketFull, v, o);
  return v;
}

// pre[d]: the sum of cnt[j * stride + d] over the blocks j < me; tot[d]: over
// all n_blocks.  Block-wide; S <= kThreads.  Under 32 buckets a warp takes a
// bucket, its lanes the blocks; from 32 a thread takes a bucket and a share
// of the blocks, so that a warp's loads of a row are contiguous.  Either way
// the loads are unrolled, to be in flight together.
template <int kThreads>
__device__ __forceinline__ void grid_bases(const int32_t* cnt, int stride, int n_blocks, int me,
                                           int S, int32_t* pre, int32_t* tot) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the caller is done with pre and tot
  if (S < 32) {
    for (int d = warp; d < S; d += kWarps) {
      int p = 0, t = 0;
#pragma unroll 4
      for (int j = lane; j < n_blocks; j += 32) {
        const int v = __ldcg(cnt + static_cast<int64_t>(j) * stride + d);
        t += v;
        p += j < me ? v : 0;
      }
      p = warp_total(p);
      t = warp_total(t);
      if (lane == 0) {
        pre[d] = p;
        tot[d] = t;
      }
    }
    __syncthreads();
    return;
  }
  for (int d = threadIdx.x; d < S; d += kThreads) {
    pre[d] = 0;
    tot[d] = 0;
  }
  __syncthreads();
  const int rows = kThreads / S;  // rows summed at once
  const int d = threadIdx.x % S;
  const int j0 = threadIdx.x / S;
  if (j0 < rows) {
    int p = 0, t = 0;
#pragma unroll 8
    for (int j = j0; j < n_blocks; j += rows) {
      const int v = __ldcg(cnt + static_cast<int64_t>(j) * stride + d);
      t += v;
      p += j < me ? v : 0;
    }
    if (p) atomicAdd(&pre[d], p);
    if (t) atomicAdd(&tot[d], t);
  }
  __syncthreads();
}

// v into every int of the rows [d * cap + min(tot[d], cap), (d + 1) * cap) of
// out [S * cap, F]: the rows that no item filled.  Grid-wide; ends: S + 1
// int64 of shared memory.
template <int kThreads>
__device__ __forceinline__ void grid_fill(int32_t* out, int F, int S, int64_t cap,
                                          const int32_t* tot, int64_t* ends, int32_t v) {
  if (threadIdx.x < 32) {  // ends[d]: the unfilled ints of the buckets before d
    const int lane = threadIdx.x;
    long long before = 0;
    for (int d0 = 0; d0 < S; d0 += 32) {
      const int d = d0 + lane;
      const long long filled = d < S && tot[d] < cap ? tot[d] : cap;
      const long long u = d < S ? (cap - filled) * F : 0;
      long long incl = u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long x = __shfl_up_sync(kBucketFull, incl, o);
        if (lane >= o) incl += x;
      }
      if (d < S) ends[d] = before + incl - u;
      before += __shfl_sync(kBucketFull, incl, 31);
    }
    if (lane == 0) ends[S] = before;
  }
  __syncthreads();
  const int64_t total = ends[S];
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; u < total;
       u += static_cast<int64_t>(gridDim.x) * kThreads) {
    int lo = 0, hi = S - 1;  // the last bucket with ends[lo] <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (ends[mid] <= u) lo = mid; else hi = mid - 1;
    }
    const int64_t filled = tot[lo] < cap ? tot[lo] : cap;
    out[(lo * cap + filled) * F + (u - ends[lo])] = v;
  }
}

// Blocks of ``kernel`` resident on the card at once (a cooperative launch's
// most), asked of the runtime once a kernel and device: the occupancy query
// costs host time on every launch otherwise.
inline cudaError_t resident_blocks(const void* kernel, int threads, int64_t* most) {
  struct Entry {
    const void* kernel;
    int dev;
    int64_t most;
  };
  static std::mutex lock;
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int k = 0; k < used; ++k) {
    if (cache[k].kernel == kernel && cache[k].dev == dev) {
      *most = cache[k].most;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *most = static_cast<int64_t>(per_sm) * sms;
  if (used < 16) cache[used++] = Entry{kernel, dev, *most};
  return cudaSuccess;
}

// The tiles a block takes so that the whole grid is resident at once (the
// condition of a cooperative launch), and the grid; an error when no block
// fits on an SM.
inline cudaError_t grid_geometry(const void* kernel, int threads, int64_t n_tiles,
                                 int64_t* per_block, int64_t* grid) {
  int64_t most = 0;
  const cudaError_t err = resident_blocks(kernel, threads, &most);
  if (err != cudaSuccess) return err;
  *per_block = (n_tiles + most - 1) / most;
  *grid = (n_tiles + *per_block - 1) / *per_block;
  return cudaSuccess;
}

}  // namespace n2v
