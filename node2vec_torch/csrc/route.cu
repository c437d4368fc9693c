// K18 route_plan and K19 route_rows: the routing of the row-sharded
// trainers (node2vec_tpu/parallel/rowsharded_sgns.py, rowsharded_hs.py).
//
// K18 route_plan replaces _plan_routes (rowsharded_sgns.py:170-203): a
// step's request vector ids [R] (walk positions mapped -1 -> 0, the shared
// negatives, Huffman tail path entries) is deduplicated; the unique ids,
// ascending, get an owner (id mod N, floor) and a rank within the owner's
// bucket in ascending id order; a unique whose rank reaches `cap` is dropped.
// The outputs are the JAX RoutePlan's fields (uniq zero-padded past
// n_uniq, inv, is_uniq, owner = N and rank = u - n_uniq on dead slots, ok,
// send_ids [N, cap] -1-padded, n_dropped), and two the port adds:
//   slot [R]   the request's row in the [N * cap] buffer that comes back
//              from the owners (owner * cap + rank), -1 where dropped;
//   order [R]  the request positions in sorted (id, position) order, which
//              K19's pack walks.
//
// Design.  The keys are (id, position) packed into one 64-bit word (the id
// with its sign bit flipped in the high half), so all keys differ and every
// sort order is total: no stability question arises, and ascending id order
// is what makes the rows dropped on overflow the ones JAX drops (the
// largest ids of an over-full bucket).  1. Tiles of 2,048 keys are sorted
// in shared memory by cub::BlockRadixSort; the scans and reductions below
// are cub::BlockScan and cub::BlockReduce (block-scope header templates of
// the CUDA toolkit, like a warp shuffle; no device-wide CUB or Thrust
// algorithm is used).  2. Runs are merged pairwise, one thread a key: its
// place is its index in its run plus the number of keys of the partner run
// below it (a binary search), log2(R / 2048) launches.  3. Scans over tiles
// of 4,096, each block adding the totals of the tiles before it: the head
// flags give each key its unique slot (uniq, inv, order, n_uniq); per-tile
// counts by owner, then one block scan an owner, give each unique its rank
// in its owner's bucket; then ok, send_ids, n_dropped (atomics of the
// blocks' sums), the dead slots, and each request's slot.  The workspace is
// two [R] arrays of 64-bit keys and [R / 4,096 * (N + 1)] ints: O(R), never
// O(V), since the layout exists for V beyond one card.
//
// K19 route_rows, two launches:
//   gather (owner side of _routed_gather, rowsharded_sgns.py:216-222):
//     out[j] = table_local[recv_ids[j] / N], zeros where recv_ids[j] < 0;
//   pack (requester side of _routed_apply, :244-251, with the per-unique
//   segment sums of the steps, :355-381 and rowsharded_hs.py:317-340): for
//     each unique u with ok[u], row (owner, rank) of send [N * cap, D + 1]
//     gets the sum of its live requests' gradient rows and, in column D, the
//     sum of their mean squares; the rest of send stays as the caller zeroed
//     it.  A request p reads row p of g_a (p < n_a) or row p - n_a of g_b; it
//     is live where its live array holds a value >= 0 (the flat walks, HS's
//     tail rows), or always where that array is null (SGNS's d_no rows).
//   The gather takes one warp a row.  The pack takes one warp a chunk of 32
//   requests in sorted order, so a unique's requests are consecutive: the
//   warp sums each run in registers and stores it in the unique's row, or,
//   for a unique whose requests continue into a neighbouring chunk, adds it
//   with fp32 atomics.  A unique may have hundreds of thousands of requests
//   (HS's tail entries past a code's length all ask for row 0), so no unique
//   is left to one warp; the atomics make those rows' sums' order vary.
//
// Bound on an H100: memory.  K18 reads the ids and writes the plan (a
// handful of [R] int32 arrays and send_ids) once; its sort moves 8 B a key
// per pass.  The gather reads the live requested rows and writes [N * cap,
// D]; the pack reads the requests' gradient rows and writes [N * cap, D + 1].

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

using u64 = unsigned long long;

constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;
constexpr int kTile = kSortThreads * kSortItems;  // keys a tile-sort block sorts
constexpr int kMergeThreads = 256;
constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // keys (or unique slots) a scan block takes
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPackChunk = 32;  // sorted requests a pack warp takes: one a lane, so that
                                // many warps hide the rows' load latency
constexpr int kMaxColsPerLane = 32;  // dim <= 1024 (the trainers' vector_size limit)

__device__ __forceinline__ u64 pack_key(int32_t id, int64_t pos) {
  return (static_cast<u64>(static_cast<uint32_t>(id) ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(pos);
}

__device__ __forceinline__ int32_t key_id(u64 k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t key_pos(u64 k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k));
}

__device__ __forceinline__ int floor_mod(int32_t v, int n) {
  int m = v % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 1. each block sorts one tile of (id, position) keys
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const int32_t* __restrict__ ids, int64_t r, u64* __restrict__ out) {
  using Sort = cub::BlockRadixSort<u64, kSortThreads, kSortItems>;
  __shared__ typename Sort::TempStorage tmp;
  u64 keys[kSortItems];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kSortItems;
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int64_t i = base + k;
    keys[k] = i < r ? pack_key(ids[i], i) : ~0ull;  // padding sorts last
  }
  Sort(tmp).Sort(keys);
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int64_t i = base + k;
    if (i < r) out[i] = keys[k];
  }
}

// 2. merge sorted runs of width w pairwise (all keys are distinct)
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const u64* __restrict__ in, u64* __restrict__ out, int64_t r, int64_t w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (i >= r) return;
  const int64_t run = i / w;
  const int64_t start = run * w;
  const int64_t pstart = (run ^ 1) * w;
  const u64 key = in[i];
  int64_t lo = pstart < r ? pstart : r;
  int64_t hi = pstart + w < r ? pstart + w : r;
  const int64_t first = lo;
  while (lo < hi) {  // partner keys below key
    const int64_t mid = (lo + hi) >> 1;
    if (in[mid] < key) lo = mid + 1; else hi = mid;
  }
  out[(run & ~static_cast<int64_t>(1)) * w + (i - start) + (lo - first)] = key;
}

struct PlanOut {
  int32_t *uniq, *inv, *owner, *rank, *send_ids, *n_out, *slot, *order;
  uint8_t *is_uniq, *ok;
};

__device__ __forceinline__ bool is_head(const u64* sorted, int64_t i) {
  return i == 0 || key_id(sorted[i]) != key_id(sorted[i - 1]);
}

// 3a. heads (first keys of an id) in each tile of sorted keys
__global__ void __launch_bounds__(kScanThreads)
head_count_kernel(const u64* __restrict__ sorted, int64_t r, int* __restrict__ tile_heads) {
  using Reduce = cub::BlockReduce<int, kScanThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  int heads = 0;
  for (int k = 0; k < kScanItems; ++k)
    if (base + k < r) heads += is_head(sorted, base + k);
  const int total = Reduce(tmp).Sum(heads);
  if (threadIdx.x == 0) tile_heads[blockIdx.x] = total;
}

// the sum of v[0 .. n) over the block, on every thread
__device__ __forceinline__ int block_prefix(const int* __restrict__ v, int n, int stride) {
  using Reduce = cub::BlockReduce<int, kScanThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  __shared__ int total;
  int part = 0;
  for (int b = threadIdx.x; b < n; b += kScanThreads) part += v[static_cast<int64_t>(b) * stride];
  const int t = Reduce(tmp).Sum(part);
  if (threadIdx.x == 0) total = t;
  __syncthreads();
  return total;
}

// 3b. each key's unique slot: uniq, inv, order; n_uniq (block 0)
__global__ void __launch_bounds__(kScanThreads)
slot_kernel(const u64* __restrict__ sorted, int64_t r, const int* __restrict__ tile_heads,
            int n_tiles, PlanOut o) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int offset = block_prefix(tile_heads, blockIdx.x, 1);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  int heads = 0;
  for (int k = 0; k < kScanItems; ++k)
    if (base + k < r) heads += is_head(sorted, base + k);
  int before;
  Scan(tmp).ExclusiveSum(heads, before);
  int s = offset + before - 1;  // a thread that starts mid-run continues slot s
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k;
    if (i >= r) break;
    const u64 key = sorted[i];
    if (is_head(sorted, i)) o.uniq[++s] = key_id(key);
    o.inv[key_pos(key)] = s;
    o.order[i] = key_pos(key);
  }
  if (blockIdx.x == 0) {
    const int n_uniq = block_prefix(tile_heads, n_tiles, 1);
    if (threadIdx.x == 0) {
      o.n_out[0] = n_uniq;
      o.n_out[1] = 0;
    }
  }
}

// 3c. each tile of unique slots' count a owner; send_ids to -1
__global__ void __launch_bounds__(kScanThreads)
owner_count_kernel(int64_t r, int n_dev, int cap, int* __restrict__ tile_cnt, PlanOut o) {
  extern __shared__ int cnt[];  // [n_dev]
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x;
       i < static_cast<int64_t>(n_dev) * cap; i += static_cast<int64_t>(gridDim.x) * kScanThreads)
    o.send_ids[i] = -1;
  for (int q = threadIdx.x; q < n_dev; q += kScanThreads) cnt[q] = 0;
  __syncthreads();
  const int n_uniq = o.n_out[0];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  for (int k = 0; k < kScanItems; ++k)
    if (base + k < n_uniq) atomicAdd(&cnt[floor_mod(o.uniq[base + k], n_dev)], 1);
  __syncthreads();
  for (int q = threadIdx.x; q < n_dev; q += kScanThreads)
    tile_cnt[static_cast<int64_t>(blockIdx.x) * n_dev + q] = cnt[q];
}

// 3d. ranks in the owners' buckets (ascending id order), ok, send_ids,
// n_dropped; the dead slots as JAX's argsort leaves them
__global__ void __launch_bounds__(kScanThreads)
rank_kernel(int64_t r, int n_dev, int cap, const int* __restrict__ tile_cnt, PlanOut o) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  using Reduce = cub::BlockReduce<int, kScanThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  const int n_uniq = o.n_out[0];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  int own[kScanItems], rk[kScanItems];
  for (int k = 0; k < kScanItems; ++k)
    own[k] = base + k < n_uniq ? floor_mod(o.uniq[base + k], n_dev) : -1;
  for (int q = 0; q < n_dev; ++q) {
    const int before_tiles = block_prefix(tile_cnt + q, blockIdx.x, n_dev);
    int c = 0;
    for (int k = 0; k < kScanItems; ++k) c += own[k] == q;
    int before;
    __syncthreads();  // the scan storage is reused
    Scan(tmp.scan).ExclusiveSum(c, before);
    int next = before_tiles + before;
    for (int k = 0; k < kScanItems; ++k)
      if (own[k] == q) rk[k] = next++;
  }
  int dropped = 0;
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t u = base + k;
    if (u >= r) break;
    if (u < n_uniq) {
      const bool fits = rk[k] < cap;
      o.owner[u] = own[k];
      o.rank[u] = rk[k];
      o.is_uniq[u] = 1;
      o.ok[u] = fits;
      if (fits) o.send_ids[static_cast<int64_t>(own[k]) * cap + rk[k]] = o.uniq[u];
      else ++dropped;
    } else {
      o.uniq[u] = 0;
      o.owner[u] = n_dev;
      o.rank[u] = static_cast<int32_t>(u - n_uniq);
      o.is_uniq[u] = 0;
      o.ok[u] = 0;
    }
  }
  __syncthreads();
  const int total = Reduce(tmp.reduce).Sum(dropped);
  if (threadIdx.x == 0 && total) atomicAdd(&o.n_out[1], total);
}

// 3e. each request's row in the returned buffer
__global__ void __launch_bounds__(kScanThreads)
request_slot_kernel(int64_t r, int cap, PlanOut o) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (p >= r) return;
  const int u = o.inv[p];
  o.slot[p] = o.ok[u] ? o.owner[u] * cap + o.rank[u] : -1;
}

__global__ void __launch_bounds__(kRowThreads)
gather_kernel(const float* __restrict__ table, int dim, const int32_t* __restrict__ recv_ids,
              int64_t n_slots, int n_dev, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= n_slots) return;
  const int32_t id = recv_ids[row];
  float* dst = out + row * dim;
  if (id < 0) {
    for (int k = lane; k < dim; k += 32) dst[k] = 0.f;
    return;
  }
  const float* src = table + static_cast<int64_t>(id / n_dev) * dim;
  for (int k = lane; k < dim; k += 32) dst[k] = src[k];
}

struct PackIn {
  const float *g_a, *g_b;
  const int32_t *live_a, *live_b;
  int64_t n_a;
};

// request p's gradient row, or null where it is not live
__device__ __forceinline__ const float* request_row(const PackIn& in, int32_t p, int dim) {
  if (p < in.n_a) {
    if (in.live_a != nullptr && in.live_a[p] < 0) return nullptr;
    return in.g_a + static_cast<int64_t>(p) * dim;
  }
  const int64_t q = p - in.n_a;
  if (in.live_b != nullptr && in.live_b[q] < 0) return nullptr;
  return in.g_b + q * dim;
}

// a run's sums into the unique's packed row: a plain store when this warp
// holds all of the unique's requests (the caller zeroed the row), fp32
// atomics when a neighbouring chunk holds some too
template <int kCols>
__device__ __forceinline__ void flush(float* __restrict__ send, const int32_t* __restrict__ owner,
                                      const int32_t* __restrict__ rank, int u, bool shared,
                                      int cap, int dim, const float (&acc)[kCols], float sq,
                                      int lane) {
  float* dst = send + (static_cast<int64_t>(owner[u]) * cap + rank[u]) * (dim + 1);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int k = lane + 32 * c;
    if (k < dim) {
      if (shared) atomicAdd(dst + k, acc[c]); else dst[k] = acc[c];
    }
  }
  if (lane == 0) {
    if (shared) atomicAdd(dst + dim, sq); else dst[dim] = sq;
  }
}

// kCols: the row's floats a lane, ceil(dim / 32)
template <int kCols>
__global__ void __launch_bounds__(kRowThreads)
pack_kernel(PackIn in, int dim, const int32_t* __restrict__ order,
            const int32_t* __restrict__ inv, const int32_t* __restrict__ owner,
            const int32_t* __restrict__ rank, const uint8_t* __restrict__ ok, int64_t r,
            int cap, float* __restrict__ send) {
  const int lane = threadIdx.x & 31;
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5)) *
                     kPackChunk;
  if (j0 >= r) return;
  const int64_t j1 = j0 + kPackChunk < r ? j0 + kPackChunk : r;
  // the uniques that continue into the chunks before and after this one
  const int u_before = j0 > 0 ? inv[order[j0 - 1]] : -1;
  const int u_after = j1 < r ? inv[order[j1]] : -1;
  float acc[kCols];
  float sq = 0.f;
  int cur = -1;
  for (int64_t g = j0; g < j1; g += 32) {
    const int64_t j = g + lane;
    int p = 0, u = -1;
    bool live = false;
    if (j < j1) {
      p = order[j];
      u = inv[p];
      live = ok[u] && request_row(in, p, dim) != nullptr;
    }
    // the group's keys are sorted: its live requests come unique by unique
    for (unsigned m = __ballot_sync(kFull, live); m != 0; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int ps = __shfl_sync(kFull, p, src), us = __shfl_sync(kFull, u, src);
      if (us != cur) {
        if (cur >= 0)
          flush<kCols>(send, owner, rank, cur, cur == u_before || cur == u_after, cap, dim, acc,
                       sq, lane);
        cur = us;
        sq = 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      }
      const float* row = request_row(in, ps, dim);
      float s2 = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (lane + 32 * c < dim) {
          const float v = row[lane + 32 * c];
          acc[c] += v;
          s2 += v * v;
        }
      }
      sq += warp_sum(s2) / static_cast<float>(dim);
    }
  }
  if (cur >= 0)
    flush<kCols>(send, owner, rank, cur, cur == u_before || cur == u_after, cap, dim, acc, sq,
                 lane);
}

}  // namespace

// ws_a and ws_b: two [r] 64-bit workspaces; ws_i: n_tiles * (n_dev + 1)
// ints, n_tiles = ceil(r / n2v_route_tile()).  send_ids [n_dev * cap];
// uniq, inv, owner, rank, slot, order [r] int32; is_uniq, ok [r] bytes;
// n_out [2] = (n_uniq, n_dropped).  All are written whole.
extern "C" int n2v_route_tile() { return kScanTile; }

extern "C" int n2v_route_plan(const int32_t* ids, int64_t r, int n_dev, int cap, u64* ws_a,
                              u64* ws_b, int* ws_i, int32_t* uniq, int32_t* inv,
                              uint8_t* is_uniq, int32_t* owner, int32_t* rank, uint8_t* ok,
                              int32_t* send_ids, int32_t* n_out, int32_t* slot, int32_t* order,
                              void* stream) {
  if (r <= 0 || n_dev < 1 || cap < 1 || r >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned sort_tiles = static_cast<unsigned>((r + kTile - 1) / kTile);
  tile_sort_kernel<<<sort_tiles, kSortThreads, 0, s>>>(ids, r, ws_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* cur = ws_a;
  u64* nxt = ws_b;
  const unsigned blocks = static_cast<unsigned>((r + kMergeThreads - 1) / kMergeThreads);
  for (int64_t w = kTile; w < r; w *= 2) {
    merge_kernel<<<blocks, kMergeThreads, 0, s>>>(cur, nxt, r, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    u64* t = cur;
    cur = nxt;
    nxt = t;
  }
  const int n_tiles = static_cast<int>((r + kScanTile - 1) / kScanTile);
  int* tile_heads = ws_i;
  int* tile_cnt = ws_i + n_tiles;
  PlanOut o{uniq, inv, owner, rank, send_ids, n_out, slot, order, is_uniq, ok};
  head_count_kernel<<<n_tiles, kScanThreads, 0, s>>>(cur, r, tile_heads);
  slot_kernel<<<n_tiles, kScanThreads, 0, s>>>(cur, r, tile_heads, n_tiles, o);
  owner_count_kernel<<<n_tiles, kScanThreads, n_dev * sizeof(int), s>>>(r, n_dev, cap, tile_cnt,
                                                                      o);
  rank_kernel<<<n_tiles, kScanThreads, 0, s>>>(r, n_dev, cap, tile_cnt, o);
  request_slot_kernel<<<static_cast<unsigned>((r + kScanThreads - 1) / kScanThreads),
                        kScanThreads, 0, s>>>(r, cap, o);
  return static_cast<int>(cudaGetLastError());
}

// out [n_slots, dim] written whole; table the rank's [V / N, dim] rows.
extern "C" int n2v_route_gather(const float* table, int dim, const int32_t* recv_ids,
                                int64_t n_slots, int n_dev, float* out, void* stream) {
  if (n_slots == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_slots + kRowWarps - 1) / kRowWarps);
  gather_kernel<<<blocks, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, dim, recv_ids, n_slots, n_dev, out);
  return static_cast<int>(cudaGetLastError());
}

// send [n_dev * cap, dim + 1] must be zeroed; the plan's arrays as
// n2v_route_plan wrote them (r requests = n_a + n_b).  live_a / live_b may
// be null (every row live).  dim <= 1024.
extern "C" int n2v_route_pack(const float* g_a, const int32_t* live_a, int64_t n_a,
                              const float* g_b, const int32_t* live_b, int dim,
                              const int32_t* order, const int32_t* inv, const int32_t* owner,
                              const int32_t* rank, const uint8_t* ok, int64_t r, int cap,
                              float* send, void* stream) {
  if (r == 0) return 0;
  if (dim < 1 || dim > 32 * kMaxColsPerLane) return static_cast<int>(cudaErrorInvalidValue);
  const PackIn in{g_a, g_b, live_a, live_b, n_a};
  const int64_t warps = (r + kPackChunk - 1) / kPackChunk;
  const unsigned blocks = static_cast<unsigned>((warps + kRowWarps - 1) / kRowWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= 128) {
    pack_kernel<4><<<blocks, kRowThreads, 0, s>>>(in, dim, order, inv, owner, rank, ok, r, cap,
                                                 send);
  } else if (dim <= 256) {
    pack_kernel<8><<<blocks, kRowThreads, 0, s>>>(in, dim, order, inv, owner, rank, ok, r, cap,
                                                 send);
  } else if (dim <= 512) {
    pack_kernel<16><<<blocks, kRowThreads, 0, s>>>(in, dim, order, inv, owner, rank, ok, r, cap,
                                                  send);
  } else {
    pack_kernel<kMaxColsPerLane><<<blocks, kRowThreads, 0, s>>>(in, dim, order, inv, owner, rank,
                                                                ok, r, cap, send);
  }
  return static_cast<int>(cudaGetLastError());
}
