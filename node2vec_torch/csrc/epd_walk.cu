// The dense graph-sharded (edge-partitioned) walk's superstep: K24
// epd_bucket, K25 epd_serve, K26 epd_advance.
//
// Replace node2vec_tpu/parallel/edge_partitioned.py:92 shard_fn's superstep
// (:103-200), one kernel per stage between its two all_to_alls:
//   K24 epd_bucket   home: the lanes bucketed by owner(cur) (:104-119) and
//                    the request pack [cur, prev, u bits, N(prev)[P]]
//                    (:121-135);
//   K25 epd_serve    owner(cur): the local row gather, the p/q bias against
//                    the carried N(prev), the separate total, the prefix and
//                    the clamped pick; the response [nxt, row ids[P]]
//                    (:143-177);
//   K26 epd_advance  home: read the response by slot, step or die, the path
//                    write, cursor, prev, cur, the carried row and alive
//                    (:185-200), and the pending count of the loop condition
//                    (:202-211).
// Each computes what its plain version in parallel/edge_partitioned.py
// computes (epd_*_plain).  The carried state is one int32 [4, n] tensor
// (rows CUR, PREV, ALIVE, CURSOR) beside the carried rows [n, P].
//
// K24: bucket_common.cuh's stable ranking, K20's (two launches over tiles
// of 1,024 lanes; the first also fills the send buffer with -1); a lane
// ranked below the capacity writes its three scalars, and each warp then
// copies its sending lanes' carried rows one after another, a lane a
// column, so the [P] copies are coalesced.  K25: a persistent grid,
// a warp a request at a time with its next request's row and N(prev) in
// flight (cp.async into the warp's other stage), the row drawn by
// dense_common.cuh's float operations, K1's, in the same order, so for the
// same row, N(prev) and uniform K25 picks what K1 picks; N(prev)'s
// membership by a bisection where N(prev) is sorted, by the whole scan
// where it is not.  An empty slot (cur < 0) is one store a field, -1 in
// every one.  K26: one thread a walker for the
// scalars; each warp then copies its stepping lanes' new carried rows, a
// lane a column; the pending count is block counts (__syncthreads_count)
// added atomically, as K23's.
//
// Bound on an H100: bytes, per superstep.  K24 reads each active lane's
// scalars and carried row and writes its request and every slot; K25 reads
// each request and its 2P * 4-byte row and writes the response; K26 reads
// the state and the responses of the lanes that sent and writes the state
// and rows of the lanes that stepped.  K25's membership tests run from
// shared memory (log2 P + 1 loads a column on a sorted N(prev)).

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_common.cuh"
#include "dense_common.cuh"

namespace {

enum Row { kCur = 0, kPrev, kAlive, kCursor };
constexpr int kTile = n2v::kBucketTile;  // K24 lanes a block
constexpr int kServeWarps = 8;           // K25 warps a block
constexpr int kAdvThreads = 256;         // K26 walkers a block
constexpr int kMaxK = n2v::kDenseMaxK;
constexpr unsigned kFull = n2v::kDenseFull;

__device__ __forceinline__ int64_t clamp_slot(int32_t s, int64_t n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// Is lane i active (alive, cursor < L), and which shard owns its cur?
__device__ __forceinline__ bool epd_lane(const int32_t* carry, int64_t n, int64_t i,
                                         int64_t rows_per_shard, int n_shards,
                                         int walk_length, int32_t* dest) {
  *dest = 0;
  if (i >= n || carry[kAlive * n + i] == 0 || carry[kCursor * n + i] >= walk_length)
    return false;
  const int32_t cur = carry[kCur * n + i];
  const int64_t o = static_cast<int64_t>(cur < 0 ? 0 : cur) / rows_per_shard;
  *dest = static_cast<int32_t>(o < n_shards - 1 ? o : n_shards - 1);
  return true;
}

__global__ void __launch_bounds__(kTile)
epd_bucket_count(const int32_t* __restrict__ carry, int64_t n, int32_t* __restrict__ send,
                 int32_t* __restrict__ tiles, int n_shards, int64_t capacity,
                 int64_t rows_per_shard, int walk_length, int p_cols) {
  extern __shared__ int32_t cnt[];  // n2v::bucket_count_smem(n_shards) bytes
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  n2v::bucket_tile_count(
      [&](int32_t* dest) {
        return epd_lane(carry, n, i, rows_per_shard, n_shards, walk_length, dest);
      },
      n_shards, cnt, tiles);
  const int64_t total = n_shards * capacity * (3 + p_cols);
  for (int64_t j = i; j < total; j += static_cast<int64_t>(gridDim.x) * kTile) send[j] = -1;
}

__global__ void __launch_bounds__(kTile)
epd_bucket_scatter(const int32_t* __restrict__ carry, int64_t n,
                   const int32_t* __restrict__ prev_rows, const float* __restrict__ u,
                   int32_t* __restrict__ send, int32_t* __restrict__ slot,
                   const int32_t* __restrict__ tiles, int n_shards, int64_t capacity,
                   int64_t rows_per_shard, int walk_length, int p_cols) {
  extern __shared__ int32_t sm[];  // n2v::bucket_rank_smem(n_shards) bytes
  const int64_t n_req = n_shards * capacity;
  const int64_t fields = 3 + p_cols;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int64_t flat = n2v::bucket_tile_rank(
      [&](int32_t* dest) {
        return epd_lane(carry, n, i, rows_per_shard, n_shards, walk_length, dest);
      },
      n_shards, capacity, tiles, sm);
  if (i < n) {
    slot[i] = static_cast<int32_t>(flat);
    if (flat < n_req) {
      int32_t* out = send + flat * fields;
      out[0] = carry[kCur * n + i];
      out[1] = carry[kPrev * n + i];
      out[2] = __float_as_int(u[i]);
    }
  }
  // the sending lanes' carried rows, one after another, a lane a column
  // (lanes past n never send: their flat slot is n_req)
  const int lane = threadIdx.x & 31;
  const int64_t i0 = i - lane;
  for (int j = 0; j < 32; ++j) {
    const int64_t f = __shfl_sync(kFull, flat, j);
    if (f >= n_req) continue;
    const int32_t* src = prev_rows + (i0 + j) * p_cols;
    int32_t* dst = send + f * fields + 3;
    for (int c = lane; c < p_cols; c += 32) dst[c] = src[c];
  }
}

// K25's copies: cp.async of 4 or 16 bytes into the warp's stage, committed
// as one group a request; a warp waits for all but its newest group (the
// next request's), then syncs so each lane sees the others' copies.
__device__ __forceinline__ void serve_cp4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void serve_cp16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void serve_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void serve_copies_wait() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncwarp();
}

// Request r's header fields (cur, prev, u bits) in lanes 0-2, -1 past n_req;
// read by the shuffles that use them, so the load stays in flight till then.
__device__ __forceinline__ int32_t serve_header(const int32_t* recv, int64_t r, int64_t n_req,
                                                int fields, int lane) {
  return r < n_req && lane < 3 ? recv[r * fields + lane] : -1;
}

// Request r's row (2P ids | weight bits) and, at second order, its N(prev)
// into a stage of the warp's buffer: [2P row | P N(prev)].
template <bool kVec>
__device__ __forceinline__ void serve_stage(int32_t* stage, const int32_t* recv, int64_t r,
                                            const int32_t* adj, int64_t n_rows, int64_t row_base,
                                            int32_t cur, bool biased, int p_cols, int lane) {
  int64_t lv = static_cast<int64_t>(cur) - row_base;
  lv = lv < 0 ? 0 : (lv >= n_rows ? n_rows - 1 : lv);
  const int32_t* row = adj + lv * 2 * p_cols;
  if (kVec) {
    for (int c = 4 * lane; c < 2 * p_cols; c += 128) serve_cp16(stage + c, row + c);
  } else {
    for (int c = lane; c < 2 * p_cols; c += 32) serve_cp4(stage + c, row + c);
  }
  if (biased) {
    const int32_t* nprev = recv + r * (3 + p_cols) + 3;
    for (int c = lane; c < p_cols; c += 32) serve_cp4(stage + 2 * p_cols + c, nprev + c);
  }
}

// K25: a persistent grid, each warp serving requests r,
// r + W, r + 2W, ... (W the grid's warps) with the next request's row and
// N(prev) copied into the other of its two stages while it serves the
// current one, and the header after that already loading.  The membership
// of each of a lane's columns in N(prev) is a bisection where N(prev) is
// sorted (one ballot over its adjacent pairs a request), the whole scan
// where it is not (``scans``, when given, counts those requests); the float
// operations are dense_bias_total's and dense_pick's.  An empty slot is one
// store a field.
template <bool kVec, int kK>
__global__ void __launch_bounds__(kServeWarps * 32)
epd_serve_kernel(const int32_t* __restrict__ recv, int64_t n_req,
                 const int32_t* __restrict__ adj, int64_t n_rows, int32_t* __restrict__ resp,
                 int64_t row_base, int p_cols, float inv_p, float inv_q, int uniform_bias,
                 int32_t* __restrict__ scans) {
  extern __shared__ __align__(16) int32_t smem[];  // [kServeWarps][2 stages][2P row | P N(prev)]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fields = 3 + p_cols;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kServeWarps;
  int32_t* stages = smem + static_cast<int64_t>(warp) * 2 * 3 * p_cols;
  const int k = n2v::dense_cols_per_lane(p_cols);
  const int col0 = lane * k;
  int top = 1;  // the largest power of two <= P
  while (2 * top <= p_cols) top *= 2;

  int64_t r = static_cast<int64_t>(blockIdx.x) * kServeWarps + warp;
  const int32_t h = serve_header(recv, r, n_req, fields, lane);
  int32_t cur = __shfl_sync(kFull, h, 0), prev = __shfl_sync(kFull, h, 1);
  int32_t ubits = __shfl_sync(kFull, h, 2);
  if (cur >= 0)
    serve_stage<kVec>(stages, recv, r, adj, n_rows, row_base, cur, prev >= 0 && !uniform_bias,
                      p_cols, lane);
  serve_commit();
  int32_t h_next = serve_header(recv, r + n_warps, n_req, fields, lane);
  int st = 0;
  for (; r < n_req; r += n_warps) {  // warp-uniform: no block barrier below
    const int64_t rn = r + n_warps;
    const int32_t cur_n = __shfl_sync(kFull, h_next, 0), prev_n = __shfl_sync(kFull, h_next, 1);
    const int32_t ubits_n = __shfl_sync(kFull, h_next, 2);
    if (cur_n >= 0)
      serve_stage<kVec>(stages + (st ^ 1) * 3 * p_cols, recv, rn, adj, n_rows, row_base, cur_n,
                        prev_n >= 0 && !uniform_bias, p_cols, lane);
    serve_commit();
    h_next = serve_header(recv, rn + n_warps, n_req, fields, lane);
    int32_t* out = resp + r * (1 + p_cols);
    if (cur < 0) {  // an empty slot: one store a field
      for (int c = lane; c <= p_cols; c += 32) out[c] = -1;
    } else {
      serve_copies_wait();
      const int32_t* srow = stages + st * 3 * p_cols;
      const int32_t* nprev = srow + 2 * p_cols;
      int32_t ids[kK];
      float bw[kK];
      n2v::dense_row_from_shared(srow, p_cols, k, col0, ids, bw);
      if (prev >= 0 && !uniform_bias) {
        bool found[kK];
        if (n2v::dense_nprev_sorted(nprev, p_cols, lane)) {
          n2v::dense_members_sorted(nprev, p_cols, top, ids, found);
        } else {
          if (lane == 0 && scans != nullptr) atomicAdd(scans, 1);
          n2v::dense_members_scan(nprev, p_cols, ids, found);
        }
        n2v::dense_bias(ids, bw, found, prev, p_cols, k, col0, inv_p, inv_q);
      }
      float lane_sum;
      const float total = n2v::dense_total(bw, lane_sum);
      const int idx = total > 0.f ? n2v::dense_pick_k(ids, bw, lane_sum, total, p_cols, k, col0,
                                                      lane, __int_as_float(ubits))
                                  : -1;  // a sink (or all-zero weights)
      if (lane == 0) out[0] = idx < 0 ? -1 : srow[idx];
      for (int c = lane; c < p_cols; c += 32) out[1 + c] = srow[c];
    }
    __syncwarp();  // every lane is done with this stage before it is copied over
    cur = cur_n;
    prev = prev_n;
    ubits = ubits_n;
    st ^= 1;
  }  // requests
}

__global__ void __launch_bounds__(kAdvThreads)
epd_advance_kernel(int32_t* __restrict__ carry, int64_t n, int32_t* __restrict__ prev_rows,
                   int32_t* __restrict__ paths, const int32_t* __restrict__ slot,
                   const int32_t* __restrict__ back, int64_t n_req, int walk_length, int p_cols,
                   int32_t* __restrict__ pending) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kAdvThreads + threadIdx.x;
  bool still = false;
  int64_t row_src = -1;  // the response slot whose row a stepping lane carries next
  if (i < n) {
    const int32_t s = slot[i];
    const bool sendable = s < n_req;
    bool alive = carry[kAlive * n + i] != 0;
    int32_t cursor = carry[kCursor * n + i];
    if (sendable) {
      const int32_t nxt = back[clamp_slot(s, n_req) * (1 + p_cols)];
      if (nxt >= 0) {
        const int32_t cur = carry[kCur * n + i];
        paths[i * (walk_length + 1) + cursor + 1] = nxt;
        ++cursor;
        carry[kCursor * n + i] = cursor;
        carry[kPrev * n + i] = cur;
        carry[kCur * n + i] = nxt;
        row_src = s;
      } else {  // a sink: the walker dies
        alive = false;
        carry[kAlive * n + i] = 0;
      }
    }
    still = alive && cursor < walk_length;
  }
  const int lane = threadIdx.x & 31;
  const int64_t i0 = i - lane;
  for (int j = 0; j < 32; ++j) {
    const int64_t s = __shfl_sync(kFull, row_src, j);
    if (s < 0) continue;
    const int32_t* src = back + s * (1 + p_cols) + 1;
    int32_t* dst = prev_rows + (i0 + j) * p_cols;
    for (int c = lane; c < p_cols; c += 32) dst[c] = src[c];
  }
  const int n_still = __syncthreads_count(still);
  if (threadIdx.x == 0 && n_still) atomicAdd(pending, n_still);
}

}  // namespace

extern "C" int n2v_epd_bucket(const int32_t* carry, int64_t n, const int32_t* prev_rows,
                              const float* u, int32_t* send, int32_t* slot, int32_t* tiles,
                              int n_shards, int64_t capacity, int64_t rows_per_shard,
                              int walk_length, int p_cols, void* stream) {
  if (n_shards < 1 || n_shards > 256 || capacity < 1 || rows_per_shard < 1 || p_cols < 1 ||
      p_cols > 32 * kMaxK || n_shards * capacity > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  auto s = static_cast<cudaStream_t>(stream);
  epd_bucket_count<<<static_cast<unsigned>(n_tiles), kTile, n2v::bucket_count_smem(n_shards),
                     s>>>(carry, n, send, tiles, n_shards, capacity, rows_per_shard,
                          walk_length, p_cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  epd_bucket_scatter<<<static_cast<unsigned>(n_tiles), kTile, n2v::bucket_rank_smem(n_shards),
                       s>>>(carry, n, prev_rows, u, send, slot, tiles, n_shards, capacity,
                            rows_per_shard, walk_length, p_cols);
  return static_cast<int>(cudaGetLastError());
}

// The persistent grid: as many blocks as the card holds at once (cached a
// device and shared memory size for each form), never more than the
// requests need.
template <bool kVec, int kK>
cudaError_t serve_launch(const int32_t* recv, int64_t n_req, const int32_t* adj, int64_t n_rows,
                         int32_t* resp, int64_t row_base, int p_cols, float inv_p, float inv_q,
                         int uniform_bias, int32_t* scans, cudaStream_t stream) {
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  const size_t smem = sizeof(int32_t) * kServeWarps * 2 * 3 * p_cols;  // <= 48 KB at P = 256
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, epd_serve_kernel<kVec, kK>, kServeWarps * 32, smem)) != cudaSuccess)
      return err;
    cached_dev = dev;
    cached_smem = smem;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t need = (n_req + kServeWarps - 1) / kServeWarps;
  const int blocks = static_cast<int>(need < cached_blocks ? need : cached_blocks);
  epd_serve_kernel<kVec, kK><<<blocks, kServeWarps * 32, smem, stream>>>(
      recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p, inv_q, uniform_bias, scans);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t serve_launch_k(int k, const int32_t* recv, int64_t n_req, const int32_t* adj,
                           int64_t n_rows, int32_t* resp, int64_t row_base, int p_cols,
                           float inv_p, float inv_q, int uniform_bias, int32_t* scans,
                           cudaStream_t stream) {
  switch (k) {  // a lane's columns, in arrays of the next power of two
    case 1: return serve_launch<kVec, 1>(recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p,
                                         inv_q, uniform_bias, scans, stream);
    case 2: return serve_launch<kVec, 2>(recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p,
                                         inv_q, uniform_bias, scans, stream);
    case 3:
    case 4: return serve_launch<kVec, 4>(recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p,
                                         inv_q, uniform_bias, scans, stream);
    default: return serve_launch<kVec, kMaxK>(recv, n_req, adj, n_rows, resp, row_base, p_cols,
                                              inv_p, inv_q, uniform_bias, scans, stream);
  }
}

extern "C" int n2v_epd_serve(const int32_t* recv, int64_t n_req, const int32_t* adj,
                             int64_t n_rows, int32_t* resp, int64_t row_base, int p_cols,
                             float inv_p, float inv_q, int uniform_bias, int32_t* scans,
                             void* stream) {
  if (p_cols < 1 || p_cols > 32 * kMaxK || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_req == 0) return 0;
  const int k = (p_cols + 31) >> 5;  // n2v::dense_cols_per_lane
  const bool vec = p_cols % 4 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? serve_launch_k<true>(k, recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p,
                                 inv_q, uniform_bias, scans, s)
          : serve_launch_k<false>(k, recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p,
                                  inv_q, uniform_bias, scans, s));
}

extern "C" int n2v_epd_advance(int32_t* carry, int64_t n, int32_t* prev_rows, int32_t* paths,
                               const int32_t* slot, const int32_t* back, int64_t n_req,
                               int walk_length, int p_cols, int32_t* pending, void* stream) {
  if (n_req < 1 || p_cols < 1 || walk_length < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t blocks = (n + kAdvThreads - 1) / kAdvThreads;
  epd_advance_kernel<<<static_cast<unsigned>(blocks), kAdvThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      carry, n, prev_rows, paths, slot, back, n_req, walk_length, p_cols, pending);
  return static_cast<int>(cudaGetLastError());
}
