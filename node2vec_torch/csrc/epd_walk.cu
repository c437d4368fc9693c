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
// column, so the [P] copies are coalesced.  K25: one warp a request, the
// carried N(prev) staged in shared memory, the row drawn by
// dense_common.cuh's device functions, the ones K1 calls: the same float
// operations in the same order, so for the same row, N(prev) and uniform
// K25 picks what K1 picks.  An empty slot (cur < 0) is skipped at once,
// its response -1 in every field.  K26: one thread a walker for the
// scalars; each warp then copies its stepping lanes' new carried rows, a
// lane a column; the pending count is block counts (__syncthreads_count)
// added atomically, as K23's.
//
// Bound on an H100: bytes, per superstep.  K24 reads each active lane's
// scalars and carried row and writes its request and every slot; K25 reads
// each request and its 2P * 4-byte row and writes the response; K26 reads
// the state and the responses of the lanes that sent and writes the state
// and rows of the lanes that stepped.  The P^2 membership compares of K25
// run from shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_common.cuh"
#include "dense_common.cuh"

namespace {

enum Row { kCur = 0, kPrev, kAlive, kCursor };
constexpr int kTile = n2v::kBucketTile;  // K24 lanes a block
constexpr int kReqWarps = 8;             // K25 requests a block
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

__global__ void __launch_bounds__(kReqWarps * 32)
epd_serve_kernel(const int32_t* __restrict__ recv, int64_t n_req,
                 const int32_t* __restrict__ adj, int64_t n_rows, int32_t* __restrict__ resp,
                 int64_t row_base, int p_cols, float inv_p, float inv_q, int uniform_bias) {
  extern __shared__ int32_t smem[];  // [kReqWarps][2][p_cols]: the row's ids, N(prev)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kReqWarps + warp;
  if (r >= n_req) return;  // warp-uniform; no block barrier below
  const int32_t* rq = recv + r * (3 + p_cols);
  int32_t* out = resp + r * (1 + p_cols);
  const int32_t cur = rq[0];
  if (cur < 0) {  // an empty slot
    for (int c = lane; c <= p_cols; c += 32) out[c] = -1;
    return;
  }
  const int32_t prev = rq[1];
  const float u01 = __int_as_float(rq[2]);
  int32_t* rows = smem + static_cast<int64_t>(warp) * 2 * p_cols;
  int32_t* prev_rows = rows + p_cols;
  if (prev >= 0 && !uniform_bias)
    for (int c = lane; c < p_cols; c += 32) prev_rows[c] = rq[3 + c];
  const int k = n2v::dense_cols_per_lane(p_cols);
  const int col0 = lane * k;
  int64_t lv = static_cast<int64_t>(cur) - row_base;
  lv = lv < 0 ? 0 : (lv >= n_rows ? n_rows - 1 : lv);
  int32_t ids[kMaxK];
  float bw[kMaxK];
  n2v::dense_load_row(adj + lv * 2 * p_cols, p_cols, k, col0, ids, bw, rows);
  __syncwarp();
  float lane_sum;
  const float total = n2v::dense_bias_total(ids, bw, prev_rows, prev, p_cols, k, col0, inv_p,
                                            inv_q, uniform_bias, lane_sum);
  const int idx = total > 0.f ? n2v::dense_pick(ids, bw, lane_sum, total, p_cols, k, col0, lane,
                                                [&] { return u01; })
                              : -1;  // a sink (or all-zero weights)
  if (lane == 0) out[0] = idx < 0 ? -1 : rows[idx];
  for (int c = lane; c < p_cols; c += 32) out[1 + c] = rows[c];
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

extern "C" int n2v_epd_serve(const int32_t* recv, int64_t n_req, const int32_t* adj,
                             int64_t n_rows, int32_t* resp, int64_t row_base, int p_cols,
                             float inv_p, float inv_q, int uniform_bias, void* stream) {
  if (p_cols < 1 || p_cols > 32 * kMaxK || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_req == 0) return 0;
  const int64_t blocks = (n_req + kReqWarps - 1) / kReqWarps;
  const size_t smem = sizeof(int32_t) * kReqWarps * 2 * p_cols;
  epd_serve_kernel<<<static_cast<unsigned>(blocks), kReqWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      recv, n_req, adj, n_rows, resp, row_base, p_cols, inv_p, inv_q, uniform_bias);
  return static_cast<int>(cudaGetLastError());
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
