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
// K24: one cooperative launch on bucket_common.cuh's grid ranking, K20's:
// each block counts its tiles' active lanes by owner(cur); after one grid
// barrier, grid_bases sums the blocks' counts block-parallel and
// tile_offset ranks each lane in lane order, as JAX's one-hot cumsum does.
// A lane ranked below the capacity is written once, whole: each warp stages
// its sending lanes' requests in shared memory, a batch of lanes at a time
// (the carried rows by 16-byte cp.async where P % 4 == 0, beside the three
// scalars), the next batch loading while one is stored, and stores them in
// the order of the send buffer, so that the stores of lanes ranked one
// after another coalesce although a request's 3 + P ints are not 16-byte
// aligned; the first batch's rows are in flight across the grid barrier.
// grid_fill writes -1 only into the slots past each bucket's count.
//
// K25: a persistent grid, a warp a request at a time with its next
// request's row and N(prev) in flight (cp.async into the warp's other
// stage), the row drawn by dense_common.cuh's float operations, K1's, in
// the same order, so for the same row, N(prev) and uniform K25 picks what
// K1 picks; N(prev)'s membership by a bisection where N(prev) is sorted, by
// the whole scan where it is not.  An empty slot (cur < 0) is one store a
// field, -1 in every one.
//
// K26: one thread a walker for the scalars; each warp then copies its
// stepping lanes' new carried rows, a lane a column; the pending count is
// block counts (__syncthreads_count) added atomically, as K23's.
//
// Bound on an H100: bytes, per superstep.  K24 reads each active lane's
// scalars and carried row and writes its request, each unfilled slot and
// every lane's slot; K25 reads each request and its 2P * 4-byte row and
// writes the response; K26 reads the state and the responses of the lanes
// that sent and writes the state and rows of the lanes that stepped.
// K25's membership tests run from shared memory (log2 P + 2 loads a column
// on a sorted N(prev)).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_common.cuh"
#include "dense_common.cuh"

namespace {

namespace cg = cooperative_groups;

enum Row { kCur = 0, kPrev, kAlive, kCursor };
constexpr int kTile = 256;                // K24 lanes a tile, threads a block
constexpr int kTileWarps = kTile / 32;
constexpr int kMaxShards = 256;
constexpr int kStageInts = 1088;          // a warp's staged requests: 2 x 8 at P = 64
constexpr int kServeWarps = 8;           // K25 warps a block
constexpr int kAdvThreads = 256;         // K26 walkers a block
constexpr int kMaxK = n2v::kDenseMaxK;
constexpr unsigned kFull = n2v::kDenseFull;

__device__ __forceinline__ int64_t clamp_slot(int32_t s, int64_t n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

struct BucketArgs {
  const int32_t* carry;
  int64_t n;
  const int32_t* prev_rows;
  const float* u;
  int32_t* send;
  int32_t* slot;
  int32_t* blk;  // [grid, n_shards]: each block's count of each bucket
  int n_shards;
  int64_t capacity;
  int64_t rows_per_shard;
  int walk_length;
  int p_cols;
  int fields;  // 3 + P
  int64_t n_tiles;
  int64_t per_block;  // tiles a block
};

// cp.async of 4 or 16 bytes into shared memory (K24's stages and K25's).
__device__ __forceinline__ void serve_cp4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void serve_cp16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// A lane's request fields and whether it is active (alive, cursor < L), read
// in one trip (every field loaded, whether or not the lane turns out active),
// with the shard that owns its cur.
struct LaneState {
  int32_t cur, prev, ubits, dest;
  bool active;
};

__device__ __forceinline__ LaneState lane_state(const BucketArgs& a, int64_t i) {
  LaneState l{0, 0, 0, 0, false};
  if (i >= a.n) return l;
  const int32_t alive = a.carry[kAlive * a.n + i], cursor = a.carry[kCursor * a.n + i];
  l.cur = a.carry[kCur * a.n + i];
  l.prev = a.carry[kPrev * a.n + i];
  l.ubits = __float_as_int(a.u[i]);
  l.active = alive != 0 && cursor < a.walk_length;
  const int64_t o = static_cast<int64_t>(l.cur < 0 ? 0 : l.cur) / a.rows_per_shard;
  l.dest = l.active ? static_cast<int32_t>(o < a.n_shards - 1 ? o : a.n_shards - 1) : 0;
  return l;
}

// The carried rows of g consecutive lanes (src0: the first's) into their
// staged requests (stride rs ints, the row at 4), the lanes of ``on`` only;
// 16-byte copies (kVec) or 4-byte ones, spread over the warp's lanes, issued
// as one cp.async group (the caller waits).
template <bool kVec>
__device__ __forceinline__ void stage_rows(int32_t* st, int rs, const int32_t* src0, int p_cols,
                                           int g, unsigned on, int lane) {
  const int per = kVec ? p_cols / 4 : p_cols;  // copies a row
  int r = lane / per, c = lane - r * per;
  for (int q = lane; q < g * per; q += 32) {
    if ((on >> r) & 1u) {
      if (kVec)
        serve_cp16(st + r * rs + 4 + 4 * c, src0 + static_cast<int64_t>(r) * p_cols + 4 * c);
      else
        serve_cp4(st + r * rs + 4 + c, src0 + static_cast<int64_t>(r) * p_cols + c);
    }
    c += 32;
    while (c >= per) {
      c -= per;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The int at offset o of a batch's g * F request ints in send order: field
// o % F of its lane o / F's staged request (the row after a pad at 3).
__device__ __forceinline__ int32_t staged_at(const int32_t* half, int o, int F, int rs) {
  const int r = o / F, f = o - r * F;
  return half[r * rs + f + (f >= 3)];
}

// A batch's requests (g lanes, staged in ``half``; fl: their flat slots, -1
// where a lane sends nothing) stored in send order.  Where the g lanes all
// send to consecutive slots (one run of g * F ints, as every batch is at
// one shard with every lane sent) and kVec, the run goes out by 16-byte
// stores between a scalar head and tail; otherwise int by int, each lane's
// request to its own slot.  Warp-wide; ``all_on``: every lane of the batch
// sends.
template <bool kVec>
__device__ __forceinline__ void store_batch(int32_t* send, const int32_t* half, const int32_t* fl,
                                            int g, int F, int rs, bool all_on, int lane) {
  const int32_t first = fl[0];
  const bool mine = lane < g && fl[lane] != first + lane;
  if (kVec && all_on && !__any_sync(n2v::kDenseFull, mine)) {
    const int64_t base = static_cast<int64_t>(first) * F;
    const int total = g * F;
    const int head = static_cast<int>((4 - (base & 3)) & 3) < total
                         ? static_cast<int>((4 - (base & 3)) & 3) : total;
    const int n4 = (total - head) >> 2;
    const int tail0 = head + 4 * n4;
    if (lane < head) send[base + lane] = staged_at(half, lane, F, rs);
    if (tail0 + lane < total) send[base + tail0 + lane] = staged_at(half, tail0 + lane, F, rs);
    int o = head + 4 * lane;
    int r = o / F, f = o - r * F;
    for (int q = lane; q < n4; q += 32) {
      int v[4];
      int rr = r, ff = f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = half[rr * rs + ff + (ff >= 3)];
        if (++ff == F) {
          ff = 0;
          ++rr;
        }
      }
      *reinterpret_cast<int4*>(send + base + o) = make_int4(v[0], v[1], v[2], v[3]);
      o += 128;
      f += 128;
      while (f >= F) {
        f -= F;
        ++r;
      }
    }
    return;
  }
  int r = lane / F, f = lane - r * F;  // int lane of the batch's g * F, in send order
  for (int q = lane; q < g * F; q += 32) {
    const int32_t dst = fl[r];
    if (dst >= 0) send[static_cast<int64_t>(dst) * F + f] = half[r * rs + f + (f >= 3)];
    f += 32;
    while (f >= F) {
      f -= F;
      ++r;
    }
  }
}

// K24: block b takes the contiguous tiles [b * per_block, ...); its first
// tile is ranked within itself before the grid barrier, its others counted;
// after the barrier each tile's lanes get their flat slots (stable in lane
// order) and each warp writes its sending lanes' requests, a batch of H
// lanes at a time through two halves of its stage: batch b + 1's rows load
// while batch b is stored.  The first tile's first batch (its active lanes)
// is issued before the barrier where every active lane sends, so its rows
// arrive while the grid waits.
template <bool kVec>
__global__ void __launch_bounds__(kTile) epd_bucket_kernel(const BucketArgs a) {
  // tile_offset's per-warp counts, then (after a barrier) the warps' staged
  // requests: [kTileWarps][2 halves][H][P + 4], a request a row of P + 4
  // ints (cur, prev, u bits, a pad, the carried row 16-byte aligned)
  __shared__ __align__(16) int32_t stage[kTileWarps * kStageInts];
  __shared__ int32_t tt[kMaxShards], pre[kMaxShards], tot[kMaxShards], run[kMaxShards];
  __shared__ int64_t ends[kMaxShards + 1];
  __shared__ int32_t flats[kTile];
  static_assert(kTileWarps * kStageInts >= kMaxShards * kTileWarps, "tile_offset's counts fit");
  const int S = a.n_shards;
  const int64_t n_req = S * a.capacity;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * a.per_block;
  const int64_t t1 = t0 + a.per_block < a.n_tiles ? t0 + a.per_block : a.n_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int F = a.fields, P = a.p_cols, rs = P + 4;
  const int H = kStageInts / (2 * rs) < 32 ? kStageInts / (2 * rs) : 32;  // lanes a batch
  const int nb = (32 + H - 1) / H;  // batches a warp
  int32_t* st = stage + warp * kStageInts;
  int32_t* fl = flats + warp * 32;

  // batch b of the warp's lanes (those of ``mask``) staged into half b & 1:
  // each lane's three scalars by the lane, the rows by cp.async
  auto issue = [&](int b, unsigned mask, const LaneState& l, int64_t i0) {
    const int j0 = b * H;
    const int g = 32 - j0 < H ? 32 - j0 : H;
    int32_t* half = st + (b & 1) * H * rs;
    const unsigned on = (mask >> j0) & (g == 32 ? 0xFFFFFFFFu : (1u << g) - 1u);
    if (((on << j0) >> lane) & 1u) {
      int32_t* h = half + (lane - j0) * rs;
      h[0] = l.cur;
      h[1] = l.prev;
      h[2] = l.ubits;
    }
    stage_rows<kVec>(half, rs, a.prev_rows + (i0 + j0) * P, P, g, on, lane);
  };

  // the tile's lanes of flat slot ``flat`` (n_req: none) written: slot, then
  // each batch of sending lanes stored whole, in send order
  auto emit = [&](int64_t i, int64_t flat, const LaneState& l, bool issued) {
    if (i < a.n) a.slot[i] = static_cast<int32_t>(flat);
    const bool sends = flat < n_req;
    const unsigned senders = __ballot_sync(n2v::kDenseFull, sends);
    if (!issued) __syncthreads();  // every warp is done with tile_offset's counts
    fl[lane] = sends ? static_cast<int32_t>(flat) : -1;
    const int64_t i0 = i - lane;
    if (senders == 0) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      return;
    }
    if (!issued) issue(0, senders, l, i0);
    for (int b = 0; b < nb; ++b) {
      if (b + 1 < nb) {
        issue(b + 1, senders, l, i0);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();
      const int j0 = b * H;
      const int g = 32 - j0 < H ? 32 - j0 : H;
      const unsigned gmask = g == 32 ? 0xFFFFFFFFu : (1u << g) - 1u;
      const unsigned on = (senders >> j0) & gmask;
      if (on)
        store_batch<kVec>(a.send, st + (b & 1) * H * rs, fl + j0, g, F, rs, on == gmask, lane);
      __syncwarp();  // every lane is done with the half before it is staged again
    }
  };

  // the first tile ranked within itself; the block's lanes counted by owner
  int64_t i = t0 * kTile + threadIdx.x;
  LaneState l = lane_state(a, i);
  const int off = n2v::tile_offset<kTile>(l.active, l.dest, S, stage, tt);
  for (int d = threadIdx.x; d < S; d += kTile) run[d] = tt[d];
  __syncthreads();
  for (int64_t t = t0 + 1; t < t1; ++t) {
    const LaneState lt = lane_state(a, t * kTile + threadIdx.x);
    if (lt.active) atomicAdd(&run[lt.dest], 1);
  }
  // the first tile's first batch in flight across the barrier, where every
  // active lane sends (capacity >= n), so that no row is read in vain
  const bool prefetch = a.capacity >= a.n;
  if (prefetch) issue(0, __ballot_sync(n2v::kDenseFull, l.active), l, i - lane);
  __syncthreads();
  for (int d = threadIdx.x; d < S; d += kTile)
    a.blk[static_cast<int64_t>(blockIdx.x) * S + d] = run[d];
  cg::this_grid().sync();

  n2v::grid_bases<kTile>(a.blk, S, gridDim.x, blockIdx.x, S, pre, tot);
  const int64_t rank0 = l.active ? pre[l.dest] + off : a.capacity;
  const int64_t flat0 = rank0 < a.capacity ? l.dest * a.capacity + rank0 : n_req;
  emit(i, flat0, l, prefetch);
  for (int d = threadIdx.x; d < S; d += kTile) run[d] = pre[d] + tt[d];
  for (int64_t t = t0 + 1; t < t1; ++t) {
    i = t * kTile + threadIdx.x;
    l = lane_state(a, i);
    const int o = n2v::tile_offset<kTile>(l.active, l.dest, S, stage, tt);
    const int64_t rank = l.active ? run[l.dest] + o : a.capacity;
    emit(i, rank < a.capacity ? l.dest * a.capacity + rank : n_req, l, false);
    __syncthreads();
    for (int d = threadIdx.x; d < S; d += kTile) run[d] += tt[d];
  }
  n2v::grid_fill<kTile>(a.send, a.fields, S, a.capacity, tot, ends, -1);
}

// K25's copies: cp.async (serve_cp4, serve_cp16) into the warp's stage,
// committed as one group a request; a warp waits for all but its newest
// group (the next request's), then syncs so each lane sees the others'
// copies.
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
// operations are dense_bias's, dense_total's and dense_pick_k's.  An empty slot is one
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

// tiles: [ceil(n / 256) or 1, n_shards] ints of workspace (the blocks'
// counts).  send and slot are written whole; with no lane, send is all -1.
extern "C" int n2v_epd_bucket(const int32_t* carry, int64_t n, const int32_t* prev_rows,
                              const float* u, int32_t* send, int32_t* slot, int32_t* tiles,
                              int n_shards, int64_t capacity, int64_t rows_per_shard,
                              int walk_length, int p_cols, void* stream) {
  if (n < 0 || n_shards < 1 || n_shards > kMaxShards || capacity < 1 || rows_per_shard < 1 ||
      p_cols < 1 || p_cols > 32 * kMaxK || n_shards * capacity > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  BucketArgs a{};
  a.carry = carry;
  a.n = n;
  a.prev_rows = prev_rows;
  a.u = u;
  a.send = send;
  a.slot = slot;
  a.blk = tiles;
  a.n_shards = n_shards;
  a.capacity = capacity;
  a.rows_per_shard = rows_per_shard;
  a.walk_length = walk_length;
  a.p_cols = p_cols;
  a.fields = 3 + p_cols;
  a.n_tiles = (n + kTile - 1) / kTile;
  if (a.n_tiles < 1) a.n_tiles = 1;  // no lane: the send buffer is still filled
  const bool vec = p_cols % 4 == 0 && reinterpret_cast<uintptr_t>(prev_rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(send) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(epd_bucket_kernel<true>)
                           : reinterpret_cast<const void*>(epd_bucket_kernel<false>);
  int64_t grid = 0;
  cudaError_t err = n2v::grid_geometry(kernel, kTile, a.n_tiles, &a.per_block, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(kTile), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
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
