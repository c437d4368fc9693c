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
// Design.  The keys are (id, position) packed into one
// 64-bit word, the id with its sign bit flipped in the high half, so
// ascending keys are ascending ids, stable in position, and ascending id
// order is what makes the rows dropped on overflow the ones JAX drops (the
// largest ids of an over-full bucket).  One cooperative launch of a
// persistent grid (every block resident, each over a run of tiles of 512
// keys, bucket_common.cuh's grid ranking) runs the phases between grid
// barriers:
//   0. each block counts its keys' lowest digit (6 bits) and ORs and ANDs
//      its flipped ids, so every block then knows the bits that vary;
//   1. LSD radix passes over those bits only (17 bits at V = 131,072: three
//      passes of 6, 6 and 5 bits; none when every id is equal): each block
//      ranks its tiles' keys by digit, stable within a tile by
//      __match_any_sync and across tiles by the counts of the blocks before
//      it, and scatters them; each key also adds itself to the next pass's
//      count of the block that will read it (warp-aggregated atomics, rows
//      zeroed in phase 0), so a pass needs one barrier, not two;
//   2. each block counts its heads (first keys of an id) and its heads by
//      owner (id mod N, floor);
//   3. each key's unique slot is the heads before it and its unique's rank
//      in the owner's bucket the heads of that owner before it (the counts
//      of earlier blocks, earlier tiles and the tile's own scan); a key
//      whose head lies in an earlier tile takes the last rank before its
//      tile.  Then uniq, inv, order, is_uniq, owner, rank, ok, send_ids,
//      slot, the dead slots, n_uniq and n_dropped, and -1 into the send_ids
//      rows that no unique fills.
// Owners are ranked 256 at a time (one round when N <= 256).  The workspace
// is two [R] arrays of 64-bit keys and [tiles * (6 * 64 + 3 + N)] ints:
// O(R), never O(V), since the layout exists for V beyond one card.
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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_common.cuh"

namespace {

using u64 = unsigned long long;

namespace cg = cooperative_groups;

constexpr int kPlanThreads = 512;  // K18 keys a tile, threads a block
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kDigitBits = 6;  // a radix pass's digit, at most
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxPasses = 6;  // 6 + 5 * 6 >= 32 bits
constexpr int kOwnerRound = 256;  // owners ranked a round
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

struct PlanOut {
  int32_t *uniq, *inv, *owner, *rank, *send_ids, *n_out, *slot, *order;
  uint8_t *is_uniq, *ok;
};

struct PlanArgs {
  const int32_t* ids;
  int64_t r;
  int n_dev;
  int cap;
  u64* ws_a;
  u64* ws_b;
  int32_t* ws;  // [kMaxPasses][grid][kDigits] digit counts, [grid][2] or / and,
                // [grid][1 + N] heads, then heads by owner
  PlanOut o;
  int64_t n_tiles;
  int64_t per_block;  // tiles a block
};

__device__ __forceinline__ uint32_t flipped(int32_t id) {
  return static_cast<uint32_t>(id) ^ 0x80000000u;
}

// the OR and AND of every thread's v and a, into s_or and s_and (set by the caller)
__device__ __forceinline__ void block_or_and(uint32_t v, uint32_t a, uint32_t* s_or,
                                             uint32_t* s_and) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v |= __shfl_xor_sync(kFull, v, o);
    a &= __shfl_xor_sync(kFull, a, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicOr(s_or, v);
    atomicAnd(s_and, a);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kPlanThreads, 2) route_plan_kernel(const PlanArgs a) {
  __shared__ int32_t wc[kOwnerRound * kPlanWarps];
  __shared__ int32_t tt[kOwnerRound], pre[kOwnerRound + 1], tot[kOwnerRound + 1];
  __shared__ int32_t run[kOwnerRound];
  __shared__ int32_t head_rank[kPlanThreads];
  __shared__ int64_t ends[kOwnerRound + 1];
  __shared__ uint32_t s_or, s_and;
  __shared__ int32_t s_count;
  constexpr int T = kPlanThreads;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x, N = a.n_dev;
  const int64_t r = a.r;
  const int64_t t0 = b * a.per_block;
  const int64_t t1 = t0 + a.per_block < a.n_tiles ? t0 + a.per_block : a.n_tiles;
  int32_t* hist = a.ws;
  uint32_t* orand = reinterpret_cast<uint32_t*>(hist + static_cast<int64_t>(kMaxPasses) * G *
                                                           kDigits);
  int32_t* hown = reinterpret_cast<int32_t*>(orand + 2 * G);  // row b: heads, heads by owner
  const PlanOut& o = a.o;

  // 0. digit 0's counts and the bits of the ids, a block's tiles; the later
  // passes' counts zeroed
  for (int64_t j = static_cast<int64_t>(b) * T + tid;
       j < static_cast<int64_t>(kMaxPasses - 1) * G * kDigits; j += static_cast<int64_t>(G) * T)
    hist[static_cast<int64_t>(G) * kDigits + j] = 0;
  if (tid < kDigits) run[tid] = 0;
  if (tid == 0) {
    s_or = 0;
    s_and = ~0u;
  }
  __syncthreads();
  uint32_t v_or = 0, v_and = ~0u;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t i = t * T + tid;
    if (i < r) {
      const uint32_t f = flipped(a.ids[i]);
      v_or |= f;
      v_and &= f;
      atomicAdd(&run[f & (kDigits - 1)], 1);
    }
  }
  block_or_and(v_or, v_and, &s_or, &s_and);
  if (tid < kDigits) hist[b * kDigits + tid] = run[tid];
  if (tid == 0) {
    orand[2 * b] = s_or;
    orand[2 * b + 1] = s_and;
  }
  grid.sync();

  // the radix passes over the bits that vary: digit 0 is bits [0, 6), the
  // rest split evenly into digits of at most 6 bits.  The blocks' bits are
  // read while digit 0's bases are summed.
  v_or = 0;
  v_and = ~0u;
  for (int j = tid; j < G; j += T) {
    v_or |= __ldcg(orand + 2 * j);
    v_and &= __ldcg(orand + 2 * j + 1);
  }
  n2v::grid_bases<T>(hist, kDigits, G, b, kDigits, pre, tot);
  if (tid == 0) {
    s_or = 0;
    s_and = ~0u;
  }
  __syncthreads();
  block_or_and(v_or, v_and, &s_or, &s_and);
  const uint32_t vary = s_or ^ s_and;
  const int bits = vary ? 32 - __clz(vary) : 0;
  const int rest = bits > kDigitBits ? bits - kDigitBits : 0;
  const int n_rest = (rest + kDigitBits - 1) / kDigitBits;
  const int w_rest = n_rest ? (rest + n_rest - 1) / n_rest : 0;
  const int passes = bits ? 1 + n_rest : 0;
  auto shift_of = [&](int p) { return p == 0 ? 0 : kDigitBits + (p - 1) * w_rest; };
  auto width_of = [&](int p) {
    return p == 0 ? kDigitBits : (w_rest < bits - shift_of(p) ? w_rest : bits - shift_of(p));
  };
  const u64* src = nullptr;
  for (int p = 0; p < passes; ++p) {
    u64* dst = (p & 1) ? a.ws_b : a.ws_a;
    const int shift = shift_of(p), nd = 1 << width_of(p);
    const bool last = p + 1 == passes;
    const int next_shift = last ? 0 : shift_of(p + 1);
    const uint32_t next_mask = last ? 0u : (1u << width_of(p + 1)) - 1u;
    int32_t* next_hist = hist + static_cast<int64_t>(p + 1) * G * kDigits;
    if (p > 0)
      n2v::grid_bases<T>(hist + static_cast<int64_t>(p) * G * kDigits, kDigits, G, b, nd, pre,
                         tot);
    if (tid < 32) {  // pre[d] += the keys of the digits below d
      int below = 0;
      for (int d0 = 0; d0 < nd; d0 += 32) {
        const int d = d0 + tid;
        const int v = d < nd ? tot[d] : 0;
        const int incl = n2v::warp_inclusive_sum(v);
        if (d < nd) pre[d] += below + incl - v;
        below += __shfl_sync(kFull, incl, 31);
      }
    }
    if (tid < nd) run[tid] = 0;
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t i = t * T + tid;
      const bool valid = i < r;
      u64 key = 0;
      if (valid) key = p == 0 ? pack_key(a.ids[i], i) : __ldcg(src + i);
      const uint32_t f = static_cast<uint32_t>(key >> 32);
      const int digit = static_cast<int>((f >> shift) & static_cast<uint32_t>(nd - 1));
      const int off = n2v::tile_offset<T>(valid, digit, nd, wc, tt);
      int64_t pos = 0;
      if (valid) {
        pos = pre[digit] + run[digit] + off;
        dst[pos] = key;
      }
      if (!last) {  // the next pass's count of the block that reads position pos
        const int cell = valid ? static_cast<int>(pos / (T * a.per_block)) * kDigits +
                                     static_cast<int>((f >> next_shift) & next_mask)
                               : -1;
        const unsigned peers = __match_any_sync(kFull, cell);
        if (valid && __ffs(peers) - 1 == (tid & 31))
          atomicAdd(&next_hist[cell], static_cast<int>(__popc(peers)));
      }
      __syncthreads();
      if (tid < nd) run[tid] += tt[tid];
    }
    src = dst;
    grid.sync();
  }

  // the sorted keys; a head is the first key of its id
  auto key_at = [&](int64_t i) { return passes ? __ldcg(src + i) : pack_key(a.ids[i], i); };
  auto is_head = [&](int64_t i, u64 key) {
    return i == 0 || (key >> 32) != (key_at(i - 1) >> 32);
  };
  const int rounds = (N + kOwnerRound - 1) / kOwnerRound;

  // 2. each block's heads, and its heads by owner
  int32_t* own = hown + 1;
  int n_heads = 0;
  for (int c = 0; c < rounds; ++c) {
    const int sc = N - c * kOwnerRound < kOwnerRound ? N - c * kOwnerRound : kOwnerRound;
    __syncthreads();
    if (tid < sc) run[tid] = 0;
    __syncthreads();
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t i = t * T + tid;
      if (i >= r) continue;
      const u64 key = key_at(i);
      if (!is_head(i, key)) continue;
      n_heads += c == 0;
      const int q = floor_mod(key_id(key), N) - c * kOwnerRound;
      if (q >= 0 && q < sc) atomicAdd(&run[q], 1);
    }
    __syncthreads();
    if (tid < sc) own[static_cast<int64_t>(b) * (N + 1) + c * kOwnerRound + tid] = run[tid];
  }
  if (tid == 0) s_count = 0;
  __syncthreads();
  if (n_heads) atomicAdd(&s_count, n_heads);
  __syncthreads();
  if (tid == 0) hown[static_cast<int64_t>(b) * (N + 1)] = s_count;
  grid.sync();

  // 3. unique slots, owner ranks and the plan; round 0 sums the heads with
  // its owners' (bucket 0), the others their owners' alone
  int heads_before = 0, n_uniq = 0, dropped = 0;
  for (int c = 0; c < rounds; ++c) {
    const int sc = N - c * kOwnerRound < kOwnerRound ? N - c * kOwnerRound : kOwnerRound;
    const int at = c == 0 ? 1 : 0;  // pre[at + q]: owner q's uniques before the block
    n2v::grid_bases<T>(hown + (c == 0 ? 0 : 1 + c * kOwnerRound), N + 1, G, b, sc + at, pre,
                       tot);
    if (c == 0) {
      heads_before = pre[0];
      n_uniq = tot[0];
    }
    if (tid < sc) run[tid] = pre[at + tid];  // the owner's uniques before the tile
    int h_run = heads_before;  // the uniques before the tile
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t i = t * T + tid;
      const bool valid = i < r;
      u64 key = 0;
      bool head = false;
      if (valid) {
        key = key_at(i);
        head = is_head(i, key);
      }
      const int32_t id = key_id(key);
      const int32_t pos = key_pos(key);
      const int q = floor_mod(id, N);
      const int qc = q - c * kOwnerRound;
      const bool mine = valid && qc >= 0 && qc < sc;
      const int h_off = n2v::tile_offset<T>(head, 0, 1, wc, tt);
      const int tile_heads = tt[0];
      const int o_off = n2v::tile_offset<T>(head && mine, mine ? qc : 0, sc, wc, tt);
      const int u = h_run + h_off + (head ? 1 : 0) - 1;
      int rk = 0;
      if (head && mine) {
        rk = run[qc] + o_off;
        head_rank[h_off] = rk;
      }
      __syncthreads();
      if (mine && !head) rk = h_off > 0 ? head_rank[h_off - 1] : run[qc] - 1;
      if (valid && c == 0) {
        o.order[i] = pos;
        o.inv[pos] = u;
        if (head) {
          o.uniq[u] = id;
          o.is_uniq[u] = 1;
        }
      }
      if (mine) {
        const bool fits = rk < a.cap;
        o.slot[pos] = fits ? q * a.cap + rk : -1;
        if (head) {
          o.owner[u] = q;
          o.rank[u] = rk;
          o.ok[u] = fits;
          if (fits) o.send_ids[static_cast<int64_t>(q) * a.cap + rk] = id;
        }
      }
      __syncthreads();
      if (tid < sc) run[tid] += tt[tid];
      h_run += tile_heads;
    }
    n2v::grid_fill<T>(o.send_ids + static_cast<int64_t>(c) * kOwnerRound * a.cap, 1, sc, a.cap,
                      tot + at, ends, -1);
    if (b == 0 && tid < sc && tot[at + tid] > a.cap) dropped += tot[at + tid] - a.cap;
  }
  // the dead slots as JAX's argsort leaves them
  for (int64_t u = n_uniq + static_cast<int64_t>(b) * T + tid; u < r;
       u += static_cast<int64_t>(G) * T) {
    o.uniq[u] = 0;
    o.owner[u] = N;
    o.rank[u] = static_cast<int32_t>(u - n_uniq);
    o.is_uniq[u] = 0;
    o.ok[u] = 0;
  }
  if (b == 0) {
    __syncthreads();
    if (tid == 0) s_count = 0;
    __syncthreads();
    if (dropped) atomicAdd(&s_count, dropped);
    __syncthreads();
    if (tid == 0) {
      o.n_out[0] = n_uniq;
      o.n_out[1] = s_count;
    }
  }
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

// ws_a and ws_b: two [r] 64-bit workspaces; ws_i: n2v_route_plan_ws(r, n_dev)
// ints.  send_ids [n_dev * cap]; uniq, inv, owner, rank, slot, order [r]
// int32; is_uniq, ok [r] bytes; n_out [2] = (n_uniq, n_dropped).  All are
// written whole.
extern "C" int64_t n2v_route_plan_ws(int64_t r, int n_dev) {
  const int64_t tiles = r > 0 ? (r + kPlanThreads - 1) / kPlanThreads : 1;
  return tiles * (kMaxPasses * kDigits + 3 + static_cast<int64_t>(n_dev));
}

// K18's grid at r keys: out[0] blocks resident an SM, [1] SMs, [2] tiles a
// block, [3] blocks (all resident: a cooperative launch refuses more).
extern "C" int n2v_route_plan_geometry(int64_t r, int64_t* out) {
  const int64_t n_tiles = r > 0 ? (r + kPlanThreads - 1) / kPlanThreads : 1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(route_plan_kernel), kPlanThreads, 0);
  out[0] = per_sm;
  out[1] = sms;
  const cudaError_t err = n2v::grid_geometry(reinterpret_cast<const void*>(route_plan_kernel),
                                             kPlanThreads, n_tiles, out + 2, out + 3);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int n2v_route_plan(const int32_t* ids, int64_t r, int n_dev, int cap, u64* ws_a,
                              u64* ws_b, int* ws_i, int32_t* uniq, int32_t* inv,
                              uint8_t* is_uniq, int32_t* owner, int32_t* rank, uint8_t* ok,
                              int32_t* send_ids, int32_t* n_out, int32_t* slot, int32_t* order,
                              void* stream) {
  if (r <= 0 || n_dev < 1 || cap < 1 || r >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  PlanArgs a{ids, r, n_dev, cap, ws_a, ws_b, ws_i,
             PlanOut{uniq, inv, owner, rank, send_ids, n_out, slot, order, is_uniq, ok},
             (r + kPlanThreads - 1) / kPlanThreads, 1};
  int64_t grid = 0;
  cudaError_t err = n2v::grid_geometry(reinterpret_cast<const void*>(route_plan_kernel),
                                       kPlanThreads, a.n_tiles, &a.per_block, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(route_plan_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(kPlanThreads), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
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
