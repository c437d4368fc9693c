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
//     sum of their mean squares; every other row of send gets zeros (the
//     rows whose send_ids entry is -1).  A request p reads row p of g_a (p <
//     n_a) or row p - n_a of g_b; it is live where its live array holds a
//     value >= 0 (the flat walks, HS's tail rows), or always where that
//     array is null (SGNS's d_no rows).
//   The gather takes one warp a row.  The pack is one cooperative launch
//   that writes every row of send once, with no float atomics: every warp
//   sums a range of the
//   sorted requests run by run, several rows in flight and the squares
//   kept a lane, with one reduction a run, then zeroes a grid-stride share
//   of the unfilled rows.  A run that crosses ranges is summed by the warp
//   where it begins: its partial stays in registers over the grid barrier,
//   the later ranges leave theirs in a workspace of one row a warp, and the
//   beginning warp adds them in range order.  A unique may have hundreds of
//   thousands of requests (HS's tail entries past a code's length all ask
//   for row 0): its ranges' partials are read a 32-range window at a time,
//   and those with no live request are skipped.  No float atomics, so two
//   calls give the same bits.
//
// Bound on an H100: memory.  K18 reads the ids and writes the plan (a
// handful of [R] int32 arrays and send_ids) once; its sort moves 8 B a key
// per pass.  The gather reads the live requested rows and writes [N * cap,
// D]; the pack reads the plan, the live requests' gradient rows and send_ids,
// and writes [N * cap, D + 1] once.

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

struct PackArgs {
  PackIn in;
  int dim;
  const int32_t *order, *inv, *owner, *rank, *send_ids;
  const uint8_t* ok;
  int64_t r, n_rows;  // requests; rows of send (n_dev * cap)
  int cap;
  int64_t per_warp;   // sorted requests a warp's range holds (a multiple of 32)
  float* lead;        // [warps][dim + 1]: a range's first run where it began before the range
  int32_t* meta;      // [warps][2]: that run's live requests (-1: none), 1 if it passes through
  float* send;
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

// live request rows a warp loads before it adds them, by the row's floats a lane
__host__ __device__ constexpr int rows_in_flight(int cols) {
  return cols <= 4 ? 4 : cols <= 8 ? 2 : 1;
}

// zeros into dst[0, n), by a warp: 16-byte stores where aligned
__device__ __forceinline__ void zero_floats(float* dst, int64_t n, int lane) {
  const int head = static_cast<int>((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16 / 4);
  const int64_t lead_n = head < n ? head : n;
  if (lane < lead_n) dst[lane] = 0.f;
  float4* body = reinterpret_cast<float4*>(dst + lead_n);
  const int64_t n4 = (n - lead_n) / 4;
  for (int64_t i = lane; i < n4; i += 32) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = lead_n + 4 * n4 + lane; i < n; i += 32) dst[i] = 0.f;
}

// A run's sums in the registers of a warp: lane l holds columns l + 32 c and
// the sum of their squares; live: the run's live requests.
template <int kCols>
struct Run {
  int u = -1;
  int32_t row = -1;  // its row of send, -1 where its unique is dropped
  int live = 0;
  float acc[kCols];
  float sq = 0.f;
  __device__ __forceinline__ void reset(int u_new, int32_t row_new) {
    u = u_new;
    row = row_new;
    live = 0;
    sq = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  }
  __device__ __forceinline__ void add(const float (&v)[kCols], int lane, int dim) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (lane + 32 * c < dim) {
        acc[c] = __fadd_rn(acc[c], v[c]);
        sq = __fmaf_rn(v[c], v[c], sq);
      }
    }
    ++live;
  }
};

// the unique's row of send (where ok): the run's sums and, in column dim,
// its squares over dim (the sum of its requests' mean squares)
template <int kCols>
__device__ __forceinline__ void store_row(const PackArgs& a, const Run<kCols>& run, float sq,
                                          int lane) {
  if (run.row < 0) return;
  float* dst = a.send + static_cast<int64_t>(run.row) * (a.dim + 1);
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (lane + 32 * c < a.dim) dst[lane + 32 * c] = run.acc[c];
  if (lane == 0) dst[a.dim] = __fdiv_rn(sq, static_cast<float>(a.dim));
}

// a range's lead to the workspace: its sums, squares, live requests and
// whether it passes through the range
template <int kCols>
__device__ __forceinline__ void store_lead(const PackArgs& a, const Run<kCols>& run, int64_t warp,
                                           bool through, int lane) {
  float* dst = a.lead + warp * (a.dim + 1);
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (lane + 32 * c < a.dim) dst[lane + 32 * c] = run.acc[c];
  const float sq = warp_sum(run.sq);
  if (lane == 0) {
    dst[a.dim] = sq;
    a.meta[2 * warp] = run.live;
    a.meta[2 * warp + 1] = through;
  }
}

// The rows of send that no unique fills (send_ids -1), a grid-stride share
// of windows of 32 rows a warp (each run of such rows in a window is one
// contiguous range of floats).
__device__ __forceinline__ void zero_unfilled(const PackArgs& a, int64_t warp, int64_t n_warps,
                                              int lane) {
  for (int64_t j0 = warp * 32; j0 < a.n_rows; j0 += n_warps * 32) {
    const int64_t j = j0 + lane;
    for (unsigned m = __ballot_sync(kFull, j < a.n_rows && a.send_ids[j] < 0); m != 0;) {
      const int s0 = __ffs(m) - 1;
      const unsigned ones = ~(m >> s0);
      const int len = ones ? __ffs(ones) - 1 : 32 - s0;
      zero_floats(a.send + (j0 + s0) * (a.dim + 1), static_cast<int64_t>(len) * (a.dim + 1),
                  lane);
      m &= len + s0 >= 32 ? (1u << s0) - 1u : ~(((1u << len) - 1u) << s0);
    }
  }
}

// K19's pack, one cooperative launch.  Phase 1, every warp: it sums a
// range of the sorted requests run by run (a run: one unique's requests),
// rows_in_flight live rows loaded at once, then zeroes a grid-stride share
// of the rows that no unique fills (send_ids -1).  A run that begins and
// ends in the range is stored; a run that began before the range is the
// range's lead, stored to the workspace (it passes through when it also
// continues past the range's end); a run that begins in the range and
// continues past its end is the warp's tail, kept in registers.  After the grid barrier each warp with a tail adds the leads
// of the ranges after it, in range order, up to the range where its run
// ends, and stores the row.  Every row of send is written once, each sum
// in one fixed order, so two calls give the same bits.
template <int kCols>
__global__ void __launch_bounds__(kRowThreads, kCols <= 4 ? 4 : kCols <= 8 ? 3 : 2)
    pack_kernel(const PackArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  const int dim = a.dim;
  constexpr int kIn = rows_in_flight(kCols);
  if (lane == 0) {  // no lead unless one is stored
    a.meta[2 * warp] = -1;
    a.meta[2 * warp + 1] = 0;
  }

  // the warp's range of sorted requests
  const int64_t lo = warp * a.per_warp;
  const int64_t hi = lo + a.per_warp < a.r ? lo + a.per_warp : a.r;
  Run<kCols> run;
  run.reset(lo > 0 && lo < a.r ? a.inv[a.order[lo - 1]] : -1, -1);
  const int u_after = hi < a.r ? a.inv[a.order[hi]] : -1;
  bool lead = true;   // the current run began before the range
  bool seen = false;  // the current run has requests in the range
  auto flush = [&]() {
    if (!seen) return;
    if (lead) {
      store_lead<kCols>(a, run, warp, false, lane);
    } else {
      store_row<kCols>(a, run, warp_sum(run.sq), lane);
    }
  };
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t j = base + lane;
    int p = 0, u = -1;
    int32_t row = -1;  // the unique's row of send, -1 where it is dropped
    bool live = false;
    if (j < hi) {
      p = a.order[j];
      u = a.inv[p];
      const bool ok = a.ok[u];
      const int32_t owner = a.owner[u], rank = a.rank[u];
      live = ok && request_row(a.in, p, dim) != nullptr;
      row = ok ? owner * a.cap + rank : -1;
    }
    const int u_prev = __shfl_up_sync(kFull, u, 1);
    unsigned heads = __ballot_sync(kFull, j < hi && u != (lane == 0 ? run.u : u_prev));
    unsigned lives = __ballot_sync(kFull, live);
    if (!(heads & 1u)) seen = true;  // the window begins inside the current run
    while (lives | heads) {
      // the next kIn live requests (32: none), their rows loaded at once
      int src[kIn];
      float v[kIn][kCols];
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        src[i] = lives ? __ffs(lives) - 1 : 32;
        lives &= lives - 1;
        const int ps = __shfl_sync(kFull, p, src[i] & 31);
        const float* row = src[i] < 32 ? request_row(a.in, ps, dim) : nullptr;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[i][c] = row != nullptr && lane + 32 * c < dim ? row[lane + 32 * c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        // the heads up to this live request (none left: every head)
        const unsigned upto = src[i] >= 31 ? ~0u : (2u << src[i]) - 1u;
        for (unsigned h = heads & upto; h != 0; h &= h - 1) {
          const int hl = __ffs(h) - 1;
          const int hu = __shfl_sync(kFull, u, hl);
          const int32_t hrow = __shfl_sync(kFull, row, hl);
          flush();
          run.reset(hu, hrow);
          lead = false;
          seen = true;
        }
        heads &= ~upto;
        if (src[i] < 32) run.add(v[i], lane, dim);
      }
    }
  }
  if (seen && run.u == u_after) {  // the run continues past the range
    if (lead) {                    // and passes through it
      store_lead<kCols>(a, run, warp, true, lane);
      seen = false;
    }
  } else {
    flush();
    seen = false;
  }
  zero_unfilled(a, warp, n_warps, lane);  // once the warp's sums are stored
  cg::this_grid().sync();

  // a tail: the leads of the ranges after this one, in range order, up to
  // the range where the run ends (the first lead that does not pass through)
  if (!seen) return;
  float sq = warp_sum(run.sq);
  for (int64_t g0 = warp + 1;; g0 += 32) {
    const int64_t g = g0 + lane;
    int live = -1, through = 0;
    if (g < n_warps) {
      live = __ldcg(a.meta + 2 * g);
      through = __ldcg(a.meta + 2 * g + 1);
    }
    const unsigned ends = __ballot_sync(kFull, !through);
    const unsigned upto = ends ? (2u << (__ffs(ends) - 1)) - 1u : ~0u;
    for (unsigned m = __ballot_sync(kFull, live > 0) & upto; m != 0; m &= m - 1) {
      const float* src = a.lead + (g0 + __ffs(m) - 1) * (dim + 1);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < dim) run.acc[c] = __fadd_rn(run.acc[c], __ldcg(src + lane + 32 * c));
      sq = __fadd_rn(sq, __ldcg(src + dim));
    }
    if (ends) break;
  }
  store_row<kCols>(a, run, sq, lane);
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

namespace {

// K19's pack: its kernel at a row width and the blocks resident on the card
// (all of them make the cooperative grid).
struct PackLaunch {
  const void* kernel;
  int64_t blocks;
};

cudaError_t pack_launch(int dim, PackLaunch* l) {
  l->kernel = dim <= 128   ? reinterpret_cast<const void*>(pack_kernel<4>)
              : dim <= 256 ? reinterpret_cast<const void*>(pack_kernel<8>)
              : dim <= 512 ? reinterpret_cast<const void*>(pack_kernel<16>)
                           : reinterpret_cast<const void*>(pack_kernel<kMaxColsPerLane>);
  return n2v::resident_blocks(l->kernel, kRowThreads, &l->blocks);
}

}  // namespace

// K19 pack's workspace at row width dim: out[0] floats (a lead row a warp of
// the grid), out[1] ints (two a warp), out[2] blocks, out[3] warps.
extern "C" int n2v_route_pack_ws(int dim, int64_t* out) {
  if (dim < 1 || dim > 32 * kMaxColsPerLane) return static_cast<int>(cudaErrorInvalidValue);
  PackLaunch l{};
  const cudaError_t err = pack_launch(dim, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = l.blocks * kRowWarps;
  out[0] = warps * (dim + 1);
  out[1] = 2 * warps;
  out[2] = l.blocks;
  out[3] = warps;
  return 0;
}

// send [n_rows = n_dev * cap, dim + 1] is written whole: each unique's row
// where ok, zeros where send_ids [n_rows] is -1.  The plan's arrays as
// n2v_route_plan wrote them (r requests = n_a + n_b); live_a / live_b may be
// null (every row live); lead / meta: n2v_route_pack_ws(dim) floats and
// ints.  dim <= 1024.
extern "C" int n2v_route_pack(const float* g_a, const int32_t* live_a, int64_t n_a,
                              const float* g_b, const int32_t* live_b, int dim,
                              const int32_t* order, const int32_t* inv, const int32_t* owner,
                              const int32_t* rank, const uint8_t* ok, const int32_t* send_ids,
                              int64_t r, int64_t n_rows, int cap, float* lead, int32_t* meta,
                              float* send, void* stream) {
  if (dim < 1 || dim > 32 * kMaxColsPerLane || r < 0 || r >= (1ll << 31) || n_rows < 0 ||
      n_rows >= (1ll << 31) || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  PackLaunch l{};
  cudaError_t err = pack_launch(dim, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = l.blocks * kRowWarps;
  const int64_t chunks = (r + 31) / 32;
  PackArgs a{PackIn{g_a, g_b, live_a, live_b, n_a}, dim, order, inv, owner, rank, send_ids, ok,
             r, n_rows, cap, 32 * ((chunks + warps - 1) / warps), lead, meta, send};
  if (a.per_warp == 0) a.per_warp = 32;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(l.kernel, dim3(static_cast<unsigned>(l.blocks)),
                                    dim3(kRowThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
