// The graph-sharded (edge-partitioned) blocked walk's superstep: K20
// ep_bucket, K21 ep_propose, K22 ep_member, and K23 ep_advance inside K20's
// launch.
//
// Replace node2vec_tpu/parallel/edge_partitioned_blocked.py:347 shard_fn's
// superstep (:367-610), one kernel per stage between its all_to_alls:
//   K20 ep_bucket   _bucket_by_dest (:297) and the request packs of phase A
//                   (:380-399, the 7-field proposal request with the hash
//                   uniforms at 4*att + 0, + 1) and phase B (:511-526, the
//                   2-field membership request);
//   K21 ep_propose  owner(cur) serves the proposal (:401-500);
//   K22 ep_member   owner(prev) answers the membership test (:527-553);
//   K23 ep_advance  home: read the responses back by slot, accept, trial cap
//                   and fallbacks, path write, carried state (:502-509,
//                   :554-610), and the pending count of the loop condition:
//                   in front of the next superstep's phase-A ranking, one
//                   launch (ep_advance_bucket).
// Each computes what its plain version in
// parallel/edge_partitioned_blocked.py computes (ep_*_plain; the fused
// launch: ep_advance_plain, then ep_bucket_plain).
//
// The carried state is one int32 [10, n] tensor (rows T, CUR, PREV, W_FWD,
// FWD_PFX, W_BACK_ENC, BACK_PFX, ALIVE, TRIALS, ATT; floats as their bits).
//
// K20: one cooperative launch a call, on bucket_common.cuh's grid ranking:
// a persistent grid of resident blocks, each over a run of tiles of 1,024
// lanes.  A block reads its first tile's lanes and requests (every load at
// once), ranks them within the tile and counts its lanes by destination;
// after one grid barrier it sums the counts of the blocks before it
// block-parallel, gives each lane its slot (stable in lane order, as JAX's
// one-hot cumsum ranks it), stores the requests of the lanes ranked below
// the capacity a warp's run at a time (staged in shared memory, so the
// stores coalesce), and writes -1 only into the rows that no lane fills.
// The fused launch is the same grid with the advance in each lane's first
// read (lane_request<true>): a lane that sent a proposal takes its step in
// registers and writes back the rows that changed and its path entry, a
// lane that sent nothing reads only its slot and the rows of its request;
// the pending count is the grid's total of active lanes after the barrier,
// written by one thread (no atomic, no memset), the fallbacks a block count
// added atomically.  The ranking consumes no draw and leaves the state as it
// is, so the walks stay the superstep-by-superstep ones.
// K21, K22: an 8-lane group a request, four a warp, as K5 groups its
// walkers: the requested row staged in shared memory and sampled by
// blocked_common.cuh's device functions, the ones K5 calls (a heavy block
// and a bids row in the lane order K5 stages them in): the same float
// operations in the same order, so the proposals equal K5's bit for bit on
// the same tables and draws.  An empty slot (cur < 0) is skipped at once:
// the buffers hold the full capacity and late supersteps are mostly empty.
// K21 stages a heavy block too (C <= 256): its weights are copied over the
// group's light row by coalesced 16-byte cp.async, swizzled so that lane r
// reads its own run of columns on its own bank quad, and scanned there.  Read
// from global memory a run a lane (past 256 columns), every 16-byte load of a
// warp touches 32 lines, three times over (the lane sums, the count below,
// the prefix), and the L1 serialises them: 54% of a warp's cycles at the main
// path's second superstep, where 87% of the requests are heavy
// (experiments/propose_preagg_attribution.py).
//
// Bound on an H100: bytes, per superstep.  K20 reads the carried state (and
// phase B the responses by slot) and writes the requests and slots; K21
// reads a request, one 512-byte light row and, at a heavy vertex, its
// block's C weights, a 32-byte id sector and an 8-byte brp pair, and writes
// a response; K22 reads a request and a light row (a heavy prev also its
// bids row); the fused launch reads every lane's slot and activity, a sent
// lane's state and responses, the request rows of an active lane, and
// writes the changed state, the path entries, the requests and slots.
// The owner kernels are latency-bound at these sizes (one dependent row load
// a request), as K5 is.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "bucket_common.cuh"
#include "hashrng.cuh"

namespace {

enum Row { kT = 0, kCur, kPrev, kWFwd, kFwdPfx, kWBackEnc, kBackPfx, kAlive, kTrials, kAtt };
namespace cg = cooperative_groups;

constexpr int kTile = 1024;       // K20 lanes a tile, threads a block
constexpr int kMaxShards = 256;   // KERNEL_MAX_SHARDS: K20's per-warp counts in shared memory
constexpr int kReqWarps = 8;      // K21, K22 warps a block
constexpr int kReqs = kReqWarps * 32 / n2v::kGroup;  // K21, K22 requests a block
constexpr int kPropose = 7, kMember = 2, kResp = 6;

__device__ __forceinline__ int32_t owner_of(int32_t v, int64_t rows_per_shard, int n_shards) {
  const int64_t o = static_cast<int64_t>(v < 0 ? 0 : v) / rows_per_shard;
  return static_cast<int32_t>(o < n_shards - 1 ? o : n_shards - 1);
}

__device__ __forceinline__ int64_t clamp_slot(int32_t s, int64_t n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

struct BucketArgs {
  int32_t* carry;  // the fused launch advances it in place; K20 alone only reads it
  int64_t n;
  const int32_t* slot_a;  // phase B and the fused launch: the proposal round's slots
  const int32_t* back;    // and its responses
  int32_t* send;
  int32_t* slot;
  int32_t* blk;  // [grid, n_shards]: each block's lanes a destination
  int n_shards;
  int64_t capacity;
  int64_t rows_per_shard;
  int walk_length;
  int64_t gid_base;
  uint32_t seed;
  int member;
  int64_t n_tiles;
  int64_t per_block;  // tiles a block
  // the fused launch: the superstep that slot_a and back answer, advanced
  const int32_t* slot_b;  // mode 2: the membership round's slots
  const int32_t* resp_b;  // and its answers, n_shards * capacity of them
  int32_t* paths;         // [n, walk_length + 1]
  int32_t* n_fb;          // the fallback count, added to
  int32_t* pending;       // written: the lanes alive with t < L after the advance
  int max_trials;
  float inv_q, alpha_hi;
  int mode;  // 0 = p = q = 1, 1 = q == 1, 2 = q != 1
};

// K20's request of a lane: phase A's 7 fields (the hash uniforms at
// 4 * att + 0, + 1), phase B's 2.
struct Request {
  int32_t f[kPropose];
};

// Is lane i active in this round, to which owner does it send, and what?
// Every load is issued at once, a lane that is not active reading its rows
// too (they share its warp's sectors), so the chain of dependent reads is
// one trip (phase B: two, the response behind the slot).
//
// kAdvance (the fused launch, phase A): the lane first takes the step of
// the superstep that slot_a, back, slot_b and resp_b answer, as
// ep_advance_plain does (JAX :502-509, :554-610), and its request is made
// from the advanced state in registers.  A lane that sent nothing changes
// nothing (it attempted nothing and cannot die), so it reads only its slot
// and the rows of its activity and request; a lane that sent also reads
// its response (at q != 1 its membership answer, behind the slot loaded
// with the rows) and the rest of its state, and writes only the rows that
// changed and its path entry.  *fb counts its trial-capped fallback.
template <bool kAdvance>
__device__ __forceinline__ bool lane_request(const BucketArgs& a, int64_t i, int64_t n_req,
                                             int32_t* dest, Request& q, int* fb) {
  *dest = 0;
  if (i >= a.n) return false;
  const int64_t n = a.n;
  int32_t* c = a.carry;
  if (a.member) {
    const int32_t t = c[kT * n + i];
    const int32_t sa = a.slot_a[i];
    const int32_t prev = c[kPrev * n + i];
    const int32_t* g = a.back + clamp_slot(sa, n_req) * kResp;
    const int32_t cand = g[0];
    const bool take = g[5] > 0;
    q.f[0] = prev;
    q.f[1] = cand;
    if (sa >= n_req || (cand < 0 && !take) || take || t == 0) return false;  // no request, died
    *dest = owner_of(prev, a.rows_per_shard, a.n_shards);
    return true;
  }
  int32_t t = c[kT * n + i], alive = c[kAlive * n + i], cur = c[kCur * n + i];
  int32_t prev = c[kPrev * n + i], wbe = c[kWBackEnc * n + i], bpfx = c[kBackPfx * n + i];
  uint32_t att = static_cast<uint32_t>(c[kAtt * n + i]);
  if (kAdvance) {
    const int32_t sa = a.slot_a[i];
    const int32_t sb = a.mode == 2 ? a.slot_b[i] : 0;
    const bool sent = sa < n_req;
    if (sent) {
      const int32_t* g = a.back + static_cast<int64_t>(sa) * kResp;
      const int32_t w_fwd = c[kWFwd * n + i], fwd_pfx = c[kFwdPfx * n + i];
      const int32_t trials0 = c[kTrials * n + i];
      const int32_t a_cand = g[0];
      const bool a_take = g[5] > 0;
      const bool shared = a.mode == 2 && a.resp_b[clamp_slot(sb, n_req)] > 0;
      const bool died = a_cand < 0 && !a_take;
      const bool first = t == 0;
      // at q != 1 a lane that needed a membership answer and was not sent
      // one defers its whole attempt
      const bool attempted = a.mode != 2 || sb < n_req || died || a_take || first;
      bool accept;
      if (a.mode == 0) {
        accept = attempted;
      } else if (a.mode == 1) {
        accept = attempted && (a_take || first || a_cand != prev);
      } else {
        const float u_acc = n2v::hash_uniform(a.seed, static_cast<uint32_t>(a.gid_base + i),
                                              att * 4u + 2u);
        const float alpha2 = wbe < 0 ? a.alpha_hi : a.inv_q;
        const float bias2 = shared ? 1.f : a.inv_q;
        accept = attempted &&
                 (a_take || first || (a_cand != prev && __fmul_rn(u_acc, alpha2) <= bias2));
      }
      const bool lives = alive != 0 && !died;
      int32_t trials = attempted ? (accept ? 0 : trials0 + 1) : trials0;
      const bool force = attempted && lives && trials >= a.max_trials;
      *fb += force && !accept;
      if ((accept || force) && lives) {
        const bool take = a_take && !force;
        const int32_t nxt = take ? prev : a_cand;
        a.paths[i * (a.walk_length + 1) + t + 1] = nxt;
        // floats move as their bits: the weights and prefixes of the edge taken
        const int32_t n_wbe =
            take ? (w_fwd | (wbe < 0 ? static_cast<int32_t>(0x80000000u) : 0)) : g[2];
        const int32_t n_bpfx = take ? fwd_pfx : g[3];
        c[kWFwd * n + i] = take ? (wbe & 0x7FFFFFFF) : g[1];
        c[kFwdPfx * n + i] = take ? bpfx : g[4];
        if (n_wbe != wbe) c[kWBackEnc * n + i] = n_wbe;
        if (n_bpfx != bpfx) c[kBackPfx * n + i] = n_bpfx;
        wbe = n_wbe;
        bpfx = n_bpfx;
        c[kPrev * n + i] = prev = cur;
        if (nxt != cur) c[kCur * n + i] = nxt;
        cur = nxt;
        c[kT * n + i] = ++t;
        trials = 0;
      }
      if (trials != trials0) c[kTrials * n + i] = trials;
      if (attempted && lives) c[kAtt * n + i] = static_cast<int32_t>(++att);
      if (!lives && alive) c[kAlive * n + i] = 0;
      alive = lives;
    }
  }
  q.f[0] = cur;
  q.f[1] = prev;
  q.f[2] = wbe;
  q.f[3] = bpfx;
  q.f[6] = t;
  if (alive == 0 || t >= a.walk_length) return false;
  const uint32_t gid = static_cast<uint32_t>(a.gid_base + i);
  q.f[4] = __float_as_int(n2v::hash_uniform(a.seed, gid, att * 4u));
  q.f[5] = __float_as_int(n2v::hash_uniform(a.seed, gid, att * 4u + 1u));
  *dest = owner_of(cur, a.rows_per_shard, a.n_shards);
  return true;
}

// The warp's requests, staged in shared memory and stored 32 ints at a time:
// int k of the warp's F * 32 is field k % F of lane k / F's request, so lanes
// ranked one after another (as a warp's lanes of one destination are) write
// one contiguous run, and the stores coalesce.  Warp-wide; flat == n_req where
// a lane sends nothing; stage: this warp's F * 32 + 32 ints.
template <int F>
__device__ __forceinline__ void store_requests(int32_t* send, int64_t flat, int64_t n_req,
                                               const Request& q, int32_t* stage) {
  const int lane = threadIdx.x & 31;
  int32_t* rows = stage + F * 32;  // [32]: each lane's row (n_req <= INT32_MAX)
#pragma unroll
  for (int f = 0; f < F; ++f) stage[lane * F + f] = q.f[f];
  rows[lane] = static_cast<int32_t>(flat);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < F; ++j) {
    const int k = j * 32 + lane;
    const int src = k / F;
    const int32_t row = rows[src];
    if (row < n_req) send[static_cast<int64_t>(row) * F + (k - src * F)] = stage[k];
  }
  __syncwarp();
}

// F: the request's fields, kPropose (phase A) or kMember (phase B).
// kAdvance: the fused launch (phase A), which advances each lane exactly once,
// in its first read (the first tile before the ranking, a later tile in the
// count pass), so the emit pass re-reads the advanced state; it adds the
// block's fallbacks to n_fb and writes the pending count (every lane active
// in the new ranking: the grid's totals after the barrier) from one thread.
template <int F, bool kAdvance>
__global__ void __launch_bounds__(kTile, 1) ep_bucket_kernel(const BucketArgs a) {
  __shared__ int32_t wc[kMaxShards * kTile / 32];  // tile_offset's; then the warps' stages
  __shared__ int32_t tt[kMaxShards], pre[kMaxShards], tot[kMaxShards], run[kMaxShards];
  __shared__ int64_t ends[kMaxShards + 1];
  __shared__ int32_t fb_block;
  static_assert(kMaxShards * kTile / 32 >= kTile / 32 * (kPropose + 1) * 32,
                "a warp's stage fits in wc");
  const int S = a.n_shards;
  const int64_t n_req = S * a.capacity;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * a.per_block;
  const int64_t t1 = t0 + a.per_block < a.n_tiles ? t0 + a.per_block : a.n_tiles;
  int32_t* stage = wc + (threadIdx.x >> 5) * (F + 1) * 32;
  if (kAdvance && threadIdx.x == 0) fb_block = 0;
  auto emit = [&](int64_t i, bool active, int32_t dest, int64_t rank, const Request& q) {
    const int64_t flat = active && rank < a.capacity ? dest * a.capacity + rank : n_req;
    if (i < a.n) a.slot[i] = static_cast<int32_t>(flat);
    __syncthreads();  // every warp is done with wc's ranks
    store_requests<F>(a.send, flat, n_req, q, stage);
  };

  // the first tile ranked within itself and its requests read; the block's
  // lanes counted by destination
  int64_t i = t0 * kTile + threadIdx.x;
  int32_t dest;
  Request q = {};
  int fb = 0;
  bool active = lane_request<kAdvance>(a, i, n_req, &dest, q, &fb);
  const int off = n2v::tile_offset<kTile>(active, dest, S, wc, tt);
  for (int d = threadIdx.x; d < S; d += kTile) run[d] = tt[d];
  __syncthreads();
  for (int64_t t = t0 + 1; t < t1; ++t) {
    int32_t dt;
    Request unused;
    if (lane_request<kAdvance>(a, t * kTile + threadIdx.x, n_req, &dt, unused, &fb))
      atomicAdd(&run[dt], 1);
  }
  if (kAdvance && fb) atomicAdd(&fb_block, fb);
  __syncthreads();
  for (int d = threadIdx.x; d < S; d += kTile)
    a.blk[static_cast<int64_t>(blockIdx.x) * S + d] = run[d];
  if (kAdvance && threadIdx.x == 0 && fb_block) atomicAdd(a.n_fb, fb_block);
  cg::this_grid().sync();

  n2v::grid_bases<kTile>(a.blk, S, gridDim.x, blockIdx.x, S, pre, tot);
  if (kAdvance && blockIdx.x == 0 && threadIdx.x < 32) {
    int p = 0;
    for (int d = threadIdx.x; d < S; d += 32) p += tot[d];
    p = n2v::warp_total(p);
    if (threadIdx.x == 0) *a.pending = p;
  }
  emit(i, active, dest, active ? pre[dest] + off : 0, q);
  for (int d = threadIdx.x; d < S; d += kTile) run[d] = pre[d] + tt[d];
  for (int64_t t = t0 + 1; t < t1; ++t) {
    i = t * kTile + threadIdx.x;
    active = lane_request<false>(a, i, n_req, &dest, q, &fb);
    const int o = n2v::tile_offset<kTile>(active, dest, S, wc, tt);
    emit(i, active, dest, active ? run[dest] + o : 0, q);
    __syncthreads();
    for (int d = threadIdx.x; d < S; d += kTile) run[d] += tt[d];
  }
  n2v::grid_fill<kTile>(a.send, F, S, a.capacity, tot, ends, -1);
}

// K21's staged heavy blocks (C <= kStageCols): a group's shared buffer holds
// its light row, then its heavy block's C weights, lane r's k4 = C / 32 int4s
// at r * k4 + (m ^ swz(r)): copied by coalesced 16-byte cp.async (the
// group's 8 lanes a 128-byte run of the block), and read by lane r in its
// column order with the eight lanes of a group on eight different bank
// quads (k4 = 8: conflict-free).  The block's scans read shared memory, so
// the block leaves the L2 once a request, in C / 128 coalesced trips.
constexpr int kStageCols = 256;

__device__ __forceinline__ int swz(int r, int k4) {
  return (k4 & (k4 - 1)) == 0 ? (r & (k4 - 1)) : 0;  // a bijection of 0 .. k4 - 1
}

struct StagedCols {
  const int4* buf;
  int r, k4;
  __device__ __forceinline__ int4 operator()(int m) const {
    return buf[r * k4 + (m ^ swz(r, k4))];
  }
};

// Start copying a block's C weights into a group's buffer (StagedCols'
// layout); complete with copies_wait.
__device__ __forceinline__ void block_issue(int32_t* buf, const int32_t* w_row, int gl, int k4,
                                            bool on) {
  if (!on) return;
  for (int i = gl; i < n2v::kGroup * k4; i += n2v::kGroup) {
    const int r = i / k4, m = i - r * k4;
    n2v::cp_async16(buf + 4 * (r * k4 + (m ^ swz(r, k4))), w_row + 4 * i);
  }
}

// The staged weight of column j.
__device__ __forceinline__ int32_t staged_at(const int32_t* buf, int j, int k4) {
  const int i = j >> 2, r = i / k4, m = i - r * k4;
  return buf[4 * (r * k4 + (m ^ swz(r, k4))) + (j & 3)];
}

// mode: 0 = p = q = 1 (target u_prop * wtot, no return branch), else the
// return branch m1 / (m1 + m2) and the prev-excluded target.  An 8-lane
// group a request, four a warp; every group runs every phase (blocked_common.cuh),
// a group without a request masked by `on`.  kStaged: the heavy block is
// scanned in shared memory (C <= kStageCols), else read from global memory
// by each lane's run of int4s.
template <bool kStaged>
__global__ void __launch_bounds__(kReqWarps * 32)
ep_propose_kernel(const int32_t* __restrict__ recv, int64_t n_req,
                  const int32_t* __restrict__ light, int64_t n_rows,
                  const int32_t* __restrict__ biw, const int32_t* __restrict__ brp,
                  int32_t* __restrict__ resp, int64_t row_base, float inv_p, float inv_q,
                  float alpha_hi, int mode, int p_l, int c) {
  __shared__ __align__(16) int32_t rows[kReqs][kStaged ? kStageCols : n2v::kLightRow];
  const int gl = threadIdx.x & (n2v::kGroup - 1);  // lane within the request's group
  const int g = threadIdx.x / n2v::kGroup;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kReqs + g;
  const bool have = r < n_req;
  const int32_t* rq = recv + (have ? r : 0) * kPropose;
  int32_t* out = resp + r * kResp;
  const int32_t cur = have ? rq[0] : -1;
  const bool on = cur >= 0;
  if (have && !on && gl < kResp) out[gl] = -1;
  if (!__any_sync(n2v::kFullMask, on)) return;  // warp-uniform; no block barrier below
  const int32_t wb_enc = rq[2];
  const float wb = __int_as_float(wb_enc & 0x7FFFFFFF);
  const float bpfx = __int_as_float(rq[3]);
  const float ub = __int_as_float(rq[4]);
  const float up = __int_as_float(rq[5]);
  const bool first = rq[6] == 0;
  int64_t lv = static_cast<int64_t>(cur) - row_base;
  lv = lv < 0 ? 0 : (lv >= n_rows ? n_rows - 1 : lv);
  int32_t* row = rows[g];
  n2v::row_issue(row, light + lv * n2v::kLightRow, gl, on);
  n2v::copies_wait();

  const int maxb = (4 * p_l - 5) / 2;
  const bool is_heavy = row[0] < -1;
  const n2v::LightCols lc = n2v::light_cols(row, gl, p_l, true);
  const int degree = is_heavy ? row[4] : lc.degree;
  const float wtot = is_heavy ? __int_as_float(row[3]) : lc.wtot;

  bool take_back = false;
  float target;
  if (mode == 0) {
    target = __fmul_rn(up, wtot);
  } else {
    const float m1 = first ? 0.f : __fmul_rn(wb, inv_p);
    const float alpha2 = wb_enc < 0 ? alpha_hi : inv_q;
    const float rest = fmaxf(__fsub_rn(wtot, wb), 0.f);
    const float m2 = __fmul_rn(rest, alpha2);
    take_back = !first && ub < __fdiv_rn(m1, fmaxf(__fadd_rn(m1, m2), 1e-30f));
    const float u2 = __fmul_rn(up, rest);
    target = u2 < bpfx ? u2 : __fadd_rn(u2, wb);
  }

  // light: every group computes it (shared memory only); a heavy one discards it
  const int below_l = n2v::light_below(lc.cdf, target, gl, p_l);
  const int slot_l = min(below_l, max(degree - 1, 0));
  const int ls = min(slot_l, n2v::kLightRow / 4 - 1);
  const float pc_l = n2v::light_cdf_at(lc.cdf, max(ls - 1, 0));
  float ppfx = ls > 0 ? pc_l : 0.f;
  int32_t cand = row[ls], wbits = row[p_l + ls], rev = row[2 * p_l + ls],
          pfx = row[3 * p_l + ls];
  if (__any_sync(n2v::kFullMask, on && is_heavy)) {
    const bool hv = on && is_heavy;
    const int nb_below = n2v::header_below(row, target, gl, maxb);
    const int blk = min(min(nb_below, max(row[2] - 1, 0)), maxb);
    const float base = blk > 0 ? __int_as_float(row[5 + maxb + blk - 1]) : 0.f;
    const float resid = __fsub_rn(target, base);
    const int64_t brow = static_cast<int64_t>(row[1]) + blk;
    const int32_t* ids_row = biw + (hv ? brow : 0) * 2 * c;
    const int32_t* w_row = ids_row + c;
    const int k4 = c / (4 * n2v::kGroup);
    const int nvalid = min(c, degree - blk * c);
    float excl, pc;
    int slot;
    if (kStaged) {
      __syncwarp();  // the group's reads of its light row are done: its buffer takes the block
      block_issue(row, w_row, gl, k4, hv);
      n2v::copies_wait();
      const StagedCols cols{reinterpret_cast<const int4*>(row), gl, k4};
      const int below = n2v::block_below(cols, k4, resid, gl, hv, &excl);
      slot = min(below, max(nvalid - 1, 0));
      pc = n2v::block_prefix_before(cols, k4, excl, slot, gl, hv);
    } else {
      const n2v::GlobalCols cols = n2v::global_cols(w_row, k4, gl);
      const int below = n2v::block_below(cols, k4, resid, gl, hv, &excl);
      slot = min(below, max(nvalid - 1, 0));
      pc = n2v::block_prefix_before(cols, k4, excl, slot, gl, hv);
    }
    if (hv) {
      ppfx = __fadd_rn(base, pc);
      cand = __ldg(ids_row + slot);
      wbits = kStaged ? staged_at(row, slot, k4) : __ldg(w_row + slot);
      const int2 pair = n2v::brp_pair(brp, brow * c + slot);
      rev = pair.x;
      pfx = pair.y;
    }
  }
  if (on && gl == 0) {
    out[0] = degree == 0 ? -1 : cand;
    out[1] = wbits;
    out[2] = rev;
    out[3] = pfx;
    out[4] = __float_as_int(ppfx);
    out[5] = take_back ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kReqWarps * 32)
ep_member_kernel(const int32_t* __restrict__ recv, int64_t n_req,
                 const int32_t* __restrict__ light, int64_t n_rows,
                 const int32_t* __restrict__ bids, int32_t* __restrict__ out, int64_t row_base,
                 int p_l, int c) {
  __shared__ __align__(16) int32_t rows[kReqs][n2v::kLightRow];
  const int gl = threadIdx.x & (n2v::kGroup - 1);  // lane within the request's group
  const int g = threadIdx.x / n2v::kGroup;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kReqs + g;
  const bool have = r < n_req;
  const int32_t prev = have ? recv[r * kMember] : -1;
  const bool on = prev >= 0;
  if (have && !on && gl == 0) out[r] = 0;
  if (!__any_sync(n2v::kFullMask, on)) return;
  const int32_t cand = on ? recv[r * kMember + 1] : 0;
  int64_t lv = static_cast<int64_t>(prev) - row_base;
  lv = lv < 0 ? 0 : (lv >= n_rows ? n_rows - 1 : lv);
  int32_t* row = rows[g];
  n2v::row_issue(row, light + lv * n2v::kLightRow, gl, on);
  n2v::copies_wait();
  const int32_t* mrow = n2v::member_row(row, bids, cand, gl, p_l, c, true);
  const bool shared = n2v::prev_member(row, mrow, c, cand, gl, p_l, on);
  if (on && gl == 0) out[r] = shared ? 1 : 0;
}

}  // namespace

// K20's grid at n lanes (fused: the fused launch's): out[0] blocks resident
// an SM, [1] SMs, [2] tiles a block, [3] blocks (all resident: a cooperative
// launch refuses more).
extern "C" int n2v_ep_bucket_geometry(int64_t n, int fused, int64_t* out) {
  const int64_t n_tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* kernel = fused ? reinterpret_cast<const void*>(ep_bucket_kernel<kPropose, true>)
                             : reinterpret_cast<const void*>(ep_bucket_kernel<kPropose, false>);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile, 0);
  out[0] = per_sm;
  out[1] = sms;
  const cudaError_t err = n2v::grid_geometry(kernel, kTile, n_tiles, out + 2, out + 3);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

namespace {

int launch_bucket(const void* kernel, BucketArgs a, void* stream) {
  a.n_tiles = (a.n + kTile - 1) / kTile;
  if (a.n_tiles < 1) a.n_tiles = 1;  // no lane: the send buffer is still filled
  int64_t grid = 0;
  cudaError_t err = n2v::grid_geometry(kernel, kTile, a.n_tiles, &a.per_block, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(kTile), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiles: [ceil(n / 1,024) or 1, n_shards] ints of workspace.  send and slot
// are written whole.
extern "C" int n2v_ep_bucket(const int32_t* carry, int64_t n, const int32_t* slot_a,
                             const int32_t* back, int32_t* send, int32_t* slot, int32_t* tiles,
                             int n_shards, int64_t capacity, int64_t rows_per_shard,
                             int walk_length, int64_t gid_base, uint32_t seed, int member,
                             void* stream) {
  if (n < 0 || n_shards < 1 || n_shards > kMaxShards || capacity < 1 || rows_per_shard < 1 ||
      n_shards * capacity > INT32_MAX || (member && (!slot_a || !back)))
    return static_cast<int>(cudaErrorInvalidValue);
  BucketArgs a{};
  a.carry = const_cast<int32_t*>(carry);  // only read
  a.n = n;
  a.slot_a = slot_a;
  a.back = back;
  a.send = send;
  a.slot = slot;
  a.blk = tiles;
  a.n_shards = n_shards;
  a.capacity = capacity;
  a.rows_per_shard = rows_per_shard;
  a.walk_length = walk_length;
  a.gid_base = gid_base;
  a.seed = seed;
  a.member = member;
  return launch_bucket(member ? reinterpret_cast<const void*>(ep_bucket_kernel<kMember, false>)
                              : reinterpret_cast<const void*>(ep_bucket_kernel<kPropose, false>),
                       a, stream);
}

// The fused launch: K23 advances the superstep that slot_a and back (mode 2:
// slot_b and resp_b) answer, in place on carry, paths and n_fb, and K20
// ranks the next superstep's proposals into send and slot; pending gets the
// lanes alive with t < L.  back: [n_shards * capacity, 6], resp_b:
// [n_shards * capacity]; tiles as n2v_ep_bucket's.
extern "C" int n2v_ep_advance_bucket(int32_t* carry, int64_t n, int32_t* paths, int32_t* n_fb,
                                     int32_t* pending, const int32_t* slot_a, const int32_t* back,
                                     const int32_t* slot_b, const int32_t* resp_b, int32_t* send,
                                     int32_t* slot, int32_t* tiles, int n_shards,
                                     int64_t capacity, int64_t rows_per_shard, int walk_length,
                                     int max_trials, int64_t gid_base, uint32_t seed, float inv_q,
                                     float alpha_hi, int mode, void* stream) {
  if (n < 0 || n_shards < 1 || n_shards > kMaxShards || capacity < 1 || rows_per_shard < 1 ||
      n_shards * capacity > INT32_MAX || mode < 0 || mode > 2 || max_trials < 1 || !slot_a ||
      !back || (mode == 2 && (!slot_b || !resp_b)))
    return static_cast<int>(cudaErrorInvalidValue);
  BucketArgs a{};
  a.carry = carry;
  a.n = n;
  a.slot_a = slot_a;
  a.back = back;
  a.send = send;
  a.slot = slot;
  a.blk = tiles;
  a.n_shards = n_shards;
  a.capacity = capacity;
  a.rows_per_shard = rows_per_shard;
  a.walk_length = walk_length;
  a.gid_base = gid_base;
  a.seed = seed;
  a.slot_b = slot_b;
  a.resp_b = resp_b;
  a.paths = paths;
  a.n_fb = n_fb;
  a.pending = pending;
  a.max_trials = max_trials;
  a.inv_q = inv_q;
  a.alpha_hi = alpha_hi;
  a.mode = mode;
  return launch_bucket(reinterpret_cast<const void*>(ep_bucket_kernel<kPropose, true>), a,
                       stream);
}

extern "C" int n2v_ep_propose(const int32_t* recv, int64_t n_req, const int32_t* light,
                              int64_t n_rows, const int32_t* biw, const int32_t* brp,
                              int32_t* resp, int64_t row_base, float inv_p, float inv_q,
                              float alpha_hi, int mode, int light_width, int block_width,
                              void* stream) {
  if (light_width < 1 || light_width > 32 || block_width < 64 || block_width % 64 ||
      block_width > 2048 || n_rows < 1 || mode < 0 || mode > 2 ||
      reinterpret_cast<uintptr_t>(light) % 16 || reinterpret_cast<uintptr_t>(biw) % 16 ||
      reinterpret_cast<uintptr_t>(brp) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_req == 0) return 0;
  const int64_t blocks = (n_req + kReqs - 1) / kReqs;
  const auto kernel = block_width <= kStageCols ? ep_propose_kernel<true>
                                                : ep_propose_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kReqWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      recv, n_req, light, n_rows, biw, brp, resp, row_base, inv_p, inv_q, alpha_hi, mode,
      light_width, block_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int n2v_ep_member(const int32_t* recv, int64_t n_req, const int32_t* light,
                             int64_t n_rows, const int32_t* bids, int32_t* out, int64_t row_base,
                             int light_width, int block_width, void* stream) {
  if (light_width < 1 || light_width > 32 || block_width < 64 || block_width % 64 ||
      block_width > 2048 || n_rows < 1 || reinterpret_cast<uintptr_t>(light) % 16 ||
      reinterpret_cast<uintptr_t>(bids) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_req == 0) return 0;
  const int64_t blocks = (n_req + kReqs - 1) / kReqs;
  ep_member_kernel<<<static_cast<unsigned>(blocks), kReqWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      recv, n_req, light, n_rows, bids, out, row_base, light_width, block_width);
  return static_cast<int>(cudaGetLastError());
}
