// The graph-sharded (edge-partitioned) blocked walk's superstep: K20
// ep_bucket, K21 ep_propose, K22 ep_member, K23 ep_advance.
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
//                   :554-610), and the pending count of the loop condition.
// Each computes what its plain version in
// parallel/edge_partitioned_blocked.py computes (ep_*_plain).
//
// The carried state is one int32 [10, n] tensor (rows T, CUR, PREV, W_FWD,
// FWD_PFX, W_BACK_ENC, BACK_PFX, ALIVE, TRIALS, ATT; floats as their bits).
//
// K20: two launches over tiles of 1,024 lanes, bucket_common.cuh's stable
// ranking (shared with K24).  The first counts each tile's active lanes per
// destination and fills the send buffer with -1; the second ranks each lane
// within its destination, stable in lane order, as JAX's one-hot cumsum
// gives; a lane ranked below the capacity writes its request.
// K21, K22: an 8-lane group a request, four a warp, as K5 groups its
// walkers: the requested row staged in shared memory and sampled by
// blocked_common.cuh's device functions, the ones K5 calls (a heavy block
// and a bids row read from global memory in the lane order K5 stages them
// in): the same float operations in the same order, so the proposals equal
// K5's bit for bit on the same tables and draws.  An empty
// slot (cur < 0) is skipped at once: the buffers hold the full capacity and
// late supersteps are mostly empty.  K23: one thread a walker; the fallback
// and pending counts are block counts (__syncthreads_count) added atomically.
//
// Bound on an H100: bytes, per superstep.  K20 reads the carried state (and
// phase B the responses by slot) and writes the requests and slots; K21
// reads a request, one 512-byte light row and, at a heavy vertex, its
// block's C weights, a 32-byte id sector and an 8-byte brp pair, and writes
// a response; K22 reads a request and a light row (a heavy prev also its
// bids row); K23 reads and writes the carried state and reads the responses.
// The owner kernels are latency-bound at these sizes (one dependent row load
// a request), as K5 is.

#include <cstdint>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "bucket_common.cuh"
#include "hashrng.cuh"

namespace {

enum Row { kT = 0, kCur, kPrev, kWFwd, kFwdPfx, kWBackEnc, kBackPfx, kAlive, kTrials, kAtt };
constexpr int kTile = n2v::kBucketTile;  // K20 lanes a block
constexpr int kReqWarps = 8;      // K21, K22 warps a block
constexpr int kReqs = kReqWarps * 32 / n2v::kGroup;  // K21, K22 requests a block
constexpr int kAdvThreads = 256;  // K23 walkers a block
constexpr int kPropose = 7, kMember = 2, kResp = 6;

__device__ __forceinline__ int32_t owner_of(int32_t v, int64_t rows_per_shard, int n_shards) {
  const int64_t o = static_cast<int64_t>(v < 0 ? 0 : v) / rows_per_shard;
  return static_cast<int32_t>(o < n_shards - 1 ? o : n_shards - 1);
}

__device__ __forceinline__ int64_t clamp_slot(int32_t s, int64_t n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// Is lane i active in this round, and to which owner does it send?
__device__ __forceinline__ bool bucket_lane(const int32_t* carry, int64_t n, int64_t i,
                                            const int32_t* slot_a, const int32_t* back,
                                            int64_t n_req, int64_t rows_per_shard,
                                            int n_shards, int walk_length, int member,
                                            int32_t* dest) {
  *dest = 0;
  if (i >= n) return false;
  const int32_t t = carry[kT * n + i];
  if (!member) {
    if (carry[kAlive * n + i] == 0 || t >= walk_length) return false;
    *dest = owner_of(carry[kCur * n + i], rows_per_shard, n_shards);
    return true;
  }
  const int32_t sa = slot_a[i];
  if (sa >= n_req) return false;
  const int32_t* g = back + clamp_slot(sa, n_req) * kResp;
  const bool take = g[5] > 0;
  if (g[0] < 0 && !take) return false;  // died
  if (take || t == 0) return false;
  *dest = owner_of(carry[kPrev * n + i], rows_per_shard, n_shards);
  return true;
}

__global__ void __launch_bounds__(kTile)
ep_bucket_count(const int32_t* __restrict__ carry, int64_t n, const int32_t* __restrict__ slot_a,
                const int32_t* __restrict__ back, int32_t* __restrict__ send,
                int32_t* __restrict__ tiles, int n_shards, int64_t capacity,
                int64_t rows_per_shard, int walk_length, int member) {
  extern __shared__ int32_t cnt[];  // [n_shards]
  const int64_t n_req = n_shards * capacity;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  n2v::bucket_tile_count(
      [&](int32_t* dest) {
        return bucket_lane(carry, n, i, slot_a, back, n_req, rows_per_shard, n_shards,
                           walk_length, member, dest);
      },
      n_shards, cnt, tiles);
  const int64_t total = n_req * (member ? kMember : kPropose);
  for (int64_t j = i; j < total; j += static_cast<int64_t>(gridDim.x) * kTile) send[j] = -1;
}

__global__ void __launch_bounds__(kTile)
ep_bucket_scatter(const int32_t* __restrict__ carry, int64_t n,
                  const int32_t* __restrict__ slot_a, const int32_t* __restrict__ back,
                  int32_t* __restrict__ send, int32_t* __restrict__ slot,
                  const int32_t* __restrict__ tiles, int n_shards, int64_t capacity,
                  int64_t rows_per_shard, int walk_length, int64_t gid_base, uint32_t seed,
                  int member) {
  extern __shared__ int32_t sm[];  // n2v::bucket_rank_smem(n_shards) bytes
  const int64_t n_req = n_shards * capacity;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int64_t flat = n2v::bucket_tile_rank(
      [&](int32_t* dest) {
        return bucket_lane(carry, n, i, slot_a, back, n_req, rows_per_shard, n_shards,
                           walk_length, member, dest);
      },
      n_shards, capacity, tiles, sm);
  if (i >= n) return;
  slot[i] = static_cast<int32_t>(flat);
  if (flat == n_req) return;
  if (!member) {
    const uint32_t gid = static_cast<uint32_t>(gid_base + i);
    const uint32_t ctr = static_cast<uint32_t>(carry[kAtt * n + i]) * 4u;
    int32_t* out = send + flat * kPropose;
    out[0] = carry[kCur * n + i];
    out[1] = carry[kPrev * n + i];
    out[2] = carry[kWBackEnc * n + i];
    out[3] = carry[kBackPfx * n + i];
    out[4] = __float_as_int(n2v::hash_uniform(seed, gid, ctr));
    out[5] = __float_as_int(n2v::hash_uniform(seed, gid, ctr + 1u));
    out[6] = carry[kT * n + i];
  } else {
    int32_t* out = send + flat * kMember;
    out[0] = carry[kPrev * n + i];
    out[1] = back[clamp_slot(slot_a[i], n_req) * kResp];
  }
}

// mode: 0 = p = q = 1 (target u_prop * wtot, no return branch), else the
// return branch m1 / (m1 + m2) and the prev-excluded target.  An 8-lane
// group a request, four a warp; every group runs every phase (blocked_common.cuh),
// a group without a request masked by `on`.
__global__ void __launch_bounds__(kReqWarps * 32)
ep_propose_kernel(const int32_t* __restrict__ recv, int64_t n_req,
                  const int32_t* __restrict__ light, int64_t n_rows,
                  const int32_t* __restrict__ biw, const int32_t* __restrict__ brp,
                  int32_t* __restrict__ resp, int64_t row_base, float inv_p, float inv_q,
                  float alpha_hi, int mode, int p_l, int c) {
  __shared__ __align__(16) int32_t rows[kReqs][n2v::kLightRow];
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
    const n2v::GlobalCols cols = n2v::global_cols(w_row, k4, gl);
    float excl;
    const int below = n2v::block_below(cols, k4, resid, gl, hv, &excl);
    const int nvalid = min(c, degree - blk * c);
    const int slot = min(below, max(nvalid - 1, 0));
    const float pc = n2v::block_prefix_before(cols, k4, excl, slot, gl, hv);
    if (hv) {
      ppfx = __fadd_rn(base, pc);
      cand = __ldg(ids_row + slot);
      wbits = __ldg(w_row + slot);
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

// mode: 0 = p = q = 1, 1 = q == 1, 2 = q != 1 (slot_b, resp_b given).
__global__ void __launch_bounds__(kAdvThreads)
ep_advance_kernel(int32_t* __restrict__ carry, int64_t n, int32_t* __restrict__ paths,
                  int32_t* __restrict__ n_fb, int32_t* __restrict__ pending,
                  const int32_t* __restrict__ slot_a, const int32_t* __restrict__ back,
                  int64_t n_req, const int32_t* __restrict__ slot_b,
                  const int32_t* __restrict__ resp_b, int64_t n_req_b, int walk_length,
                  int max_trials, int64_t gid_base, uint32_t seed, float inv_q, float alpha_hi,
                  int mode) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kAdvThreads + threadIdx.x;
  bool fb = false, still = false;
  if (i < n) {
    int32_t t = carry[kT * n + i], cur = carry[kCur * n + i], prev = carry[kPrev * n + i];
    float w_fwd = __int_as_float(carry[kWFwd * n + i]);
    float fwd_pfx = __int_as_float(carry[kFwdPfx * n + i]);
    int32_t w_back_enc = carry[kWBackEnc * n + i];
    float back_pfx = __int_as_float(carry[kBackPfx * n + i]);
    bool alive = carry[kAlive * n + i] != 0;
    int32_t trials = carry[kTrials * n + i];
    uint32_t att = static_cast<uint32_t>(carry[kAtt * n + i]);
    const float w_back = __int_as_float(w_back_enc & 0x7FFFFFFF);
    const bool back_shared = w_back_enc < 0;
    const bool first = t == 0;

    const int32_t sa = slot_a[i];
    const bool send_a = sa < n_req;
    const int32_t* g = back + clamp_slot(sa, n_req) * kResp;
    const int32_t a_cand = g[0];
    const bool a_take = g[5] > 0;
    const bool died = send_a && a_cand < 0 && !a_take;
    bool attempted = send_a;
    bool shared = false;
    if (mode == 2) {
      const bool need_b = send_a && !died && !a_take && !first;
      const int32_t sb = slot_b[i];
      shared = resp_b[clamp_slot(sb, n_req_b)] > 0;
      attempted = send_a && (sb < n_req_b || !need_b);
    }
    bool accept;
    if (mode == 0) {
      accept = attempted;
    } else if (mode == 1) {
      accept = attempted && (a_take || first || a_cand != prev);
    } else {
      const float u_acc = n2v::hash_uniform(seed, static_cast<uint32_t>(gid_base + i),
                                            att * 4u + 2u);
      const float alpha2 = back_shared ? alpha_hi : inv_q;
      const float bias2 = shared ? 1.f : inv_q;
      accept = attempted && (a_take || first || (a_cand != prev && __fmul_rn(u_acc, alpha2) <= bias2));
    }
    alive = alive && !died;
    if (attempted) trials = accept ? 0 : trials + 1;
    const bool force = attempted && alive && trials >= max_trials;
    fb = force && !accept;
    if ((accept || force) && alive) {
      const bool take = a_take && !force;
      const int32_t nxt = take ? prev : a_cand;
      paths[i * (walk_length + 1) + t + 1] = nxt;
      const float nw_fwd = take ? w_back : __int_as_float(g[1]);
      const float nf_pfx = take ? back_pfx : __int_as_float(g[4]);
      const int32_t nw_back_enc =
          take ? (__float_as_int(w_fwd) | (back_shared ? static_cast<int32_t>(0x80000000u) : 0))
               : g[2];
      const float nb_pfx = take ? fwd_pfx : __int_as_float(g[3]);
      w_fwd = nw_fwd;
      fwd_pfx = nf_pfx;
      w_back_enc = nw_back_enc;
      back_pfx = nb_pfx;
      prev = cur;
      cur = nxt;
      ++t;
      trials = 0;
    }
    if (attempted && alive) ++att;
    carry[kT * n + i] = t;
    carry[kCur * n + i] = cur;
    carry[kPrev * n + i] = prev;
    carry[kWFwd * n + i] = __float_as_int(w_fwd);
    carry[kFwdPfx * n + i] = __float_as_int(fwd_pfx);
    carry[kWBackEnc * n + i] = w_back_enc;
    carry[kBackPfx * n + i] = __float_as_int(back_pfx);
    carry[kAlive * n + i] = alive ? 1 : 0;
    carry[kTrials * n + i] = trials;
    carry[kAtt * n + i] = static_cast<int32_t>(att);
    still = alive && t < walk_length;
  }
  const int n_fb_block = __syncthreads_count(fb);
  const int n_still = __syncthreads_count(still);
  if (threadIdx.x == 0) {
    if (n_fb_block) atomicAdd(n_fb, n_fb_block);
    if (n_still) atomicAdd(pending, n_still);
  }
}

}  // namespace

extern "C" int n2v_ep_bucket(const int32_t* carry, int64_t n, const int32_t* slot_a,
                             const int32_t* back, int32_t* send, int32_t* slot, int32_t* tiles,
                             int n_shards, int64_t capacity, int64_t rows_per_shard,
                             int walk_length, int64_t gid_base, uint32_t seed, int member,
                             void* stream) {
  if (n_shards < 1 || n_shards > 256 || capacity < 1 || rows_per_shard < 1 ||
      n_shards * capacity > INT32_MAX || (member && (!slot_a || !back)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  auto s = static_cast<cudaStream_t>(stream);
  ep_bucket_count<<<static_cast<unsigned>(n_tiles), kTile, n2v::bucket_count_smem(n_shards),
                    s>>>(
      carry, n, slot_a, back, send, tiles, n_shards, capacity, rows_per_shard, walk_length,
      member);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ep_bucket_scatter<<<static_cast<unsigned>(n_tiles), kTile, n2v::bucket_rank_smem(n_shards),
                      s>>>(
      carry, n, slot_a, back, send, slot, tiles, n_shards, capacity, rows_per_shard,
      walk_length, gid_base, seed, member);
  return static_cast<int>(cudaGetLastError());
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
  ep_propose_kernel<<<static_cast<unsigned>(blocks), kReqWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
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

extern "C" int n2v_ep_advance(int32_t* carry, int64_t n, int32_t* paths, int32_t* n_fb,
                              int32_t* pending, const int32_t* slot_a, const int32_t* back,
                              int64_t n_req, const int32_t* slot_b, const int32_t* resp_b,
                              int64_t n_req_b, int walk_length, int max_trials, int64_t gid_base,
                              uint32_t seed, float inv_q, float alpha_hi, int mode,
                              void* stream) {
  if (mode < 0 || mode > 2 || max_trials < 1 || n_req < 1 ||
      (mode == 2 && (!slot_b || !resp_b || n_req_b < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t blocks = (n + kAdvThreads - 1) / kAdvThreads;
  ep_advance_kernel<<<static_cast<unsigned>(blocks), kAdvThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      carry, n, paths, n_fb, pending, slot_a, back, n_req, slot_b, resp_b, n_req_b, walk_length,
      max_trials, gid_base, seed, inv_q, alpha_hi, mode);
  return static_cast<int>(cudaGetLastError());
}
