// K5 blocked_walk: asynchronous rejection walks over the two-table blocked
// CSR of heavy-tailed graphs, the whole walk inside one launch.
//
// Replaces node2vec_tpu/walk/blocked.py:732 blocked_walk_chunk_impl (loop
// body :791-1093), its shared-list branch (:772-1077) included, together
// with ops/hashrng.py and ops/sampling.py:60 prefix_sums.  It computes what
// the plain version walk/blocked.py:blocked_walk_chunk_plain computes,
// walker by walker.
//
// Design: one warp per walker, the walker's state in registers (every lane
// holds the same copy, so every branch is warp-uniform).  The current
// vertex's 128-lane light row is one int4 per lane, a coalesced 512-byte
// load made only when the walker enters a vertex; it sits in a per-warp
// shared-memory buffer, and an accepted step swaps that buffer with the
// previous row's (the membership test reads N(prev) from there, as the JAX
// loop carries prev_mem).  Light proposals: an inclusive warp scan of the P
// weights (one column per lane, computed once per entry), then count(cdf <
// target) by ballot.  Heavy proposals: the header CDF (MAXB <= 61 entries,
// two per lane) picks the block by ballot; the block's C weights are read
// C/32 contiguous columns per lane, summed per lane and warp-scanned, then
// counted against the residual.  The chosen edge's (rev±, pfx) pair is one
// 8-byte load from brp.  A heavy prev's membership picks its block from the
// header's block minima and compares the bids row, coalesced, by ballot.
// There is no compaction cascade: each warp loops its walker until it
// finishes, dies or reaches it_bound = walk_length * (max_trials + 2)
// iterations, and warps retire independently (the TPU cascade exists only
// because its lanes advance in lockstep).
//
// Shared lists (modes 3 and 4): at each entry the warp reads the arrival
// edge's 64-byte slq entry, one int a lane on lanes 0-15, and shuffles it so
// that lane k < 8 holds the k-th stored (slot, weight); their sum and the
// 8-weight inclusive scan are warp shuffles.  The 3-atom branch draws
// back | shared | proportional-to-w from u_branch (the shared atom's slot by
// ballot over the scan against u_prop * w_sh), forces the proposal's slot
// (and a heavy vertex's block, before its weights are read) to the shared
// pick, and accepts a proportional-to-w proposal unless it lands on a
// stored slot.  Mode 3 (some edges overflowed) keeps the N(prev) probe for
// lanes without a complete list; mode 4 (none did) drops the probe and the
// prev-row swap.  The walker carries its arrival edge's global id: the
// row's ebase lane (lane 4P: in the shared buffer for P <= 31, one scalar
// load of a 256-lane row for P = 32) plus the accepted slot, or the stored
// reverse-edge id after a return hop.  Draws stay keyed on att * 4, so a
// lane that consumes no u_acc keeps every later draw where it was.
//
// Rounding: every float op is a _rn intrinsic so nvcc cannot contract it
// into an FMA, and the operands are those of the plain version; where every
// partial sum is exact (dyadic weights, p and q powers of two) the paths and
// counters are bit-equal to it.  Prefix sums are taken in another order
// than torch.cumsum, so general weights agree in distribution (chi-square).
//
// A block's valid column count is min(C, degree - blk*C): the packer fills
// a heavy vertex's blocks in order, so it equals the count of non-PAD ids
// that the plain version takes from the row, without reading the ids.
//
// Bound on an H100: bytes.  Per live walker-step one 512-byte light row (and
// with shared lists one 64-byte slq entry); per
// attempt at a heavy vertex the block's C*4 weight bytes plus a 32-byte
// sector each for the chosen id, its brp pair and the membership probe;
// the paths written.  The kernel also reads the whole bids row (C*4 bytes)
// for a heavy prev's membership test and re-reads the weights from L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashrng.cuh"

namespace {

constexpr int32_t kPadId = 0x7FFFFFFF;
constexpr int kWarps = 8;   // walkers per block
constexpr int kRow = 128;   // light-row lanes (P <= 32)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float warp_incl_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = __fadd_rn(v, u);
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

constexpr int kSlK = 8;         // shared-list entries an edge
constexpr int kSlLanes = 16;    // int32 lanes of an edge's slq entry
constexpr int kSlPadSlot = 0xFFFF;

// mode: 0 = p = q = 1 (every proposal accepted), 1 = q == 1 (only the
// return edge is biased), 2 = q != 1 (membership against N(prev)), 3 = q != 1
// with shared lists, some overflowed (N(prev) for lanes without a list), 4 =
// q != 1 with shared lists, none overflowed (no N(prev)).  kSl is mode >= 3:
// the instantiation without shared lists carries none of their state.
template <bool kSl>
__global__ void __launch_bounds__(kWarps * 32)
blocked_walk_kernel(const int32_t* __restrict__ light, int row_width,
                    const int32_t* __restrict__ biw,
                    const int32_t* __restrict__ bids, const int32_t* __restrict__ brp,
                    const int32_t* __restrict__ slq,  // read in modes 3 and 4 only
                    const int32_t* __restrict__ starts, int32_t* __restrict__ paths,
                    unsigned long long* __restrict__ counters, int64_t n_walkers,
                    int walk_length, int64_t gid_base, uint32_t seed, float inv_p,
                    float inv_q, float alpha_shared, int max_trials, int p_l, int c,
                    int has_heavy, int mode) {
  __shared__ __align__(16) int32_t rows[kWarps][2][kRow];
  __shared__ unsigned long long block_fb[kWarps], block_att[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  unsigned long long n_fb = 0, n_att = 0;

  if (w < n_walkers) {  // warp-uniform; every warp reaches the block sync below
    int32_t* cur_row = rows[warp][0];
    int32_t* prev_row = rows[warp][1];
    for (int i = lane; i < kRow; i += 32) prev_row[i] = kPadId;
    const int maxb = (4 * p_l - 5) / 2;
    const int k = c / 32;  // block columns per lane
    const int col0 = lane * k;
    int32_t* out = paths + w * (walk_length + 1);
    const uint32_t gid = static_cast<uint32_t>(gid_base + w);
    const bool need_prev = mode == 2 || mode == 3;

    const int32_t start = starts[w];
    bool alive = start >= 0;
    if (lane == 0) out[0] = alive ? start : -1;
    int32_t cur = alive ? start : 0;
    int32_t prev = -1;
    float w_fwd = 0.f, fwd_pfx = 0.f, w_back = 0.f, back_pfx = 0.f;
    bool back_shared = false;
    int t = 0, trials = 0;
    uint32_t att = 0;
    bool need_entry = true;
    // the current row, decoded at entry
    bool is_heavy = false;
    int32_t h_bs = 0, h_nb = 0, degree = 0;
    float wtot = 0.f;
    int32_t my_id = kPadId;              // light column `lane`
    float my_w = 0.f, my_cdf = 0.f;
    float cum0 = 0.f, cum1 = 0.f;        // header CDF entries lane, lane + 32
    // shared lists: the arrival edge's list (lane k < 8 holds entry k; the
    // plain version's carried sl_row starts as zeros), decoded at entry
    int64_t aedge = -1;
    int32_t ebase_cur = 0, sl_rev = 0, sl_flags = 0;
    int sl_slot = 0, n_sh = 0;
    float sl_w = 0.f, sl_cdf = 0.f, w_sh = 0.f;
    bool sl_valid = false;

    const uint32_t it_bound =
        static_cast<uint32_t>(walk_length) * static_cast<uint32_t>(max_trials + 2);
    for (uint32_t it = 0; it < it_bound && alive; ++it) {
      // --- entry: (re)gather the frontier vertex's row -----------------------
      if (need_entry) {
        need_entry = false;
        __syncwarp();  // every lane is done with the buffer overwritten here
        const int32_t* row_g = light + static_cast<int64_t>(cur) * row_width;
        reinterpret_cast<int4*>(cur_row)[lane] = __ldg(reinterpret_cast<const int4*>(row_g) + lane);
        __syncwarp();
        if (kSl) {
          ebase_cur = 4 * p_l < kRow ? cur_row[4 * p_l] : __ldg(row_g + 4 * p_l);
          if (aedge >= 0) {  // one slq entry per accepted step: the arrival edge's
            const int32_t v = lane < kSlLanes ? __ldg(slq + aedge * kSlLanes + lane) : 0;
            const int e = lane & (kSlK - 1);  // the entry this lane holds
            const int32_t packed = __shfl_sync(kFull, v, e >> 1);
            sl_slot = (e & 1) ? (packed >> 16) & 0xFFFF : packed & 0xFFFF;
            sl_w = __int_as_float(__shfl_sync(kFull, v, kSlK / 2 + e));
            sl_rev = __shfl_sync(kFull, v, 12);
            sl_flags = __shfl_sync(kFull, v, 13);
          }
          const float wk = lane < kSlK ? sl_w : 0.f;
          w_sh = warp_sum(wk);
          sl_cdf = warp_incl_scan(wk, lane);
          n_sh = __popc(__ballot_sync(kFull, lane < kSlK && sl_slot != kSlPadSlot));
          sl_valid = aedge >= 0 && (sl_flags & 1) == 0;
        }
        is_heavy = has_heavy && cur_row[0] < -1;
        if (is_heavy) {
          h_bs = cur_row[1];
          h_nb = cur_row[2];
          wtot = __int_as_float(cur_row[3]);
          degree = cur_row[4];
          cum0 = lane < maxb ? __int_as_float(cur_row[5 + maxb + lane]) : 0.f;
          cum1 = lane + 32 < maxb ? __int_as_float(cur_row[5 + maxb + lane + 32]) : 0.f;
        } else {
          my_id = lane < p_l ? cur_row[lane] : kPadId;
          my_w = lane < p_l ? __int_as_float(cur_row[p_l + lane]) : 0.f;
          const bool real = lane < p_l && my_id != kPadId && (!has_heavy || my_id >= 0);
          degree = __popc(__ballot_sync(kFull, real));
          wtot = warp_sum(my_w);
          my_cdf = warp_incl_scan(my_w, lane);
        }
        if (degree == 0) {  // sink death, before the draw
          alive = false;
          break;
        }
      }

      const uint32_t ctr = att * 4u;
      const float u_branch = n2v::hash_uniform(seed, gid, ctr);
      const float u_prop = n2v::hash_uniform(seed, gid, ctr + 1u);
      const float u_acc = n2v::hash_uniform(seed, gid, ctr + 2u);

      // --- mixture: back-edge atom vs prev-excluded proportional-to-w -------
      bool take_back = false, take_sh = false;
      float alpha2 = inv_q;
      float target;
      int sh_slot = 0;
      if (mode == 0) {
        target = __fmul_rn(u_prop, wtot);
      } else {
        alpha2 = back_shared ? alpha_shared : inv_q;
        const float m1 = __fmul_rn(w_back, inv_p);
        const float rest = fmaxf(__fsub_rn(wtot, w_back), 0.f);
        if (kSl) {
          // the exact 3-atom mixture on lanes with a complete list
          if (sl_valid) alpha2 = inv_q;
          const float m1sh = __fadd_rn(m1, sl_valid ? w_sh : 0.f);
          const float m2 = __fmul_rn(rest, alpha2);
          const float ub = __fmul_rn(u_branch, __fadd_rn(m1sh, m2));
          take_back = ub < m1;
          take_sh = sl_valid && !take_back && ub < m1sh;
          const float u_sh = __fmul_rn(u_prop, w_sh);
          const int k_below = __popc(__ballot_sync(kFull, lane < kSlK && sl_cdf < u_sh));
          sh_slot = __shfl_sync(kFull, sl_slot, min(k_below, max(n_sh - 1, 0)));
        } else {
          const float m2 = __fmul_rn(rest, alpha2);
          take_back = u_branch < __fdiv_rn(m1, fmaxf(__fadd_rn(m1, m2), 1e-30f));
        }
        const float u2 = __fmul_rn(u_prop, rest);
        target = u2 < back_pfx ? u2 : __fadd_rn(u2, w_back);
      }

      // --- proposal: two-level exact inverse CDF ----------------------------
      int32_t cand, rev_enc = 0;
      float w_cand, ppfx, pfx_c = 0.f;
      int row_slot;  // the proposal's slot within N(cur)
      if (!is_heavy) {
        const int below = __popc(__ballot_sync(kFull, lane < p_l && my_cdf < target));
        const int slot = take_sh ? sh_slot : min(below, max(degree - 1, 0));
        row_slot = slot;
        cand = __shfl_sync(kFull, my_id, slot);
        w_cand = __shfl_sync(kFull, my_w, slot);
        const float pc = __shfl_sync(kFull, my_cdf, max(slot - 1, 0));
        ppfx = slot > 0 ? pc : 0.f;
        if (mode != 0) {
          rev_enc = cur_row[2 * p_l + slot];
          pfx_c = __int_as_float(cur_row[3 * p_l + slot]);
        }
      } else {
        const int nb_below = __popc(__ballot_sync(kFull, lane < maxb && cum0 < target)) +
                             __popc(__ballot_sync(kFull, lane + 32 < maxb && cum1 < target));
        // a shared pick forces its block before the block's weights are read
        const int blk = take_sh ? sh_slot / c : min(nb_below, max(h_nb - 1, 0));
        const float base = blk > 0 ? __int_as_float(cur_row[5 + maxb + blk - 1]) : 0.f;
        const float resid = __fsub_rn(target, base);
        const int64_t brow = static_cast<int64_t>(h_bs) + blk;
        const int32_t* ids_row = biw + brow * 2 * c;
        const int32_t* w_row = ids_row + c;
        float lsum = 0.f;
        for (int m = 0; m < k; ++m) lsum = __fadd_rn(lsum, __int_as_float(__ldg(w_row + col0 + m)));
        float excl = __shfl_up_sync(kFull, warp_incl_scan(lsum, lane), 1);
        if (lane == 0) excl = 0.f;
        float run = excl;
        int below = 0;
        for (int m = 0; m < k; ++m) {
          run = __fadd_rn(run, __int_as_float(__ldg(w_row + col0 + m)));
          below += run < resid;
        }
        below = __reduce_add_sync(kFull, below);
        const int nvalid = min(c, degree - blk * c);
        const int slot = take_sh ? sh_slot % c : min(below, max(nvalid - 1, 0));
        row_slot = blk * c + slot;
        float pc = 0.f;
        if (slot > 0) {  // cdf[slot - 1], recomputed by the lane that owns it
          const int j = slot - 1;
          const int owner = j / k;
          if (lane == owner) {
            pc = excl;
            for (int m = col0; m <= j; ++m) pc = __fadd_rn(pc, __int_as_float(__ldg(w_row + m)));
          }
          pc = __shfl_sync(kFull, pc, owner);
        }
        ppfx = __fadd_rn(base, pc);
        cand = __ldg(ids_row + slot);
        w_cand = __int_as_float(__ldg(w_row + slot));
        if (mode != 0) {  // brp's flat index of slot gslot's (rev, pfx) is 2*gslot
          const int2 pair = __ldg(reinterpret_cast<const int2*>(brp) + (brow * c + slot));
          rev_enc = pair.x;
          pfx_c = __int_as_float(pair.y);
        }
      }

      // --- acceptance -------------------------------------------------------
      const bool first_order = t == 0;
      bool accept;
      if (mode == 0) {
        accept = true;
      } else if (mode == 1) {
        accept = take_back || first_order || cand != prev;
      } else if (kSl && (mode == 4 || (mode == 3 && sl_valid))) {
        // a list lane: the only rejection is a proportional-to-w proposal on
        // a stored shared slot (it belongs to the shared atom)
        const bool hit =
            __any_sync(kFull, lane < kSlK && sl_slot != kSlPadSlot && sl_slot == row_slot);
        accept = (mode == 4 && first_order) || take_back || take_sh || (cand != prev && !hit);
      } else {
        bool shared;
        if (has_heavy && prev_row[0] < -1) {
          const int32_t p_bs = prev_row[1];
          const int32_t p_nb = prev_row[2];
          int jm = __popc(__ballot_sync(kFull, lane < maxb && prev_row[5 + lane] <= cand)) +
                   __popc(__ballot_sync(kFull, lane + 32 < maxb && prev_row[5 + lane + 32] <= cand)) - 1;
          jm = min(max(jm, 0), max(p_nb - 1, 0));
          const int32_t* mrow = bids + (static_cast<int64_t>(p_bs) + jm) * c;
          bool hit = false;
          for (int i = lane; i < c; i += 32) hit |= __ldg(mrow + i) == cand;
          shared = __any_sync(kFull, hit);
        } else {
          shared = __any_sync(kFull, lane < p_l && prev_row[lane] == cand);
        }
        const float bias2 = shared ? 1.f : inv_q;
        accept = take_back || first_order || (cand != prev && __fmul_rn(u_acc, alpha2) <= bias2);
      }

      // --- trial cap: bounded-bias proportional-to-w fallback, counted ------
      trials = accept ? 0 : trials + 1;
      const bool force = trials >= max_trials;
      n_fb += force && !accept;
      ++att;  // counts the final accepted draw of a finishing walker too
      if (accept || force) {
        const bool take = take_back && !force;
        const int32_t nxt = take ? prev : cand;
        if (lane == 0) out[t + 1] = nxt;
        if (mode != 0) {
          // arrival-edge metadata; a return hop swaps the carried fields
          const float nw_back = take ? w_fwd : __int_as_float(rev_enc & 0x7FFFFFFF);
          const float nb_pfx = take ? fwd_pfx : pfx_c;
          const bool nb_shared = take ? back_shared : rev_enc < 0;
          w_fwd = take ? w_back : w_cand;
          fwd_pfx = take ? back_pfx : ppfx;
          w_back = nw_back;
          back_pfx = nb_pfx;
          back_shared = nb_shared;
        }
        if (kSl) aedge = take ? sl_rev : static_cast<int64_t>(ebase_cur) + row_slot;
        if (need_prev) {  // the frontier row becomes next step's N(prev)
          int32_t* tmp = prev_row;
          prev_row = cur_row;
          cur_row = tmp;
        }
        prev = cur;
        cur = nxt;
        ++t;
        trials = 0;
        need_entry = true;
        alive = t < walk_length;
      }
    }
    for (int s = t + 1 + lane; s <= walk_length; s += 32) out[s] = -1;
    n_att = att;
  }
  if (lane == 0) {
    block_fb[warp] = n_fb;
    block_att[warp] = n_att;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long fb = 0, at = 0;
    for (int i = 0; i < kWarps; ++i) {
      fb += block_fb[i];
      at += block_att[i];
    }
    if (fb) atomicAdd(counters, fb);
    if (at) atomicAdd(counters + 1, at);
  }
}

}  // namespace

extern "C" int n2v_blocked_walk(const int32_t* light, int row_width, const int32_t* biw,
                                const int32_t* bids, const int32_t* brp, const int32_t* slq,
                                const int32_t* starts, int32_t* paths,
                                int64_t* counters, int64_t n_walkers, int walk_length,
                                int64_t gid_base, uint32_t seed, float inv_p, float inv_q,
                                float alpha_shared, int max_trials, int light_width,
                                int block_width, int has_heavy, int mode, void* stream) {
  if (light_width < 1 || light_width > 32 || block_width < 64 || block_width % 64 ||
      block_width > 2048 || max_trials < 1 || mode < 0 || mode > 4 ||
      (row_width != 128 && row_width != 256) || (mode >= 3 && row_width < 4 * light_width + 1) ||
      reinterpret_cast<uintptr_t>(light) % 16 || reinterpret_cast<uintptr_t>(brp) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_walkers == 0) return 0;
  const int64_t blocks = (n_walkers + kWarps - 1) / kWarps;
  auto kernel = mode >= 3 ? blocked_walk_kernel<true> : blocked_walk_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      light, row_width, biw, bids, brp, slq, starts, paths,
      reinterpret_cast<unsigned long long*>(counters),
      n_walkers, walk_length, gid_base, seed, inv_p, inv_q, alpha_shared, max_trials,
      light_width, block_width, has_heavy, mode);
  return static_cast<int>(cudaGetLastError());
}
