// K5 blocked_walk: asynchronous rejection walks over the two-table blocked
// CSR of heavy-tailed graphs, the whole walk inside one launch.
//
// Replaces node2vec_tpu/walk/blocked.py:732 blocked_walk_chunk_impl (loop
// body :791-1093), its shared-list branch (:772-1077) included, together
// with ops/hashrng.py and ops/sampling.py:60 prefix_sums.  It computes what
// the plain version walk/blocked.py:blocked_walk_chunk_plain computes,
// walker by walker.
//
// What bounds it: dependent loads, many at once.  An attempt is a chain of
// them: the frontier's 512-byte light row (or heavy header); at a heavy
// vertex the block's C weights, then the chosen column's id and (rev, pfx)
// pair; at a heavy prev, N(prev)'s block of ids for the membership test;
// then the next row.  The tables (551 MB on the RMAT main path) are far past
// L2, and the walk carries nothing that would let a walker's next link start
// before its last one lands.  The earlier design (a warp a walker, 32
// resident an SM) read a block's weights in two passes of C/32 columns a
// lane and its bids row likewise: its clock64() phases
// (experiments/k5_attribution.py) put 36% of a warp's time in the block
// scan, 27% in the membership probe, 12% in the id and brp loads, and under
// 0.2% in a block's tail.
//
// The design does four things about it.
// * Several chains in flight a warp.  A walker is an 8-lane group and a warp
//   holds four, each with its state in its lanes' registers (the same copy
//   in the 8 lanes).  The warp runs each phase of an attempt for its four
//   walkers at once, branch-free across groups: a group that has no part in
//   a phase masks its loads (blocked_common.cuh: `on`), so the four walkers'
//   loads issue together and wait together.  A phase no group needs is
//   skipped by a warp-uniform test.  8 warps a block: 32 walkers, 96 an SM.
// * A heavy block read whole once a launch, then one lane's eighth of it.  A
//   heavy attempt needs count(CDF < residual) over its block and the CDF
//   before the slot (blocked_common.cuh's form: lane r's partial sums L_r
//   of columns [r C/8, (r+1) C/8), plus ex_r, the group's exclusive scan of
//   the lanes' totals).  The first group to draw from a block reads it
//   whole (C*4 bytes) and writes its eight (ex_r, ex_r + L_r(last)) to a
//   table of 64 bytes a block (NaN until then, through L2).  Every later
//   attempt reads those 64 bytes: a lane whose last column lies below the
//   residual counts its columns, one whose first cannot counts none, and
//   the lane between them (one, but for ties) is copied with its ids into
//   the group's lane buffer by cp.async, C/2 bytes in one trip, and
//   counted there; the chosen id and weight come from that buffer.  The
//   hub blocks of a heavy-tailed graph are drawn from again and again, so
//   most attempts move 64 + C/2 bytes instead of C*4, in one trip fewer;
//   the count is the one block_below makes over every column, bit for bit.
//   Whole reads are counted (counters[3]).
// * A fraction of N(prev)'s bids row.  The row is sorted, so the membership
//   test reads the first id of each eighth of it, then the one eighth that
//   can hold the candidate (blocked_common.cuh: prev_member): 8 sectors and
//   C/2 bytes in two trips where the earlier design read C*4 bytes.  It is
//   asked only where acceptance depends on it (not a return, not the first
//   step, not the previous vertex), and the brp pair loads meanwhile.
// * No block tail.  The grid is persistent (the blocks that fit on the
//   card at once); a group whose walker ends takes the next walker id from
//   an atomic counter (counters[2]).  Draws are keyed on (seed, gid_base +
//   w, att * 4), so the paths do not depend on which group walks a walker.
// Where modes 2 and 3 keep N(prev)'s row, an accepted step swaps the two
// row buffers, so a return hop (or any step back onto prev) finds its next
// row already in shared memory.  What remains is bound by those trips under
// load (a warp's iteration ~11k cycles at (0.25, 4), ~4 GB moved a launch,
// PERF.md section 6).
//
// Shared lists (modes 3 and 4): at each entry the group reads the arrival
// edge's 64-byte slq entry, 8 bytes a lane, and shuffles it so that lane r
// holds the r-th stored (slot, weight); their sum and 8-weight inclusive
// scan are group shuffles.  The 3-atom branch draws back | shared |
// proportional-to-w from u_branch (the shared atom's slot by ballot over the
// scan against u_prop * w_sh), forces the proposal's slot (and a heavy
// vertex's block, before its weights are read) to the shared pick, and
// accepts a proportional-to-w proposal unless it lands on a stored slot.
// Mode 3 (some edges overflowed) keeps the N(prev) probe for walkers
// without a complete list; mode 4 (none did) drops the probe and the prev
// row.  The walker carries its arrival edge's global id: the row's ebase
// lane (lane 4P: in the shared buffer for P <= 31, one scalar load of a
// 256-lane row for P = 32) plus the accepted slot, or the stored
// reverse-edge id after a return hop.  Draws stay keyed on att * 4, so a
// walker that consumes no u_acc keeps every later draw where it was.
//
// The light-row scan, the header's block pick, the block scan, the brp pair
// load and the N(prev) membership test are blocked_common.cuh's device
// functions, which the graph-sharded walk's owner kernels (ep_walk.cu) call
// too, at the same lane grouping.
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
// Bound on an H100: bytes.  Each table byte the run needs read once (the
// distinct light rows, blocks, id and brp sectors and bids rows,
// chip_smoke.py: blocked_bytes) and the paths written.  What a run moves
// is more: per live walker-step one 512-byte light row (and with shared
// lists one 64-byte slq entry); per attempt at a heavy vertex 64 bytes of
// lane sums, C/2 bytes of one lane's columns and their ids (C*4 more on a
// whole read) and the sector of the chosen column's brp pair; per
// membership probe of a heavy prev 8 sectors and C/2 bytes of its bids row.

#include <cstdint>
#include <cuda_runtime.h>

#include "blocked_common.cuh"
#include "hashrng.cuh"

namespace {

using n2v::kGroup;
using n2v::kPadId;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = kThreads / kGroup;  // walkers a block at a time
constexpr int kRow = n2v::kLightRow;        // light-row lanes staged (P <= 32)
constexpr int kRowStride = kRow + 8;        // a warp's four row buffers on different banks
constexpr unsigned kFull = n2v::kFullMask;

constexpr int kSlLanes = 16;    // int32 lanes of an edge's slq entry
constexpr int kSlPadSlot = 0xFFFF;

// mode: 0 = p = q = 1 (every proposal accepted), 1 = q == 1 (only the
// return edge is biased), 2 = q != 1 (membership against N(prev)), 3 = q != 1
// with shared lists, some overflowed (N(prev) for walkers without a list), 4
// = q != 1 with shared lists, none overflowed (no N(prev)).  kSl is mode >=
// 3: the instantiation without shared lists carries none of their state.
//
// Dynamic shared memory: kGroups row buffers (two where N(prev) is kept) of
// kRowStride ints, then kGroups lane buffers of C/4 ints (a lane's C/8
// weights and their ids).  lane_sums [NB, 8] float2, NaN on entry: a block's
// (ex_r, hi_r), filled by the first group that reads the block whole.
// counters: [0] fallbacks, [1] attempts, [2] walkers taken, [3] heavy
// attempts that read their block whole.
template <bool kSl>
__global__ void __launch_bounds__(kThreads, 3)
blocked_walk_kernel(const int32_t* __restrict__ light, int row_width,
                    const int32_t* __restrict__ biw,
                    const int32_t* __restrict__ bids, const int32_t* __restrict__ brp,
                    const int32_t* __restrict__ slq,  // read in modes 3 and 4 only
                    float* __restrict__ lane_sums,
                    const int32_t* __restrict__ starts, int32_t* __restrict__ paths,
                    unsigned long long* __restrict__ counters, int64_t n_walkers,
                    int walk_length, int64_t gid_base, uint32_t seed, float inv_p,
                    float inv_q, float alpha_shared, int max_trials, int p_l, int c,
                    int has_heavy, int mode) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ unsigned long long block_cnt[kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = lane & (kGroup - 1);
  const int grp = threadIdx.x / kGroup;
  const bool need_prev = mode == 2 || mode == 3;
  const int n_rows = need_prev ? 2 : 1;
  int32_t* cur_row = smem + grp * n_rows * kRowStride;
  int32_t* prev_row = cur_row + (need_prev ? kRowStride : 0);
  const int maxb = (4 * p_l - 5) / 2;
  const int k4 = c / (4 * kGroup);  // int4s of a block row a lane owns
  const int seg = 4 * k4;            // its columns
  int32_t* lane_w = smem + kGroups * n_rows * kRowStride + grp * 2 * seg;  // a lane's columns
  int32_t* lane_id = lane_w + seg;                                        // and their ids
  const n2v::SharedCols buf{reinterpret_cast<const int4*>(lane_w)};
  const uint32_t it_bound =
      static_cast<uint32_t>(walk_length) * static_cast<uint32_t>(max_trials + 2);
  unsigned long long n_fb = 0, n_att = 0, n_whole = 0;

  // the group's walker (the same copy in its 8 lanes)
  bool have = false, done = false, alive = false;
  int32_t* out = paths;
  uint32_t gid = 0;
  int32_t cur = 0, prev = -1;
  float w_fwd = 0.f, fwd_pfx = 0.f, w_back = 0.f, back_pfx = 0.f;
  bool back_shared = false, need_entry = false, row_cached = false;
  int t = 0, trials = 0;
  uint32_t att = 0;  // attempts, also the loop's iterations: the bound is on them
  // the current row, decoded at entry
  bool is_heavy = false;
  int32_t h_bs = 0, h_nb = 0, degree = 0;
  float wtot = 0.f;
  float cdf[n2v::kGroupCols] = {0.f, 0.f, 0.f, 0.f};  // light columns 4r .. 4r + 3
  // shared lists: the arrival edge's list (lane r holds entry r; the plain
  // version's carried sl_row starts as zeros), decoded at entry
  int64_t aedge = -1;
  int32_t ebase_cur = 0, sl_rev = 0;
  int sl_slot = 0, n_sh = 0;
  float sl_cdf = 0.f, w_sh = 0.f;
  bool sl_valid = false;

  while (true) {
    // --- a group without a walker takes the next one ----------------------
    const bool want = !have && !done;
    unsigned long long got = 0;
    if (want && r == 0) got = atomicAdd(counters + 2, 1ull);
    got = __shfl_sync(kFull, got, 0, kGroup);
    if (want) {
      if (static_cast<int64_t>(got) >= n_walkers) {
        done = true;
      } else {
        const int64_t w = static_cast<int64_t>(got);
        have = true;
        out = paths + w * (walk_length + 1);
        gid = static_cast<uint32_t>(gid_base + w);
        const int32_t start = starts[w];
        alive = start >= 0;
        if (r == 0) out[0] = alive ? start : -1;
        cur = alive ? start : 0;
        prev = -1;
        w_fwd = fwd_pfx = w_back = back_pfx = 0.f;
        back_shared = false;
        t = trials = 0;
        att = 0;
        need_entry = true;
        row_cached = false;
        if (need_prev)
          for (int i = r; i < kRow; i += kGroup) prev_row[i] = kPadId;
        if (kSl) {
          aedge = -1;
          sl_slot = 0;
          sl_rev = 0;
        }
      }
    }
    if (!__any_sync(kFull, have)) break;  // every group of the warp is done

    // --- entry: (re)gather the frontier vertex's row -----------------------
    const bool ent = have && alive && need_entry;
    const int32_t* row_g = light + static_cast<int64_t>(cur) * row_width;
    __syncwarp();  // the row buffer's earlier reads are done
    n2v::row_issue(cur_row, row_g, r, ent && !row_cached);
    int2 slv = make_int2(0, 0);
    int32_t ebase_g = 0;
    if (kSl && ent) {
      if (aedge >= 0)  // one slq entry per accepted step: the arrival edge's
        slv = __ldg(reinterpret_cast<const int2*>(slq + aedge * kSlLanes) + r);
      if (4 * p_l >= kRow) ebase_g = __ldg(row_g + 4 * p_l);
    }
    n2v::copies_wait();
    if (__any_sync(kFull, ent)) {
      if (kSl) {
        // lane r: entry r's packed slot (slq lane r / 2, group lane r / 4) and
        // weight (slq lane 4 + r, group lane 2 + r / 2); rev and flags are
        // slq lanes 12, 13 (group lane 6)
        const int32_t pk0 = __shfl_sync(kFull, slv.x, r >> 2, kGroup);
        const int32_t pk1 = __shfl_sync(kFull, slv.y, r >> 2, kGroup);
        const int32_t wk0 = __shfl_sync(kFull, slv.x, 2 + (r >> 1), kGroup);
        const int32_t wk1 = __shfl_sync(kFull, slv.y, 2 + (r >> 1), kGroup);
        const int32_t rev = __shfl_sync(kFull, slv.x, 6, kGroup);
        const int32_t flags = __shfl_sync(kFull, slv.y, 6, kGroup);
        // the weights count only where the list is complete (sl_valid), so
        // an entry without a fetch (a return along an absent reverse edge)
        // may take them as 0; the slots it keeps (mode 4's hit test reads them)
        const bool fetch = ent && aedge >= 0;
        if (fetch) {
          const int32_t packed = (r >> 1) & 1 ? pk1 : pk0;
          sl_slot = (r & 1) ? (packed >> 16) & 0xFFFF : packed & 0xFFFF;
          sl_rev = rev;
        }
        const float wk = fetch ? __int_as_float(r & 1 ? wk1 : wk0) : 0.f;
        const float sum = n2v::group_sum(wk);
        const float scan = n2v::group_incl_scan(wk, r);
        const int cnt = n2v::group_count(sl_slot != kSlPadSlot);
        if (ent) {
          w_sh = sum;
          sl_cdf = scan;
          n_sh = cnt;
          sl_valid = fetch && (flags & 1) == 0;
          ebase_cur = 4 * p_l < kRow ? cur_row[4 * p_l] : ebase_g;
        }
      }
      const n2v::LightCols lc = n2v::light_cols(cur_row, r, p_l, has_heavy);
      if (ent) {
        need_entry = false;
        is_heavy = has_heavy && cur_row[0] < -1;
        if (is_heavy) {
          h_bs = cur_row[1];
          h_nb = cur_row[2];
          wtot = __int_as_float(cur_row[3]);
          degree = cur_row[4];
        } else {
#pragma unroll
          for (int j = 0; j < n2v::kGroupCols; ++j) cdf[j] = lc.cdf[j];
          degree = lc.degree;
          wtot = lc.wtot;
        }
        if (degree == 0) alive = false;  // sink death, before the draw
      }
    }
    const bool on = have && alive;

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
        // the exact 3-atom mixture on walkers with a complete list
        if (sl_valid) alpha2 = inv_q;
        const float m1sh = __fadd_rn(m1, sl_valid ? w_sh : 0.f);
        const float m2 = __fmul_rn(rest, alpha2);
        const float ub = __fmul_rn(u_branch, __fadd_rn(m1sh, m2));
        take_back = ub < m1;
        take_sh = sl_valid && !take_back && ub < m1sh;
        const float u_sh = __fmul_rn(u_prop, w_sh);
        const int k_below = n2v::group_count(sl_cdf < u_sh);
        sh_slot = __shfl_sync(kFull, sl_slot, min(k_below, max(n_sh - 1, 0)), kGroup);
      } else {
        const float m2 = __fmul_rn(rest, alpha2);
        take_back = u_branch < __fdiv_rn(m1, fmaxf(__fadd_rn(m1, m2), 1e-30f));
      }
      const float u2 = __fmul_rn(u_prop, rest);
      target = u2 < back_pfx ? u2 : __fadd_rn(u2, w_back);
    }

    // --- proposal: two-level exact inverse CDF ----------------------------
    // light: every group computes it (shared memory only); a heavy one
    // discards it
    const int below_l = n2v::light_below(cdf, target, r, p_l);
    const int slot_l = take_sh ? sh_slot : min(below_l, max(degree - 1, 0));
    const int ls = min(slot_l, kRow / 4 - 1);  // in the buffer for a heavy group
    const float pc_l = n2v::light_cdf_at(cdf, max(ls - 1, 0));
    int32_t cand = cur_row[ls];
    float w_cand = __int_as_float(cur_row[p_l + ls]);
    float ppfx = ls > 0 ? pc_l : 0.f;
    int32_t rev_enc = 0;
    float pfx_c = 0.f;
    if (mode != 0) {
      rev_enc = cur_row[2 * p_l + ls];
      pfx_c = __int_as_float(cur_row[3 * p_l + ls]);
    }
    int row_slot = slot_l;  // the proposal's slot within N(cur)
    if (__any_sync(kFull, on && is_heavy)) {
      const bool hv = on && is_heavy;
      const int nb_below = n2v::header_below(cur_row, target, r, maxb);
      // a shared pick forces its block before the block's weights are read
      const int blk = take_sh ? sh_slot / c : min(nb_below, max(h_nb - 1, 0));
      const int blk_l = min(blk, maxb);  // in the header for a light group
      const float base = blk_l > 0 ? __int_as_float(cur_row[5 + maxb + blk_l - 1]) : 0.f;
      const float resid = __fsub_rn(target, base);
      const int64_t brow = static_cast<int64_t>(h_bs) + blk;
      const int32_t* ids_row = biw + brow * 2 * c;
      const int32_t* w_row = ids_row + c;
      const n2v::GlobalCols cols = n2v::global_cols(w_row, k4, r);
      // the block's lane sums (ex_r, hi_r = ex_r + L_r(last)): from the table
      // once a group has read the block whole, else from a whole read that
      // fills the table (each entry written once, with the same bits by any
      // group; through L2, where every SM sees it)
      float2* at = reinterpret_cast<float2*>(lane_sums) + brow * kGroup + r;
      float2 ls = hv ? __ldcg(at) : make_float2(0.f, 0.f);
      const int known = n2v::group_count(!isnan(ls.x) && !isnan(ls.y));  // every lane votes
      const bool whole = hv && known < kGroup;
      if (__any_sync(kFull, whole)) {
        const float lsum = n2v::lane_sum(cols, whole ? k4 : 0);
        const float ex = n2v::group_excl_scan(lsum, r);
        if (whole) {
          ls = make_float2(ex, __fadd_rn(ex, lsum));
          __stcg(at, ls);
          n_whole += r == 0;
        }
      }
      // count(block CDF < resid) as block_below counts it: a lane whose last
      // column lies below counts them all, one whose first cannot none, and
      // only a lane between (one, but for ties) counts its columns, which the
      // group copies with their ids into its lane buffer, a lane at a time
      const bool all_below = ls.y < resid;
      int cnt = all_below ? seg : 0;
      bool pend = hv && !all_below && ls.x < resid;
      int held = -1;  // the lane whose columns the buffer holds (group-uniform)
      while (__any_sync(kFull, pend)) {
        const unsigned pm = n2v::group_bits(__ballot_sync(kFull, pend));
        const int s = __ffs(pm) - 1;
        __syncwarp();  // the buffer's earlier reads are done
        if (pm) {
          const int4* w_src = reinterpret_cast<const int4*>(w_row) + s * k4;
          const int4* id_src = reinterpret_cast<const int4*>(ids_row) + s * k4;
          for (int i = r; i < k4; i += kGroup) {
            n2v::cp_async16(lane_w + 4 * i, w_src + i);
            n2v::cp_async16(lane_id + 4 * i, id_src + i);
          }
          held = s;
        }
        n2v::copies_wait();
        if (pend && r == s) {
          cnt += n2v::lane_below(buf, k4, ls.x, resid);
          pend = false;
        }
      }
      const int below = n2v::group_isum(hv ? cnt : 0);
      const int nvalid = min(c, degree - blk * c);
      const int slot = take_sh ? sh_slot % c : min(below, max(nvalid - 1, 0));
      const int lo = held * seg;  // the buffer's first column
      const bool in_buf = held >= 0 && slot >= lo && slot < lo + seg;
      // the CDF at slot - 1, by its owner: hi_r at the owner's last column,
      // else ex_r plus its partial sum (block_prefix_before's bits), from the
      // buffer where it holds the owner's columns
      const int j = max(slot - 1, 0);
      const int owner = j / seg;
      const int last = j - owner * seg;
      float pc = 0.f;
      if (hv && slot > 0 && r == owner)
        pc = last == seg - 1 ? ls.y
                             : __fadd_rn(ls.x, owner == held ? n2v::lane_prefix(buf, last)
                                                             : n2v::lane_prefix(cols, last));
      pc = __shfl_sync(kFull, pc, owner, kGroup);
      if (hv) {
        row_slot = blk * c + slot;
        ppfx = __fadd_rn(base, slot > 0 ? pc : 0.f);
        // the id and its weight from the buffer where it holds them; the brp
        // pair, read at the step's end, loads while acceptance is decided
        cand = in_buf ? lane_id[slot - lo] : __ldg(ids_row + slot);
        w_cand = __int_as_float(in_buf ? lane_w[slot - lo] : __ldg(w_row + slot));
        if (mode != 0) {
          const int2 pair = n2v::brp_pair(brp, brow * c + slot);
          rev_enc = pair.x;
          pfx_c = __int_as_float(pair.y);
        }
      }
    }

    // --- acceptance -------------------------------------------------------
    const bool first_order = t == 0;
    bool accept = true;
    if (mode == 1) {
      accept = take_back || first_order || cand != prev;
    } else if (mode >= 2) {
      // a list walker: the only rejection is a proportional-to-w proposal on
      // a stored shared slot (it belongs to the shared atom)
      const bool list = kSl && (mode == 4 || sl_valid);
      bool accept_list = false;
      if (kSl) {
        const bool hit = n2v::group_any(sl_slot != kSlPadSlot && sl_slot == row_slot);
        accept_list = (mode == 4 && first_order) || take_back || take_sh ||
                      (cand != prev && !hit);
      }
      // the others: cand in N(prev), asked only where the answer matters
      const bool probe = on && !list && !take_back && !first_order && cand != prev;
      bool shared = false;
      if (mode != 4 && __any_sync(kFull, probe)) {
        const int32_t* mrow = n2v::member_row(prev_row, bids, cand, r, p_l, c, has_heavy);
        shared = n2v::prev_member(prev_row, mrow, c, cand, r, p_l, probe);
      }
      const float bias2 = shared ? 1.f : inv_q;
      const bool accept_probe =
          take_back || first_order || (cand != prev && __fmul_rn(u_acc, alpha2) <= bias2);
      accept = list ? accept_list : accept_probe;
    }

    // --- trial cap: bounded-bias proportional-to-w fallback, counted ------
    if (on) {
      trials = accept ? 0 : trials + 1;
      const bool force = trials >= max_trials;
      n_fb += (force && !accept && r == 0);
      ++att;  // counts the final accepted draw of a finishing walker too
      if (accept || force) {
        const bool take = take_back && !force;
        const int32_t nxt = take ? prev : cand;
        if (r == 0) out[t + 1] = nxt;
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
          row_cached = nxt == prev;  // a step back onto prev: its row is here
        }
        prev = cur;
        cur = nxt;
        ++t;
        trials = 0;
        need_entry = true;
        alive = t < walk_length;
      }
      if (att >= it_bound) alive = false;  // unfinished: the rest of the path stays -1
    }
    // --- a walker that ended: the rest of its path, its attempts ----------
    if (have && !alive) {
      for (int s = t + 1 + r; s <= walk_length; s += kGroup) out[s] = -1;
      n_att += r == 0 ? att : 0;
      have = false;
    }
  }
  // lane 0 of each group holds its counts: a warp's, then the block's
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_fb += __shfl_xor_sync(kFull, n_fb, off);
    n_att += __shfl_xor_sync(kFull, n_att, off);
    n_whole += __shfl_xor_sync(kFull, n_whole, off);
  }
  if (lane == 0) {
    block_cnt[warp][0] = n_fb;
    block_cnt[warp][1] = n_att;
    block_cnt[warp][2] = n_whole;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long s = 0;
    for (int i = 0; i < kWarps; ++i) s += block_cnt[i][threadIdx.x];
    if (s) atomicAdd(counters + (threadIdx.x == 2 ? 3 : threadIdx.x), s);
  }
}

// The launch's kernel and dynamic shared memory at block width c and mode.
struct Launch {
  void (*kernel)(const int32_t*, int, const int32_t*, const int32_t*, const int32_t*,
                 const int32_t*, float*, const int32_t*, int32_t*, unsigned long long*,
                 int64_t, int, int64_t, uint32_t, float, float, float, int, int, int, int, int);
  size_t smem;
};

Launch launch_for(int c, int mode) {
  const int n_rows = mode == 2 || mode == 3 ? 2 : 1;
  Launch l;
  l.smem = sizeof(int32_t) * kGroups * (n_rows * kRowStride + c / 4);
  l.kernel = mode >= 3 ? blocked_walk_kernel<true> : blocked_walk_kernel<false>;
  return l;
}

// Blocks of the launch resident on one SM at once (0 on an error).
int blocks_per_sm(const Launch& l) {
  if (cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(l.smem)) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, l.kernel, kThreads, l.smem) !=
      cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// The launch geometry at block width c and mode: out[0] blocks resident an
// SM, [1] walkers a block, [2] SMs, [3] dynamic shared memory a block (B).
extern "C" int n2v_blocked_walk_geometry(int block_width, int mode, int* out) {
  if (block_width < 64 || block_width % 64 || block_width > 2048 || mode < 0 || mode > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = launch_for(block_width, mode);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = blocks_per_sm(l);
  out[1] = kGroups;
  out[2] = sms;
  out[3] = static_cast<int>(l.smem);
  return static_cast<int>(cudaGetLastError());
}

// counters: int64 [4], zeroed by the caller; lane_sums: float [NB * 16],
// NaN (see the kernel's note).
extern "C" int n2v_blocked_walk(const int32_t* light, int row_width, const int32_t* biw,
                                const int32_t* bids, const int32_t* brp, const int32_t* slq,
                                float* lane_sums, const int32_t* starts, int32_t* paths,
                                int64_t* counters, int64_t n_walkers, int walk_length,
                                int64_t gid_base, uint32_t seed, float inv_p, float inv_q,
                                float alpha_shared, int max_trials, int light_width,
                                int block_width, int has_heavy, int mode, void* stream) {
  if (light_width < 1 || light_width > 32 || block_width < 64 || block_width % 64 ||
      block_width > 2048 || max_trials < 1 || mode < 0 || mode > 4 ||
      (row_width != 128 && row_width != 256) || (mode >= 3 && row_width < 4 * light_width + 1) ||
      reinterpret_cast<uintptr_t>(light) % 16 || reinterpret_cast<uintptr_t>(biw) % 16 ||
      reinterpret_cast<uintptr_t>(bids) % 16 || reinterpret_cast<uintptr_t>(brp) % 8 ||
      reinterpret_cast<uintptr_t>(slq) % 8 || reinterpret_cast<uintptr_t>(lane_sums) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_walkers == 0) return 0;
  const Launch l = launch_for(block_width, mode);
  const int per_sm = blocks_per_sm(l);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t needed = (n_walkers + kGroups - 1) / kGroups;
  const int64_t blocks = needed < static_cast<int64_t>(per_sm) * sms
                             ? needed : static_cast<int64_t>(per_sm) * sms;
  l.kernel<<<static_cast<unsigned>(blocks), kThreads, l.smem,
             static_cast<cudaStream_t>(stream)>>>(
      light, row_width, biw, bids, brp, slq, lane_sums, starts, paths,
      reinterpret_cast<unsigned long long*>(counters),
      n_walkers, walk_length, gid_base, seed, inv_p, inv_q, alpha_shared, max_trials,
      light_width, block_width, has_heavy, mode);
  return static_cast<int>(cudaGetLastError());
}
