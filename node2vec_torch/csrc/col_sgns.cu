// K16 col_pair_logits and K17 col_pair_grads: the column-sharded SGNS step.
//
// Replaces node2vec_tpu/parallel/sharded_sgns.py:57 _col_step (driven by
// :284 sharded_sgns_step and :248 col_sgns_epoch), the mesh's default
// trainer.  Each rank holds dims [m * Dm, (m + 1) * Dm) of every row of
// emb_in and emb_out (Dm = D / n_model), so the pair step of K13
// (sgns_pairs.cu) splits at the all-reduce over the model axis: a logit is
// a sum of partial dot products, one a rank.  The step on a rank:
//   K13's first launch  pair lists (centers, contexts; -1 where invalid)
//   K16                 partial logits over this rank's Dm columns
//   all_reduce(model)   full logits
//   K17                 gradients over Dm from the full logits, and the
//                       partial squares of each gradient row
//   all_reduce(model)   full squares (divided by the full D in K3)
//   K3, squares mode    dacc, then all_reduce(data) and acc += dacc
//   K4                  the update, scaled by the final accumulators
//
// K16 writes, for the walk's P lanes in the JAX order (walk, offset,
// position) and for its L1 positions:
//   pos_part[p]         = ci[p] . co[p] over Dm   (0 on an invalid lane)
//   neg_part[b, i, s]   = xin[i] . no[s] over Dm  (0 for a position with no
//                                                  valid lane)
// The negative logits depend only on the center, a walk position, so they
// are computed once a position, as K13 does, and the buffer is [B * L1, S]
// where the JAX step's is [P, S] (2w rows a position, all equal).
//
// K17 takes the all-reduced logits and writes, as K13 does over D:
//   d_ci[p] = g_pos[p] * co[p] + gn[center]      (0 where invalid)
//   d_co[p] = g_pos[p] * ci[p]                   (0 where invalid)
//   d_no    = sum over valid lanes of g_neg^T ci (block partials, added
//             with 16-byte atomics once a block)
// beside each lane's partial squares sum_k d_ci[p, k]^2 and sum_k
// d_co[p, k]^2, each negative's sum_k d_no[s, k]^2 (the last block to
// finish reads d_no after every block's atomics), and the loss partials of
// each block, as K13's.  At n_model = 1, K16 then K17 is K13's function.
//
// Both kernels run on K13's walk-group machinery (tf32_tiles.cuh): walk
// groups of G = 64 / L1 walks (one walk when L1 > 64) in an M-tile of Mt
// rows, Dm in chunks of KC columns through the two-stage ring of gathered
// [Mt, KC] chunks of X_in and X_out, the products on 3xTF32 mma.sync, NO
// [S, Dm] in shared memory once a block.  Each makes one pass over a
// group's chunks (an item a chunk):
//
// * K16 is K13's pass 1: NL += X_in . NO_c^T in 16 x 16 tiles and PL +=
//   X_in . X_out^T in the 16 x 8 tiles that meet the band |i - j| <= w.
//   After the last chunk the group's outputs are two contiguous runs: its
//   lanes' PL[i, i + d] (0 where invalid) into pos_part, and its positions'
//   NL rows (0 where the position has no valid lane) into neg_part, 16
//   bytes a thread where S and the buffer allow.
// * K17 is K13's elementwise phase, pass 2 and store phase, with no pass 1.
//   The group's logits land by cp.async ahead of it (its lanes' pos_logit
//   a group ahead; its positions' neg_logit rows during the previous
//   group's last store phase, once Gneg is read no more); at its first
//   chunk the elementwise phase turns them in place into g_pos and Gneg,
//   with mult * Gneg and the loss partials.  A chunk: GN_c = Gneg . NO_c and the block's
//   d_no partial += (mult * Gneg)^T . X_in_c on 16 x 32 warp tiles, then
//   the store phase writes the group's lane rows of d_ci and d_co (one
//   contiguous run each, 8 threads a row, 16 bytes a store, the next
//   chunk's gather already in flight) and adds each lane row's partial
//   squares, summed over its 8 threads by shuffles, to a per-lane sum in
//   shared memory, written out at the group's last chunk.  No pass reads the
//   gradients back.
//
// A group's rows table lands two groups ahead (three buffers), so the
// gather of the next group's first chunk, issued at the top of this
// group's last item, finds it even when a pass is one chunk; its lanes'
// centers (and K17's positive logits) one group ahead (two buffers).
//
// Staging: a shape whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); there the gathers are plain copies.
//
// Bound on an H100: memory.  K17 writes 2 * P * Dm * 4 bytes of per-lane
// gradients (550 MB at B = 2,560, L1 = 21, w = 5, Dm = 128, 0.164 ms) and
// K3/K4 read them back; K16 reads the walk's rows and writes P + B * L1 * S
// floats.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tiles;

constexpr int kTabs = 3;  // rows tables in flight: two groups ahead

struct ColArgs {
  const float* emb_in;
  const float* emb_out;
  const int32_t* walks;
  const int32_t* centers;
  const int32_t* neg_ids;
  int n_walks;
  // K16
  float* pos_part;
  float* neg_part;
  // K17
  const float* pos_logit;
  const float* neg_logit;
  float neg_scale;
  float* d_ci;
  float* d_co;
  float* d_no;
  float* sq_ci;
  float* sq_co;
  float* sq_no;
  float* loss_parts;
  unsigned* done;
};

// Floats of the arrays both kernels carve after their own: the rows tables
// [kTabs][Mt] and the centers [2][2w * Mt] (ints), mult [Mt], two mbarriers.
inline size_t group_floats(const Geo& g) {
  return static_cast<size_t>(g.Mt) * (kTabs + 2 * 2 * g.W + 1) + 4;
}

// K16: NO [Sp, ldn]; the ring; NL [Mt, ldg]; PL [Mt, ldb]; the group arrays.
size_t logits_smem_bytes(const Geo& g) {
  const size_t floats = static_cast<size_t>(g.Sp) * g.ldn +
                        static_cast<size_t>(kStages) * 2 * g.Mt * g.ldx +
                        static_cast<size_t>(g.Mt) * (g.ldg + g.ldb) + group_floats(g);
  return floats * sizeof(float);
}

// K17: NO and the d_no partial; the ring; the neg logits / Gneg [Mt, ldg] and
// mult * Gneg [Mt, ldg]; GN_c [Mt, ldc]; the pos logits / g_pos [2][2w * Mt];
// the per-lane squares [2][2w * Mt]; the loss reduction and the ticket; the
// group arrays.
size_t grads_smem_bytes(const Geo& g) {
  const size_t floats = 2 * static_cast<size_t>(g.Sp) * g.ldn +
                        static_cast<size_t>(kStages) * 2 * g.Mt * g.ldx +
                        2 * static_cast<size_t>(g.Mt) * g.ldg +
                        static_cast<size_t>(g.Mt) * g.ldc +
                        4 * static_cast<size_t>(g.W) * 2 * g.Mt + 3 * kWarps + 4 +
                        group_floats(g);
  return floats * sizeof(float);
}

Geo logits_geo(int length, int dim, int n_neg, int window) {
  return tiles::pick_geo(length, dim, n_neg, window,
                         [](const Geo& g) { return logits_smem_bytes(g); });
}

Geo grads_geo(int length, int dim, int n_neg, int window) {
  return tiles::pick_geo(length, dim, n_neg, window,
                         [](const Geo& g) { return grads_smem_bytes(g); });
}

// ---- the group arrays -------------------------------------------------------

// Group q's rows table: the walk's vertex ids, -1 past a ragged last group.
template <bool kShared>
__device__ __forceinline__ void load_tab(int* tab, const Geo& g, const ColArgs& a, int q) {
  const Item it = group_of(g, a.n_walks, q);
  for (int r = threadIdx.x; r < g.Mt; r += kThreads) {
    if (r < it.rows)
      copy_int<kShared>(tab + r, a.walks + it.row0 + r);
    else
      tab[r] = -1;
  }
}

// Group q's lanes' centers, in lane order (walk, offset, position).
template <bool kShared>
__device__ __forceinline__ void load_centers(int* cen, const Geo& g, const ColArgs& a, int q) {
  const Item it = group_of(g, a.n_walks, q);
  const int64_t lane0 = it.row0 * 2 * g.W;
  for (int p = threadIdx.x; p < it.rows * 2 * g.W; p += kThreads)
    copy_int<kShared>(cen + p, a.centers + lane0 + p);
}

// K17: group q's positions' neg_logit rows into nl [Mt, ldg] (columns S..
// zeroed).
template <bool kShared>
__device__ __forceinline__ void load_neg_logits(float* nl, const Geo& g, const ColArgs& a,
                                                int q, bool vec_nl) {
  const Item it = group_of(g, a.n_walks, q);
  const int per_row = vec_nl ? g.Sp / 4 : g.Sp;
  for (int i = threadIdx.x; i < it.rows * per_row; i += kThreads) {
    const int r = i / per_row;
    copy_piece<kShared>(nl + r * g.ldg, a.neg_logit + (it.row0 + r) * g.S, 0, g.S,
                        i % per_row, vec_nl);
  }
}

// K17: group q's lanes' pos_logit into pos [2w * Mt].
template <bool kShared>
__device__ __forceinline__ void load_pos_logits(float* pos, const Geo& g, const ColArgs& a,
                                                int q) {
  const Item it = group_of(g, a.n_walks, q);
  const int n_lanes = it.rows * 2 * g.W;
  for (int p = threadIdx.x; p < n_lanes; p += kThreads)
    copy_piece<kShared>(pos, a.pos_logit + it.row0 * 2 * g.W, 0, n_lanes, p, false);
}

// mult[r]: the valid lanes of the group's row r (0 past its rows).
__device__ __forceinline__ float count_lanes(const int* cen, const Geo& g, int r, int rows) {
  if (r >= rows) return 0.f;
  const int W2 = 2 * g.W;
  const int* lanes = cen + (r / g.L) * W2 * g.L + r % g.L;
  float m = 0.f;
  for (int o = 0; o < W2; ++o) m += lanes[o * g.L] >= 0 ? 1.f : 0.f;
  return m;
}

// NO [Sp, ldn] alone (K16 keeps no d_no partial).
template <bool kShared>
__device__ __forceinline__ void load_no(float* no, const Geo& g, const float* emb_out,
                                        const int32_t* neg_rows, bool vec) {
  const int per_row = vec ? g.Dp / 4 : g.Dp;
  for (int i = threadIdx.x; i < g.Sp * per_row; i += kThreads) {
    const int s = i / per_row;
    const int row = s < g.S ? neg_rows[s] : -1;
    copy_piece<kShared>(no + s * g.ldn,
                        row < 0 ? nullptr : emb_out + static_cast<int64_t>(row) * g.D, 0, g.D,
                        i % per_row, vec);
  }
}

// ---- K16: partial logits ----------------------------------------------------

template <bool kShared>
__device__ __forceinline__ void logits_block(float* sm, const Geo& g, const ColArgs& a) {
  float* no = sm;                                  // [Sp, ldn]
  float* ring = no + g.Sp * g.ldn;                 // [kStages][2][Mt, ldx]
  float* nl = ring + kStages * 2 * g.Mt * g.ldx;   // [Mt, ldg] NL
  float* pl = nl + g.Mt * g.ldg;                   // [Mt, ldb] PL
  int* tabs = reinterpret_cast<int*>(pl + g.Mt * g.ldb);  // [kTabs][Mt]
  int* cens = tabs + kTabs * g.Mt;                        // [2][2w * Mt]
  float* mult = reinterpret_cast<float*>(cens + 2 * 2 * g.W * g.Mt);  // [Mt]
  uint64_t* mbars = reinterpret_cast<uint64_t*>(mult + g.Mt);          // [2] the ring's

  const int tid = threadIdx.x;
  const int L = g.L, D = g.D, S = g.S, W = g.W, Mt = g.Mt, KC = g.KC, nc = g.nc;
  const int W2 = 2 * W;
  const int n_mine = my_groups(g, a.n_walks);
  const int n_items = n_mine * nc;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.emb_out) % 16 == 0);
  const bool vec_neg = S % 4 == 0 && (reinterpret_cast<uintptr_t>(a.neg_part) % 16 == 0);
  const bool bulk = kShared && vec;

  // prologue: groups 0 and 1's tables, group 0's centers; NO and item 0's
  // chunks in flight
  if (n_mine > 0) {
    load_tab<kShared>(tabs, g, a, 0);
    load_centers<kShared>(cens, g, a, 0);
  }
  if (n_mine > 1) load_tab<kShared>(tabs + Mt, g, a, 1);
  if (bulk) init_ring(mbars, Mt);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  load_no<kShared>(no, g, a.emb_out, a.neg_ids, vec);
  if (n_items > 0)
    gather<kShared>(ring, g, Rows{a.emb_in, a.emb_out, D, tabs, tabs}, 0, vec, smem_addr(mbars));
  cp_commit();

  for (int t = 0; t < n_items; ++t) {
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage and outputs are done
    if (t + 1 < n_items) {
      const int* tab = tabs + ((t + 1) / nc % kTabs) * Mt;
      gather<kShared>(ring + ((t + 1) % kStages) * 2 * Mt * g.ldx, g,
                      Rows{a.emb_in, a.emb_out, D, tab, tab}, t + 1, vec,
                      smem_addr(mbars + (t + 1) % kStages));
    }
    const int q = t / nc, chunk = t % nc;
    if (chunk == 0) {  // landed by the next item's top
      if (q + 2 < n_mine) load_tab<kShared>(tabs + (q + 2) % kTabs * Mt, g, a, q + 2);
      if (q + 1 < n_mine) load_centers<kShared>(cens + ((q + 1) & 1) * W2 * Mt, g, a, q + 1);
    }
    cp_commit();

    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;
    pass1_products(g, chunk, xin, g.ldx, no + chunk * KC, nl, xin + Mt * g.ldx, pl);
    if (chunk + 1 < nc) continue;

    // the group's outputs: its lanes' positive logits, its positions' rows
    // of negative logits
    const Item it = group_of(g, a.n_walks, q);
    const int* cen = cens + (q & 1) * W2 * Mt;
    for (int r = tid; r < Mt; r += kThreads) mult[r] = count_lanes(cen, g, r, it.rows);
    __syncthreads();  // NL, PL and mult complete
    const int64_t lane0 = it.row0 * W2;
    for (int lr = tid; lr < it.rows * W2; lr += kThreads) {
      const int i = lr % L, o = (lr / L) % W2, r = lr / (W2 * L) * L + i;
      a.pos_part[lane0 + lr] = cen[lr] >= 0 ? pl[r * g.ldb + r + offset_of(o, W)] : 0.f;
    }
    float* neg_out = a.neg_part + it.row0 * S;
    if (vec_neg) {
      const int per_row = S / 4;
      for (int e = tid; e < it.rows * per_row; e += kThreads) {
        const int r = e / per_row, s = 4 * (e % per_row);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mult[r] > 0.f) v = *reinterpret_cast<const float4*>(nl + r * g.ldg + s);
        *reinterpret_cast<float4*>(neg_out + r * S + s) = v;
      }
    } else {
      for (int e = tid; e < it.rows * S; e += kThreads) {
        const int r = e / S, s = e % S;
        neg_out[e] = mult[r] > 0.f ? nl[r * g.ldg + s] : 0.f;
      }
    }
  }
  cp_wait_all();
}

__global__ void __launch_bounds__(kThreads, 1) col_pair_logits_kernel(Geo g, ColArgs a) {
  extern __shared__ __align__(16) float sm[];
  logits_block<true>(sm, g, a);
}

__global__ void __launch_bounds__(kThreads, 1)
col_pair_logits_kernel_staged(Geo g, ColArgs a, float* ws, int64_t ws_stride) {
  logits_block<false>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

// ---- K17: gradients and partial squares from the full logits ---------------

template <bool kShared>
__device__ __forceinline__ void grads_block(float* sm, const Geo& g, const ColArgs& a) {
  const int Mt = g.Mt, W2 = 2 * g.W;
  float* no = sm;                                  // [Sp, ldn]
  float* dno = no + g.Sp * g.ldn;                  // [Sp, ldn] the block's d_no partial
  float* ring = dno + g.Sp * g.ldn;                // [kStages][2][Mt, ldx]
  float* nlg = ring + kStages * 2 * Mt * g.ldx;    // [Mt, ldg] neg logits, then Gneg
  float* gm = nlg + Mt * g.ldg;                    // [Mt, ldg] mult * Gneg
  float* gn = gm + Mt * g.ldg;                     // [Mt, ldc] GN_c
  float* poss = gn + Mt * g.ldc;                   // [2][2w * Mt] pos logits, then g_pos
  float* sqs = poss + 2 * W2 * Mt;                 // [2][2w * Mt] partial squares (ci, co)
  float* red = sqs + 2 * W2 * Mt;                  // [3 * kWarps]
  int* last = reinterpret_cast<int*>(red + 3 * kWarps);  // [4] this block finished last
  int* tabs = last + 4;                                  // [kTabs][Mt]
  int* cens = tabs + kTabs * Mt;                         // [2][2w * Mt]
  float* mult = reinterpret_cast<float*>(cens + 2 * W2 * Mt);  // [Mt]
  uint64_t* mbars = reinterpret_cast<uint64_t*>(mult + Mt);     // [2] the ring's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = g.L, D = g.D, S = g.S, W = g.W, Sp = g.Sp, KC = g.KC, nc = g.nc;
  const int n_mine = my_groups(g, a.n_walks);
  const int n_items = n_mine * nc;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.emb_out) % 16 == 0);
  const bool vec_out = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.d_ci) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(a.d_co) % 16 == 0);
  const bool vec_nl = S % 4 == 0 && (reinterpret_cast<uintptr_t>(a.neg_logit) % 16 == 0);
  const bool bulk = kShared && vec;

  // prologue: groups 0 and 1's tables, group 0's centers and logits; NO and
  // item 0's chunks in flight
  if (n_mine > 0) {
    load_tab<kShared>(tabs, g, a, 0);
    load_centers<kShared>(cens, g, a, 0);
    load_neg_logits<kShared>(nlg, g, a, 0, vec_nl);
    load_pos_logits<kShared>(poss, g, a, 0);
  }
  if (n_mine > 1) load_tab<kShared>(tabs + Mt, g, a, 1);
  if (bulk) init_ring(mbars, Mt);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  load_negatives<kShared>(no, dno, g, a.emb_out, D, a.neg_ids, vec);
  if (n_items > 0)
    gather<kShared>(ring, g, Rows{a.emb_in, a.emb_out, D, tabs, tabs}, 0, vec, smem_addr(mbars));
  cp_commit();
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  // the store phase's threads: 8 a lane row, a thread's k-th 4 columns at
  // 4 * piece + 32 * k (k < KC / 32), so a quarter-warp reads 32 contiguous
  // floats of a row and a warp writes 4 rows' 128 contiguous bytes a store
  constexpr int kRowThreads = 8;
  const int piece = tid % kRowThreads, step = kThreads / kRowThreads;
  const unsigned row_mask = 0xFFu << (lane & ~(kRowThreads - 1));
  const int mt16 = Mt / 16, sp16 = Sp / 16;
  // the warp tiles: 16 x 32 (4 mma tiles) in shared memory; 16 x 16 in a
  // global workspace (as K2)
  constexpr int kP2Tiles = kShared ? 4 : 2;
  const int kc2 = KC / (8 * kP2Tiles);  // warp tiles across a chunk
  const int n_gn = mt16 * kc2, n_dno = sp16 * kc2;

  for (int t = 0; t < n_items; ++t) {
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage is free
    if (t + 1 < n_items) {
      const int* tab = tabs + ((t + 1) / nc % kTabs) * Mt;
      gather<kShared>(ring + ((t + 1) % kStages) * 2 * Mt * g.ldx, g,
                      Rows{a.emb_in, a.emb_out, D, tab, tab}, t + 1, vec,
                      smem_addr(mbars + (t + 1) % kStages));
    }
    const int q = t / nc, chunk = t % nc;
    if (chunk == 0) {  // landed by the next item's top
      if (q + 2 < n_mine) load_tab<kShared>(tabs + (q + 2) % kTabs * Mt, g, a, q + 2);
      if (q + 1 < n_mine) {
        const int nb = (q + 1) & 1;
        load_centers<kShared>(cens + nb * W2 * Mt, g, a, q + 1);
        load_pos_logits<kShared>(poss + nb * W2 * Mt, g, a, q + 1);
      }
    }
    cp_commit();

    const Item it = group_of(g, a.n_walks, q);
    const int* cen = cens + (q & 1) * W2 * Mt;
    float* gpos = poss + (q & 1) * W2 * Mt;
    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;
    const float* xout = xin + Mt * g.ldx;
    const int c0 = chunk * KC;
    const int n_lanes = it.rows * W2;

    if (chunk == 0) {
      // the elementwise phase: mult, then Gneg and mult * Gneg a warp a row,
      // and each lane's g_pos, in place of the logits
      for (int r = tid; r < Mt; r += kThreads) {
        const float m = count_lanes(cen, g, r, it.rows);
        mult[r] = m;
        mult_acc += m;
      }
      __syncthreads();
      for (int r = warp; r < Mt; r += kWarps) {
        const float m = mult[r];
        float* nrow = nlg + r * g.ldg;
        float* mrow = gm + r * g.ldg;
        for (int s = lane; s < Sp; s += 32) {
          float out = 0.f;
          if (m > 0.f && s < S) {
            const float nl = nrow[s];
            float l1pe;
            out = sigmoid_log1pe(nl, l1pe) * a.neg_scale;
            neg_acc += (fminf(-nl, 0.f) - l1pe) * m;  // log sigmoid(-nl), a lane each
          }
          nrow[s] = out;
          mrow[s] = out * m;
        }
      }
      for (int lr = tid; lr < n_lanes; lr += kThreads) {
        float gp = 0.f;
        if (cen[lr] >= 0) {
          const float pl = gpos[lr];
          float l1pe;
          gp = sigmoid_log1pe(pl, l1pe) - 1.f;
          pos_acc += fminf(pl, 0.f) - l1pe;  // log sigmoid(pl)
        }
        gpos[lr] = gp;
      }
      __syncthreads();
    }

    // pass 2: GN_c and the d_no partial on the tensor cores
    const int k_live = min(Mt, round_up(it.rows, 8));
    for (int w = warp; w < n_gn + n_dno; w += kWarps) {
      if (w < n_gn) {  // GN_c = Gneg . NO_c
        const int m0 = (w / kc2) * 16, n0 = (w % kc2) * 8 * kP2Tiles;
        if (m0 >= it.rows) continue;
        float acc[kP2Tiles][4] = {};
        mma_tile<kP2Tiles, false, true, true>(acc, nlg, g.ldg, no + c0, g.ldn, m0, n0, KC, 0,
                                              Sp);
        store_acc(acc, gn, g.ldc, m0, n0, KC);
      } else {  // the d_no partial += (mult * Gneg)^T . X_in
        const int j = w - n_gn, s0 = (j / kc2) * 16, n0 = (j % kc2) * 8 * kP2Tiles;
        if (s0 >= S) continue;
        accumulate_dno<kP2Tiles>(dno + c0, g, gm, xin, g.ldx, s0, n0, k_live);
      }
    }
    __syncthreads();
    const bool first = chunk == 0, last_chunk = chunk + 1 == nc;
    // Gneg is read no more: the next group's negative logits land by the
    // next item's top, while this store phase runs
    if (last_chunk && q + 1 < n_mine) {
      load_neg_logits<kShared>(nlg, g, a, q + 1, vec_nl);
      cp_commit();
    }

    // the store phase: lane row lr of the group is (walk ql, offset o,
    // position i), row r = ql * L1 + i of the tile; lr advances by `step`,
    // so a thread takes the same lane rows at every chunk
    const int64_t lane0 = it.row0 * W2;
    int lr = tid / kRowThreads, i = lr % L, o = (lr / L) % W2, ql = lr / (W2 * L);
    for (; lr < n_lanes; lr += step) {
      const int r = ql * L + i;
      const bool live = cen[lr] >= 0;
      const float gp = live ? gpos[lr] : 0.f;
      const float* xo_row = xout + (r + (live ? offset_of(o, W) : 0)) * g.ldx;
      float sa = 0.f, sc = 0.f;  // the row's squares over this chunk
#pragma unroll 2
      for (int k = 0; k < KC / 32; ++k) {
        const int col = 4 * piece + 32 * k;
        float4 ci = make_float4(0.f, 0.f, 0.f, 0.f), co = ci;
        if (live) {
          ci = fma4(gp, *reinterpret_cast<const float4*>(xo_row + col),
                    *reinterpret_cast<const float4*>(gn + r * g.ldc + col));
          co = scale4(gp, *reinterpret_cast<const float4*>(xin + r * g.ldx + col));
        }
        store4(a.d_ci + (lane0 + lr) * D, c0 + col, D, vec_out, ci);
        store4(a.d_co + (lane0 + lr) * D, c0 + col, D, vec_out, co);
        sa += ci.x * ci.x + ci.y * ci.y + ci.z * ci.z + ci.w * ci.w;
        sc += co.x * co.x + co.y * co.y + co.z * co.z + co.w * co.w;
      }
      for (int off = kRowThreads / 2; off > 0; off >>= 1) {  // over the row's threads
        sa += __shfl_xor_sync(row_mask, sa, off);
        sc += __shfl_xor_sync(row_mask, sc, off);
      }
      if (piece == 0) {
        if (!first) {
          sa += sqs[lr];
          sc += sqs[W2 * Mt + lr];
        }
        if (last_chunk) {
          a.sq_ci[lane0 + lr] = sa;
          a.sq_co[lane0 + lr] = sc;
        } else {
          sqs[lr] = sa;
          sqs[W2 * Mt + lr] = sc;
        }
      }
      for (i += step; i >= L; i -= L)
        if (++o == W2) {
          o = 0;
          ++ql;
        }
    }
  }
  cp_wait_all();
  __syncthreads();
  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, mult_acc, a.loss_parts);
  __threadfence();  // this block's d_no atomics land before its ticket
  __syncthreads();
  if (tid == 0) *last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  // the last block: every block's d_no is in, read it from L2
  for (int s = warp; s < S; s += kWarps) {
    float acc = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float v = __ldcg(a.d_no + static_cast<int64_t>(s) * D + k);
      acc += v * v;
    }
    acc = warp_sum(acc);
    if (lane == 0) a.sq_no[s] = acc;
  }
}

__global__ void __launch_bounds__(kThreads, 1) col_pair_grads_kernel(Geo g, ColArgs a) {
  extern __shared__ __align__(16) float sm[];
  grads_block<true>(sm, g, a);
}

__global__ void __launch_bounds__(kThreads, 1)
col_pair_grads_kernel_staged(Geo g, ColArgs a, float* ws, int64_t ws_stride) {
  grads_block<false>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

}  // namespace

// Bytes of shared memory a block takes (or of workspace it stages in).
extern "C" size_t n2v_col_pair_logits_smem(int length, int dim, int n_neg, int window) {
  return logits_smem_bytes(logits_geo(length, dim, n_neg, window));
}

extern "C" size_t n2v_col_pair_grads_smem(int length, int dim, int n_neg, int window) {
  return grads_smem_bytes(grads_geo(length, dim, n_neg, window));
}

// K16 on K13's pair lists: pos_part [n_walks * 2w * length], neg_part
// [n_walks * length, n_neg], both written whole.  ws null: shared staging;
// else ws, ws_blocks blocks of n2v::staging_stride(n2v_col_pair_logits_smem(
// ...)) floats (staging.cuh).
extern "C" int n2v_col_pair_logits(const float* emb_in, const float* emb_out, int dim,
                                   const int32_t* walks, const int32_t* centers,
                                   const int32_t* neg_ids, int n_walks, int length,
                                   int window, int n_neg, float* pos_part, float* neg_part,
                                   float* ws, int ws_blocks, void* stream) {
  if (n_walks == 0 || length <= 0) return 0;
  const Geo g = logits_geo(length, dim, n_neg, window);
  ColArgs a{};
  a.emb_in = emb_in;
  a.emb_out = emb_out;
  a.walks = walks;
  a.centers = centers;
  a.neg_ids = neg_ids;
  a.n_walks = n_walks;
  a.pos_part = pos_part;
  a.neg_part = neg_part;
  const int n_groups = (n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(col_pair_logits_kernel, col_pair_logits_kernel_staged, kThreads,
                            logits_smem_bytes(g), n_groups, ws, ws_blocks,
                            static_cast<cudaStream_t>(stream), g, a);
}

// K17 on the model-summed logits.  d_no must be zeroed [n_neg, dim],
// loss_parts must hold 3 * n_walks zeros and done one zero; d_ci, d_co
// [n_walks * 2w * length, dim], sq_ci, sq_co and sq_no are written whole.
extern "C" int n2v_col_pair_grads(const float* emb_in, const float* emb_out, int dim,
                                  const int32_t* walks, const int32_t* centers,
                                  const int32_t* neg_ids, const float* pos_logit,
                                  const float* neg_logit, int n_walks, int length, int window,
                                  int n_neg, float neg_scale, float* d_ci, float* d_co,
                                  float* d_no, float* sq_ci, float* sq_co, float* sq_no,
                                  float* loss_parts, unsigned* done, float* ws, int ws_blocks,
                                  void* stream) {
  if (n_walks == 0 || length <= 0) return 0;
  const Geo g = grads_geo(length, dim, n_neg, window);
  ColArgs a{};
  a.emb_in = emb_in;
  a.emb_out = emb_out;
  a.walks = walks;
  a.centers = centers;
  a.neg_ids = neg_ids;
  a.n_walks = n_walks;
  a.pos_logit = pos_logit;
  a.neg_logit = neg_logit;
  a.neg_scale = neg_scale;
  a.d_ci = d_ci;
  a.d_co = d_co;
  a.d_no = d_no;
  a.sq_ci = sq_ci;
  a.sq_co = sq_co;
  a.sq_no = sq_no;
  a.loss_parts = loss_parts;
  a.done = done;
  const int n_groups = (n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(col_pair_grads_kernel, col_pair_grads_kernel_staged, kThreads,
                            grads_smem_bytes(g), n_groups, ws, ws_blocks,
                            static_cast<cudaStream_t>(stream), g, a);
}
