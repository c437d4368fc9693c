// K13 sgns_pair_grads: the pair-based SGNS step's pair lists and gradients.
//
// Replaces node2vec_tpu/models/skipgram.py:130 make_pairs and the gradient
// half of :168 sgns_train_step_impl (:198-235).  The step works on a flat
// list of P = B * 2w * L1 (center, context) lanes in the JAX order (walk,
// offset, position); each lane gathers its own rows, and every output is
// per lane.  The row-wise Adagrad that follows is K3 + K4 (adagrad.cu) over
// three lists: d_ci at the center rows, d_co at the context rows, d_no at
// the shared negatives.
//
// Two launches:
//  1. pair lists, one thread a lane: centers[p] and contexts[p] are the
//     lane's vertex ids, or -1 where the lane is invalid (either id < 0,
//     |d| > the position's shrunk window b, or either id out of the
//     vocabulary) -- make_pairs' rule.  make_pairs on the card returns this
//     launch's output in the JAX form (id 0 and valid=False).
//  2. gradients, on launch 1's centers.  A lane's center is a walk position
//     i and its context the position i + d of the same walk, so the lane's
//     rows are the walk's: ci = emb_in[walk[i]], co = emb_out[walk[i + d]].
//     With mult[i] the valid lanes of center i:
//       d_ci[p] = g_pos[p] * co[p] + GN[i],  GN = Gneg . NO     (0 where invalid)
//       d_co[p] = g_pos[p] * ci[p]                              (0 where invalid)
//       d_no    = (mult * Gneg)^T . X_in
//     Gneg = sigmoid(X_in . NO^T) * K/S on centers with a valid lane: the
//     JAX function, with its sums over lanes taken once a center.
//
// Bound on an H100: memory.  The per-lane gradients the JAX function defines
// are the largest output: 2 * P * D * 4 bytes written (550 MB at B = 2,560,
// L1 = 21, w = 5, D = 128, 0.164 ms), which K3/K4 then read back per
// occurrence.  The products are K2's (sgns.cu) on the same walk positions,
// so launch 2 is built on K2's walk-group machinery (tf32_tiles.cuh):
//
// * Walk groups of G = 64 / L1 walks in an M-tile of Mt rows, D in chunks
//   of KC columns through K2's ring of two gathered stages (X_in and X_out
//   at the group's positions; dead positions and a ragged last group's
//   missing walks zero-filled).  The group's row table and its lanes'
//   centers land by cp.async a group ahead.
// * Pass 1 is K2's: NL += X_in . NO^T in 16 x 16 tiles and the positive
//   logits, PL += X_in . X_out^T in the 16 x 8 tiles that meet the band
//   |i - j| <= w, on 3xTF32 mma.sync.  The elementwise phase reads each
//   valid lane's logit PL[i, i + d] into g_pos[offset][row], counts mult,
//   and makes Gneg and mult * Gneg.
// * Pass 2, a chunk at a time: GN_c = Gneg . NO_c into shared memory and
//   the block's d_no partial += (mult * Gneg)^T . X_in_c (K2's 16 x 32 warp
//   tiles); then the store phase writes the group's lane rows, which are
//   one contiguous run of G * 2w * L1 rows of each output: every thread 16
//   bytes of d_ci and of d_co a row, a warp 2 (or 4) rows of 256 (128)
//   contiguous bytes.  The stores are fire-and-forget: the next chunk's
//   gather is already in flight (issued at the item's top), and other
//   blocks' products run while this one's stores drain.
// * NO [S, D] and the block's d_no partial stay in shared memory; the
//   partial is added once a block with 16-byte atomics.  Loss partials go
//   to loss_parts[block] (pos, neg without the K/S factor, valid lanes).
//
// Staging: a shape whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); there the gathers are plain copies.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tiles;

constexpr int kListThreads = 256;  // launch 1's block

__global__ void __launch_bounds__(kListThreads)
pair_lists_kernel(const int32_t* __restrict__ walks, const int32_t* __restrict__ b_sh,
                  const uint8_t* __restrict__ vocab_mask, int n_walks, int length,
                  int window, int32_t* __restrict__ centers,
                  int32_t* __restrict__ contexts) {
  const int W2 = 2 * window;
  const int64_t n = static_cast<int64_t>(n_walks) * W2 * length;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kListThreads + threadIdx.x;
  if (p >= n) return;
  const int i = static_cast<int>(p % length);
  const int64_t t = p / length;
  const int o = static_cast<int>(t % W2);
  const int64_t base = (t / W2) * length;
  const int d = offset_of(o, window), j = i + d;
  const int c = walks[base + i];
  const int x = (j >= 0 && j < length) ? walks[base + j] : -1;  // -1 padded
  bool valid = c >= 0 && x >= 0 && abs(d) <= b_sh[base + i];
  valid = valid && vocab_mask[c] && vocab_mask[x];
  centers[p] = valid ? c : -1;
  contexts[p] = valid ? x : -1;
}

struct K13Args {
  const float* emb_in;
  const float* emb_out;
  const int32_t* walks;
  const int32_t* centers;
  const int32_t* neg_ids;
  int n_walks;
  float neg_scale;
  float* d_ci;
  float* d_co;
  float* d_no;
  float* loss_parts;
};

// A group's rows and lanes (in shared memory):
//   tab [2 parities][Mt]  the walk's vertex ids, the rows of X_in and X_out;
//                         -1 where the position is dead or past a ragged
//                         last group; loaded a group ahead (the gather of a
//                         group's first item is issued in the previous one);
//   cen [2w * Mt]         the group's lanes' centers, in lane order (walk,
//                         offset, position), >= 0 where the lane is valid;
//                         loaded at the group's first item, read from its
//                         elementwise phase on.
size_t smem_bytes(const Geo& g) {
  const size_t floats =
      common_floats(g) +                                   // NO, d_no, ring
      2 * static_cast<size_t>(g.Mt) * g.ldg +              // NL / Gneg, mult * Gneg
      static_cast<size_t>(g.Mt) * (g.ldb > g.ldc ? g.ldb : g.ldc) +  // PL, then GN_c
      static_cast<size_t>(g.Mt) * (2 + 2 * g.W + 1 + 2 * g.W);  // tab, cen; mult, g_pos
  return floats * sizeof(float);
}

Geo pick_geo(int length, int dim, int n_neg, int window) {
  return tiles::pick_geo(length, dim, n_neg, window, [](const Geo& g) { return smem_bytes(g); });
}

// Group q's tab (cp.async into shared memory).
template <bool kShared>
__device__ __forceinline__ void load_tab(int* tab, const Geo& g, const K13Args& a, int q) {
  const Item it = group_of(g, a.n_walks, q);
  for (int r = threadIdx.x; r < g.Mt; r += kThreads) {
    if (r < it.rows)
      copy_int<kShared>(tab + r, a.walks + it.row0 + r);
    else
      tab[r] = -1;
  }
}

// Group it's lanes' centers (cp.async into shared memory).
template <bool kShared>
__device__ __forceinline__ void load_centers(int* cen, const Geo& g, const K13Args& a,
                                             const Item& it) {
  const int64_t lane0 = it.row0 * 2 * g.W;
  for (int p = threadIdx.x; p < it.rows * 2 * g.W; p += kThreads)
    copy_int<kShared>(cen + p, a.centers + lane0 + p);
}

// ---- one block's work -----------------------------------------------------

// Every array carved from sm: the dynamic shared memory, or the block's
// slice of a global workspace (staging.cuh).
template <bool kShared>
__device__ __forceinline__ void pair_grads_block(float* sm, const Geo& g, const K13Args& a) {
  float* no = sm;                                  // [Sp, ldn] the shared negatives' rows
  float* dno = no + g.Sp * g.ldn;                  // [Sp, ldn] the block's d_no partial
  float* ring = dno + g.Sp * g.ldn;                // [kStages][2][Mt, ldx]
  float* nlg = ring + kStages * 2 * g.Mt * g.ldx;  // [Mt, ldg] NL, then Gneg
  float* gm = nlg + g.Mt * g.ldg;                  // [Mt, ldg] mult * Gneg
  float* plb = gm + g.Mt * g.ldg;  // [Mt, ldb] PL; in pass 2 GN_c [Mt, ldc]
  float* gn = plb;
  int* tabs = reinterpret_cast<int*>(plb + g.Mt * (g.ldb > g.ldc ? g.ldb : g.ldc));  // [2][Mt]
  int* cen = tabs + 2 * g.Mt;                                        // [2w * Mt]
  float* mult = reinterpret_cast<float*>(cen + 2 * g.W * g.Mt);      // [Mt]
  float* gpos = mult + g.Mt;                    // [2w][Mt] g_pos of each lane
  float* red = gpos + 2 * g.W * g.Mt;           // [3 * kWarps]
  uint64_t* mbars = reinterpret_cast<uint64_t*>(red + 3 * kWarps);  // [2] the ring's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = g.L, D = g.D, S = g.S, W = g.W, Mt = g.Mt, Sp = g.Sp, KC = g.KC;
  const int W2 = 2 * W;
  const int n_mine = my_groups(g, a.n_walks);
  const int n_items = n_mine * 2 * g.nc;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.emb_out) % 16 == 0);
  const bool vec_out = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.d_ci) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(a.d_co) % 16 == 0);
  const bool bulk = kShared && vec;  // the ring fills by bulk copies

  // prologue: group 0's table, then NO and item 0's chunks in flight
  if (n_items > 0) load_tab<kShared>(tabs, g, a, 0);
  if (bulk) init_ring(mbars, Mt);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  load_negatives<kShared>(no, dno, g, a.emb_out, D, a.neg_ids, vec);
  if (n_items > 0)
    gather<kShared>(ring, g, Rows{a.emb_in, a.emb_out, D, tabs, tabs}, 0, vec,
                    smem_addr(mbars));
  cp_commit();
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  const int per_row = KC / 4;  // threads a row of a chunk, 4 columns each
  const int col = 4 * (tid % per_row), step = kThreads / per_row;
  const int mt16 = Mt / 16, sp16 = Sp / 16;
  // pass 2's warp tiles: 16 x 32 (4 mma tiles) in shared memory; 16 x 16 in
  // a global workspace (as K2)
  constexpr int kP2Tiles = kShared ? 4 : 2;
  const int kc2 = KC / (8 * kP2Tiles);  // pass 2's warp tiles across a chunk
  const int n_gn = mt16 * kc2, n_dno = sp16 * kc2;

  for (int t = 0; t < n_items; ++t) {
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage is free
    if (t + 1 < n_items) {
      const int* tab = tabs + (((t + 1) / (2 * g.nc)) & 1) * Mt;
      gather<kShared>(ring + ((t + 1) % kStages) * 2 * Mt * g.ldx, g,
                      Rows{a.emb_in, a.emb_out, D, tab, tab}, t + 1, vec,
                      smem_addr(mbars + (t + 1) % kStages));
    }
    const Item it = item_of(g, a.n_walks, t);
    if (it.pass == 0 && it.chunk == 0) {  // landed by the next item's top
      load_centers<kShared>(cen, g, a, it);
      if (it.q + 1 < n_mine) load_tab<kShared>(tabs + ((it.q + 1) & 1) * Mt, g, a, it.q + 1);
    }
    cp_commit();

    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;
    const float* xout = xin + Mt * g.ldx;
    const int c0 = it.chunk * KC;

    if (it.pass == 0) {  // pass 1: K2's NL and banded PL
      pass1_products(g, it.chunk, xin, g.ldx, no + c0, nlg, xout, plb);
      continue;
    }

    if (it.chunk == 0) {
      // the elementwise phase: mult, then Gneg, mult * Gneg and each valid
      // lane's g_pos
      for (int r = tid; r < Mt; r += kThreads) {
        float m = 0.f;
        if (r < it.rows) {
          const int* lanes = cen + (r / L) * W2 * L + r % L;
          for (int o = 0; o < W2; ++o) m += lanes[o * L] >= 0 ? 1.f : 0.f;
        }
        mult[r] = m;
        mult_acc += m;
      }
      __syncthreads();
      for (int r = warp; r < Mt; r += kWarps) {  // a warp a row
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
        const int* lanes = cen + (r / L) * W2 * L + r % L;
        for (int o = lane; o < W2; o += 32) {
          float gp = 0.f;
          if (m > 0.f && lanes[o * L] >= 0) {
            const float pl = plb[r * g.ldb + r + offset_of(o, W)];
            float l1pe;
            gp = sigmoid_log1pe(pl, l1pe) - 1.f;
            pos_acc += fminf(pl, 0.f) - l1pe;  // log sigmoid(pl)
          }
          gpos[o * Mt + r] = gp;
        }
      }
      __syncthreads();
    }

    // pass 2: GN_c (over PL, read no more) and the d_no partial on the
    // tensor cores, then the group's lane rows of this chunk's columns
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

    // the store phase: lane row lr of the group is (walk ql, offset o,
    // position i), row r = ql * L1 + i of the tile; lr advances by `step`
    const int n_lanes = it.rows * W2;
    const int64_t lane0 = it.row0 * W2;
    int lr = tid / per_row, i = lr % L, o = (lr / L) % W2, ql = lr / (W2 * L);
    for (; lr < n_lanes; lr += step) {
      const int r = ql * L + i;
      float4 ci = make_float4(0.f, 0.f, 0.f, 0.f), co = ci;
      if (cen[lr] >= 0) {
        const float gp = gpos[o * Mt + r];
        const float4 xo =
            *reinterpret_cast<const float4*>(xout + (r + offset_of(o, W)) * g.ldx + col);
        ci = fma4(gp, xo, *reinterpret_cast<const float4*>(gn + r * g.ldc + col));
        co = scale4(gp, *reinterpret_cast<const float4*>(xin + r * g.ldx + col));
      }
      store4(a.d_ci + (lane0 + lr) * D, c0 + col, D, vec_out, ci);
      store4(a.d_co + (lane0 + lr) * D, c0 + col, D, vec_out, co);
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
}

__global__ void __launch_bounds__(kThreads, 1) sgns_pair_grads_kernel(Geo g, K13Args a) {
  extern __shared__ __align__(16) float sm[];
  pair_grads_block<true>(sm, g, a);
}

__global__ void __launch_bounds__(kThreads, 1)
sgns_pair_grads_kernel_staged(Geo g, K13Args a, float* ws, int64_t ws_stride) {
  pair_grads_block<false>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

}  // namespace

// Bytes of shared memory a block of launch 2 takes (or of workspace it
// stages in).
extern "C" size_t n2v_sgns_pair_grads_smem(int length, int dim, int n_neg, int window) {
  return smem_bytes(pick_geo(length, dim, n_neg, window));
}

// Launch 1: centers and contexts [n_walks * 2w * length], -1 where invalid.
extern "C" int n2v_pair_lists(const int32_t* walks, const int32_t* b_sh,
                              const uint8_t* vocab_mask, int n_walks, int length,
                              int window, int32_t* centers, int32_t* contexts,
                              void* stream) {
  const int64_t n = static_cast<int64_t>(n_walks) * 2 * window * length;
  if (n == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kListThreads - 1) / kListThreads);
  pair_lists_kernel<<<grid, kListThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      walks, b_sh, vocab_mask, n_walks, length, window, centers, contexts);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2, on launch 1's centers.  loss_parts must hold 3 * n_walks zeros;
// d_no must be zeroed [n_neg, dim]; d_ci and d_co [n_walks * 2w * length,
// dim] are written whole.  ws null: the blocks stage in shared memory; else
// in ws, ws_blocks blocks of n2v::staging_stride(n2v_sgns_pair_grads_smem(...))
// floats (staging.cuh).
extern "C" int n2v_sgns_pair_grads(const float* emb_in, const float* emb_out, int dim,
                                   const int32_t* walks, const int32_t* centers,
                                   const int32_t* neg_ids, int n_walks, int length,
                                   int window, int n_neg, float neg_scale, float* d_ci,
                                   float* d_co, float* d_no, float* loss_parts, float* ws,
                                   int ws_blocks, void* stream) {
  if (n_walks == 0 || length <= 0 || window <= 0) return 0;
  const Geo g = pick_geo(length, dim, n_neg, window);
  const K13Args a{emb_in, emb_out, walks, centers, neg_ids, n_walks, neg_scale,
                  d_ci, d_co, d_no, loss_parts};
  const int n_groups = (n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(sgns_pair_grads_kernel, sgns_pair_grads_kernel_staged, kThreads,
                            smem_bytes(g), n_groups, ws, ws_blocks,
                            static_cast<cudaStream_t>(stream), g, a);
}
