// K2 sgns_grads: the gradient half of one walk-structured SGNS step.
//
// Replaces node2vec_tpu/models/skipgram.py:344-398 (inside
// sgns_walk_step_impl, :261): the positional positive pairs over window
// offsets +-1..+-w with the shrunk-window mask, the positive grads g_in /
// g_out (the latter through the -d shift), the per-center multiplicity, the
// shared-negative logits nl = x_in . no^T, g_neg = sigmoid(nl) * mult * K/S,
// g_in += g_neg . no, d_no = g_neg^T . x_in, and both loss sums.  The
// row-wise Adagrad that follows is K3 + K4 (adagrad.cu).
//
// Bound on an H100: 6 * B * L1 * D * (S + 2w) flops at the fp32 rate
// (3.05 GFLOP at B = 2,560, L1 = 21, D = 128, S = 64, w = 5: 0.0456 ms),
// against 110.6 MB of row reads and grad writes (0.033 ms).  The products
// are matrix products, so the design puts them on the tensor cores:
//
// * Walk groups.  A persistent grid (one block of 16 warps an SM) walks
//   over groups of G = 64 / L1 walks (one walk when L1 > 64): the group's
//   G * L1 positions make the rows of one M-tile of Mt = G * L1 rounded up
//   to 16 (L1 = 21: 3 walks, 63 of 64 rows).  Its negative half is three
//   products,
//     NL = X_in . NO^T [Mt, S],  g_in += Gneg . NO,  d_no += Gneg^T . X_in,
//   and its positive half three banded ones on the group's [Mt, Mt] logits
//   PL = X_in . X_out^T, computed only in the 16 x 8 tiles that meet the
//   band |i - j| <= w: Band = (sigmoid(PL) - 1) where (i, j) is a valid
//   pair of one walk, g_in += Band . X_out, g_out += Band^T . X_in.  No dot
//   product is tied to one warp; a warp owns 16 x 16 output tiles in pass
//   1 and 16 x 32 ones in pass 2.
// * fp32 accuracy on TF32 tensor cores (3xTF32).  Every operand is split as
//   a = hi + lo, hi rounded to TF32, and each product accumulates
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32 with mma.sync m16n8k8 (lo
//   is handed over unrounded: the tensor cores read its top 19 bits), about
//   22 bits of each product kept, against TF32's 11 alone.
// * Columns in chunks.  D is cut into chunks of KC = 64 (or 32, where 64
//   does not fit) columns, gathered as [Mt, KC] slices of X_in and X_out.  A
//   group streams its chunks twice: pass 1 accumulates NL and PL over them;
//   then the elementwise phase turns NL into Gneg and PL into Band; pass 2
//   makes each chunk's columns of g_in, g_out and d_no.  Shared memory
//   grows with Mt * KC, S * D and Mt^2, not with L1 * D.
// * Asynchronous gathers.  The chunks come through a ring of two stages,
//   the next chunk (of this group or the next) gathered while the current
//   one computes: a row a bulk copy (cp.async.bulk, completing on the
//   stage's mbarrier) where rows are 16-byte aligned, cp.async 4 B at a time
//   at row stride D + 1.  The row indices come from a table per group, read
//   a group ahead.  Rows of dead positions, dropped routed slots and a
//   ragged last group's missing walks are zero-filled, not read
//   (out-of-vocabulary rows are read, and masked): their grads are 0 either
//   way.
// * NO [S, D] is loaded once a block and stays in shared memory; the
//   block's d_no partial stays there across its groups and is added to the
//   global [S, D] with one 16-byte atomic per 4 elements at the end, so the
//   atomics are grid * S * D, not B * S * D.  Loss partials go to
//   loss_parts[block] (pos, neg without the K/S factor, sum of mult).
//
// Strides: a chunk's and NO's rows are 4 mod 32 floats apart and Gneg's
// and Band's 8 mod 32, with the k index of pass 2's fragments permuted
// (slots t and t + 4 hold k = 2t and 2t + 1), so that most fragment loads
// meet no bank conflict.
//
// Staging: a shape whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); there the gathers are plain copies.
//
// The walk groups, the 3xTF32 products, the gather ring and the group loop
// live in tf32_tiles.cuh, which K9 (cbow.cu) and K13 (sgns_pairs.cu) build
// on as well; this file keeps K2's row tables, elementwise phase and pass 2.
//
// Routed mode (the row-sharded step, node2vec_tpu/parallel/rowsharded_sgns.py
// :270-344): the body is the same; only where a row comes from changes.
// emb_in and emb_out are then the [N * cap, D] buffers the owners sent back
// (K19's gather between two all_to_alls), the row of walk position p is
// emb_in[slot_in[p]] and emb_out[slot_out[p]], negative s is
// emb_out[slot_neg[s]] (K18's request slots: owner * cap + rank, -1 where
// the row was dropped on overflow, which reads as zeros), a position is valid
// only where both its slots are live (ok_in & ok_out), and when any negative
// was dropped every negative term of the step is masked (the JAX step's
// ok_neg.all(), :337), which each block checks from slot_neg itself.
//
// ld is the tables' row stride in floats: D for the [V, D] tables of every
// trainer, D + 1 for the fused [V, D+1] tables of sgns_walk_step_fused
// (skipgram.py:541-596 compute the same gradients from the first D columns;
// the accumulator in column D is read by K14, fused_adagrad.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tiles;

size_t smem_bytes(const Geo& g) {
  const size_t floats = common_floats(g) +                              // NO, d_no, ring
                        static_cast<size_t>(g.Mt) * (g.ldg + g.ldb) +    // NL / Gneg, PL / Band
                        11 * static_cast<size_t>(g.Mt);  // two groups' tables; mult
  return floats * sizeof(float);
}

Geo pick_geo(int length, int dim, int n_neg, int window) {
  return tiles::pick_geo(length, dim, n_neg, window, [](const Geo& g) { return smem_bytes(g); });
}

// Routed mode's request slots (null in the direct mode)
struct Slots {
  const int32_t *in, *out, *neg;
};

struct K2Args {
  const float* emb_in;
  const float* emb_out;
  int ld;  // the tables' row stride (routed: D)
  const int32_t* walks;
  const uint8_t* vocab_mask;
  const int32_t* b_sh;
  const int32_t* neg_ids;
  int n_walks;
  float neg_scale;
  float* g_in;
  float* g_out;
  float* d_no;
  float* loss_parts;
  Slots sl;
};

// A group's row table (in shared memory, one a group parity):
//   tab [2][Mt]  the rows of X_in and X_out in the tables, -1 where the
//                position is dead, a routed slot was dropped or the row is
//                past a ragged last group (its rows zero-filled);
//   wid [Mt]     the walk's vertex id, for the vocabulary lookup;
//   bsh [Mt]     the shrunk window;
//   valid [Mt]   whether the position carries pairs: tab >= 0 and the vertex
//                in the vocabulary, written at the end of the group's first
//                item (out-of-vocabulary rows are gathered, and masked).
struct Table {
  int *tab, *wid, *bsh, *valid;
};

__device__ __forceinline__ Table table_of(int* tabs, int mt, int par) {
  int* base = tabs + par * 5 * mt;
  return Table{base, base + 2 * mt, base + 3 * mt, base + 4 * mt};
}

// one row's entries of a table, read from global memory
struct RowIds {
  int in, out, wid, bsh;
};

template <bool kRouted>
__device__ __forceinline__ RowIds load_row(const K2Args& a, const Item& it, int r) {
  RowIds x{-1, -1, -1, 0};
  if (r < it.rows) {
    const int64_t p = it.row0 + r;
    x.wid = a.walks[p];
    x.bsh = a.b_sh[p];
    if (kRouted) {
      const int si = a.sl.in[p], so = a.sl.out[p];
      const bool ok = x.wid >= 0 && si >= 0 && so >= 0;
      x.in = ok ? si : -1;
      x.out = ok ? so : -1;
    } else {
      x.in = x.out = x.wid >= 0 ? x.wid : -1;
    }
  }
  return x;
}

__device__ __forceinline__ void store_row(const Table& t, int mt, int r, const RowIds& x) {
  t.tab[r] = x.in;
  t.tab[mt + r] = x.out;
  t.wid[r] = x.wid;
  t.bsh[r] = x.bsh;
}

__device__ __forceinline__ Rows rows_of(const K2Args& a, int ld, const int* tab, int mt) {
  return Rows{a.emb_in, a.emb_out, ld, tab, tab + mt};
}

// ---- one block's work -----------------------------------------------------

// Every array carved from sm: the dynamic shared memory, or the block's
// slice of a global workspace (staging.cuh).
template <bool kRouted, bool kShared>
__device__ __forceinline__ void sgns_grads_block(float* sm, const Geo& g, const K2Args& a) {
  float* no = sm;                                    // [Sp, ldn] the shared negatives' rows
  float* dno = no + g.Sp * g.ldn;                    // [Sp, ldn] the block's d_no partial
  float* ring = dno + g.Sp * g.ldn;                  // [kStages][2][Mt, ldx]
  float* nlg = ring + kStages * 2 * g.Mt * g.ldx;    // [Mt, ldg] NL, then Gneg
  float* plb = nlg + g.Mt * g.ldg;                   // [Mt, ldb] PL, then Band
  int* tabs = reinterpret_cast<int*>(plb + g.Mt * g.ldb);  // [2 parities][5][Mt] (Table)
  float* mult = reinterpret_cast<float*>(tabs + 10 * g.Mt);  // [Mt]
  float* red = mult + g.Mt;                                  // [3 * kWarps]
  uint64_t* mbars = reinterpret_cast<uint64_t*>(red + 3 * kWarps);  // [2] the ring's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = g.L, D = g.D, S = g.S, W = g.W, Mt = g.Mt, Sp = g.Sp, KC = g.KC;
  const int n_mine = my_groups(g, a.n_walks);
  const int n_items = n_mine * 2 * g.nc;
  const int ld = kRouted ? D : a.ld;
  const bool vec = ld % 4 == 0 && D % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.emb_out) % 16 == 0);

  // prologue: group 0's table, then NO and item 0's chunks in flight
  const bool bulk = kShared && vec;  // the ring fills by bulk copies
  if (n_items > 0) {
    const Item g0 = group_of(g, a.n_walks, 0);
    const Table t0 = table_of(tabs, Mt, 0);
    for (int r = tid; r < Mt; r += kThreads) store_row(t0, Mt, r, load_row<kRouted>(a, g0, r));
  }
  if (bulk) init_ring(mbars, Mt);
  __syncthreads();
  load_negatives<kShared>(no, dno, g, a.emb_out, ld, kRouted ? a.sl.neg : a.neg_ids, vec);
  if (n_items > 0) gather<kShared>(ring, g, rows_of(a, ld, tabs, Mt), 0, vec, smem_addr(mbars));
  cp_commit();
  float neg_live = 1.f;  // routed: 0 when any negative was dropped
  if (kRouted) {
    for (int s = 0; s < S; ++s)
      if (a.sl.neg[s] < 0) neg_live = 0.f;
  }
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  const int mt16 = Mt / 16, sp16 = Sp / 16;
  // pass 2's warp tiles: 16 x 32 (4 mma tiles) in shared memory; 16 x 16 in
  // a global workspace, where the wider tile's registers cost more than its
  // reuse gains
  constexpr int kP2Tiles = kShared ? 4 : 2;
  const int kc2 = KC / (8 * kP2Tiles);  // pass 2's warp tiles across a chunk
  const int n_gi = mt16 * kc2, n_dno = sp16 * kc2;

  for (int t = 0; t < n_items; ++t) {
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage is free
    if (t + 1 < n_items)
      gather<kShared>(ring + ((t + 1) % kStages) * 2 * Mt * g.ldx, g,
                      rows_of(a, ld, table_of(tabs, Mt, ((t + 1) / (2 * g.nc)) & 1).tab, Mt),
                      t + 1, vec, smem_addr(mbars + (t + 1) % kStages));
    cp_commit();

    const Item it = item_of(g, a.n_walks, t);
    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;
    const float* xout = xin + Mt * g.ldx;
    const int c0 = it.chunk * KC;
    const int par = it.q & 1;
    const Table tb = table_of(tabs, Mt, par);

    if (it.pass == 0) {
      // At a group's first item: its vocabulary flags and the next group's
      // table, loaded first and stored after the products, which hide the
      // loads' latency.  Read from the next item on, after a barrier (the
      // next group's first gather is issued at the top of this group's last
      // item, the second at the earliest).
      const bool first = it.chunk == 0, ahead = first && it.q + 1 < n_mine;
      int ok = 0;
      RowIds nx{-1, -1, -1, 0};
      if (first && tid < Mt) ok = tb.tab[tid] >= 0 && a.vocab_mask[tb.wid[tid]];
      if (ahead && tid < Mt) nx = load_row<kRouted>(a, group_of(g, a.n_walks, it.q + 1), tid);

      // pass 1: NL += X_in . NO^T in 16 x 16 tiles and, in the band's 16 x 8
      // tiles, PL += X_in . X_out^T
      pass1_products(g, it.chunk, xin, g.ldx, no + c0, nlg, xout, plb);

      if (first) {
        for (int r = tid; r < Mt; r += kThreads)  // rows past the threads (L1 > kThreads)
          if (r >= kThreads) tb.valid[r] = tb.tab[r] >= 0 && a.vocab_mask[tb.wid[r]];
        if (tid < Mt) tb.valid[tid] = ok;
      }
      if (ahead) {
        const Item nq = group_of(g, a.n_walks, it.q + 1);
        const Table tn = table_of(tabs, Mt, par ^ 1);
        for (int r = tid; r < Mt; r += kThreads)
          store_row(tn, Mt, r, r < kThreads ? nx : load_row<kRouted>(a, nq, r));
      }
      continue;
    }

    if (it.chunk == 0) {
      // the elementwise phase: multiplicities, then Gneg and Band in place
      const int* valid = tb.valid;
      const int* bsh = tb.bsh;
      for (int r = tid; r < Mt; r += kThreads) {
        float m = 0.f;
        if (valid[r]) {
          const int i = r % L;
          for (int d = 1; d <= W && d <= bsh[r]; ++d) {
            if (i - d >= 0 && valid[r - d]) m += 1.f;
            if (i + d < L && valid[r + d]) m += 1.f;
          }
        }
        mult[r] = m;
        mult_acc += m;
      }
      __syncthreads();
      for (int r = warp; r < Mt; r += kWarps) {  // a warp a row
        const float m = mult[r] * neg_live;
        float* nrow = nlg + r * g.ldg;
        for (int s = lane; s < Sp; s += 32) {
          float out = 0.f;
          if (m > 0.f && s < S) {
            const float nl = nrow[s];
            float l1pe;
            out = sigmoid_log1pe(nl, l1pe) * m * a.neg_scale;
            neg_acc += (fminf(-nl, 0.f) - l1pe) * m;  // log sigmoid(-nl)
          }
          nrow[s] = out;
        }
        const int vr = valid[r], br = min(bsh[r], W), ir = r % L;
        float* prow = plb + r * g.ldb;
        for (int c = lane; c < Mt; c += 32) {
          const int ad = abs(c - r), ic = ir + c - r;  // c's position, if in r's walk
          float out = 0.f;
          if (vr && ad >= 1 && ad <= br && ic >= 0 && ic < L && valid[c]) {
            const float pl = prow[c];
            float l1pe;
            out = sigmoid_log1pe(pl, l1pe) - 1.f;
            pos_acc += fminf(pl, 0.f) - l1pe;  // log sigmoid(pl)
          }
          prow[c] = out;
        }
      }
      __syncthreads();
    }

    // pass 2: this chunk's columns of g_in, d_no and g_out in 16 x 32 warp
    // tiles.  Slots: g_in's tiles first, then d_no's, then g_out's placed
    // so that each lands on the warp of the d_no tile of its index (a g_in
    // tile takes about as long as a d_no and a g_out tile together).
    const int k_live = min(Mt, round_up(it.rows, 8));
    const int go0 = n_gi + round_up(n_dno, kWarps);
    for (int w = warp; w < go0 + n_gi; w += kWarps) {
      float acc[kP2Tiles][4] = {};
      if (w < n_gi) {  // g_in = Gneg . NO + Band . X_out
        const int m0 = (w / kc2) * 16, n0 = (w % kc2) * 8 * kP2Tiles;
        if (m0 >= it.rows) continue;
        mma_tile<kP2Tiles, false, true, true>(acc, nlg, g.ldg, no + c0, g.ldn, m0, n0, KC, 0,
                                              Sp);
        const int kb0 = max(0, m0 - W) / 8 * 8, kb1 = min(Mt, round_up(m0 + 16 + W, 8));
        mma_tile<kP2Tiles, false, true, true>(acc, plb, g.ldb, xout, g.ldx, m0, n0, KC, kb0,
                                              kb1);
        store_grads(acc, a.g_in, it.row0, D, it.rows, m0, c0 + n0);
      } else if (w < n_gi + n_dno) {  // the d_no partial += Gneg^T . X_in
        const int j = w - n_gi, s0 = (j / kc2) * 16, n0 = (j % kc2) * 8 * kP2Tiles;
        if (s0 >= S) continue;
        accumulate_dno<kP2Tiles>(dno + c0, g, nlg, xin, g.ldx, s0, n0, k_live);
      } else if (w >= go0) {  // g_out = Band^T . X_in
        const int j = w - go0, m0 = (j / kc2) * 16, n0 = (j % kc2) * 8 * kP2Tiles;
        if (m0 >= it.rows) continue;
        const int kb0 = max(0, m0 - W) / 8 * 8, kb1 = min(Mt, round_up(m0 + 16 + W, 8));
        mma_tile<kP2Tiles, true, true, true>(acc, plb, g.ldb, xin, g.ldx, m0, n0, KC, kb0, kb1);
        store_grads(acc, a.g_out, it.row0, D, it.rows, m0, c0 + n0);
      }
    }
  }
  cp_wait_all();
  __syncthreads();
  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, mult_acc, a.loss_parts);
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads, 1) sgns_grads_kernel(Geo g, K2Args a) {
  extern __shared__ __align__(16) float sm[];
  sgns_grads_block<kRouted, true>(sm, g, a);
}

template <bool kRouted>
__global__ void __launch_bounds__(kThreads, 1)
sgns_grads_kernel_staged(Geo g, K2Args a, float* ws, int64_t ws_stride) {
  sgns_grads_block<kRouted, false>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

template <bool kRouted>
int launch(int length, int dim, int n_neg, int window, const K2Args& a, float* ws,
           int ws_blocks, void* stream) {
  if (a.n_walks == 0 || length <= 0) return 0;
  const Geo g = pick_geo(length, dim, n_neg, window);
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(sgns_grads_kernel<kRouted>, sgns_grads_kernel_staged<kRouted>,
                            kThreads, smem_bytes(g), n_groups, ws, ws_blocks,
                            static_cast<cudaStream_t>(stream), g, a);
}

}  // namespace

// Bytes of shared memory a block takes (or of workspace it stages in).
extern "C" size_t n2v_sgns_grads_smem(int length, int dim, int n_neg, int window) {
  return smem_bytes(pick_geo(length, dim, n_neg, window));
}

// loss_parts must hold 3 * n_walks zeros; d_no must be zeroed [n_neg, dim];
// the tables are [V, ld] with ld >= dim, their first dim columns read.  ws
// null: the blocks stage in shared memory; else in ws, ws_blocks blocks of
// n2v::staging_stride(n2v_sgns_grads_smem(...)) floats (staging.cuh).
extern "C" int n2v_sgns_grads(const float* emb_in, const float* emb_out, int dim,
                              int ld, const int32_t* walks, const uint8_t* vocab_mask,
                              const int32_t* b_sh, const int32_t* neg_ids,
                              int n_walks, int length, int window, int n_neg,
                              float neg_scale, float* g_in, float* g_out,
                              float* d_no, float* loss_parts, float* ws, int ws_blocks,
                              void* stream) {
  const K2Args a{emb_in, emb_out, ld, walks, vocab_mask, b_sh, neg_ids, n_walks, neg_scale,
                 g_in, g_out, d_no, loss_parts, Slots{nullptr, nullptr, nullptr}};
  return launch<false>(length, dim, n_neg, window, a, ws, ws_blocks, stream);
}

// Routed mode: x_in and x_out are the [N * cap, dim] buffers the owners sent
// back (row stride dim); slot_in, slot_out [n_walks * length] and slot_neg
// [n_neg] the requests' rows in them (-1: dropped).  The shared memory is the
// direct mode's (n2v_sgns_grads_smem); the other arguments are n2v_sgns_grads's.
extern "C" int n2v_sgns_grads_routed(const float* x_in, const float* x_out, int dim,
                                     const int32_t* walks, const uint8_t* vocab_mask,
                                     const int32_t* b_sh, const int32_t* slot_in,
                                     const int32_t* slot_out, const int32_t* slot_neg,
                                     int n_walks, int length, int window, int n_neg,
                                     float neg_scale, float* g_in, float* g_out, float* d_no,
                                     float* loss_parts, float* ws, int ws_blocks,
                                     void* stream) {
  const K2Args a{x_in, x_out, dim, walks, vocab_mask, b_sh, nullptr, n_walks, neg_scale,
                 g_in, g_out, d_no, loss_parts, Slots{slot_in, slot_out, slot_neg}};
  return launch<true>(length, dim, n_neg, window, a, ws, ws_blocks, stream);
}
