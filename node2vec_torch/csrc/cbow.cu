// K9 cbow_grads: the gradient half of one walk-structured CBOW
// negative-sampling step.
//
// Replaces node2vec_tpu/models/cbow.py:112 cbow_walk_step_impl up to the
// optimizer (:148-196, with _context_mean :60 and _scatter_context_grads
// :94).  For every position i, its contexts are the positions j = i + d with
// valid_pos[i] & valid_pos[j] & |d| <= b_sh[i], cnt[i] of them, and
//   h[i]        = sum of the contexts' emb_in rows (/ max(cnt, 1) under cbow_mean),
//   w_c[i]      = valid_pos[i] & cnt[i] > 0 (a trainable center),
//   g_pos[i]    = (sigmoid(h[i] . emb_out[i]) - 1) * w_c[i],
//   g_neg[i, s] = sigmoid(h[i] . no[s]) * w_c[i] * K/S over the S shared negatives,
//   g_h[i]      = g_pos[i] emb_out[i] + sum_s g_neg[i, s] no[s] (/ max(cnt, 1) under
//                 cbow_mean),
//   g_in[j]     = sum of g_h over the centers whose context j is,
//   d_out[i]    = g_pos[i] h[i],  d_no = g_neg^T h,
// with the loss parts (sum of w_c log sigmoid(pos), of w_c log sigmoid(-nl)
// without the K/S factor, and of w_c).  The row-wise Adagrad that follows is
// K3 + K4 (adagrad.cu) over (g_in, walks), (d_out, walks), (d_no, negatives).
//
// Bound on an H100: operations, about (6 S + 7) D flops a trainable center
// (the [B*L1, S] logits, g_neg . no and g_neg^T . h dominate) and 2 D a
// (center, context) pair, at the fp32 rate, against the distinct rows read
// and the live rows' grads written.  The three products over the S negatives
// are K2's negative half (sgns.cu), so the design is K2's, on its walk-group
// machinery (tf32_tiles.cuh):
//
// * Walk groups.  A persistent grid (one block of 16 warps an SM) walks over
//   groups of G = 64 / L1 walks (one walk when L1 > 64), the group's
//   positions the rows of one M-tile of Mt rows; D in chunks of KC = 64 (or
//   32) columns through K2's ring of two gathered stages ([Mt, KC] of X_in
//   and X_out a stage: bulk copies on an mbarrier, cp.async at unaligned
//   rows).  Rows of dead positions and of a ragged last group's missing
//   walks are zero-filled, not read.
// * Context sums on the CUDA cores.  H_c = A . X_in_c, A the group's fixed
//   banded [Mt, Mt] matrix (1 where j is a context of i in the same walk),
//   is at most 2w row additions an element: each thread sums its 4 columns
//   of a row over the row's contexts (float4 loads from the ring) in the
//   JAX order of offsets, and divides by cnt under cbow_mean, as the plain
//   version does.  The band holds 2w of Mt entries a row, so a banded
//   tensor-core product would spend most of its tiles on zeros.
// * Pass 1, a chunk at a time: H_c, the positive logits' partial dots
//   (h . x_out over the chunk, summed across the row's threads by shuffles)
//   and NL += H_c . NO_c^T on 3xTF32 mma.sync (K2's 16 x 16 tiles).
// * The elementwise phase (the group's first pass-2 item): g_pos, Gneg =
//   sigmoid(NL) * w_c * K/S in place, the loss parts; and the next group's
//   vocabulary flags and context counts, from its table, read a group ahead.
// * H kept or remade.  Where the whole [Mt, D] H fits in shared memory
//   beside the rest (the main path's shape: L1 = 21, D = 128), pass 1 keeps
//   it and pass 2 reads it (0.260 against 0.291 ms summing again, on an
//   H100 at that shape); elsewhere pass 2 remakes H_c from the ring, through
//   which the chunk comes again, so that shared memory grows with D only
//   through NO and d_no, as in K2.
// * Pass 2, a chunk at a time: H_c and d_out = g_pos * H_c stored; G_h =
//   Gneg . NO_c + g_pos * X_out_c (/ cnt) into shared memory and the block's d_no partial
//   += Gneg^T . H_c on the tensor cores (K2's 16 x 32 warp tiles); then g_in
//   = A^T . G_h, the band again, on the CUDA cores.  g_in and d_out are
//   written whole, zero on rows that get nothing.
// * NO [S, D] stays in shared memory; the block's d_no partial too, added
//   to the global d_no once a block with 16-byte atomics.  Loss partials go
//   to loss_parts[block].
//
// Staging: a shape whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); there the gathers are plain copies.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tiles;

struct K9Args {
  const float* emb_in;
  const float* emb_out;
  const int32_t* walks;
  const uint8_t* vocab_mask;
  const int32_t* b_sh;
  const int32_t* neg_ids;
  int n_walks;
  float neg_scale;
  int cbow_mean;
  int keep_h;  // H is kept from pass 1 ([Mt, Dp]), else remade in pass 2 ([Mt, KC])
  float* g_in;
  float* d_out;
  float* d_no;
  float* loss_parts;
};

// A group's table (in shared memory, one a group parity):
//   tab [Mt]    the walk's vertex ids, the rows of X_in and X_out; -1 where
//               the position is dead or past a ragged last group;
//   bsh [Mt]    the shrunk window;
//   valid [Mt]  tab >= 0 and the vertex in the vocabulary;
//   cnt [Mt]    the context count.
// tab and bsh land by cp.async a group ahead; valid and cnt are made in the
// previous group's elementwise phase (group 0's in the prologue).
struct Table {
  int *tab, *bsh, *valid;
  float* cnt;
};

__device__ __forceinline__ Table table_of(int* tabs, int mt, int par) {
  int* base = tabs + par * 4 * mt;
  return Table{base, base + mt, base + 2 * mt, reinterpret_cast<float*>(base + 3 * mt)};
}

// H's row stride: the whole [Mt, Dp] kept from pass 1, or a chunk's
__host__ __device__ inline int h_stride(const Geo& g, bool keep_h) {
  return keep_h ? g.ldn : g.ldx;
}

size_t smem_bytes(const Geo& g, bool keep_h) {
  const size_t floats = common_floats(g) +  // NO, d_no, ring
                        static_cast<size_t>(g.Mt) * (g.ldg + h_stride(g, keep_h) + g.ldc) +
                        10 * static_cast<size_t>(g.Mt);  // NL, H, G_h; two tables; pl, g_pos
  return floats * sizeof(float);
}

// The chunk width of tiles::pick_geo; H kept from pass 1 where the whole
// [Mt, Dp] of it fits in shared memory at that width (then pass 2 reads it
// instead of summing the band again), else remade from the ring in pass 2.
Geo pick_geo(int length, int dim, int n_neg, bool& keep_h) {
  const Geo g = tiles::pick_geo(length, dim, n_neg, 0,
                                [](const Geo& x) { return smem_bytes(x, false); });
  keep_h = smem_bytes(g, true) <= kSmemOptin;
  return g;
}

// Group q's tab and bsh into t (cp.async into shared memory).
template <bool kShared>
__device__ __forceinline__ void load_table(const Table& t, const Geo& g, const K9Args& a,
                                           int q) {
  const Item it = group_of(g, a.n_walks, q);
  for (int r = threadIdx.x; r < g.Mt; r += kThreads) {
    if (r < it.rows) {
      copy_int<kShared>(t.tab + r, a.walks + it.row0 + r);
      copy_int<kShared>(t.bsh + r, a.b_sh + it.row0 + r);
    } else {
      t.tab[r] = -1;
      t.bsh[r] = 0;
    }
  }
}

// The band's loops run over the 2w window offsets in the JAX order, each
// tested against the walk's ends and the shrunk window.  (Written over d in
// [max(-b, -i), min(b, L1 - 1 - i)] instead, the sums built by nvcc 12.8
// took offsets past the upper bound on an H100, for rows at some i mod 4.)
// The sums are branch-free: every offset loads a row of the tile (the row
// itself where the offset leaves the walk) and adds it with weight 1 or 0
// through fmaf, which gives the conditional sum's bits, so that the loads
// of the offsets can be in flight together.

// whether row r + d of the tile is a context of row r (position i of its
// walk, shrunk window b)
__device__ __forceinline__ bool is_context(const Table& t, const Geo& g, int r, int i, int b,
                                           int d) {
  return abs(d) <= b && i + d >= 0 && i + d < g.L && t.valid[r + d];
}

// cnt of each row of t, from its valid flags and shrunk windows
__device__ __forceinline__ void context_counts(const Table& t, const Geo& g) {
  for (int r = threadIdx.x; r < g.Mt; r += kThreads) {
    float c = 0.f;
    if (t.valid[r]) {
      const int i = r % g.L, b = t.bsh[r];
      for (int o = 0; o < 2 * g.W; ++o) c += is_context(t, g, r, i, b, offset_of(o, g.W));
    }
    t.cnt[r] = c;
  }
}

// Row r's context sum over this thread's 4 columns `col` of the chunk x
// ([Mt, ldx]), divided by cnt under cbow_mean; zero where r is not valid.
__device__ __forceinline__ float4 context_sum(const Table& t, const Geo& g, const float* x, int r,
                                              int col, bool mean) {
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!t.valid[r]) return h;
  const int i = r % g.L, b = t.bsh[r];
#pragma unroll 4
  for (int o = 0; o < 2 * g.W; ++o) {
    const int d = offset_of(o, g.W);
    const bool in = i + d >= 0 && i + d < g.L;
    const int j = in ? r + d : r;
    const int v = t.valid[j];
    h = fma4(in && abs(d) <= b && v ? 1.f : 0.f,
             *reinterpret_cast<const float4*>(x + j * g.ldx + col), h);
  }
  if (mean) {
    const float c = fmaxf(t.cnt[r], 1.f);
    h = make_float4(h.x / c, h.y / c, h.z / c, h.w / c);
  }
  return h;
}

// g_in of row j over this thread's 4 columns: the sum of G_h ([Mt, ldc]) over
// the centers c = j - d whose context j is
__device__ __forceinline__ float4 context_scatter(const Table& t, const Geo& g, const float* gh,
                                                  int j, int col) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!t.valid[j]) return s;
  const int i = j % g.L;
#pragma unroll 4
  for (int o = 0; o < 2 * g.W; ++o) {  // center c = j - d sees j at offset d
    const int d = offset_of(o, g.W);
    const bool in = i - d >= 0 && i - d < g.L;
    const int c = in ? j - d : j;
    const int v = t.valid[c], bc = t.bsh[c];
    s = fma4(in && abs(d) <= bc && v ? 1.f : 0.f,
             *reinterpret_cast<const float4*>(gh + c * g.ldc + col), s);
  }
  return s;
}

// ---- one block's work -----------------------------------------------------

// Every array carved from sm: the dynamic shared memory, or the block's
// slice of a global workspace (staging.cuh).
template <bool kShared>
__device__ __forceinline__ void cbow_grads_block(float* sm, const Geo& g, const K9Args& a) {
  float* no = sm;                                  // [Sp, ldn] the shared negatives' rows
  float* dno = no + g.Sp * g.ldn;                  // [Sp, ldn] the block's d_no partial
  float* ring = dno + g.Sp * g.ldn;                // [kStages][2][Mt, ldx]
  float* nlg = ring + kStages * 2 * g.Mt * g.ldx;  // [Mt, ldg] NL, then Gneg
  float* hc = nlg + g.Mt * g.ldg;                  // [Mt, ldh] H (or H_c)
  const int ldh = h_stride(g, a.keep_h);
  float* gh = hc + g.Mt * ldh;                     // [Mt, ldc] G_h of the chunk
  int* tabs = reinterpret_cast<int*>(gh + g.Mt * g.ldc);  // [2 parities][4][Mt] (Table)
  float* pl = reinterpret_cast<float*>(tabs + 8 * g.Mt);  // [Mt] positive logits
  float* gpos = pl + g.Mt;                                // [Mt]
  float* red = gpos + g.Mt;                               // [3 * kWarps]
  uint64_t* mbars = reinterpret_cast<uint64_t*>(red + 3 * kWarps);  // [2] the ring's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = g.D, S = g.S, Mt = g.Mt, Sp = g.Sp, KC = g.KC;
  const bool mean = a.cbow_mean != 0;
  const int n_mine = my_groups(g, a.n_walks);
  const int n_items = n_mine * 2 * g.nc;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.emb_out) % 16 == 0);
  const bool vec_out = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.g_in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(a.d_out) % 16 == 0);
  const bool bulk = kShared && vec;  // the ring fills by bulk copies

  // prologue: group 0's table, flags and counts; NO and item 0's chunks in flight
  const Table t0 = table_of(tabs, Mt, 0);
  if (n_items > 0) load_table<kShared>(t0, g, a, 0);
  if (bulk) init_ring(mbars, Mt);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  if (n_items > 0)
    for (int r = tid; r < Mt; r += kThreads)
      t0.valid[r] = t0.tab[r] >= 0 && a.vocab_mask[t0.tab[r]];
  load_negatives<kShared>(no, dno, g, a.emb_out, D, a.neg_ids, vec);
  if (n_items > 0)
    gather<kShared>(ring, g, Rows{a.emb_in, a.emb_out, D, t0.tab, t0.tab}, 0, vec,
                    smem_addr(mbars));
  cp_commit();
  __syncthreads();
  if (n_items > 0) context_counts(t0, g);
  float pos_acc = 0.f, neg_acc = 0.f, ctr_acc = 0.f;

  const int per_row = KC / 4;  // threads a row of a chunk, 4 columns each
  const int col = 4 * (tid % per_row);
  const int mt16 = Mt / 16, sp16 = Sp / 16;
  // pass 2's warp tiles: 16 x 32 (4 mma tiles) in shared memory; 16 x 16 in
  // a global workspace (as K2)
  constexpr int kP2Tiles = kShared ? 4 : 2;
  const int kc2 = KC / (8 * kP2Tiles);  // pass 2's warp tiles across a chunk
  const int n_gh = mt16 * kc2, n_dno = sp16 * kc2;

  for (int t = 0; t < n_items; ++t) {
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage is free
    if (t + 1 < n_items) {
      const int* tab = table_of(tabs, Mt, ((t + 1) / (2 * g.nc)) & 1).tab;
      gather<kShared>(ring + ((t + 1) % kStages) * 2 * Mt * g.ldx, g,
                      Rows{a.emb_in, a.emb_out, D, tab, tab}, t + 1, vec,
                      smem_addr(mbars + (t + 1) % kStages));
    }
    const Item it = item_of(g, a.n_walks, t);
    const int par = it.q & 1;
    const bool ahead = it.q + 1 < n_mine;
    const Table tb = table_of(tabs, Mt, par), tn = table_of(tabs, Mt, par ^ 1);
    // the next group's table, read by the elementwise phase (a later item)
    if (ahead && it.pass == 0 && it.chunk == 0) load_table<kShared>(tn, g, a, it.q + 1);
    cp_commit();

    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;
    const float* xout = xin + Mt * g.ldx;
    const int c0 = it.chunk * KC;
    float* hcc = hc + (a.keep_h ? c0 : 0);  // the chunk's columns of H

    if (it.pass == 0) {
      // pass 1: H_c and the positive logits' partial dots, then NL += H_c . NO_c^T
      for (int r = tid / per_row; r < Mt; r += kThreads / per_row) {
        const float4 h = context_sum(tb, g, xin, r, col, mean);
        *reinterpret_cast<float4*>(hcc + r * ldh + col) = h;
        const float4 xo = *reinterpret_cast<const float4*>(xout + r * g.ldx + col);
        float p = h.x * xo.x + h.y * xo.y + h.z * xo.z + h.w * xo.w;
        for (int off = per_row / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
        if (col == 0) pl[r] = it.chunk == 0 ? p : pl[r] + p;
      }
      __syncthreads();
      pass1_products(g, it.chunk, hcc, ldh, no + c0, nlg, nullptr, nullptr);
      continue;
    }

    if (it.chunk == 0) {
      // the elementwise phase: g_pos and Gneg (in place of NL), the loss
      // parts; the next group's vocabulary flags, loaded first
      int vn = 0;
      if (ahead && tid < Mt) vn = tn.tab[tid] >= 0 && a.vocab_mask[tn.tab[tid]];
      for (int r = warp; r < Mt; r += kWarps) {  // a warp a row
        const bool wc = tb.valid[r] && tb.cnt[r] > 0.f;
        float* nrow = nlg + r * g.ldg;
        for (int s = lane; s < Sp; s += 32) {
          float out = 0.f;
          if (wc && s < S) {
            const float nl = nrow[s];
            float l1pe;
            out = sigmoid_log1pe(nl, l1pe) * a.neg_scale;
            neg_acc += fminf(-nl, 0.f) - l1pe;  // log sigmoid(-nl)
          }
          nrow[s] = out;
        }
        if (lane == 0) {
          float gp = 0.f;
          if (wc) {
            float l1pe;
            gp = sigmoid_log1pe(pl[r], l1pe) - 1.f;
            pos_acc += fminf(pl[r], 0.f) - l1pe;  // log sigmoid(pl)
            ctr_acc += 1.f;
          }
          gpos[r] = gp;
        }
      }
      if (ahead) {
        for (int r = tid; r < Mt; r += kThreads)  // rows past the threads (L1 > kThreads)
          if (r >= kThreads) tn.valid[r] = tn.tab[r] >= 0 && a.vocab_mask[tn.tab[r]];
        if (tid < Mt) tn.valid[tid] = vn;
      }
      __syncthreads();
      if (ahead) context_counts(tn, g);  // read from the next group's first item
    }

    // pass 2: H_c (kept, or summed again) and d_out = g_pos * H_c; then G_h
    // and the d_no partial on the tensor cores; then g_in = A^T . G_h
    for (int r = tid / per_row; r < Mt; r += kThreads / per_row) {
      float4 h;
      if (a.keep_h) {
        h = *reinterpret_cast<const float4*>(hcc + r * ldh + col);
      } else {
        h = context_sum(tb, g, xin, r, col, mean);
        *reinterpret_cast<float4*>(hcc + r * ldh + col) = h;
      }
      if (r < it.rows) store4(a.d_out + (it.row0 + r) * D, c0 + col, D, vec_out, scale4(gpos[r], h));
    }
    __syncthreads();
    const int k_live = min(Mt, round_up(it.rows, 8));
    const int lq = lane >> 2, tq = lane & 3;
    for (int w = warp; w < n_gh + n_dno; w += kWarps) {
      if (w < n_gh) {  // G_h = Gneg . NO_c + g_pos * X_out_c (/ cnt)
        const int m0 = (w / kc2) * 16, n0 = (w % kc2) * 8 * kP2Tiles;
        if (m0 >= it.rows) continue;
        float acc[kP2Tiles][4] = {};
        mma_tile<kP2Tiles, false, true, true>(acc, nlg, g.ldg, no + c0, g.ldn, m0, n0, KC, 0,
                                              Sp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + lq + 8 * h;
          const float gp = gpos[r], c = mean ? fmaxf(tb.cnt[r], 1.f) : 1.f;
#pragma unroll
          for (int j = 0; j < kP2Tiles; ++j) {
            const int cc = n0 + 8 * j + 2 * tq;
            const float2 xo = *reinterpret_cast<const float2*>(xout + r * g.ldx + cc);
            float v0 = fmaf(gp, xo.x, acc[j][2 * h]), v1 = fmaf(gp, xo.y, acc[j][2 * h + 1]);
            if (mean) {
              v0 /= c;
              v1 /= c;
            }
            *reinterpret_cast<float2*>(gh + r * g.ldc + cc) = make_float2(v0, v1);
          }
        }
      } else {  // the d_no partial += Gneg^T . H_c
        const int j = w - n_gh, s0 = (j / kc2) * 16, n0 = (j % kc2) * 8 * kP2Tiles;
        if (s0 >= S) continue;
        accumulate_dno<kP2Tiles>(dno + c0, g, nlg, hcc, ldh, s0, n0, k_live);
      }
    }
    __syncthreads();
    for (int r = tid / per_row; r < it.rows; r += kThreads / per_row)
      store4(a.g_in + (it.row0 + r) * D, c0 + col, D, vec_out, context_scatter(tb, g, gh, r, col));
  }
  cp_wait_all();
  __syncthreads();
  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, ctr_acc, a.loss_parts);
}

__global__ void __launch_bounds__(kThreads, 1) cbow_grads_kernel(Geo g, K9Args a) {
  extern __shared__ __align__(16) float sm[];
  cbow_grads_block<true>(sm, g, a);
}

__global__ void __launch_bounds__(kThreads, 1)
cbow_grads_kernel_staged(Geo g, K9Args a, float* ws, int64_t ws_stride) {
  cbow_grads_block<false>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

}  // namespace

// Bytes of shared memory a block takes (or of workspace it stages in).
extern "C" size_t n2v_cbow_grads_smem(int length, int dim, int n_neg) {
  bool keep_h;
  const Geo g = pick_geo(length, dim, n_neg, keep_h);
  return smem_bytes(g, keep_h);
}

// loss_parts must hold 3 * n_walks zeros; d_no must be zeroed [n_neg, dim].
// g_in and d_out [n_walks * length, dim] are written whole.  ws null: the
// blocks stage in shared memory; else in ws, ws_blocks blocks of
// n2v::staging_stride(n2v_cbow_grads_smem(...)) floats (staging.cuh).
extern "C" int n2v_cbow_grads(const float* emb_in, const float* emb_out, int dim,
                              const int32_t* walks, const uint8_t* vocab_mask,
                              const int32_t* b_sh, const int32_t* neg_ids, int n_walks,
                              int length, int window, int n_neg, float neg_scale,
                              int cbow_mean, float* g_in, float* d_out, float* d_no,
                              float* loss_parts, float* ws, int ws_blocks, void* stream) {
  if (n_walks == 0 || length <= 0) return 0;
  bool keep_h;
  Geo g = pick_geo(length, dim, n_neg, keep_h);
  g.W = window;
  const K9Args a{emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, n_walks, neg_scale,
                 cbow_mean, keep_h, g_in, d_out, d_no, loss_parts};
  const int n_groups = (n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(cbow_grads_kernel, cbow_grads_kernel_staged, kThreads,
                            smem_bytes(g, keep_h), n_groups, ws, ws_blocks,
                            static_cast<cudaStream_t>(stream), g, a);
}
