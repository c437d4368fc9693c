// K8 hs_grads: the gradient half of one walk-structured hierarchical-softmax
// skip-gram step.
//
// Replaces node2vec_tpu/models/hsoftmax.py:209 hs_walk_step_impl up to the
// optimizer (:255-380, and the head closure :388-395): for every valid
// (center i, context j = i + d) pair, valid_pos[i] & valid_pos[j] &
// |d| <= b_sh[i], and every entry c < len(j) of the context's Huffman path,
//   logit = x_in[i] . theta[point_c(j)],  sgn = 1 - 2 * code_c(j),
//   loss -= log sigmoid(sgn * logit),  g = sigmoid(logit) - (1 + sgn) / 2,
//   g_in[i] += g * theta[point_c(j)],
// and the path entry's gradient g * x_in[i], summed over the centers that
// pair with context j, goes to
//   - g_tail[(j, c - H)] for tail levels c >= H (one row per occurrence, the
//     (-d)-shifted sum of :348-352), with its theta row in tail_rows, or -1
//     where the position is dead or c >= len(j);
//   - d_head[point_c(j)] for head levels c < H, pre-aggregated over the
//     batch (:393-395).
// Head entries are scored as dot products with theta[point], the number the
// JAX package picks from its [B*L1, D] @ [D, K] matmul by one-hot selects.
// The row-wise Adagrad that follows is K3 + K4 (adagrad.cu).
//
// Bound on an H100: the per-occurrence tail gradients written (B * L1 * CLT
// * D * 4 bytes: 248 MB at B = 2,570, L1 = 21, D = 128, CL = 18, H = 9, about
// 0.074 ms of the 0.093 ms byte bound) against 6 * D flops per live (pair,
// path entry) on the fp32 CUDA cores (about 3.9 GFLOP, 0.058 ms).  Per level
// a walk's logits are a band of X_in . Theta_c^T (|i - j| <= w), which fills
// about a sixth of a 64 x 64 tile, so the products stay on the CUDA cores.
//
// Design (Hopper):
// * Walk groups.  A persistent grid (one block of 16 warps an SM) walks
//   over groups of G walks whose G * L1 positions fill up to 16 strips of P
//   positions (G = 16P / L1, one walk when L1 > 16P; P = 4 at D <= 128).  A
//   group runs its CL levels as items; each warp owns a strip.
// * Level-ahead gathers.  Level c + 1's theta rows (and, at a group's last
//   level, the next group's emb_in rows) are gathered into a ring of two
//   stages while level c computes, each warp issuing its share as it leaves
//   phase A (the copy engine takes the copies one by one, so the issue
//   overlaps the other warps' work): one bulk copy a row (cp.async.bulk,
//   completing on the stage's mbarrier, the issue spread over every warp,
//   one arrival a warp) where rows are 16-byte aligned, cp.async otherwise.
//   Dead rows are not copied: what a dead entry's theta row or an invalid
//   position's emb_in row holds is never used.  The next group's tables (row ids, windows, path
//   entries with their code bits) are loaded at a group's first level, 8
//   entries a thread at a time.
// * Phase A, per level, registers-blocked: a strip's P emb_in rows sit in
//   registers, 16 lanes a row (NQ float4s a lane), and the two half-warps
//   stream the strip's context rows (P + 2w of them) two at a time.  Each
//   context row's P partial dot products are reduced across the 16 lanes by
//   a transposed butterfly (P - 1 + log2(16 / P) shuffles for P sums), so
//   the lane that owns a center ends with its logit; it forms g and the
//   loss, stores g for phase B, and g is broadcast back for
//   g_in += g * theta_row with the row still in registers.  The half-warps
//   take two row pairs a step, two chains in flight.  A level's g_in sums
//   are added to the group's g_in in shared memory once a level (as the
//   plain version sums its terms level by level: a few roundings at g_in's
//   size, not one a term).
// * Phase B (after the block's barrier), per level: a warp a row, the
//   strip's contexts gather g * x_in[center] from the centers' rows, and the
//   sums go out: tail levels as 16-byte stores into g_tail; head levels
//   first combined within the strip (equal path nodes summed in registers),
//   then added to the block's shared partial of d_head's first KS rows (as
//   many rows as the shared memory leaves room for: 103 at the main shape,
//   levels 0-5 and part of 6), bank-swizzled, or with one 16-byte global
//   atomic per strip and row past KS.  The partial goes to d_head with one
//   16-byte atomic per 4 elements at the end.  Loss parts go to
//   loss_parts[block] (the log-sigmoid sum and the pair count).
// * D up to 512 (NQ = 2, 4, 8; P = 4, 2, 1) in one pass.  A warp takes
//   every 16th strip where a group has more than 16 (L1 > 16P).
// * Wider rows (D > 512, P = 1) in chunks of 512 columns (kWide): phase A
//   first sums each lane's partial dots over the chunks, then runs the
//   butterfly, g and the loss as above; then, a chunk at a time, g_in's
//   terms with g read back from gcen.  Phase B and the g_in stores go a
//   chunk at a time.  Such rows stage in global memory unless the walk is
//   short enough for shared memory.
//
// Routed mode (the row-sharded step, node2vec_tpu/parallel/rowsharded_hs.py
// :156-298): the body is the same; only where a row comes from changes.
// emb_in is then the [N * cap_in, D] buffer of centers the owners sent back
// and theta the [N * cap_th, D] buffer of tail path rows: the center of walk
// position p is emb_in[slot_in[p]], and the level-c (c >= H) theta row of
// context position p is theta[slot_th[p * CLT + c - H]] (K18's request
// slots, -1 where dropped on overflow).  Head levels (c < H) read the
// all-gathered head table head [K, D] at their inner-node id.  A position
// is valid only where its center slot is live (plan_in.ok), and a tail path
// entry is masked where its slot is -1 (plan_th.ok): no loss, no gradient,
// and tail_rows -1.  The same shared and global staging, the same outputs.
//
// Staging: a shape whose arrays exceed the card's shared memory per block
// stages them in a per-block slice of a global workspace instead, with the
// same body (staging.cuh); there the gathers are plain copies.
//
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;             // the ring of gathered levels
constexpr size_t kSmemOptin = 232448;  // an H100's shared memory per block
constexpr int kStagedHeadRows = 127;   // the partial's rows in global staging
constexpr unsigned kFull = 0xFFFFFFFFu;

// sigmoid(x) and log(1 + exp(-|x|)) from one exp (sgns.cu's)
__device__ __forceinline__ float sigmoid_log1pe(float x, float& log1pe) {
  const float e = __expf(-fabsf(x));
  log1pe = __logf(1.f + e);
  const float inv = __fdividef(1.f, 1.f + e);
  return x >= 0.f ? inv : e * inv;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 b) {
  acc.x += s * b.x;
  acc.y += s * b.y;
  acc.z += s * b.z;
  acc.w += s * b.w;
}

__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// A launch's geometry, computed alike on the host and in the kernel.
struct Geo {
  int L, D, W, CL, H, CLT;
  int NQ;   // float4s of a row a lane holds in phase A (16 lanes a row)
  int P;    // positions a strip (8 / NQ)
  int G;    // walks a group
  int Mt;   // a group's rows: G * L rounded up to P
  int ns;   // strips a group
  int ld;   // row stride of every staged row: D rounded up to 64 * NQ floats
  int nc;   // column chunks of 64 * NQ a row (1 up to D = 512)
  int KS;   // d_head rows summed in the block's shared partial
  int gs;   // gcen's row stride: 2w + 1 + 2P (zeros around the band)
  int go;   // g(center k, offset d) at gcen[k * gs + go + d], go = P + w
  // float offsets of the carve (mbarriers first, at offset 0)
  int o_xs, o_ring, o_gis, o_dhs, o_gcen, o_tab, o_wix, o_red, total;
};

// floats a group's tables take: xrow, cinfo [Mt] and ent [Mt, CL] (ints)
__host__ __device__ inline int table_floats(int mt, int cl) { return round_up(2 * mt + mt * cl, 4); }

Geo make_geo(int length, int dim, int cl, int window, int n_head, int k_rows, bool shared) {
  Geo g;
  g.L = length;
  g.D = dim;
  g.W = window;
  g.CL = cl;
  g.H = n_head;
  g.CLT = cl - n_head;
  g.NQ = dim <= 128 ? 2 : dim <= 256 ? 4 : 8;
  g.P = 8 / g.NQ;
  const int rows = kWarps * g.P;
  g.G = length >= rows ? 1 : rows / length;
  g.Mt = round_up(g.G * length, g.P);
  g.ns = g.Mt / g.P;
  g.ld = round_up(dim, 64 * g.NQ);
  g.nc = g.ld / (64 * g.NQ);
  g.gs = 2 * window + 1 + 2 * g.P;
  g.go = g.P + window;
  int o = 4;  // two mbarriers
  g.o_xs = o;
  o += 2 * g.Mt * g.ld;
  g.o_ring = o;
  o += kStages * g.Mt * g.ld;
  g.o_gis = o;
  o += g.Mt * g.ld;
  g.o_gcen = o;
  o += round_up(g.Mt * g.gs, 4);
  g.o_tab = o;
  o += 2 * table_floats(g.Mt, cl);
  g.o_wix = o;
  o += round_up(g.Mt, 4);
  g.o_red = o;
  o += 2 * kWarps;
  g.o_dhs = o;
  // the partial takes what the card's shared memory leaves (as many head
  // rows as fit); in global staging a fixed share
  const int64_t room = static_cast<int64_t>(kSmemOptin / sizeof(float)) - o;
  int ks = room >= g.ld ? static_cast<int>(room / g.ld) : 0;
  if (!shared || room < 0) ks = kStagedHeadRows;
  g.KS = k_rows < ks ? k_rows : ks;
  g.total = o + g.KS * g.ld;
  return g;
}

size_t smem_bytes(const Geo& g) { return static_cast<size_t>(g.total) * sizeof(float); }

// the shared geometry when it fits, else the global one
Geo pick_geo(int length, int dim, int cl, int window, int n_head, int k_rows) {
  const Geo g = make_geo(length, dim, cl, window, n_head, k_rows, true);
  if (smem_bytes(g) <= kSmemOptin) return g;
  return make_geo(length, dim, cl, window, n_head, k_rows, false);
}

struct K8Args {
  const float* emb_in;  // routed: the centers' buffer
  const float* theta;   // routed: the tail rows' buffer
  const float* head;    // routed: the all-gathered head [K, D]; direct: null
  const int32_t* walks;
  const uint8_t* vocab_mask;
  const int32_t* b_sh;
  const int32_t* points;
  const int8_t* codes;
  const int32_t* lengths;
  const int32_t* slot_in;  // routed only
  const int32_t* slot_th;
  int n_walks;
  float* g_in;
  float* g_tail;
  int32_t* tail_rows;
  float* d_head;
  float* loss_parts;
};

// A group's tables, one a group parity:
//   xrow [Mt]     the emb_in row of the position, -1 where the position is
//                 not valid (dead, out of the vocabulary, a dropped routed
//                 slot, past a ragged last group): zero-filled;
//   cinfo [Mt]    the shrunk window min(b_sh, w) of a valid position, else -1;
//   ent [Mt, CL]  2 * row + code of the position's level-c path entry where
//                 the entry is live (a valid position, c < len, a routed tail
//                 slot not dropped), else -1; row is the theta (or routed
//                 slot, or head) row.
struct Table {
  int *xrow, *cinfo, *ent;
};

__device__ __forceinline__ Table table_of(float* sm, const Geo& g, int par) {
  int* base = reinterpret_cast<int*>(sm + g.o_tab + par * table_floats(g.Mt, g.CL));
  return Table{base, base + g.Mt, base + 2 * g.Mt};
}

// Load group gq's tables (and write its tail_rows), synchronously: each
// thread issues the loads of kBatch entries before it uses any, so a group
// costs two dependent global latencies (walk ids, then what they index).
constexpr int kBatch = 8;

template <bool kRouted>
__device__ void load_table(const Table& t, const Geo& g, const K8Args& a, int gq) {
  const int w0 = gq * g.G;
  const int rows = min(g.G, a.n_walks - w0) * g.L;
  const int64_t row0 = static_cast<int64_t>(w0) * g.L;
  for (int r = threadIdx.x; r < g.Mt; r += kThreads) {
    int xrow = -1, ci = -1;
    if (r < rows) {
      const int64_t p = row0 + r;
      const int v = a.walks[p];
      const int si = kRouted ? a.slot_in[p] : 0;
      const int bs = a.b_sh[p];
      const bool ok = v >= 0 && a.vocab_mask[v] && si >= 0;
      if (ok) {
        xrow = kRouted ? si : v;
        ci = min(max(bs, 0), g.W);
      }
    }
    t.xrow[r] = xrow;
    t.cinfo[r] = ci;
  }
  const int n = g.Mt * g.CL;
  for (int e0 = 0; e0 < n; e0 += kThreads * kBatch) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads + threadIdx.x;
      const int r = e / g.CL;
      v[j] = e < n && r < rows ? a.walks[row0 + r] : -1;
    }
    int len[kBatch], pt[kBatch], slot[kBatch];
    bool cd[kBatch], ok[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads + threadIdx.x;
      const int r = e / g.CL, c = e - r * g.CL;
      const int64_t p = row0 + r;
      const int64_t src = static_cast<int64_t>(v[j] >= 0 ? v[j] : 0) * g.CL + c;
      len[j] = pt[j] = slot[j] = 0;
      cd[j] = ok[j] = false;
      if (v[j] >= 0) {
        len[j] = a.lengths[v[j]];
        pt[j] = a.points[src];
        cd[j] = a.codes[src] != 0;
        ok[j] = a.vocab_mask[v[j]] && (!kRouted || a.slot_in[p] >= 0);
        if (kRouted && c >= g.H) slot[j] = a.slot_th[p * g.CLT + (c - g.H)];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads + threadIdx.x;
      if (e >= n) continue;
      const int r = e / g.CL, c = e - r * g.CL;
      int ent = -1;
      if (v[j] >= 0) {
        const bool routed_tail = kRouted && c >= g.H;
        const int row = routed_tail ? slot[j] : pt[j];
        const bool live = c < len[j] && (!routed_tail || row >= 0);
        if (c >= g.H) a.tail_rows[(row0 + r) * g.CLT + (c - g.H)] = live ? pt[j] : -1;
        if (ok[j] && live) ent = 2 * row + (cd[j] ? 1 : 0);
      } else if (r < rows && c >= g.H) {
        a.tail_rows[(row0 + r) * g.CLT + (c - g.H)] = -1;
      }
      t.ent[e] = ent;
    }
  }
}

// ---- the gathers ----------------------------------------------------------

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  }
}

// Copy the piece-th 16 B (vec) or 4 B of a row of `dim` floats from src
// (null: zeros; columns past dim: zeros) into dst: cp.async into shared
// memory, plain copies into a global workspace.
template <bool kShared>
__device__ __forceinline__ void copy_piece(float* dst, const float* src, int dim, int piece,
                                           bool vec) {
  if (vec) {
    const int col = 4 * piece;
    float* d = dst + col;
    if (src != nullptr && col < dim) {
      if (kShared) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d)),
                     "l"(src + col));
      } else {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src + col);
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    float* d = dst + piece;
    if (src != nullptr && piece < dim) {
      if (kShared) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(d)),
                     "l"(src + piece));
      } else {
        *d = src[piece];
      }
    } else {
      *d = 0.f;
    }
  }
}

// Gather level c's theta rows of table t into `stage` and, where xdst is
// not null (a group's first level), the group's emb_in rows into xdst.
// Bulk mode: every row a bulk copy on the stage's mbarrier; each warp
// arrives once a phase with its rows' bytes (kWarps arrivals).
// A dead row keeps what it held: phase A reads a theta row only where its
// entry is live and phase B an emb_in row only where its position is valid
// (the columns past D stay zero from the start).
template <bool kRouted, bool kShared>
__device__ __forceinline__ void gather(float* stage, float* xdst, const Table& t, int c,
                                       const Geo& g, const K8Args& a, bool vec, bool bulk,
                                       uint32_t mbar) {
  const float* tsrc = (kRouted && c < g.H) ? a.head : a.theta;
  const int n_rows = 2 * g.Mt;
  if (kShared && bulk) {
    // each warp issues a share of the rows and arrives once, first, with
    // its rows' bytes (one arrival a warp: the mbarrier counts kWarps a phase)
    const int per_warp = (n_rows + kWarps - 1) / kWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    auto row_at = [&](int i, float*& dst, const float*& base) {  // -1: no copy
      const int rr = warp * per_warp + i;
      if (i >= per_warp || rr >= n_rows) return -1;
      if (rr < g.Mt) {
        const int e = t.ent[rr * g.CL + c];
        dst = stage + rr * g.ld;
        base = tsrc;
        return e >= 0 ? e >> 1 : -1;
      }
      if (xdst == nullptr) return -1;
      dst = xdst + (rr - g.Mt) * g.ld;
      base = a.emb_in;
      return t.xrow[rr - g.Mt];
    };
    int total = 0;
    for (int i = lane; i < per_warp; i += 32) {
      float* dst;
      const float* base;
      total += row_at(i, dst, base) >= 0 ? 4 * g.D : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(kFull, total, off);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
                   "r"(total)
                   : "memory");
    for (int i = lane; i < per_warp; i += 32) {
      float* dst = nullptr;
      const float* base = nullptr;
      const int id = row_at(i, dst, base);
      if (id >= 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(dst)),
            "l"(base + static_cast<int64_t>(id) * g.D), "r"(4 * g.D), "r"(mbar)
            : "memory");
    }
    return;
  }
  // a row's pieces over min(pieces, kThreads) threads
  const int per_row = vec ? g.ld / 4 : g.ld;
  const int tpr = per_row < kThreads ? per_row : kThreads;
  for (int rr = threadIdx.x / tpr; rr < n_rows; rr += kThreads / tpr) {
    if (rr >= g.Mt && xdst == nullptr) break;
    const bool th = rr < g.Mt;
    const int r = th ? rr : rr - g.Mt;
    int id;
    if (th) {
      const int e = t.ent[r * g.CL + c];
      id = e >= 0 ? e >> 1 : -1;
    } else {
      id = t.xrow[r];
    }
    const float* src = id < 0 ? nullptr : (th ? tsrc : a.emb_in) + static_cast<int64_t>(id) * g.D;
    for (int piece = threadIdx.x % tpr; piece < per_row; piece += tpr)
      copy_piece<kShared>((th ? stage : xdst) + r * g.ld, src, g.D, piece, vec);
  }
}

// ---- the level's two phases -----------------------------------------------

// The transposed butterfly: P partial sums a lane, reduced over the 16 lanes
// of a half-warp; the lane ends with the whole sum of v[sub / (16 / P)].
template <int P>
__device__ __forceinline__ float reduce16(float (&v)[P], int sub) {
#pragma unroll
  for (int n = P / 2, m = 8; n >= 1; n /= 2, m /= 2) {
    const bool up = (sub & m) != 0;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const float send = up ? v[k] : v[k + n];
      const float keep = up ? v[k + n] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, m);
    }
  }
  float s = v[0];
#pragma unroll
  for (int m = 8 / P; m >= 1; m /= 2) s += __shfl_xor_sync(kFull, s, m);
  return s;
}

// g of a valid pair's path entry from its logit and code bit; the lane
// that owns the center adds the entry's log sigmoid(sgn * logit), sgn =
// 1 - 2 code, to the loss.
__device__ __forceinline__ float entry_g(float logit, int code, bool owner, float& loss_acc) {
  float l1pe;
  const float sig = sigmoid_log1pe(logit, l1pe);
  if (owner) loss_acc += fminf(code ? -logit : logit, 0.f) - l1pe;
  return sig - 1.f + static_cast<float>(code);
}

// Phase A of strip s at level c: the logits of the strip's centers with
// every context row in reach, g and the loss, g stored at gcen[center, d]
// for phase B, and gi += g * theta_row (16 lanes a row, NQ float4s a lane;
// the half-warps take rows rb + h and rb + 2 + h, two chains in flight).
// gi holds the level's sums of the lane's half-warp.
template <int NQ>
__device__ __forceinline__ void phase_a(const Geo& g, int s0, int c, const float* xs,
                                        const float* th, const Table& t, const int* wix,
                                        float* gcen, float4 (&gi)[8 / NQ][NQ],
                                        float& loss_acc) {
  constexpr int P = 8 / NQ;
  const int lane = threadIdx.x & 31, h = lane >> 4, sub = lane & 15;
  const int W = g.W, ld = g.ld, CL = g.CL;
  float4 xr[P][NQ];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      xr[i][q] = *reinterpret_cast<const float4*>(xs + (s0 + i) * ld + 4 * (sub + 16 * q));
  const int i_own = sub / (16 / P);
  const bool owner = (sub & (16 / P - 1)) == 0;
  const int ctr = s0 + i_own;
  const int ci = t.cinfo[ctr], cw = wix[ctr];
  const int rlo = max(0, s0 - W), rhi = min(g.Mt, s0 + P + W);
  for (int rb = rlo; rb < rhi; rb += 4) {
    int r[2], e[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      r[u] = rb + 2 * u + h;
      e[u] = r[u] < rhi ? t.ent[r[u] * CL + c] : -1;
    }
    // all four rows' entries dead: nothing of them is read in phase B
    if (__all_sync(kFull, e[0] < 0 && e[1] < 0)) continue;
    float4 tv[2][NQ];
    float p[2][P];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        tv[u][q] = e[u] >= 0
                       ? *reinterpret_cast<const float4*>(th + r[u] * ld + 4 * (sub + 16 * q))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc += dot4(xr[i][q], tv[u][q]);
        p[u][i] = acc;
      }
    }
    float gv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float logit = reduce16<P>(p[u], sub);
      const int d = r[u] - ctr, ad = abs(d);
      gv[u] = e[u] >= 0 && ad >= 1 && ad <= ci && wix[r[u]] == cw
                  ? entry_g(logit, e[u] & 1, owner, loss_acc)
                  : 0.f;
      if (owner && r[u] < rhi && ad >= 1 && ad <= W) gcen[ctr * g.gs + g.go + d] = gv[u];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int src = (lane & 16) | (i * (16 / P));
      const float g0 = __shfl_sync(kFull, gv[0], src), g1 = __shfl_sync(kFull, gv[1], src);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        fma4(gi[i][q], g0, tv[0][q]);
        fma4(gi[i][q], g1, tv[1][q]);
      }
    }
  }
}

// Phase B of strip s at level c, columns col0 .. col0 + 64 NQ: each
// context's gradient sum over its centers (a warp a row, NQ / 2 float4s a
// lane), out to g_tail or d_head.
template <int NQ>
__device__ __forceinline__ void phase_b(const Geo& g, int s0, int c, const float* xs,
                                        const Table& t, const float* gcen, float* dhs,
                                        const K8Args& a, int rows, int64_t row0, bool vec,
                                        int col0) {
  constexpr int P = 8 / NQ, NB = NQ / 2;
  const int lane = threadIdx.x & 31;
  const int W = g.W, ld = g.ld, CL = g.CL, D = g.D;
  int ids[P];
  bool any = false;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    ids[i] = t.ent[(s0 + i) * CL + c];
    any |= ids[i] >= 0;
  }
  // Row k of gcen holds zeros off the band (and at d = 0), so a context's g
  // is read at a fixed offset from the row, branch-free; a dead context's
  // entries may be stale, and its sum is zeroed at the end.
  float4 gc[P][NB];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int q = 0; q < NB; ++q) gc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (any) {
    const int rlo = max(0, s0 - W), rhi = min(g.Mt, s0 + P + W);
    for (int k = rlo; k < rhi; ++k) {
      if (t.cinfo[k] < 1) continue;  // no pairs with center k
      float4 xk[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q)
        xk[q] = *reinterpret_cast<const float4*>(xs + k * ld + col0 + 4 * (lane + 32 * q));
      const float* gk = gcen + k * g.gs + g.go + s0 - k;  // g(k, s0 + i) at gk[i]
      float gv[P];
#pragma unroll
      for (int i = 0; i < P; ++i) gv[i] = gk[i];
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int q = 0; q < NB; ++q) fma4(gc[i][q], gv[i], xk[q]);
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (ids[i] < 0) gc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (c >= g.H) {  // tail level: every position's row of g_tail
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (s0 + i >= rows) break;
      float* dst = a.g_tail + ((row0 + s0 + i) * g.CLT + (c - g.H)) * D;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int col = col0 + 4 * (lane + 32 * q);
        if (vec) {
          if (col < D) *reinterpret_cast<float4*>(dst + col) = gc[i][q];
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (col + k < D) dst[col + k] = comp(gc[i][q], k);
        }
      }
    }
    return;
  }
  // head level: equal path nodes of the strip summed first
#pragma unroll
  for (int i = 0; i < P; ++i) ids[i] = ids[i] >= 0 ? ids[i] >> 1 : -1;
#pragma unroll
  for (int i = 1; i < P; ++i) {
#pragma unroll
    for (int i2 = 0; i2 < i; ++i2) {
      if (ids[i] >= 0 && ids[i2] == ids[i]) {
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          gc[i2][q].x += gc[i][q].x;
          gc[i2][q].y += gc[i][q].y;
          gc[i2][q].z += gc[i][q].z;
          gc[i2][q].w += gc[i][q].w;
        }
        ids[i] = -1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int id = ids[i];
    if (id < 0) continue;
    if (id < g.KS) {  // the block's partial, bank-swizzled shared atomics
      float* row = dhs + id * ld;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int col = col0 + 4 * (lane + 32 * q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int kk = (k + (lane >> 3)) & 3;
          atomicAdd(row + col + kk, comp(gc[i][q], kk));
        }
      }
    } else {
      float* row = a.d_head + static_cast<int64_t>(id) * D;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int col = col0 + 4 * (lane + 32 * q);
        if (vec) {
          if (col < D) atomicAdd(reinterpret_cast<float4*>(row + col), gc[i][q]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (col + k < D) atomicAdd(row + col + k, comp(gc[i][q], k));
        }
      }
    }
  }
}

// The level's g_in sums of strip s (columns col0 on): the half-warps'
// partials added together, then into gis (shared g_in), once a level, so
// g_in gathers its terms level by level as the plain version does (a few
// roundings at its own size rather than one a term).  gi is zeroed for the
// next level.
template <int NQ>
__device__ __forceinline__ void flush_gin(const Geo& g, int s0, float4 (&gi)[8 / NQ][NQ],
                                          float* gis, int col0) {
  constexpr int P = 8 / NQ;
  const int lane = threadIdx.x & 31, h = lane >> 4, sub = lane & 15;
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float4 v = gi[i][q];
      v.x += __shfl_xor_sync(kFull, v.x, 16);
      v.y += __shfl_xor_sync(kFull, v.y, 16);
      v.z += __shfl_xor_sync(kFull, v.z, 16);
      v.w += __shfl_xor_sync(kFull, v.w, 16);
      if (h == 0) {
        float4* p = reinterpret_cast<float4*>(gis + (s0 + i) * g.ld + col0 + 4 * (sub + 16 * q));
        float4 o = *p;
        o.x += v.x;
        o.y += v.y;
        o.z += v.z;
        o.w += v.w;
        *p = o;
      }
      gi[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// Phase A of strip s (one position) at level c for rows wider than a lane
// group holds (D > 512, NQ = 8), in chunks of 512 columns: first every
// context row's logit (each lane's partial dot summed over the chunks, then
// the butterfly), g and the loss, g stored at gcen[center, d]; then, a
// chunk at a time, g_in's terms g * theta_row with g read back from gcen,
// added to gis once a chunk.  The rows go to the half-warps as phase_a's do.
__device__ __forceinline__ void phase_a_wide(const Geo& g, int s0, int c, const float* xs,
                                             const float* th, const Table& t, const int* wix,
                                             float* gcen, float* gis, float& loss_acc) {
  constexpr int NQ = 8;
  const int lane = threadIdx.x & 31, h = lane >> 4, sub = lane & 15;
  const int W = g.W, ld = g.ld, CL = g.CL;
  const int ctr = s0;
  const bool owner = sub == 0;
  const int ci = t.cinfo[ctr], cw = wix[ctr];
  const int rlo = max(0, s0 - W), rhi = min(g.Mt, s0 + 1 + W);
  const float* xrow = xs + ctr * ld + 4 * sub;
  for (int rb = rlo; rb < rhi; rb += 4) {
    int r[2], e[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      r[u] = rb + 2 * u + h;
      e[u] = r[u] < rhi ? t.ent[r[u] * CL + c] : -1;
    }
    if (__all_sync(kFull, e[0] < 0 && e[1] < 0)) continue;
    float p[2][1] = {{0.f}, {0.f}};
    for (int k = 0; k < g.nc; ++k) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = 512 * k + 64 * q;
        const float4 xq = *reinterpret_cast<const float4*>(xrow + col);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (e[u] >= 0)
            p[u][0] += dot4(xq, *reinterpret_cast<const float4*>(th + r[u] * ld + 4 * sub + col));
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float logit = reduce16<1>(p[u], sub);
      const int d = r[u] - ctr, ad = abs(d);
      const float gv = e[u] >= 0 && ad >= 1 && ad <= ci && wix[r[u]] == cw
                           ? entry_g(logit, e[u] & 1, owner, loss_acc)
                           : 0.f;
      if (owner && r[u] < rhi && ad >= 1 && ad <= W) gcen[ctr * g.gs + g.go + d] = gv;
    }
  }
  __syncwarp();  // every g of the strip in gcen
  for (int k = 0; k < g.nc; ++k) {
    float4 gi[1][NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) gi[0][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rb = rlo; rb < rhi; rb += 4) {
      int r[2], e[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        r[u] = rb + 2 * u + h;
        e[u] = r[u] < rhi ? t.ent[r[u] * CL + c] : -1;
      }
      if (__all_sync(kFull, e[0] < 0 && e[1] < 0)) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (e[u] < 0) continue;
        const int d = r[u] - ctr, ad = abs(d);
        const float gv = ad >= 1 && ad <= W ? gcen[ctr * g.gs + g.go + d] : 0.f;
        const float* trow = th + r[u] * ld + 512 * k + 4 * sub;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          fma4(gi[0][q], gv, *reinterpret_cast<const float4*>(trow + 64 * q));
      }
    }
    flush_gin<NQ>(g, s0, gi, gis, 512 * k);
  }
}

// g_in of strip s (columns col0 .. col0 + 64 NQ) at the end of its group,
// from gis (which is zeroed).
template <int NQ>
__device__ __forceinline__ void write_gin(const Geo& g, int s0, float* gis, const K8Args& a,
                                          int rows, int64_t row0, bool vec, int col0) {
  constexpr int P = 8 / NQ, NB = NQ / 2;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float* src = gis + (s0 + i) * g.ld;
    float* dst = a.g_in + (row0 + s0 + i) * g.D;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int col = col0 + 4 * (lane + 32 * q);
      const float4 v = *reinterpret_cast<const float4*>(src + col);
      *reinterpret_cast<float4*>(src + col) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + i >= rows) continue;
      if (vec) {
        if (col < g.D) *reinterpret_cast<float4*>(dst + col) = v;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < g.D) dst[col + k] = comp(v, k);
      }
    }
  }
}

// ---- one block's work -----------------------------------------------------

template <int NQ, bool kRouted, bool kShared, bool kWide>
__device__ __forceinline__ void hs_grads_block(float* sm, const Geo& g, const K8Args& a) {
  constexpr int P = 8 / NQ;
  static_assert(!kWide || NQ == 8, "chunked rows hold 8 float4s a lane");
  const int nc = kWide ? g.nc : 1;  // column chunks of 64 NQ
  uint64_t* mbars = reinterpret_cast<uint64_t*>(sm);  // [2] the ring's
  float* xs = sm + g.o_xs;                             // [2][Mt, ld] emb_in rows a parity
  float* ring = sm + g.o_ring;                         // [kStages][Mt, ld] theta rows
  float* gis = sm + g.o_gis;                           // [Mt, ld] the group's g_in
  float* dhs = sm + g.o_dhs;                           // [KS, ld] partial of d_head
  float* gcen = sm + g.o_gcen;                         // [Mt, gs] g of (center, offset)
  int* wix = reinterpret_cast<int*>(sm + g.o_wix);     // [Mt] walk of a row in its group
  float* red = sm + g.o_red;                           // [2 * kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CL = g.CL, Mt = g.Mt;
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  const int my_groups =
      n_groups > static_cast<int>(blockIdx.x) ? (n_groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_items = my_groups * CL;
  const bool vec = g.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.theta) % 16 == 0 &&
                   (!kRouted || reinterpret_cast<uintptr_t>(a.head) % 16 == 0);
  const bool vec_out = g.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.g_in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.g_tail) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.d_head) % 16 == 0;
  const bool bulk = kShared && vec;

  // prologue: zeroed rows (their columns past D stay zero), the first
  // group's tables, then its first level in flight
  for (int i = tid; i < 2 * Mt * g.ld; i += kThreads) xs[i] = 0.f;
  for (int i = tid; i < kStages * Mt * g.ld; i += kThreads) ring[i] = 0.f;
  for (int i = tid; i < Mt * g.ld; i += kThreads) gis[i] = 0.f;
  for (int i = tid; i < g.KS * g.ld; i += kThreads) dhs[i] = 0.f;
  for (int i = tid; i < Mt * g.gs; i += kThreads) gcen[i] = 0.f;
  for (int r = tid; r < Mt; r += kThreads) wix[r] = r / g.L;
  if (my_groups > 0) load_table<kRouted>(table_of(sm, g, 0), g, a, blockIdx.x);
  if (bulk && tid == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(mbars + st)),
                   "r"(kWarps)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_items > 0)
    gather<kRouted, kShared>(ring, xs, table_of(sm, g, 0), 0, g, a, vec, bulk, smem_addr(mbars));
  cp_commit();

  float loss_acc = 0.f, pair_acc = 0.f;
  float4 gi[P][NQ];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) gi[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_items; ++t) {
    const int q = t / CL, c = t - q * CL;
    const int gq = blockIdx.x + q * gridDim.x;
    if (bulk) mbar_wait(smem_addr(mbars + t % kStages), (t / kStages) & 1);
    cp_wait_all();
    __syncthreads();  // item t landed; item t - 1's stage is free
    // the next group's tables, before any gather reads them (the next
    // item's is the next group's first when CL = 1)
    if (c == 0 && q + 1 < my_groups) {
      load_table<kRouted>(table_of(sm, g, (q + 1) & 1), g, a, gq + gridDim.x);
      if (CL == 1) __syncthreads();
    }

    const Table tb = table_of(sm, g, q & 1);
    const float* xg = xs + (q & 1) * Mt * g.ld;
    const float* th = ring + (t % kStages) * Mt * g.ld;
    const int w0 = gq * g.G;
    const int rows = min(g.G, a.n_walks - w0) * g.L;
    const int64_t row0 = static_cast<int64_t>(w0) * g.L;
    if (c == 0) {  // the group's valid pairs
      for (int i = tid; i < Mt; i += kThreads) {
        const int ci = tb.cinfo[i];
        for (int d = 1; d <= ci; ++d) {
          if (i - d >= 0 && wix[i - d] == wix[i] && tb.cinfo[i - d] >= 0) pair_acc += 1.f;
          if (i + d < Mt && wix[i + d] == wix[i] && tb.cinfo[i + d] >= 0) pair_acc += 1.f;
        }
      }
    }

    for (int s = warp; s < g.ns; s += kWarps) {
      if (kWide) {
        phase_a_wide(g, s, c, xg, th, tb, wix, gcen, gis, loss_acc);
      } else {
        phase_a<NQ>(g, s * P, c, xg, th, tb, wix, gcen, gi, loss_acc);
        flush_gin<NQ>(g, s * P, gi, gis, 0);
      }
    }
    // the next item's rows, each warp as it leaves phase A: its copies' issue
    // (the copy engine takes them one by one) overlaps the others' phase A.
    // Stage (t + 1) % 2 and the next group's emb_in rows are free since the
    // barrier at this item's top.
    if (t + 1 < n_items) {
      const int q1 = (t + 1) / CL, c1 = t + 1 - q1 * CL;
      gather<kRouted, kShared>(ring + ((t + 1) % kStages) * Mt * g.ld,
                               c1 == 0 ? xs + (q1 & 1) * Mt * g.ld : nullptr,
                               table_of(sm, g, q1 & 1), c1, g, a, vec, bulk,
                               smem_addr(mbars + (t + 1) % kStages));
    }
    cp_commit();
    __syncthreads();  // every g of the level is in gcen
    for (int s = warp; s < g.ns; s += kWarps)
      for (int k = 0; k < nc; ++k)
        phase_b<NQ>(g, s * P, c, xg, tb, gcen, dhs, a, rows, row0, vec_out, 64 * NQ * k);
    if (c == CL - 1)  // the group's g_in (a strip's rows of gis are its warp's alone)
      for (int s = warp; s < g.ns; s += kWarps)
        for (int k = 0; k < nc; ++k)
          write_gin<NQ>(g, s * P, gis, a, rows, row0, vec_out, 64 * NQ * k);
  }
  cp_wait_all();
  __syncthreads();

  // the block's partial of d_head's first KS rows
  if (vec_out) {
    const int d4 = g.D / 4;
    for (int e = tid; e < g.KS * d4; e += kThreads) {
      const int r = e / d4, col = 4 * (e - r * d4);
      const float4 v = *reinterpret_cast<const float4*>(dhs + r * g.ld + col);
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(a.d_head + static_cast<int64_t>(r) * g.D + col), v);
    }
  } else {
    for (int e = tid; e < g.KS * g.D; e += kThreads) {
      const int r = e / g.D, col = e - r * g.D;
      const float v = dhs[r * g.ld + col];
      if (v != 0.f) atomicAdd(a.d_head + static_cast<int64_t>(r) * g.D + col, v);
    }
  }
  loss_acc = warp_sum(loss_acc);
  pair_acc = warp_sum(pair_acc);
  if (lane == 0) {
    red[warp] = loss_acc;
    red[kWarps + warp] = pair_acc;
  }
  __syncthreads();
  if (tid < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[tid * kWarps + w];
    a.loss_parts[2 * blockIdx.x + tid] = s;
  }
}

template <int NQ, bool kRouted, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) hs_grads_kernel(Geo g, K8Args a) {
  extern __shared__ __align__(16) float sm[];
  hs_grads_block<NQ, kRouted, true, kWide>(sm, g, a);
}

template <int NQ, bool kRouted, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
hs_grads_kernel_staged(Geo g, K8Args a, float* ws, int64_t ws_stride) {
  hs_grads_block<NQ, kRouted, false, kWide>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g,
                                            a);
}

template <bool kRouted>
int launch(int length, int dim, int cl, int window, int n_head, int k_rows, const K8Args& a,
           float* ws, int ws_blocks, void* stream) {
  if (a.n_walks == 0 || length <= 0) return 0;
  if (dim <= 0 || cl < 1 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = pick_geo(length, dim, cl, window, n_head, k_rows);
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(g);
  if (g.NQ == 2)
    return n2v::launch_staged(hs_grads_kernel<2, kRouted, false>,
                              hs_grads_kernel_staged<2, kRouted, false>, kThreads, smem, n_groups,
                              ws, ws_blocks, st, g, a);
  if (g.NQ == 4)
    return n2v::launch_staged(hs_grads_kernel<4, kRouted, false>,
                              hs_grads_kernel_staged<4, kRouted, false>, kThreads, smem, n_groups,
                              ws, ws_blocks, st, g, a);
  if (g.nc == 1)
    return n2v::launch_staged(hs_grads_kernel<8, kRouted, false>,
                              hs_grads_kernel_staged<8, kRouted, false>, kThreads, smem, n_groups,
                              ws, ws_blocks, st, g, a);
  return n2v::launch_staged(hs_grads_kernel<8, kRouted, true>,
                            hs_grads_kernel_staged<8, kRouted, true>, kThreads, smem, n_groups, ws,
                            ws_blocks, st, g, a);
}

}  // namespace

// Bytes of shared memory a block takes (or of workspace it stages in); 0
// for a dim below 1.
extern "C" size_t n2v_hs_grads_smem(int length, int dim, int cl, int window, int k_rows) {
  if (dim <= 0) return 0;
  // the head's level count does not change the carve
  return smem_bytes(pick_geo(length, dim, cl, window, 0, k_rows));
}

// loss_parts must hold 2 * n_walks zeros; d_head must be zeroed [k_rows, dim].
// g_in [n_walks * length, dim], g_tail [n_walks * length * (cl - n_head), dim]
// and tail_rows [n_walks * length * (cl - n_head)] are written whole.  ws
// null: the blocks stage in shared memory; else in ws (staging.cuh).
extern "C" int n2v_hs_grads(const float* emb_in, const float* theta, int dim,
                            const int32_t* walks, const uint8_t* vocab_mask,
                            const int32_t* b_sh, const int32_t* points,
                            const int8_t* codes, const int32_t* lengths, int cl,
                            int n_walks, int length, int window, int n_head,
                            int k_rows, float* g_in, float* g_tail, int32_t* tail_rows,
                            float* d_head, float* loss_parts, float* ws, int ws_blocks,
                            void* stream) {
  const K8Args a{emb_in, theta, nullptr, walks, vocab_mask, b_sh, points, codes, lengths,
                 nullptr, nullptr, n_walks, g_in, g_tail, tail_rows, d_head, loss_parts};
  return launch<false>(length, dim, cl, window, n_head, k_rows, a, ws, ws_blocks, stream);
}

// Routed mode: x_in [N * cap_in, dim] and th [N * cap_th, dim] the buffers
// the owners sent back, slot_in [n_walks * length] and slot_th [n_walks *
// length * (cl - n_head)] the requests' rows in them (-1: dropped), head
// [k_rows, dim] the all-gathered head rows.  The shared memory is the direct
// mode's (n2v_hs_grads_smem); the outputs are n2v_hs_grads's.
extern "C" int n2v_hs_grads_routed(const float* x_in, const float* th, const float* head,
                                   int dim, const int32_t* walks, const uint8_t* vocab_mask,
                                   const int32_t* b_sh, const int32_t* points,
                                   const int8_t* codes, const int32_t* lengths,
                                   const int32_t* slot_in, const int32_t* slot_th, int cl,
                                   int n_walks, int length, int window, int n_head, int k_rows,
                                   float* g_in, float* g_tail, int32_t* tail_rows,
                                   float* d_head, float* loss_parts, float* ws, int ws_blocks,
                                   void* stream) {
  const K8Args a{x_in, th, head, walks, vocab_mask, b_sh, points, codes, lengths,
                 slot_in, slot_th, n_walks, g_in, g_tail, tail_rows, d_head, loss_parts};
  return launch<true>(length, dim, cl, window, n_head, k_rows, a, ws, ws_blocks, stream);
}
