// K10 cbow_hs_grads: the gradient half of one walk-structured CBOW
// hierarchical-softmax step.
//
// Replaces node2vec_tpu/models/cbow.py:230 cbow_hs_step_impl up to the
// optimizer (:264-304, with _context_mean :60 and _scatter_context_grads
// :94), and the squares its row-wise Adagrad adds (:306-322).  For every
// center i, h[i] is the sum (or, under cbow_mean, the mean) of its valid
// contexts' emb_in rows inside the shrunk window; a valid position with a
// context is a trainable center, scored along its OWN Huffman path (no
// per-offset shift, no dense head): for every entry c < len(center),
//   logit = h[i] . theta[point_c(i)],  sgn = 1 - 2 * code_c(i),
//   loss -= log sigmoid(sgn * logit),  g = sigmoid(logit) - (1 + sgn) / 2,
//   g_h[i] += g * theta[point_c(i)]    (then / max(cnt, 1) under cbow_mean),
// and the entry's theta gradient is g * h[i], whose mean square is
// g^2 * mean(h[i]^2).  g_in[j] is the sum of g_h over the centers whose
// context j is.  Row-wise Adagrad is per occurrence: every occurrence adds
// its own mean square to the accumulator, and every occurrence of a row is
// scaled by the same final accumulator, so a theta row's update needs only
// the SUM of its occurrences' gradients and the SUM of their squares.
//
// Outputs (the layout cbow_hs_grads_plain, models/cbow.py, builds too):
//   g_in [B*L1, D] and sq_in [B*L1] (sum of squares of the row);
//   the head, levels c < H: g_head [K, D] and sq_head [K], summed over the
//     batch per theta row.  K = min(2^H - 1, n_inner): with the trees' BFS
//     numbering every path entry of level c < H is below 2^H - 1;
//   the tail, levels c >= H, one row per occurrence: g_tail [B*L1*(CL-H), D]
//     with tail_rows (-1 where the center is not trainable or c lies beyond
//     its code: a zero row) and sq_tail;
// every square a sum over the row's columns (K3's squares mode divides by
// D).  The step then runs K3's squares mode and K4 over (sq_in | g_in,
// walks), (sq_tail | g_tail, tail_rows), (sq_head | g_head, 0..K-1).
//
// What bounds it on an H100: the tail rows written (B * L1 * (CL - H) * D
// * 4 bytes: 277 MB at main_path_cbow_hs's B = 2,570, L1 = 21, D = 128,
// CL = 18, H = 8) and the theta rows of the paths read, against 5 * D
// flops per live path entry on the fp32 cores.  Before this design every
// occurrence of every level wrote its row (497 MB a step at that shape,
// read twice more by K3 and K4), one warp descended one path with one
// dependent theta load a level, and h and the g_in scatter ran a column
// element a thread, every offset's window test repeated per element (their
// phases took 0.40 of a warp's clocks at the main shape, 0.78 at D = 512;
// experiments/k10_attribution.py).  What is left is latency: each phase
// below is a chain of dependent shared-memory loads behind a barrier, one
// 16-warp block an SM (the head's partial holds most of its shared memory).
//
// Design (Hopper):
// * A persistent grid (one block of 16 warps an SM) walks over groups of G
//   walks, M = G * L1 positions (G = 2 * units / L1: two positions a unit).
// * Per group: its tables built from the raw ones (walk ids, shrinks,
//   vocabulary flags, code lengths, path entries as 2 * point + code),
//   which the warps the head sums leave idle fetched during the last
//   group's descent; each center's context mask by one ballot and each
//   position's mask as a context (windows up to 32).  Then h a chunk of 128
//   columns at a time: the chunk's emb_in rows staged (16-byte loads where
//   D % 4 == 0, four a thread in flight), then a warp a position, its
//   contexts from its mask (float4 loads that do not wait on each other).
//   Columns past the chunk never stage, so D = 512 at L1 = 81
//   (main_path_wide) fits in shared memory.
// * The descent, a round of positions a unit: 16 lanes (D <= 256) or a
//   warp (D <= 512) hold h and g_h in registers (NQ float4s a lane) and
//   keep PF theta rows in flight in a register ring (level c + PF is loaded
//   as level c is used), so a path costs one load latency, not one a
//   level.  The two half-warps of a warp run to the longer path, the
//   other's lanes masked.  A tail level stores its row with 16-byte stores;
//   a head level keeps its g.  After the round's barrier warp c sums level
//   c's entries into the block's shared partial of g_head (each position's
//   entry held a lane, four positions' h rows loaded at once, a run of one
//   row summed in registers and added once: a level's rows are its warp's
//   alone, so no atomics — shared float atomics cost more than they
//   save here), and g^2 * |h|^2 into sq_head's; then g_h takes the place
//   of h's row (no other unit reads it).
// * The scatter: a warp a position, its centers from its mask, g_in
//   written with its sum of squares.
// * At the end the partial goes to g_head with one 16-byte atomic per 4
//   nonzero elements, sq_head with one atomic a nonzero row.  Loss parts
//   go to loss_parts[block] (the log-sigmoid sum and the trainable centers).
// * Wider rows (D > 512), D % 4 != 0 or unaligned tables (the generic
//   path): a warp a position, lanes over the columns, h and g_h both in
//   shared memory, one theta row a level read as it is used, the head's
//   rows added with shared atomics.
//
// Staging: a shape whose arrays (the head partial included) exceed the
// card's shared memory per block stages them in a per-block slice of a
// global workspace instead, with the same body (staging.cuh); the wrapper
// picks the mode from the shape.

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // emb_in columns staged at a time
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ inline int round4(int a) { return (a + 3) / 4 * 4; }

// sigmoid(x) and log(1 + exp(-|x|)) from one exp
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

// the sum over a unit's UL lanes (every lane of the warp takes part)
template <int UL>
__device__ __forceinline__ float unit_sum(float v) {
#pragma unroll
  for (int off = UL / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
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

__device__ __forceinline__ void add4(float4& acc, float4 b) {
  acc.x += b.x;
  acc.y += b.y;
  acc.z += b.z;
  acc.w += b.w;
}

__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// offset index o in [0, 2w) -> window offset d in -w..-1, 1..w (the JAX order)
__device__ __forceinline__ int offset_of(int o, int window) {
  return o < window ? o - window : o - window + 1;
}

// A launch's geometry, computed alike on the host and in the kernel (and
// by models/cbow.py: cbow_hs_head, which picks H).
struct Geo {
  int L, D, W, CL, H, CLT, K;
  int G, M;   // walks and positions a group (two positions a unit of 16 or 32 lanes)
  int ld;     // row stride of h, g_h and the head partial: D rounded up to 4
  int cw;     // emb_in columns staged at a time: min(ld, kChunk)
  // float offsets of the carve
  int o_xc, o_h, o_gh, o_ent, o_gv, o_tab, o_raw, o_head, o_sq, o_red, total;
};

Geo make_geo(int length, int dim, int cl, int window, int n_head, int k_rows, bool fast) {
  Geo g;
  g.L = length;
  g.D = dim;
  g.W = window;
  g.CL = cl;
  g.H = n_head;
  g.CLT = cl - n_head;
  g.K = k_rows;
  // a unit: 16 lanes on the registers-blocked descent at D <= 256 (D % 4
  // == 0, aligned tables), else 32
  const int units = kThreads / (fast && dim <= 256 ? 16 : 32);
  g.G = length >= 2 * units ? 1 : 2 * units / length;
  g.M = g.G * length;
  g.ld = round4(dim);
  g.cw = g.ld < kChunk ? g.ld : kChunk;
  int o = 0;
  g.o_xc = o;
  o += round4(g.M * g.cw);
  g.o_h = o;
  o += round4(g.M * g.ld);
  g.o_gh = o;  // the generic path's g_h rows
  if (!fast) o += round4(g.M * g.ld);
  g.o_ent = o;  // [M, CL] path entries
  o += round4(g.M * cl);
  g.o_gv = o;  // [M, CL] g of each path entry, and [M] |h|^2 (the head phase's)
  o += round4(g.M * cl) + round4(g.M);
  g.o_tab = o;  // [M] rows, validity, shrinks, context counts; [M] two 8-byte masks
  o += round4(8 * g.M);
  g.o_raw = o;  // the raw tables: [M] four ints, [M, CL] one
  o += round4(4 * g.M) + round4(g.M * cl);
  g.o_red = o;
  o += round4(2 * kWarps);
  g.o_head = o;  // [K, ld] the block's partial of g_head
  o += round4(k_rows * g.ld);
  g.o_sq = o;  // [K] of sq_head
  o += round4(k_rows);
  g.total = o;
  return g;
}

size_t smem_bytes(const Geo& g) { return static_cast<size_t>(g.total) * sizeof(float); }

struct K10Args {
  const float* emb_in;
  const float* theta;
  const int32_t* walks;
  const uint8_t* vocab_mask;
  const int32_t* b_sh;
  const int32_t* points;
  const int8_t* codes;
  const int32_t* lengths;
  int n_walks, cbow_mean;
  float* g_in;
  float* sq_in;
  float* g_tail;
  float* sq_tail;
  int32_t* tail_rows;
  float* g_head;
  float* sq_head;
  float* loss_parts;
};

// A group's tables, carved from sm: row [M] (the emb_in row, 0 where
// dead), vpos [M] (valid and in the vocabulary), bsh [M] (the shrunk
// window), cnt [M] (the context count; a trainable center has cnt > 0),
// ctx [M] (bit o: offset offset_of(o) is a context of the center) and rcv
// [M] (bit o: the position is a context of center r - offset_of(o)), and
// ent [M, CL] = 2 * point + code where c < len(center) and the position is
// valid, else -1.  The masks take the window test out of the h and scatter
// loops (windows up to 32).
struct Tab {
  int *row, *vpos, *bsh;
  float* cnt;
  unsigned long long *ctx, *rcv;
  int* ent;
  // what device memory holds for the group, fetched ahead (fetch_raw): walk
  // ids (-1 past the batch), shrinks, vocabulary flags, code lengths [M];
  // path entries 2 * point + code bit [M, CL]
  int *raw_w, *raw_b, *raw_vm, *raw_len, *raw_e;
};

__device__ __forceinline__ Tab tab_of(float* sm, const Geo& g) {
  int* t = reinterpret_cast<int*>(sm + g.o_tab);
  auto* m = reinterpret_cast<unsigned long long*>(sm + g.o_tab + 4 * g.M);
  int* raw = reinterpret_cast<int*>(sm + g.o_raw);
  return Tab{t, t + g.M, t + 2 * g.M, sm + g.o_tab + 3 * g.M, m, m + g.M,
             reinterpret_cast<int*>(sm + g.o_ent), raw, raw + g.M, raw + 2 * g.M, raw + 3 * g.M,
             raw + round4(4 * g.M)};
}

// position r + d is a context of center r (both in one walk of the group)
__device__ __forceinline__ bool in_context(const Tab& t, const Geo& g, int r, int d) {
  const int i = r % g.L, j = i + d;
  return t.vpos[r] && j >= 0 && j < g.L && t.vpos[r + d] && abs(d) <= t.bsh[r];
}

// Group gq's raw tables from device memory, by threads it0, it0 + nt, ...
// of the block: stage 1 the walk ids and shrinks; stage 2, once stage 1 is
// visible, what they index (vocabulary flags, code lengths, path points
// and code bits, kLoads entries a thread with their loads issued before
// any is used).  The descent runs the next group's stages on the warps the
// head sums leave idle, so its latency hides behind them.
constexpr int kLoads = 4;

__device__ void fetch_raw(const Tab& t, const Geo& g, const K10Args& a, int gq, int stage,
                          int it0, int nt) {
  const int w0 = gq * g.G;
  const int rows = min(g.G, a.n_walks - w0) * g.L;
  const int64_t row0 = static_cast<int64_t>(w0) * g.L;
  if (stage == 1) {
    for (int r = it0; r < g.M; r += nt) {
      t.raw_w[r] = r < rows ? a.walks[row0 + r] : -1;
      t.raw_b[r] = r < rows ? a.b_sh[row0 + r] : 0;
    }
    return;
  }
  for (int r = it0; r < g.M; r += nt) {
    const int v = t.raw_w[r], safe = v >= 0 ? v : 0;
    t.raw_vm[r] = v >= 0 ? a.vocab_mask[safe] : 0;
    t.raw_len[r] = v >= 0 ? a.lengths[safe] : 0;
  }
  const int n = g.M * g.CL;
  for (int e0 = it0; e0 < n; e0 += nt * kLoads) {
    int pt[kLoads];
    int8_t cd[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nt, r = e / g.CL, c = e - r * g.CL;
      const int v = e < n ? t.raw_w[r] : -1;
      pt[u] = 0;
      cd[u] = 0;
      if (v >= 0) {
        const int64_t src = static_cast<int64_t>(v) * g.CL + c;
        pt[u] = a.points[src];
        cd[u] = a.codes[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nt;
      if (e < n) t.raw_e[e] = 2 * pt[u] + (cd[u] != 0 ? 1 : 0);
    }
  }
}

// The group's tables from its raw ones: rows, validity, shrinks; then each
// center's context mask (a warp a center, a lane an offset, one ballot),
// its count and its path entries; then each position's mask as a context.
// Ends at a barrier.
__device__ void build_tables(const Tab& t, const Geo& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = threadIdx.x; r < g.M; r += kThreads) {
    const int v = t.raw_w[r];
    t.row[r] = v >= 0 ? v : 0;
    t.vpos[r] = v >= 0 && t.raw_vm[r] != 0;
    t.bsh[r] = t.raw_b[r];
  }
  __syncthreads();
  for (int r = warp; r < g.M; r += kWarps) {
    unsigned long long m = 0;
    for (int o0 = 0; o0 < 2 * g.W; o0 += 32) {
      const int o = o0 + lane;
      const bool in = o < 2 * g.W && in_context(t, g, r, offset_of(o, g.W));
      m |= static_cast<unsigned long long>(__ballot_sync(kFull, in)) << o0;
    }
    if (lane == 0) {
      t.ctx[r] = m;
      t.cnt[r] = static_cast<float>(__popcll(m));
    }
  }
  for (int e = threadIdx.x; e < g.M * g.CL; e += kThreads) {
    const int r = e / g.CL, c = e - r * g.CL;
    t.ent[e] = t.vpos[r] && c < t.raw_len[r] ? t.raw_e[e] : -1;
  }
  __syncthreads();
  for (int j = warp; j < g.M; j += kWarps) {
    unsigned long long m = 0;
    for (int o0 = 0; o0 < 2 * g.W; o0 += 32) {
      const int o = o0 + lane, c = j - offset_of(o, g.W);
      const bool in = o < 2 * g.W && c >= 0 && c < g.M && ((t.ctx[c] >> o) & 1ull);
      m |= static_cast<unsigned long long>(__ballot_sync(kFull, in)) << o0;
    }
    if (lane == 0) t.rcv[j] = m;
  }
  __syncthreads();
}

// h of every position of the group into hb [M, ld], a chunk of cw columns
// at a time through xc: the chunk's emb_in rows staged (kLoads loads a
// thread in flight), then a warp a position, a float4 a lane, its contexts
// from its mask in the JAX offset order.

__device__ void context_mean(float* xc, float* hb, const Tab& t, const Geo& g,
                             const K10Args& a, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < g.D; k0 += g.cw) {
    const int w = min(g.cw, g.D - k0);
    if (vec) {
      const int w4 = g.cw / 4, n = g.M * w4;
      for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kLoads) {
        float4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int e = e0 + u * kThreads, r = e / w4, c = 4 * (e - r * w4);
          v[u] = e < n && c < w && t.vpos[r]
                     ? __ldg(reinterpret_cast<const float4*>(
                           a.emb_in + static_cast<int64_t>(t.row[r]) * g.D + k0 + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int e = e0 + u * kThreads;
          if (e < n) *reinterpret_cast<float4*>(xc + 4 * e) = v[u];
        }
      }
    } else {
      for (int e = threadIdx.x; e < g.M * g.cw; e += kThreads) {
        const int r = e / g.cw, c = e - r * g.cw;
        xc[e] = c < w && t.vpos[r] ? a.emb_in[static_cast<int64_t>(t.row[r]) * g.D + k0 + c]
                                   : 0.f;
      }
    }
    __syncthreads();
    if (4 * lane < g.cw) {
      for (int r = warp; r < g.M; r += kWarps) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (unsigned long long m = t.ctx[r]; m; m &= m - 1) {
          const int d = offset_of(__ffsll(m) - 1, g.W);
          add4(acc, *reinterpret_cast<const float4*>(xc + (r + d) * g.cw + 4 * lane));
        }
        if (a.cbow_mean) {
          const float inv = fmaxf(t.cnt[r], 1.f);
          acc = make_float4(acc.x / inv, acc.y / inv, acc.z / inv, acc.w / inv);
        }
        if (k0 + 4 * lane < g.ld)
          *reinterpret_cast<float4*>(hb + r * g.ld + k0 + 4 * lane) = acc;
      }
    }
    __syncthreads();
  }
}

// g_in [rows, D] and sq_in [rows] of the group from its g_h rows: a warp a
// position, its centers from its mask in the JAX offset order, float4s a
// lane over chunks of 128 columns.
__device__ void scatter_context(const float* ghb, const Tab& t, const Geo& g, const K10Args& a,
                                int rows, int64_t row0, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < rows; j += kWarps) {
    float ss = 0.f;
    float* dst = a.g_in + (row0 + j) * g.D;
    const unsigned long long rcv = t.rcv[j];
    for (int k0 = 0; k0 < g.ld; k0 += kChunk) {
      const int col = k0 + 4 * lane;
      if (col >= g.ld) break;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (unsigned long long m = rcv; m; m &= m - 1) {
        const int c = j - offset_of(__ffsll(m) - 1, g.W);
        add4(acc, *reinterpret_cast<const float4*>(ghb + c * g.ld + col));
      }
      if (vec) {
        *reinterpret_cast<float4*>(dst + col) = acc;
        ss += dot4(acc, acc);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (col + k < g.D) {
            const float v = comp(acc, k);
            dst[col + k] = v;
            ss += v * v;
          }
        }
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) a.sq_in[row0 + j] = ss;
  }
}

// A live entry's g from its logit and code bit; the owning lane adds its
// log sigmoid(sgn * logit), sgn = 1 - 2 code, to the loss.
__device__ __forceinline__ float entry_g(float logit, int code, bool owner, float& loss_acc) {
  float l1pe;
  const float sig = sigmoid_log1pe(logit, l1pe);
  if (owner) loss_acc += fminf(code ? -logit : logit, 0.f) - l1pe;
  return sig - 1.f + static_cast<float>(code);
}

// A masked tail row: zeros, row -1, square 0 (lanes sub of UL).
template <int UL>
__device__ __forceinline__ void tail_zero(const K10Args& a, const Geo& g, int64_t t, int sub,
                                          bool vec) {
  float* dst = a.g_tail + t * g.D;
  if (vec) {
    for (int col = 4 * sub; col < g.D; col += 4 * UL)
      *reinterpret_cast<float4*>(dst + col) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int col = sub; col < g.D; col += UL) dst[col] = 0.f;
  }
  if (sub == 0) {
    a.tail_rows[t] = -1;
    a.sq_tail[t] = 0.f;
  }
}

// Level c's head entries of the round's positions p0 .. p0 + n - 1 (n <=
// 32), added into the block's partial by one warp (a level's rows are its
// warp's alone, with the trees' BFS numbering): the positions' entries
// held a lane each, then taken in order, U positions' entries broadcast
// and their h rows loaded before any is used; a run of one row is summed in
// registers (float4s a lane, KC chunks of 128 columns) and added to its
// partial row once.
template <int KC>
__device__ void head_sums(const float* hb, float* head, float* sqh, const float* gvb,
                          const Tab& t, const Geo& g, int rows, int p0, int n, int c) {
  constexpr int U = 4 / KC;
  const int lane = threadIdx.x & 31, ld = g.ld, CL = g.CL;
  const int pp = p0 + lane;
  int e = -1;
  float gv = 0.f, hh = 0.f;
  if (lane < n && pp < rows && t.cnt[pp] > 0.f) {
    e = t.ent[pp * CL + c];
    if (e >= 0 && (e >> 1) < g.K) {
      gv = gvb[pp * CL + c];
      hh = gvb[round4(g.M * CL) + pp];
    } else {
      e = -1;
    }
  }
  float4 acc[KC];
  float sq = 0.f;
  int cur = -1;
  auto flush = [&]() {  // the run's sum into its row
    if (cur < 0) return;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int col = 4 * lane + 128 * k;
      if (col < ld) {
        float4* dst = reinterpret_cast<float4*>(head + cur * ld + col);
        float4 v = *dst;
        add4(v, acc[k]);
        *dst = v;
      }
    }
    if (lane == 0) sqh[cur] += sq;
  };
  for (int i = 0; i < n; i += U) {
    int ei[U];
    float gi[U], hi[U];
    float4 hv[U][KC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ei[u] = __shfl_sync(kFull, e, (i + u) & 31);
      gi[u] = __shfl_sync(kFull, gv, (i + u) & 31);
      hi[u] = __shfl_sync(kFull, hh, (i + u) & 31);
      if (i + u >= n) ei[u] = -1;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int col = 4 * lane + 128 * k;
        const int row = min(p0 + i + u, g.M - 1);  // past the round: read, never used
        hv[u][k] = col < ld ? *reinterpret_cast<const float4*>(hb + row * ld + col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ei[u] < 0) continue;
      if ((ei[u] >> 1) != cur) {
        flush();
        cur = ei[u] >> 1;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        sq = 0.f;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) fma4(acc[k], gi[u], hv[u][k]);
      sq += gi[u] * gi[u] * hi[u];
    }
  }
  flush();
}

// The descent of the fast path: a unit of UL lanes a position, NQ float4s
// a lane (columns 4 * (sub + UL * q)), PF theta rows in flight.  A round
// takes a position a unit; a head level stores its g in gvb, and after the
// round's barrier warp c adds level c's entries into the block's partial
// (head_sums: no atomics), then g_h takes the place of h's row.
template <int NQ, int UL>
__device__ bool descend_fast(float* hb, float* head, float* sqh, float* gvb, const Tab& t,
                             const Geo& g, const K10Args& a, int rows, int64_t row0,
                             int next, float& loss_acc, float& ctr_acc) {
  constexpr int PF = NQ <= 2 ? 4 : 2;
  constexpr int kUnits = kThreads / UL;
  // the next group's raw tables on the warps the head sums leave idle, its
  // two stages in the first two rounds
  const bool ahead = next >= 0 && g.H < kWarps && g.M > kUnits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (UL - 1);
  const int unit = UL == 16 ? 2 * warp + (lane >> 4) : warp;
  const int D = g.D, ld = g.ld, CL = g.CL, H = g.H;
  float* hhb = gvb + round4(g.M * CL);  // [M] |h|^2
  for (int p0 = 0; p0 < g.M; p0 += kUnits) {  // every warp alike: its units' shuffles meet
    const int p = p0 + unit;
    const bool inb = p < rows;
    const bool tr = inb && t.vpos[p] && t.cnt[p] > 0.f;
    int plen = 0;
    if (tr)
      while (plen < CL && t.ent[p * CL + plen] >= 0) ++plen;
    float4 hr[NQ], gh[NQ];
    float hh = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = 4 * (sub + UL * q);
      hr[q] = tr && col < D ? *reinterpret_cast<const float4*>(hb + p * ld + col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      gh[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      hh += dot4(hr[q], hr[q]);
    }
    hh = unit_sum<UL>(hh);
    if (tr && sub == 0) hhb[p] = hh;
    int cmax = plen;
    if (UL == 16) cmax = max(cmax, __shfl_xor_sync(kFull, cmax, 16));
    float4 ring[PF][NQ];
    int eid[PF];
    auto fetch = [&](int u, int c) {
      eid[u] = c < plen ? t.ent[p * CL + c] : -1;
      if (eid[u] >= 0) {
        const float* src = a.theta + static_cast<int64_t>(eid[u] >> 1) * D;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int col = 4 * (sub + UL * q);
          ring[u][q] = col < D ? __ldg(reinterpret_cast<const float4*>(src + col))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
#pragma unroll
        for (int q = 0; q < NQ; ++q) ring[u][q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
#pragma unroll
    for (int u = 0; u < PF; ++u) fetch(u, u);
    for (int c0 = 0; c0 < cmax; c0 += PF) {
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int c = c0 + u;
        if (c >= cmax) break;  // alike in both halves of the warp
        const int e = eid[u];
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) part += dot4(hr[q], ring[u][q]);
        const float logit = unit_sum<UL>(part);
        if (e >= 0) {
          const float gv = entry_g(logit, e & 1, sub == 0, loss_acc);
#pragma unroll
          for (int q = 0; q < NQ; ++q) fma4(gh[q], gv, ring[u][q]);
          if (c < H) {
            if (sub == 0) gvb[p * CL + c] = gv;
          } else {
            const int64_t tr_row = (row0 + p) * g.CLT + (c - H);
            float* dst = a.g_tail + tr_row * D;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const int col = 4 * (sub + UL * q);
              if (col < D)
                *reinterpret_cast<float4*>(dst + col) =
                    make_float4(gv * hr[q].x, gv * hr[q].y, gv * hr[q].z, gv * hr[q].w);
            }
            if (sub == 0) {
              a.tail_rows[tr_row] = e >> 1;
              a.sq_tail[tr_row] = gv * gv * hh;
            }
          }
        }
        fetch(u, c + PF);
      }
    }
    if (inb)
      for (int c = max(plen, H); c < CL; ++c)
        tail_zero<UL>(a, g, (row0 + p) * g.CLT + (c - H), sub, true);
    __syncthreads();  // the round's head entries are in gvb, its h rows intact
    for (int c = warp; c < H; c += kWarps)
      head_sums<(4 * NQ * UL + 127) / 128>(hb, head, sqh, gvb, t, g, rows, p0, kUnits, c);
    if (ahead && warp >= H && p0 < 2 * kUnits)
      fetch_raw(t, g, a, next, p0 == 0 ? 1 : 2, (warp - H) * 32 + lane, (kWarps - H) * 32);
    __syncthreads();  // every warp is past the round's h rows
    if (tr) {
      const float inv = a.cbow_mean ? fmaxf(t.cnt[p], 1.f) : 1.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = 4 * (sub + UL * q);
        if (col < D)
          *reinterpret_cast<float4*>(hb + p * ld + col) =
              make_float4(gh[q].x / inv, gh[q].y / inv, gh[q].z / inv, gh[q].w / inv);
      }
      if (sub == 0) ctr_acc += 1.f;
    }
  }
  return ahead;
}

// The descent of the generic path: a warp a position, lanes over the
// columns, h in hb and g_h in ghb, one theta row a level read as it is used.
__device__ void descend_generic(const float* hb, float* ghb, float* head, float* sqh,
                                const Tab& t, const Geo& g, const K10Args& a, int rows,
                                int64_t row0, bool vec, float& loss_acc, float& ctr_acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = g.D, ld = g.ld, CL = g.CL, H = g.H;
  for (int p = warp; p < rows; p += kWarps) {
    const bool tr = t.vpos[p] && t.cnt[p] > 0.f;
    int plen = 0;
    if (tr)
      while (plen < CL && t.ent[p * CL + plen] >= 0) ++plen;
    const float* hi = hb + p * ld;
    float* gh = ghb + p * ld;
    float hh = 0.f;
    for (int k = lane; k < D; k += 32) {
      hh += hi[k] * hi[k];
      gh[k] = 0.f;
    }
    hh = warp_sum(hh);
    for (int c = 0; c < plen; ++c) {
      const int e = t.ent[p * CL + c], id = e >> 1;
      const float* th = a.theta + static_cast<int64_t>(id) * D;
      float acc = 0.f;
      for (int k = lane; k < D; k += 32) acc += hi[k] * th[k];
      const float gv = entry_g(warp_sum(acc), e & 1, lane == 0, loss_acc);
      for (int k = lane; k < D; k += 32) gh[k] += gv * th[k];
      if (c < H) {
        if (id < g.K) {
          for (int k = lane; k < D; k += 32) atomicAdd(head + id * ld + k, gv * hi[k]);
          if (lane == 0) atomicAdd(sqh + id, gv * gv * hh);
        }
      } else {
        const int64_t tr_row = (row0 + p) * g.CLT + (c - H);
        float* dst = a.g_tail + tr_row * D;
        for (int k = lane; k < D; k += 32) dst[k] = gv * hi[k];
        if (lane == 0) {
          a.tail_rows[tr_row] = id;
          a.sq_tail[tr_row] = gv * gv * hh;
        }
      }
    }
    for (int c = max(plen, H); c < CL; ++c)
      tail_zero<32>(a, g, (row0 + p) * g.CLT + (c - H), lane, vec);
    if (tr) {
      if (a.cbow_mean) {
        const float inv = fmaxf(t.cnt[p], 1.f);
        for (int k = lane; k < D; k += 32) gh[k] = gh[k] / inv;
      }
      if (lane == 0) ctr_acc += 1.f;
    }
  }
}

// ---- one block's work -----------------------------------------------------

template <int NQ, int UL, bool kFast>
__device__ __forceinline__ void cbow_hs_block(float* sm, const Geo& g, const K10Args& a) {
  float* xc = sm + g.o_xc;
  float* hb = sm + g.o_h;                  // h, then (fast path) g_h
  float* ghb = kFast ? hb : sm + g.o_gh;   // g_h
  float* head = sm + g.o_head;             // [K, ld] partial of g_head
  float* sqh = sm + g.o_sq;                // [K] partial of sq_head
  float* red = sm + g.o_red;               // [2 * kWarps]
  const Tab t = tab_of(sm, g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 16-byte global loads and stores of rows
  const bool vec = g.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.emb_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.g_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.g_tail) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.g_head) % 16 == 0;

  for (int i = tid; i < g.K * g.ld; i += kThreads) head[i] = 0.f;
  for (int i = tid; i < g.K; i += kThreads) sqh[i] = 0.f;
  float loss_acc = 0.f, ctr_acc = 0.f;
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  bool ready = false;  // the group's raw tables were fetched during the last descent
  for (int gq = blockIdx.x; gq < n_groups; gq += gridDim.x) {
    const int w0 = gq * g.G;
    const int rows = min(g.G, a.n_walks - w0) * g.L;
    const int64_t row0 = static_cast<int64_t>(w0) * g.L;
    if (!ready) {
      fetch_raw(t, g, a, gq, 1, tid, kThreads);
      __syncthreads();
      fetch_raw(t, g, a, gq, 2, tid, kThreads);
      __syncthreads();
    }
    build_tables(t, g);                  // ends at a barrier
    context_mean(xc, hb, t, g, a, vec);  // ends at a barrier
    const int next = gq + static_cast<int>(gridDim.x) < n_groups ? gq + gridDim.x : -1;
    if constexpr (kFast) {
      ready = descend_fast<NQ, UL>(hb, head, sqh, sm + g.o_gv, t, g, a, rows, row0, next,
                                   loss_acc, ctr_acc);
    } else {
      descend_generic(hb, ghb, head, sqh, t, g, a, rows, row0, vec, loss_acc, ctr_acc);
    }
    __syncthreads();
    scatter_context(ghb, t, g, a, rows, row0, vec);
    __syncthreads();  // the next group overwrites the tables and rows
  }

  // the block's partial of g_head and sq_head
  if (vec) {
    const int d4 = g.D / 4;
    for (int e = tid; e < g.K * d4; e += kThreads) {
      const int r = e / d4, col = 4 * (e - r * d4);
      const float4 v = *reinterpret_cast<const float4*>(head + r * g.ld + col);
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(a.g_head + static_cast<int64_t>(r) * g.D + col), v);
    }
  } else {
    for (int e = tid; e < g.K * g.D; e += kThreads) {
      const int r = e / g.D, col = e - r * g.D;
      const float v = head[r * g.ld + col];
      if (v != 0.f) atomicAdd(a.g_head + static_cast<int64_t>(r) * g.D + col, v);
    }
  }
  for (int e = tid; e < g.K; e += kThreads)
    if (sqh[e] != 0.f) atomicAdd(a.sq_head + e, sqh[e]);
  loss_acc = warp_sum(loss_acc);
  ctr_acc = warp_sum(ctr_acc);
  if (lane == 0) {
    red[warp] = loss_acc;
    red[kWarps + warp] = ctr_acc;
  }
  __syncthreads();
  if (tid < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[tid * kWarps + w];
    a.loss_parts[2 * blockIdx.x + tid] = s;
  }
}

template <int NQ, int UL, bool kFast>
__global__ void __launch_bounds__(kThreads, 1) cbow_hs_grads_kernel(Geo g, K10Args a) {
  extern __shared__ __align__(16) float sm[];
  cbow_hs_block<NQ, UL, kFast>(sm, g, a);
}

template <int NQ, int UL, bool kFast>
__global__ void __launch_bounds__(kThreads, 1)
cbow_hs_grads_kernel_staged(Geo g, K10Args a, float* ws, int64_t ws_stride) {
  cbow_hs_block<NQ, UL, kFast>(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, g, a);
}

template <int NQ, int UL, bool kFast>
int launch(const Geo& g, const K10Args& a, float* ws, int ws_blocks, cudaStream_t st) {
  const int n_groups = (a.n_walks + g.G - 1) / g.G;
  return n2v::launch_staged(cbow_hs_grads_kernel<NQ, UL, kFast>,
                            cbow_hs_grads_kernel_staged<NQ, UL, kFast>, kThreads, smem_bytes(g),
                            n_groups, ws, ws_blocks, st, g, a);
}

}  // namespace

// Bytes of shared memory a block takes (or of workspace it stages in) with
// a head of k_rows rows; fast: the registers-blocked descent (dim % 4 == 0,
// dim <= 512, 16-byte aligned tables and outputs).
extern "C" size_t n2v_cbow_hs_grads_smem(int length, int dim, int cl, int k_rows, int fast) {
  if (length <= 0 || dim <= 0) return 0;
  return smem_bytes(make_geo(length, dim, cl, 0, 0, k_rows, fast != 0));
}

// loss_parts must hold 2 * n_walks zeros, g_head [k_rows, dim] and sq_head
// [k_rows] zeros.  g_in [n_walks * length, dim], sq_in [n_walks * length],
// g_tail [n_walks * length * (cl - n_head), dim], sq_tail and tail_rows
// [n_walks * length * (cl - n_head)] are written whole.  Every live path
// entry of a level below n_head must be below k_rows (the trees' BFS
// numbering with k_rows = min(2^n_head - 1, n_inner)); one that is not adds
// nothing.  ws null: the blocks stage in shared memory; else in ws.
extern "C" int n2v_cbow_hs_grads(const float* emb_in, const float* theta, int dim,
                                 const int32_t* walks, const uint8_t* vocab_mask,
                                 const int32_t* b_sh, const int32_t* points,
                                 const int8_t* codes, const int32_t* lengths, int cl,
                                 int n_walks, int length, int window, int cbow_mean, int n_head,
                                 int k_rows, int fast, float* g_in, float* sq_in, float* g_tail,
                                 float* sq_tail, int32_t* tail_rows, float* g_head,
                                 float* sq_head, float* loss_parts, float* ws, int ws_blocks,
                                 void* stream) {
  if (n_walks == 0 || length <= 0) return 0;
  if (dim <= 0 || cl < 1 || window < 0 || window > 32 || n_head < 0 || n_head > cl ||
      k_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (fast && !(dim % 4 == 0 && dim <= 512 && aligned(emb_in) && aligned(theta) &&
                aligned(g_in) && aligned(g_tail) && aligned(g_head)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(length, dim, cl, window, n_head, k_rows, fast != 0);
  const K10Args a{emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths, n_walks,
                  cbow_mean, g_in, sq_in, g_tail, sq_tail, tail_rows, g_head, sq_head,
                  loss_parts};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fast) return launch<1, 32, false>(g, a, ws, ws_blocks, st);
  if (dim <= 64) return launch<1, 16, true>(g, a, ws, ws_blocks, st);
  if (dim <= 128) return launch<2, 16, true>(g, a, ws, ws_blocks, st);
  if (dim <= 256) return launch<4, 16, true>(g, a, ws, ws_blocks, st);
  return launch<4, 32, true>(g, a, ws, ws_blocks, st);
}
