// K3 adagrad_accumulate and K4 adagrad_apply: row-wise Adagrad per
// occurrence over three (grads, rows) lists.
//
// Replaces node2vec_tpu/models/skipgram.py:463-475 (SGNS),
// node2vec_tpu/models/hsoftmax.py:396-429 (HS) and models/cbow.py:306-322
// (CBOW-HS):
//   K3: acc_in[rows_in]     += mean(g_in^2)
//       acc_out[rows_out]   += mean(g_out^2)
//       acc_out[rows_extra] += mean(g_extra^2)
//   K4: emb_in[rows_in]     += -lr * g_in    * rsqrt(acc_in[rows_in]     + 1e-12)
//       emb_out[rows_out]   += -lr * g_out   * rsqrt(acc_out[rows_out]   + 1e-12)
//       emb_out[rows_extra] += -lr * g_extra * rsqrt(acc_out[rows_extra] + 1e-12)
// where a row id < 0 skips its gradient row (the JAX versions add exact
// zeros there).  SGNS: rows_in = rows_out = the flat walks, the extra list
// its shared negatives with d_no.  HS: rows_in = the flat walks, rows_out
// the tail path entries' theta rows (-1 where masked) with the
// per-occurrence tail gradients, the extra list the head rows 0..K-1 with
// the pre-aggregated d_head.  HS's head and tail rows are disjoint (BFS
// numbering), so the JAX order (head, emb_in, tail) equals one pass.
// CBOW-HS: K10's lists (cbow_hs.cu), the flat walks, the tail path
// entries' theta rows and the head rows 0..K-1 with the head's gradients
// summed per row, each with its own squares (below).
//
// K3 has a second mode, "squares given", for the column-sharded step
// (node2vec_tpu/parallel/sharded_sgns.py:106-116, col_sgns.cu), the row
// layout's owners and the CBOW-HS step: each row's square arrives already
// summed (over the model group's column slices; over a head row's path
// occurrences, each occurrence's own square), and
//   acc_in[rows_in]     += sq_in / D
//   acc_out[rows_out]   += sq_out / D
//   acc_out[rows_extra] += sq_extra / D
// with D the full width, one thread a row, rows < 0 skipped (the JAX step
// multiplies their squares by a zero validity weight).
//
// They are two launches on purpose: every occurrence's square has to land
// in the accumulator before any row reads it back, and two lists share
// acc_out.  Fusing them into one pass that reads partial accumulators would
// change the update.
//
// K3's design (Hopper): a block of 8 warps takes a run of rows of the lists
// laid end to end (32 at D = 128), each warp kUnroll rows a lane group, as
// many blocks as runs: every row's loads are in flight at once, as in K3's
// first design (a warp a row), with 4 rows a warp.  Each row is read by T
// lanes (T the power of two that covers the row's float4s, at most 32;
// 32 / T rows side by side), 16 bytes a lane where D % 4 == 0 and the
// lists' bases are 16-byte aligned, 4 bytes otherwise (the host picks; both
// are this kernel).  Duplicate row ids are combined before the global
// atomics, twice: equal ids among a lane group's kUnroll rows are summed in
// registers (a pair list's center recurs 2w times in a row), and the mean
// square of a row whose id is below kHot goes into the block's shared array
// for its accumulator, each nonzero entry of which is added to the
// accumulator with one fp32 atomic when the block ends (a block with no hot
// id, found by one barrier, skips its arrays); any other id takes its
// global atomic at once.  No atomic waits on its result.  With the
// Huffman trees' BFS numbering the hot ids are the top 9 levels of HS's and
// CBOW-HS's theta rows (the root alone is on every path: about 54k
// occurrences a step), so a block's occurrences of a top node cost one
// atomic, not one each; any list, one id repeated everywhere included,
// gives the plain version's sums up to fp32 order (the JAX scatter sums in
// yet another order, hence a tolerance in the comparisons).
//
// K4's design (Hopper): the first one (PR 1) took a warp a row and one
// 4-byte atomic an element (on CBOW-HS's per-occurrence lists 0.627 ms, of
// which 0.045 was contention on the hot rows: the same lists with every
// theta row made distinct took 0.582; experiments/k10_attribution.py).  So
// the atomics themselves bound it, not their addresses.  Now a block takes
// a run of rows as K3 does (T lanes a row, kUnroll rows a lane group, 16
// bytes a lane where D % 4 == 0 and the lists' and tables' bases are
// 16-byte aligned; a lane group's rows consecutive, so a pair list's run of
// one center meets in one group at any D), reads every row's scale -lr * rsqrt(acc[v] + 1e-12)
// before its loads, sums equal rows of a lane group in registers (a pair
// list's center recurs 2w times in a row) and adds each remaining row with
// one 16-byte atomic per 4 elements (sm_90's vector atomics), no atomic
// waiting on its result.  A dead row issues no load and no atomic.  K4
// reads the accumulators only, so every scale is read before any row is
// written.  K3's squares mode is one thread a row.
//
// Bound on an H100: memory — reading the grads once and a read-modify-write
// of each touched accumulator entry (K3) or table row (K4).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kEps = 1e-12f;

struct RowLists {
  const float *g_in, *g_out, *g_extra;
  const int32_t *rows_in, *rows_out, *rows_extra;
  int64_t n_in, n_out, n_extra;
};

// The r-th row of the lists laid end to end: its gradient row, its table
// row v (< 0: skip) and whether it belongs to the input table (list 0).
// Named fields and selects, so nothing indexes the kernel's parameters.
__device__ __forceinline__ bool locate(const RowLists& l, int64_t r, int dim,
                                       const float*& g, int& v, bool& first) {
  first = r < l.n_in;
  if (first) {
    v = l.rows_in[r];
    g = l.g_in + r * dim;
    return true;
  }
  r -= l.n_in;
  if (r < l.n_out) {
    v = l.rows_out[r];
    g = l.g_out + r * dim;
    return true;
  }
  r -= l.n_out;
  if (r < l.n_extra) {
    v = l.rows_extra[r];
    g = l.g_extra + r * dim;
    return true;
  }
  return false;
}

__device__ __forceinline__ float plus(float a, float b) { return a + b; }
__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// g * (-lr * scale): within an ulp of the plain version's (-lr * g) * scale
__device__ __forceinline__ float times(float g, float s) { return g * s; }
__device__ __forceinline__ float4 times(float4 g, float s) {
  return make_float4(g.x * s, g.y * s, g.z * s, g.w * s);
}

// ---- K3 -------------------------------------------------------------------

constexpr int kHot = 512;        // ids below it are summed in the block's shared arrays
constexpr int kUnroll = 4;       // rows a group of lanes loads at once
constexpr int kK3Threads = 256;
constexpr int kK3Warps = kK3Threads / 32;

// Sum of squares of n floats (kVec: n / 4 float4s) from g, lanes sub, sub +
// kT, ... of a group of kT lanes; each of kUnroll rows' loads issued before
// any is used.
template <bool kVec, int kT>
__device__ __forceinline__ void row_squares(const float* const (&g)[kUnroll], int dim, int sub,
                                            float (&acc)[kUnroll]) {
  const int n = kVec ? dim / 4 : dim;
  for (int c = sub; c < n; c += kT) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kVec) {
        const float4 x = g[u] != nullptr ? __ldg(reinterpret_cast<const float4*>(g[u]) + c)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u] = x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      } else {
        const float x = g[u] != nullptr ? __ldg(g[u] + c) : 0.f;
        v[u] = x * x;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] += v[u];
  }
}

// A block's run of rows: kK3Warps * (32 / kT) * kUnroll rows of the lists
// laid end to end, kUnroll a group of kT lanes.
template <bool kVec, int kT>
__device__ __forceinline__ void accumulate_rows(float* acc_in, float* acc_out,
                                                const RowLists& l, int dim, float* hot) {
  constexpr int kSides = 32 / kT;  // rows side by side in a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (kT - 1), side = lane / kT;
  const int64_t n = l.n_in + l.n_out + l.n_extra;
  const float inv_dim = 1.f / static_cast<float>(dim);
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * kK3Warps + warp) * kSides * kUnroll;
  const float* g[kUnroll];
  int id[kUnroll];
  bool first[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t r = base + u * kSides + side;
    g[u] = nullptr;
    id[u] = -1;
    first[u] = false;
    if (r < n) locate(l, r, dim, g[u], id[u], first[u]);
    if (id[u] < 0) g[u] = nullptr;
  }
  float acc[kUnroll] = {};
  row_squares<kVec, kT>(g, dim, sub, acc);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int off = kT / 2; off > 0; off >>= 1) acc[u] += __shfl_xor_sync(kFull, acc[u], off);
  // equal rows of the lane group summed first (a pair list's center recurs
  // 2w times in a row)
#pragma unroll
  for (int u = 1; u < kUnroll; ++u)
#pragma unroll
    for (int u2 = 0; u2 < u; ++u2)
      if (id[u] >= 0 && id[u2] == id[u] && first[u2] == first[u]) {
        acc[u2] += acc[u];
        id[u] = -1;
      }
  // the block's hot arrays, only where one of its rows has a hot id (the
  // barrier after every row's loads have come back)
  bool mine = false;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) mine |= id[u] >= 0 && id[u] < kHot;
  const bool hot_block = __syncthreads_or(mine) != 0;
  if (hot_block) {
    for (int e = threadIdx.x; e < 2 * kHot; e += kK3Threads) hot[e] = 0.f;
    __syncthreads();
  }
  // the group's lanes take a row each: a hot id into the block's array, any
  // other straight to its accumulator (no atomic waits on a result)
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (sub != u % kT || id[u] < 0) continue;
    const float v = acc[u] * inv_dim;
    if (id[u] < kHot) {
      atomicAdd(hot + (first[u] ? 0 : kHot) + id[u], v);
    } else {
      atomicAdd((first[u] ? acc_in : acc_out) + id[u], v);
    }
  }
  if (!hot_block) return;
  __syncthreads();  // the block's rows are in its arrays
  for (int e = threadIdx.x; e < 2 * kHot; e += kK3Threads) {
    const float v = hot[e];
    if (v != 0.f) atomicAdd((e < kHot ? acc_in : acc_out) + (e & (kHot - 1)), v);
  }
}

template <bool kVec, int kT>
__global__ void __launch_bounds__(kK3Threads)
adagrad_accumulate_kernel(float* __restrict__ acc_in, float* __restrict__ acc_out,
                          RowLists l, int dim) {
  __shared__ float hot[2 * kHot];  // [acc_in's, acc_out's]
  accumulate_rows<kVec, kT>(acc_in, acc_out, l, dim, hot);
}

template <bool kVec, int kT>
int launch_accumulate(float* acc_in, float* acc_out, const RowLists& l, int64_t n, int dim,
                      cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(kK3Warps) * (32 / kT) * kUnroll;  // a block's
  adagrad_accumulate_kernel<kVec, kT>
      <<<static_cast<unsigned>((n + rows - 1) / rows), kK3Threads, 0, stream>>>(acc_in, acc_out,
                                                                                l, dim);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_accumulate(float* acc_in, float* acc_out, const RowLists& l, int64_t n, int dim,
                      int t, cudaStream_t stream) {
  switch (t) {
    case 32: return launch_accumulate<kVec, 32>(acc_in, acc_out, l, n, dim, stream);
    case 16: return launch_accumulate<kVec, 16>(acc_in, acc_out, l, n, dim, stream);
    case 8: return launch_accumulate<kVec, 8>(acc_in, acc_out, l, n, dim, stream);
    case 4: return launch_accumulate<kVec, 4>(acc_in, acc_out, l, n, dim, stream);
    case 2: return launch_accumulate<kVec, 2>(acc_in, acc_out, l, n, dim, stream);
    default: return launch_accumulate<kVec, 1>(acc_in, acc_out, l, n, dim, stream);
  }
}

// ---- K4 -------------------------------------------------------------------

constexpr int kK4Threads = 256;
constexpr int kK4Warps = kK4Threads / 32;

__device__ __forceinline__ void atomic_add_piece(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}
__device__ __forceinline__ void atomic_add_piece(float* dst, float v) { atomicAdd(dst, v); }

// A block's run of rows, kK4Warps * (32 / kT) * kUnroll rows of the lists
// laid end to end, kUnroll consecutive rows a group of kT lanes: every
// row's scale read and every load of a column step issued before any is
// used; equal rows of the group summed in registers before their atomic.
template <bool kVec, int kT>
__global__ void __launch_bounds__(kK4Threads)
adagrad_apply_kernel(float* __restrict__ emb_in, float* __restrict__ emb_out,
                     const float* __restrict__ acc_in, const float* __restrict__ acc_out,
                     RowLists l, int dim, float lr) {
  using Piece = typename std::conditional<kVec, float4, float>::type;
  constexpr int kSides = 32 / kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (kT - 1), side = lane / kT;
  const int64_t n = l.n_in + l.n_out + l.n_extra;
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * kK4Warps + warp) * kSides * kUnroll;
  const Piece* g[kUnroll];
  float* dst[kUnroll];
  float scale[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t r = base + side * kUnroll + u;
    const float* gr = nullptr;
    int id = -1;
    bool first = false;
    if (r < n) locate(l, r, dim, gr, id, first);
    g[u] = id >= 0 ? reinterpret_cast<const Piece*>(gr) : nullptr;
    dst[u] = id >= 0 ? (first ? emb_in : emb_out) + static_cast<int64_t>(id) * dim : nullptr;
    scale[u] = id >= 0 ? -lr * rsqrtf((first ? acc_in : acc_out)[id] + kEps) : 0.f;
  }
  // a row equal to an earlier one of the group adds into it (same table
  // row, same scale): one atomic for both
  int into[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    into[u] = -1;
#pragma unroll
    for (int u2 = 0; u2 < u; ++u2)
      if (into[u] < 0 && g[u] != nullptr && into[u2] < 0 && dst[u2] == dst[u]) into[u] = u2;
  }
  const int pieces = kVec ? dim / 4 : dim;
  for (int c = sub; c < pieces; c += kT) {
    Piece v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (kVec) {
        v[u] = g[u] != nullptr ? Piece(__ldg(reinterpret_cast<const float4*>(g[u]) + c))
                               : Piece();
      } else {
        v[u] = g[u] != nullptr ? Piece(__ldg(reinterpret_cast<const float*>(g[u]) + c))
                               : Piece();
      }
    }
#pragma unroll
    for (int u = 1; u < kUnroll; ++u)
#pragma unroll
      for (int u2 = 0; u2 < u; ++u2)
        if (into[u] == u2) v[u2] = plus(v[u2], v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g[u] != nullptr && into[u] < 0)
        atomic_add_piece(dst[u] + (kVec ? 4 : 1) * c, times(v[u], scale[u]));
  }
}

template <bool kVec, int kT>
int launch_apply(float* emb_in, float* emb_out, const float* acc_in, const float* acc_out,
                 const RowLists& l, int64_t n, int dim, float lr, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(kK4Warps) * (32 / kT) * kUnroll;  // a block's
  adagrad_apply_kernel<kVec, kT><<<static_cast<unsigned>((n + rows - 1) / rows), kK4Threads, 0,
                                   stream>>>(emb_in, emb_out, acc_in, acc_out, l, dim, lr);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_apply(float* emb_in, float* emb_out, const float* acc_in, const float* acc_out,
                 const RowLists& l, int64_t n, int dim, float lr, int t, cudaStream_t stream) {
  switch (t) {
    case 32: return launch_apply<kVec, 32>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, stream);
    case 16: return launch_apply<kVec, 16>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, stream);
    case 8: return launch_apply<kVec, 8>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, stream);
    case 4: return launch_apply<kVec, 4>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, stream);
    case 2: return launch_apply<kVec, 2>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, stream);
    default: return launch_apply<kVec, 1>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, stream);
  }
}

__global__ void __launch_bounds__(kThreads)
adagrad_accumulate_squares_kernel(float* __restrict__ acc_in, float* __restrict__ acc_out,
                                  RowLists l, float div) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const float* sq;
  int v;
  bool first;
  // each list's "gradient row" is one float: locate at width 1
  if (!locate(l, r, 1, sq, v, first) || v < 0) return;
  atomicAdd((first ? acc_in : acc_out) + v, *sq / div);
}

RowLists make_lists(const float* g_in, const int32_t* rows_in, int64_t n_in,
                    const float* g_out, const int32_t* rows_out, int64_t n_out,
                    const float* g_extra, const int32_t* rows_extra, int64_t n_extra) {
  return RowLists{g_in, g_out, g_extra, rows_in, rows_out, rows_extra, n_in, n_out, n_extra};
}

// K4's pieces: 16 bytes where the row length and every base allow it
bool aligned16(const void* p, int64_t rows) {
  return rows == 0 || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// lanes a row: the least power of two >= the row's pieces, at most 32
int lanes_a_row(int pieces) {
  int t = 1;
  while (t < pieces && t < 32) t *= 2;
  return t;
}

}  // namespace

// K3.  Rows go 16 bytes a lane where dim % 4 == 0 and every list's base is
// 16-byte aligned, else 4; T lanes a row, T the least power of two >= the
// row's pieces, at most 32.  A block a run of kK3Warps * (32 / T) * kUnroll
// rows.
extern "C" int n2v_adagrad_accumulate(float* acc_in, float* acc_out,
                                      const float* g_in, const int32_t* rows_in,
                                      int64_t n_in, const float* g_out,
                                      const int32_t* rows_out, int64_t n_out,
                                      const float* g_extra,
                                      const int32_t* rows_extra, int64_t n_extra,
                                      int dim, void* stream) {
  const RowLists l = make_lists(g_in, rows_in, n_in, g_out, rows_out, n_out, g_extra,
                                rows_extra, n_extra);
  const int64_t n = n_in + n_out + n_extra;
  if (n == 0 || dim <= 0) return 0;
  auto aligned = [](const float* p, int64_t rows) {
    return rows == 0 || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = dim % 4 == 0 && aligned(g_in, n_in) && aligned(g_out, n_out) &&
                   aligned(g_extra, n_extra);
  const int pieces = vec ? dim / 4 : dim;
  int t = 1;
  while (t < pieces && t < 32) t *= 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_accumulate<true>(acc_in, acc_out, l, n, dim, t, st)
             : launch_accumulate<false>(acc_in, acc_out, l, n, dim, t, st);
}

extern "C" int n2v_adagrad_apply(float* emb_in, float* emb_out, const float* acc_in,
                                 const float* acc_out, const float* g_in,
                                 const int32_t* rows_in, int64_t n_in,
                                 const float* g_out, const int32_t* rows_out,
                                 int64_t n_out, const float* g_extra,
                                 const int32_t* rows_extra, int64_t n_extra, int dim,
                                 float lr, void* stream) {
  const RowLists l = make_lists(g_in, rows_in, n_in, g_out, rows_out, n_out, g_extra,
                                rows_extra, n_extra);
  const int64_t n = n_in + n_out + n_extra;
  if (n == 0 || dim <= 0) return 0;
  const bool vec = dim % 4 == 0 && aligned16(g_in, n_in) && aligned16(g_out, n_out) &&
                   aligned16(g_extra, n_extra) && aligned16(emb_in, 1) &&
                   aligned16(emb_out, 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = lanes_a_row(vec ? dim / 4 : dim);
  return vec ? launch_apply<true>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, t, st)
             : launch_apply<false>(emb_in, emb_out, acc_in, acc_out, l, n, dim, lr, t, st);
}

// K3's squares mode: three (squares [n], rows [n]) lists, D the full width.
extern "C" int n2v_adagrad_accumulate_squares(float* acc_in, float* acc_out,
                                              const float* sq_in, const int32_t* rows_in,
                                              int64_t n_in, const float* sq_out,
                                              const int32_t* rows_out, int64_t n_out,
                                              const float* sq_extra,
                                              const int32_t* rows_extra, int64_t n_extra,
                                              int dim, void* stream) {
  const RowLists l = make_lists(sq_in, rows_in, n_in, sq_out, rows_out, n_out, sq_extra,
                                rows_extra, n_extra);
  const int64_t n = n_in + n_out + n_extra;
  if (n == 0) return 0;
  adagrad_accumulate_squares_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc_in, acc_out, l, static_cast<float>(dim));
  return static_cast<int>(cudaGetLastError());
}
