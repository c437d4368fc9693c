// K3 adagrad_accumulate and K4 adagrad_apply: row-wise Adagrad per
// occurrence over three (grads, rows) lists.
//
// Replaces node2vec_tpu/models/skipgram.py:463-475 (SGNS) and
// node2vec_tpu/models/hsoftmax.py:396-429 (HS):
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
//
// K3 has a second mode, "squares given", for the column-sharded step
// (node2vec_tpu/parallel/sharded_sgns.py:106-116, col_sgns.cu): each row's
// square arrives already summed over the model group's column slices, and
//   acc_in[rows_in]     += sq_in / D
//   acc_out[rows_out]   += sq_out / D
//   acc_out[rows_extra] += sq_extra / D
// with D the full width, one thread a row, rows < 0 skipped (the JAX step
// multiplies their squares by a zero validity weight).
//
// They are two launches on purpose: every occurrence's square has to land
// in the accumulator before any row reads it back, and two lists share
// acc_out.  Fusing them into one pass that reads partial accumulators would
// change the update.  Duplicate rows accumulate through fp32 atomics (in
// another order than the JAX scatter, hence a tolerance in the
// comparisons).
//
// Design: one warp per gradient row of the three lists laid end to end;
// the row's squares are a warp reduction, and its update is one coalesced
// pass of atomics over the table row.
//
// Bound on an H100: memory — reading the grads once and a read-modify-write
// of each touched accumulator entry (K3) or table row (K4).

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float row_mean_sq(const float* g, int dim, int lane) {
  float acc = 0.f;
  for (int k = lane; k < dim; k += 32) acc += g[k] * g[k];
  return warp_sum(acc) / static_cast<float>(dim);
}

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

__global__ void __launch_bounds__(kThreads)
adagrad_accumulate_kernel(float* __restrict__ acc_in, float* __restrict__ acc_out,
                          RowLists l, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const float* g;
  int v;
  bool first;
  if (!locate(l, r, dim, g, v, first) || v < 0) return;
  const float sq = row_mean_sq(g, dim, lane);
  if (lane == 0) atomicAdd((first ? acc_in : acc_out) + v, sq);
}

__global__ void __launch_bounds__(kThreads)
adagrad_apply_kernel(float* __restrict__ emb_in, float* __restrict__ emb_out,
                     const float* __restrict__ acc_in,
                     const float* __restrict__ acc_out, RowLists l, int dim,
                     float lr) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const float* g;
  int v;
  bool first;
  if (!locate(l, r, dim, g, v, first) || v < 0) return;
  const float scale = rsqrtf((first ? acc_in : acc_out)[v] + kEps);
  float* t = (first ? emb_in : emb_out) + static_cast<int64_t>(v) * dim;
  for (int k = lane; k < dim; k += 32) atomicAdd(t + k, (-lr * g[k]) * scale);
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

unsigned n_blocks(const RowLists& l) {
  return static_cast<unsigned>((l.n_in + l.n_out + l.n_extra + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int n2v_adagrad_accumulate(float* acc_in, float* acc_out,
                                      const float* g_in, const int32_t* rows_in,
                                      int64_t n_in, const float* g_out,
                                      const int32_t* rows_out, int64_t n_out,
                                      const float* g_extra,
                                      const int32_t* rows_extra, int64_t n_extra,
                                      int dim, void* stream) {
  const RowLists l = make_lists(g_in, rows_in, n_in, g_out, rows_out, n_out, g_extra,
                                rows_extra, n_extra);
  if (n_blocks(l) == 0) return 0;
  adagrad_accumulate_kernel<<<n_blocks(l), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(acc_in, acc_out, l, dim);
  return static_cast<int>(cudaGetLastError());
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
  if (n_blocks(l) == 0) return 0;
  adagrad_apply_kernel<<<n_blocks(l), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      emb_in, emb_out, acc_in, acc_out, l, dim, lr);
  return static_cast<int>(cudaGetLastError());
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
