// K3 adagrad_accumulate and K4 adagrad_apply: the row-wise Adagrad of one
// walk-structured SGNS step, per occurrence (the non-preaggregated path).
//
// Replaces node2vec_tpu/models/skipgram.py:463-475:
//   K3: acc_in[rows]  += mean(g_in^2)  * row_valid
//       acc_out[rows] += mean(g_out^2) * row_valid
//       acc_out[neg]  += mean(d_no^2)
//   K4: emb_in[rows]  += -lr * g_in  * rsqrt(acc_in[rows]  + 1e-12) * row_valid
//       emb_out[rows] += -lr * g_out * rsqrt(acc_out[rows] + 1e-12) * row_valid
//       emb_out[neg]  += -lr * d_no  * rsqrt(acc_out[neg]  + 1e-12)
// with rows = max(walks, 0) and row_valid = walks >= 0.
//
// They are two launches on purpose: every occurrence's square has to land
// in the accumulator before any row reads it back, and context rows and
// negatives share acc_out.  Fusing them into one pass that reads partial
// accumulators would change the update.  Duplicate rows and duplicate
// negatives accumulate through fp32 atomics (in another order than the
// JAX scatter, hence a tolerance in the comparisons).
//
// Design: one warp per gradient row (B*L1 walk positions, then S negatives);
// the row's squares are a warp reduction, and its update is one coalesced
// pass of atomics over the table row.  Invalid positions (walks < 0) add
// exact zeros in the JAX version and are skipped here.
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

__global__ void __launch_bounds__(kThreads)
adagrad_accumulate_kernel(float* __restrict__ acc_in, float* __restrict__ acc_out,
                          const float* __restrict__ g_in,
                          const float* __restrict__ g_out,
                          const float* __restrict__ d_no,
                          const int32_t* __restrict__ walks, int64_t n_rows,
                          const int32_t* __restrict__ neg_ids, int n_neg, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r < n_rows) {
    const int v = walks[r];
    if (v < 0) return;
    const float sq_in = row_mean_sq(g_in + r * dim, dim, lane);
    const float sq_out = row_mean_sq(g_out + r * dim, dim, lane);
    if (lane == 0) {
      atomicAdd(acc_in + v, sq_in);
      atomicAdd(acc_out + v, sq_out);
    }
  } else if (r < n_rows + n_neg) {
    const int64_t s = r - n_rows;
    const float sq = row_mean_sq(d_no + s * dim, dim, lane);
    if (lane == 0) atomicAdd(acc_out + neg_ids[s], sq);
  }
}

__global__ void __launch_bounds__(kThreads)
adagrad_apply_kernel(float* __restrict__ emb_in, float* __restrict__ emb_out,
                     const float* __restrict__ acc_in,
                     const float* __restrict__ acc_out,
                     const float* __restrict__ g_in,
                     const float* __restrict__ g_out,
                     const float* __restrict__ d_no,
                     const int32_t* __restrict__ walks, int64_t n_rows,
                     const int32_t* __restrict__ neg_ids, int n_neg, int dim,
                     float lr) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r < n_rows) {
    const int v = walks[r];
    if (v < 0) return;
    const float s_in = rsqrtf(acc_in[v] + kEps);
    const float s_out = rsqrtf(acc_out[v] + kEps);
    float* t_in = emb_in + static_cast<int64_t>(v) * dim;
    float* t_out = emb_out + static_cast<int64_t>(v) * dim;
    const float* gi = g_in + r * dim;
    const float* go = g_out + r * dim;
    for (int k = lane; k < dim; k += 32) {
      atomicAdd(t_in + k, (-lr * gi[k]) * s_in);
      atomicAdd(t_out + k, (-lr * go[k]) * s_out);
    }
  } else if (r < n_rows + n_neg) {
    const int64_t s = r - n_rows;
    const int v = neg_ids[s];
    const float scale = rsqrtf(acc_out[v] + kEps);
    float* t = emb_out + static_cast<int64_t>(v) * dim;
    const float* g = d_no + s * dim;
    for (int k = lane; k < dim; k += 32) atomicAdd(t + k, (-lr * g[k]) * scale);
  }
}

unsigned n_blocks(int64_t n_rows, int n_neg) {
  return static_cast<unsigned>((n_rows + n_neg + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int n2v_adagrad_accumulate(float* acc_in, float* acc_out,
                                      const float* g_in, const float* g_out,
                                      const float* d_no, const int32_t* walks,
                                      int64_t n_rows, const int32_t* neg_ids,
                                      int n_neg, int dim, void* stream) {
  if (n_rows + n_neg == 0) return 0;
  adagrad_accumulate_kernel<<<n_blocks(n_rows, n_neg), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      acc_in, acc_out, g_in, g_out, d_no, walks, n_rows, neg_ids, n_neg, dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int n2v_adagrad_apply(float* emb_in, float* emb_out,
                                 const float* acc_in, const float* acc_out,
                                 const float* g_in, const float* g_out,
                                 const float* d_no, const int32_t* walks,
                                 int64_t n_rows, const int32_t* neg_ids,
                                 int n_neg, int dim, float lr, void* stream) {
  if (n_rows + n_neg == 0) return 0;
  adagrad_apply_kernel<<<n_blocks(n_rows, n_neg), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      emb_in, emb_out, acc_in, acc_out, g_in, g_out, d_no, walks, n_rows,
      neg_ids, n_neg, dim, lr);
  return static_cast<int>(cudaGetLastError());
}
