// K14 fused_adagrad: the one-pass row-wise Adagrad of the fused-table SGNS
// step, on [V, D+1] tables whose column D is the row's accumulator.
//
// Replaces node2vec_tpu/models/skipgram.py:597-620 (inside
// sgns_walk_step_fused_impl, :506).  Over three (grads, rows) lists -- g_in
// at rows_in of tab_in, g_out at rows_out and d_no at the negatives of
// tab_out -- each occurrence r adds
//   tab[v, :D] += -lr * g_r * rsqrt(acc0[v] + sq_r + 1e-12)
//   tab[v, D]  += sq_r,          sq_r = mean(g_r^2)
// where acc0 is column D as it stood before the batch.  Repeated rows do not
// see each other's squares: that is the JAX semantics (:523-537).  A row id
// < 0 (walks < 0) skips its occurrence; JAX adds exact zeros to row 0 there.
//
// Two launches, because the scatter writes the very column the scale reads:
// atomics into column D during one pass would let a later occurrence read
// an accumulator the batch already moved.  Launch 1 reads acc0 and writes
// each occurrence's (scale, sq) to scratch; launch 2 only adds.
//
// Design: a warp a gradient row in both launches (the lists laid end to
// end); the row's squares are a warp reduction, its update one pass of
// fp32 atomics over D + 1 floats.  Bound on an H100: memory -- the grads
// read twice (once per launch) where the function needs them once, the
// scratch (8 B an occurrence) written and read, and a read-modify-write of
// each touched table row.

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

// The r-th row of the lists laid end to end: its gradient row, its table
// row v (< 0: skip) and whether it belongs to the input table (list 0).
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
fused_scale_kernel(const float* __restrict__ tab_in, const float* __restrict__ tab_out,
                   RowLists l, int dim, float* __restrict__ scale,
                   float* __restrict__ sq) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const float* g;
  int v;
  bool first;
  if (!locate(l, r, dim, g, v, first) || v < 0) return;
  float acc = 0.f;
  for (int k = lane; k < dim; k += 32) acc += g[k] * g[k];
  const float s = warp_sum(acc) / static_cast<float>(dim);
  if (lane == 0) {
    const float acc0 = (first ? tab_in : tab_out)[static_cast<int64_t>(v) * (dim + 1) + dim];
    scale[r] = rsqrtf(acc0 + s + kEps);
    sq[r] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_add_kernel(float* __restrict__ tab_in, float* __restrict__ tab_out, RowLists l,
                 int dim, const float* __restrict__ scale, const float* __restrict__ sq,
                 float lr) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const float* g;
  int v;
  bool first;
  if (!locate(l, r, dim, g, v, first) || v < 0) return;
  float* t = (first ? tab_in : tab_out) + static_cast<int64_t>(v) * (dim + 1);
  const float sc = scale[r];
  for (int k = lane; k < dim; k += 32) atomicAdd(t + k, (-lr * g[k]) * sc);
  if (lane == 0) atomicAdd(t + dim, sq[r]);
}

}  // namespace

// tab_in, tab_out: [V, dim + 1]; the grads [n, dim] beside int32 rows [n];
// scale and sq: float scratch of n_in + n_out + n_extra entries.
extern "C" int n2v_fused_adagrad(float* tab_in, float* tab_out, const float* g_in,
                                 const int32_t* rows_in, int64_t n_in,
                                 const float* g_out, const int32_t* rows_out,
                                 int64_t n_out, const float* g_extra,
                                 const int32_t* rows_extra, int64_t n_extra, int dim,
                                 float lr, float* scale, float* sq, void* stream) {
  const RowLists l{g_in, g_out, g_extra, rows_in, rows_out, rows_extra, n_in, n_out, n_extra};
  const int64_t n = n_in + n_out + n_extra;
  if (n == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_scale_kernel<<<grid, kThreads, 0, s>>>(tab_in, tab_out, l, dim, scale, sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_add_kernel<<<grid, kThreads, 0, s>>>(tab_in, tab_out, l, dim, scale, sq, lr);
  return static_cast<int>(cudaGetLastError());
}
