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
// Design: one heavy launch reads each gradient row once.  A warp
// takes a row of the lists laid end to end: its lanes load the row as
// float4s into registers (up to 1,024 floats), sum its squares there, read
// acc0 from column D -- which this launch never writes -- and add the row's
// update with 16-byte atomics (red.global.add.v4.f32).  A table row sits at
// a stride of D + 1 floats, so its aligned run starts h = 0..3 floats in;
// the lanes realign the gradient to it with __shfl_sync (lane j takes
// chunk j's last 4 - h floats and chunk j + 1's first h), and the head and
// tail (at most 3 floats each) take scalar atomics.  Column D's increments
// are deferred: each occurrence writes its (row, square) pair (8 B), and a
// second small launch adds them, so every scale reads acc0 as the semantics
// ask.  Rows of other widths (D not a multiple of 4, a gradient list not
// 16-byte aligned, D > 1,024) take the same warp a row with scalar loads and
// atomics, the row read again from L1 for its update.
//
// Bound on an H100: memory -- each live gradient row read once, its row id,
// and a read-modify-write of each touched table row.  What holds it is the
// L2's read-modify-write of the table rows: with 128 scalar atomics a row in
// place of the 16-byte ones it takes as long, and four rows a warp in flight
// gain nothing (PERF.md, the K14 findings).

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

// The r-th gradient row of the lists laid end to end (r below their total),
// its table row v (< 0: skip) and whether it belongs to the input table.
struct RowRef {
  const float* g;
  int v;
  bool first;
};

__device__ __forceinline__ RowRef locate(const RowLists& l, int64_t r, int dim) {
  if (r < l.n_in) return {l.g_in + r * dim, l.rows_in[r], true};
  r -= l.n_in;
  if (r < l.n_out) return {l.g_out + r * dim, l.rows_out[r], false};
  r -= l.n_out;
  return {l.g_extra + r * dim, l.rows_extra[r], false};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float part(const float4& a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

// The 4 floats that start h floats into a and go on into b.
__device__ __forceinline__ float4 shifted(const float4& a, const float4& b, int h) {
  switch (h) {
    case 0: return a;
    case 1: return make_float4(a.y, a.z, a.w, b.x);
    case 2: return make_float4(a.z, a.w, b.x, b.y);
    default: return make_float4(a.w, b.x, b.y, b.z);
  }
}

// One warp, one row (D % 4 == 0, the row 16-byte aligned, D <= 128 K): the
// row in K float4s a lane, chunk k * 32 + lane in v[k].
template <int K>
__device__ __forceinline__ void row_update(float* tab_in, float* tab_out, const RowLists& l,
                                           int64_t r, int dim, float lr, int2* pend) {
  const int lane = threadIdx.x & 31;
  const RowRef ref = locate(l, r, dim);
  if (ref.v < 0) {
    if (lane == 0) pend[r] = make_int2(-1, 0);
    return;
  }
  float* t = (ref.first ? tab_in : tab_out) + static_cast<int64_t>(ref.v) * (dim + 1);
  const float acc0 = t[dim];
  const int nc = dim >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(ref.g);
  float4 v[K];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = k * 32 + lane;
    v[k] = c < nc ? __ldg(g4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc += v[k].x * v[k].x + v[k].y * v[k].y + v[k].z * v[k].z + v[k].w * v[k].w;
  }
  const float s = warp_sum(acc) / static_cast<float>(dim);
  const float sc = rsqrtf(acc0 + s + kEps);
  auto upd = [&](float x) { return (-lr * x) * sc; };
  // the table row's aligned run: h floats to its first 16-byte boundary,
  // then nb float4s, then a tail of dim - h - 4 nb floats (4 - h where h > 0)
  const int h = min(static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(t) & 15u)) & 15u) >> 2),
                    dim);
  const int nb = (dim - h) >> 2;
  const int tail = dim - h - 4 * nb;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = k * 32 + lane;  // the run's float4 j: columns h + 4 j .. h + 4 j + 3
    float4 a = v[k];
    if (h) {  // the row's, so warp-uniform: every lane shuffles
      const float4& w = v[k + 1 < K ? k + 1 : k];  // the next group's chunk, for lane 31
      float4 nx;
      nx.x = __shfl_down_sync(kFull, v[k].x, 1);
      nx.y = __shfl_down_sync(kFull, v[k].y, 1);
      nx.z = __shfl_down_sync(kFull, v[k].z, 1);
      const float wx = __shfl_sync(kFull, w.x, 0);
      const float wy = __shfl_sync(kFull, w.y, 0);
      const float wz = __shfl_sync(kFull, w.z, 0);
      if (lane == 31) {
        nx.x = wx;
        nx.y = wy;
        nx.z = wz;
      }
      nx.w = 0.f;
      a = shifted(v[k], nx, h);
    }
    if (j < nb) {
      atomicAdd(reinterpret_cast<float4*>(t + h + 4 * j),
                make_float4(upd(a.x), upd(a.y), upd(a.z), upd(a.w)));
    } else if (j == nb && tail) {  // chunk nb's floats h .. 3
      for (int e = h; e < 4; ++e) atomicAdd(t + 4 * j + e, upd(part(v[k], e)));
    }
  }
  // head and tail: at most 3 floats each, scalar atomics (the tail above)
  if (lane == 0) {
    for (int e = 0; e < h; ++e) atomicAdd(t + e, upd(part(v[0], e)));
    pend[r] = make_int2(ref.v, __float_as_int(s));
  }
}

// Any other row: scalar loads, the row read again (from L1) for its update.
__device__ __forceinline__ void row_update_scalar(float* tab_in, float* tab_out,
                                                  const RowLists& l, int64_t r, int dim, float lr,
                                                  int2* pend) {
  const int lane = threadIdx.x & 31;
  const RowRef ref = locate(l, r, dim);
  if (ref.v < 0) {
    if (lane == 0) pend[r] = make_int2(-1, 0);
    return;
  }
  float* t = (ref.first ? tab_in : tab_out) + static_cast<int64_t>(ref.v) * (dim + 1);
  const float acc0 = t[dim];
  float acc = 0.f;
  for (int k = lane; k < dim; k += 32) acc += ref.g[k] * ref.g[k];
  const float s = warp_sum(acc) / static_cast<float>(dim);
  const float sc = rsqrtf(acc0 + s + kEps);
  for (int k = lane; k < dim; k += 32) atomicAdd(t + k, (-lr * ref.g[k]) * sc);
  if (lane == 0) pend[r] = make_int2(ref.v, __float_as_int(s));
}

// K: float4s a lane holds (1, 2, 4, 8), 0 for the scalar rows.
template <int K>
__global__ void __launch_bounds__(kThreads)
fused_rows_kernel(float* tab_in, float* tab_out, const RowLists l, int64_t n, int dim,
                  float lr, int2* __restrict__ pend) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  if (K == 0)
    row_update_scalar(tab_in, tab_out, l, r, dim, lr, pend);
  else
    row_update<(K > 0 ? K : 1)>(tab_in, tab_out, l, r, dim, lr, pend);
}

// Column D: each live occurrence's square, added once every scale is read.
__global__ void __launch_bounds__(kThreads)
fused_squares_kernel(float* tab_in, float* tab_out, const int2* __restrict__ pend, int64_t n_in,
                     int64_t n, int dim) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int2 p = pend[r];
  if (p.x >= 0)
    atomicAdd((r < n_in ? tab_in : tab_out) + static_cast<int64_t>(p.x) * (dim + 1) + dim,
              __int_as_float(p.y));
}

template <int K>
int launch(float* tab_in, float* tab_out, const RowLists& l, int64_t n, int dim, float lr,
           int2* pend, cudaStream_t s) {
  fused_rows_kernel<K><<<static_cast<unsigned>((n + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      tab_in, tab_out, l, n, dim, lr, pend);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_squares_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      tab_in, tab_out, pend, l.n_in, n, dim);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// tab_in, tab_out: [V, dim + 1]; the grads [n, dim] beside int32 rows [n];
// pend: int32 scratch of 2 (n_in + n_out + n_extra) entries.
extern "C" int n2v_fused_adagrad(float* tab_in, float* tab_out, const float* g_in,
                                 const int32_t* rows_in, int64_t n_in,
                                 const float* g_out, const int32_t* rows_out,
                                 int64_t n_out, const float* g_extra,
                                 const int32_t* rows_extra, int64_t n_extra, int dim,
                                 float lr, int32_t* pend, void* stream) {
  if (dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  const RowLists l{g_in, g_out, g_extra, rows_in, rows_out, rows_extra, n_in, n_out, n_extra};
  const int64_t n = n_in + n_out + n_extra;
  if (n == 0) return 0;
  int2* p = reinterpret_cast<int2*>(pend);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dim % 4 == 0 && aligned16(g_in) && aligned16(g_out) && aligned16(g_extra);
  if (!vec || dim > 1024) return launch<0>(tab_in, tab_out, l, n, dim, lr, p, s);
  if (dim <= 128) return launch<1>(tab_in, tab_out, l, n, dim, lr, p, s);
  if (dim <= 256) return launch<2>(tab_in, tab_out, l, n, dim, lr, p, s);
  if (dim <= 512) return launch<4>(tab_in, tab_out, l, n, dim, lr, p, s);
  return launch<8>(tab_in, tab_out, l, n, dim, lr, p, s);
}
