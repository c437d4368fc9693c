// K11 preagg_rows: one summed gradient per distinct vertex of an SGNS
// batch, with its occurrence count; and sgd_apply, the SGD update on them.
//
// Replaces node2vec_tpu/models/skipgram.py:405-443, the pre-aggregated
// branch of sgns_walk_step_impl that optimizer="sgd" forces (and that
// preagg=True takes with Adagrad):
//   preagg_rows (:409-423, :431-433): over the batch's flat rows [N = B*L1],
//     ga_in[s]  = sum of g_in[r]  over the rows r of vertex s with walks >= 0
//     ga_out[s] = sum of g_out[r] over the same rows
//     cnt[s]    = the number of those rows (out-of-vocabulary rows count,
//                 with their zero gradients)
//   sgd_apply (:434-442):
//     emb_in[v]  += -lr * ga_in  * 1 / max(cnt, 1)   for every segment head v
//     emb_out[v] += -lr * ga_out * 1 / max(cnt, 1)
//     emb_out[neg_ids[j]] += -lr * d_no[j] / max(pairs * K / S, 1)
// The JAX version argsorts the rows and segment-sums them in sorted order,
// the segment heads first.  Here segment s sits at the first live row of its
// vertex instead (heads[r] = v there and -1 elsewhere), so the outputs keep
// the batch's [N] row layout and K3/K4 and sgd_apply take heads as a row
// list unchanged.  No sort: a persistent slot map [V] (INT32_MAX where
// unclaimed, allocated once a fit) names each vertex's representative row.
//
// preagg_rows is three launches:
//   1. claim: each row zeroes its own output row, and each live row does
//      atomicMin(slot[v], r), so the first occurrence wins;
//   2. sum: each live row adds its g_in and g_out into row slot[v] with
//      fp32 atomics and counts itself; every row writes its head;
//   3. reset: each live row puts slot[v] back to INT32_MAX, so the map is
//      as it was for the next step.
// They are separate because each reads what the previous one completed.
// The fp32 atomics sum a vertex's rows in another order than the JAX
// segment sum, so the sums agree to rounding; heads and counts exactly.
//
// sgd_apply is one launch, a warp per row: a head row updates emb_in with
// plain stores (heads are distinct vertices) and emb_out with atomics, and
// the S negative rows follow, also with atomics (negatives repeat and may
// be heads).  The negatives' scale reads `pairs` (K2's valid-pair count) on
// the device, so the step never synchronises.  Every product and quotient
// is a _rn intrinsic, in the plain version's order.
//
// Design: one warp per row, lanes over D (coalesced 128-byte rows).
// Bound on an H100: bytes.  preagg_rows reads the rows and the live rows'
// gradients once and writes the [N, D] sums, heads and counts once;
// sgd_apply reads the heads' sums and a read-modify-write of each head's
// and negative's table rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kEmpty = 0x7FFFFFFF;

__device__ __forceinline__ int64_t warp_row() {
  return static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

__global__ void __launch_bounds__(kThreads)
preagg_claim_kernel(const int32_t* __restrict__ rows, int64_t n, int dim,
                    int32_t* __restrict__ slot, float* __restrict__ ga_in,
                    float* __restrict__ ga_out, float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int64_t r = warp_row();
  if (r >= n) return;
  float* a = ga_in + r * dim;
  float* b = ga_out + r * dim;
  for (int k = lane; k < dim; k += 32) {
    a[k] = 0.f;
    b[k] = 0.f;
  }
  if (lane == 0) {
    cnt[r] = 0.f;
    const int32_t v = rows[r];
    if (v >= 0) atomicMin(slot + v, static_cast<int32_t>(r));
  }
}

__global__ void __launch_bounds__(kThreads)
preagg_sum_kernel(const int32_t* __restrict__ rows, int64_t n, int dim,
                  const int32_t* __restrict__ slot, const float* __restrict__ g_in,
                  const float* __restrict__ g_out, float* __restrict__ ga_in,
                  float* __restrict__ ga_out, int32_t* __restrict__ heads,
                  float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int64_t r = warp_row();
  if (r >= n) return;
  const int32_t v = rows[r];
  const int64_t rep = v >= 0 ? slot[v] : -1;
  if (lane == 0) heads[r] = (v >= 0 && rep == r) ? v : -1;
  if (v < 0) return;
  const float* gi = g_in + r * dim;
  const float* go = g_out + r * dim;
  float* a = ga_in + rep * dim;
  float* b = ga_out + rep * dim;
  for (int k = lane; k < dim; k += 32) {
    atomicAdd(a + k, gi[k]);
    atomicAdd(b + k, go[k]);
  }
  if (lane == 0) atomicAdd(cnt + rep, 1.f);
}

__global__ void preagg_reset_kernel(const int32_t* __restrict__ rows, int64_t n,
                                    int32_t* __restrict__ slot) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int32_t v = rows[r];
  if (v >= 0) slot[v] = kEmpty;
}

__global__ void __launch_bounds__(kThreads)
sgd_apply_kernel(float* __restrict__ emb_in, float* __restrict__ emb_out, int dim,
                 const float* __restrict__ ga_in, const float* __restrict__ ga_out,
                 const int32_t* __restrict__ heads, const float* __restrict__ cnt,
                 int64_t n, const float* __restrict__ d_no,
                 const int32_t* __restrict__ neg_ids, int64_t s,
                 const float* __restrict__ pairs, float neg_scale, float lr) {
  const int lane = threadIdx.x & 31;
  const int64_t r = warp_row();
  const float neg_lr = -lr;
  if (r < n) {
    const int32_t v = heads[r];
    if (v < 0) return;
    const float inv = __fdiv_rn(1.f, fmaxf(cnt[r], 1.f));
    const float* a = ga_in + r * dim;
    const float* b = ga_out + r * dim;
    float* ti = emb_in + static_cast<int64_t>(v) * dim;
    float* to = emb_out + static_cast<int64_t>(v) * dim;
    for (int k = lane; k < dim; k += 32) {
      ti[k] = __fadd_rn(ti[k], __fmul_rn(__fmul_rn(neg_lr, a[k]), inv));
      atomicAdd(to + k, __fmul_rn(__fmul_rn(neg_lr, b[k]), inv));
    }
    return;
  }
  const int64_t j = r - n;
  if (j >= s) return;
  const float cnt_neg = fmaxf(__fmul_rn(pairs[0], neg_scale), 1.f);
  const float* d = d_no + j * dim;
  float* to = emb_out + static_cast<int64_t>(neg_ids[j]) * dim;
  for (int k = lane; k < dim; k += 32) atomicAdd(to + k, __fdiv_rn(__fmul_rn(neg_lr, d[k]), cnt_neg));
}

unsigned warp_blocks(int64_t n_rows) {
  return static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int n2v_preagg_rows(const int32_t* rows, int64_t n, const float* g_in,
                               const float* g_out, int dim, int32_t* slot, float* ga_in,
                               float* ga_out, int32_t* heads, float* cnt, void* stream) {
  if (dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  preagg_claim_kernel<<<warp_blocks(n), kThreads, 0, st>>>(rows, n, dim, slot, ga_in, ga_out,
                                                            cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  preagg_sum_kernel<<<warp_blocks(n), kThreads, 0, st>>>(rows, n, dim, slot, g_in, g_out, ga_in,
                                                          ga_out, heads, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  preagg_reset_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      rows, n, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int n2v_sgd_apply(float* emb_in, float* emb_out, int dim, const float* ga_in,
                             const float* ga_out, const int32_t* heads, const float* cnt,
                             int64_t n, const float* d_no, const int32_t* neg_ids, int64_t s,
                             const float* pairs, float neg_scale, float lr, void* stream) {
  if (dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n + s == 0) return 0;
  sgd_apply_kernel<<<warp_blocks(n + s), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      emb_in, emb_out, dim, ga_in, ga_out, heads, cnt, n, d_no, neg_ids, s, pairs, neg_scale,
      lr);
  return static_cast<int>(cudaGetLastError());
}
