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
// preagg_rows is one cooperative launch over a resident grid (bucket_common.cuh's
// grid_geometry), in three phases split by grid barriers; a warp takes the
// same rows in every phase:
//   1. claim: each live row does atomicMin(slot[v], r), so the first
//      occurrence wins;
//   2. write: a head row (slot[v] == r) copies its own g_in and g_out rows
//      into its output rows with plain 16-byte loads and stores and counts
//      itself; every other row stores zeros.  A repeated occurrence keeps its
//      head's row in heads[r] (as -2 - head), its own entry;
//   3. add: a repeated occurrence adds its two gradient rows into its head's
//      with 16-byte red.global.add.v4.f32 (atomicAdd on float4), counts
//      itself there and writes heads[r] = -1; a head puts slot[v] back to
//      INT32_MAX (no row reads the map in this phase), so the map is as it
//      was for the next step.
// So every output row is written once, and only the repeats go through the
// L2's atomic unit.  Rows whose D is not a multiple of 4, or gradients or
// sums off 16-byte alignment, take the same phases with scalar loads, stores
// and atomics.
// The atomics sum a vertex's rows in another order than the JAX segment
// sum, so the sums agree to rounding; heads and counts exactly.
//
// sgd_apply is one launch, a warp per row: a head row updates emb_in with
// plain stores (heads are distinct vertices) and emb_out with atomics, and
// the S negative rows follow, also with atomics (negatives repeat and may
// be heads).  The negatives' scale reads `pairs` (K2's valid-pair count) on
// the device, so the step never synchronises.  Every product and quotient
// is a _rn intrinsic, in the plain version's order.
//
// Design: one warp per row, lanes over D (coalesced rows).
// Bound on an H100: bytes.  preagg_rows reads the rows and the live rows'
// gradients once and writes the [N, D] sums, heads and counts once;
// sgd_apply reads the heads' sums and a read-modify-write of each head's
// and negative's table rows.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kEmpty = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t warp_row() {
  return static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

struct PreaggArgs {
  const int32_t* rows;
  int64_t n;
  int dim;
  const float* g_in;
  const float* g_out;
  int32_t* slot;
  float* ga_in;
  float* ga_out;
  int32_t* heads;
  float* cnt;
};

// Rows a and b (b < 0: none) of dst = their src rows where `take_*`, else
// zeros; lanes over the rows, float4s when kVec, both rows' loads issued
// before either's stores.
template <bool kVec>
__device__ __forceinline__ void put_rows(float* __restrict__ dst, const float* __restrict__ src,
                                         int dim, int lane, int64_t a, bool take_a, int64_t b,
                                         bool take_b) {
  if (kVec) {
    float4* d = reinterpret_cast<float4*>(dst);
    const float4* s = reinterpret_cast<const float4*>(src);
    const int64_t nc = dim / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = lane; c < nc; c += 32) {
      const float4 x = take_a ? __ldg(s + a * nc + c) : z;
      const float4 y = take_b ? __ldg(s + b * nc + c) : z;
      d[a * nc + c] = x;
      if (b >= 0) d[b * nc + c] = y;
    }
  } else {
    for (int k = lane; k < dim; k += 32) {
      const float x = take_a ? __ldg(src + a * dim + k) : 0.f;
      const float y = take_b ? __ldg(src + b * dim + k) : 0.f;
      dst[a * dim + k] = x;
      if (b >= 0) dst[b * dim + k] = y;
    }
  }
}

// dst row ha += src row a, and hb += b (b < 0: none), with red.global.add
// (16 bytes a lane when kVec); both rows' loads issued before the adds.
template <bool kVec>
__device__ __forceinline__ void add_rows(float* dst, const float* __restrict__ src, int dim,
                                         int lane, int64_t a, int64_t ha, int64_t b,
                                         int64_t hb) {
  if (kVec) {
    float4* d = reinterpret_cast<float4*>(dst);
    const float4* s = reinterpret_cast<const float4*>(src);
    const int64_t nc = dim / 4;
    for (int c = lane; c < nc; c += 32) {
      const float4 x = __ldg(s + a * nc + c);
      const float4 y = b >= 0 ? __ldg(s + b * nc + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      atomicAdd(d + ha * nc + c, x);
      if (b >= 0) atomicAdd(d + hb * nc + c, y);
    }
  } else {
    for (int k = lane; k < dim; k += 32) {
      const float x = __ldg(src + a * dim + k);
      const float y = b >= 0 ? __ldg(src + b * dim + k) : 0.f;
      atomicAdd(dst + ha * dim + k, x);
      if (b >= 0) atomicAdd(dst + hb * dim + k, y);
    }
  }
}

// Warp w takes rows w + k W (W warps in all), the same in every phase, 32
// at a time: lane i holds the i-th row's scalars (its id, its head), so a
// batch costs one load of each, and the rows' floats move two rows at once.
// The write phase walks its rows from the last batch down, so that the
// rows written last, which the repeats add into soonest, are the low rows,
// where a vertex's first occurrence (its head) lies.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
preagg_kernel(PreaggArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < a.n;
       r += n_threads) {
    const int32_t v = a.rows[r];
    if (v >= 0) atomicMin(a.slot + v, static_cast<int32_t>(r));
  }
  cg::this_grid().sync();

  const int64_t mine = w0 < a.n ? (a.n - w0 + n_warps - 1) / n_warps : 0;  // rows of this warp
  for (int64_t k0 = (mine - 1) / 32 * 32; k0 >= 0 && mine > 0; k0 -= 32) {
    const int64_t ri = w0 + (k0 + lane) * n_warps;  // lane i's row
    const bool in = k0 + lane < mine;
    const int32_t v = in ? a.rows[ri] : -1;
    const int32_t rep = v >= 0 ? __ldcg(a.slot + v) : -1;
    const bool head = v >= 0 && rep == ri;
    if (in) {
      a.heads[ri] = head ? v : (v >= 0 ? -2 - rep : -1);
      a.cnt[ri] = head ? 1.f : 0.f;
    }
    const unsigned heads_bits = __ballot_sync(kFull, head);
    const int m = mine - k0 < 32 ? static_cast<int>(mine - k0) : 32;  // rows in the batch
    for (int j = 0; j < m; j += 2) {
      const int64_t ra = w0 + (k0 + j) * n_warps;
      const int64_t rb = j + 1 < m ? ra + n_warps : -1;
      const bool ta = (heads_bits >> j) & 1u, tb = (heads_bits >> (j + 1)) & 1u;
      put_rows<kVec>(a.ga_in, a.g_in, a.dim, lane, ra, ta, rb, tb);
      put_rows<kVec>(a.ga_out, a.g_out, a.dim, lane, ra, ta, rb, tb);
    }
  }
  cg::this_grid().sync();

  for (int64_t k0 = 0; k0 < mine; k0 += 32) {
    const int64_t ri = w0 + (k0 + lane) * n_warps;
    const bool in = k0 + lane < mine;
    const int32_t h = in ? a.heads[ri] : -1;  // this warp's own entries, from the write phase
    if (h >= 0) a.slot[h] = kEmpty;  // no row reads the map in this phase
    const bool rep = h < -1;
    if (rep) {
      atomicAdd(a.cnt + (-2 - static_cast<int64_t>(h)), 1.f);
      a.heads[ri] = -1;
    }
    unsigned left = __ballot_sync(kFull, rep);
    while (left) {
      const int ja = __ffs(left) - 1;
      left &= left - 1;
      const int jb = left ? __ffs(left) - 1 : -1;
      if (jb >= 0) left &= left - 1;
      const int64_t ha = -2 - static_cast<int64_t>(__shfl_sync(kFull, h, ja));
      const int64_t hb = -2 - static_cast<int64_t>(__shfl_sync(kFull, h, jb < 0 ? 0 : jb));
      const int64_t ra = w0 + (k0 + ja) * n_warps;
      const int64_t rb = jb >= 0 ? w0 + (k0 + jb) * n_warps : -1;
      add_rows<kVec>(a.ga_in, a.g_in, a.dim, lane, ra, ha, rb, hb);
      add_rows<kVec>(a.ga_out, a.g_out, a.dim, lane, ra, ha, rb, hb);
    }
  }
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned warp_blocks(int64_t n_rows) {
  return static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int n2v_preagg_rows(const int32_t* rows, int64_t n, const float* g_in,
                               const float* g_out, int dim, int32_t* slot, float* ga_in,
                               float* ga_out, int32_t* heads, float* cnt, void* stream) {
  if (dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = dim % 4 == 0 && aligned16(g_in) && aligned16(g_out) && aligned16(ga_in) &&
                   aligned16(ga_out);
  const void* kernel = vec ? reinterpret_cast<const void*>(preagg_kernel<true>)
                           : reinterpret_cast<const void*>(preagg_kernel<false>);
  int64_t per_block = 0, grid = 0;
  cudaError_t err = n2v::grid_geometry(kernel, kThreads, (n + kWarps - 1) / kWarps, &per_block,
                                       &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  PreaggArgs a{rows, n, dim, g_in, g_out, slot, ga_in, ga_out, heads, cnt};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
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
