// K1 dense_walk: exact second-order biased walks over the packed dense
// adjacency, the whole walk_length loop inside one launch.
//
// Replaces node2vec_tpu/walk/dense.py:85 dense_walk_chunk_impl together with
// dense.py:52 shared_neighbor_mask, ops/sampling.py:60 prefix_sums and
// ops/hashrng.py; it also computes what the one Pallas kernel,
// experiments/pallas_step.py:106 fused_stage (body :55), computes for a step.
// The semantics follow dense.py, not the Pallas experiment: `total` is a
// separate sum (not cdf[-1]), the pick is clamped to degree-1, `alive &=
// total > 0` is sticky, and the carried previous row moves only while alive.
//
// Design: one warp per walker.  Lane l owns the k = ceil(P/32) contiguous
// columns [l*k, l*k+k) of the [2P] packed row (ids | f32 weight bits), in
// arrays of kK, the next power of two >= k (one launch form a kK), so the
// one row gather per step is a coalesced 2P*4-byte read.  The current and
// previous rows' ids sit in two per-warp shared-memory buffers that swap
// each step, so the previous row is never re-gathered.  Whether a row is
// non-decreasing is found once, when it is loaded, from the lanes'
// registers (dense_row_sorted), and carried to the next step as a
// warp-uniform flag.  Membership of a candidate in N(prev) is then a
// lockstep bisection of that row (log2 P + 1 shared loads a column at a
// power of two P) where it is sorted, as build_padded_adjacency keeps every
// row, and the whole scan (P compares a column) where it is not; ``scans``,
// when given, counts the steps that scanned.  The step's float operations (dense_bias, dense_total,
// dense_pick_k) are dense_common.cuh's, which K25 epd_serve calls too, in
// the same order; each uses the _rn intrinsics so the compiler cannot
// contract them into FMAs: the kernel then rounds like the plain PyTorch
// version, and on dyadic weights the two agree bit for bit.  The step's
// uniform is hashed before its row is loaded, so that the hash overlaps
// the load.
//
// Bound on an H100: per live walker-step one 2P*4-byte row read from device
// memory (the membership tests run from shared memory), so the kernel is
// bound by the gather bytes at large W.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "hashrng.cuh"

namespace {

constexpr int kWarps = 8;  // walkers per block
constexpr int kMaxK = n2v::kDenseMaxK;

template <int kK>
__global__ void __launch_bounds__(kWarps * 32)
dense_walk_kernel(const int32_t* __restrict__ adj, int p_cols,
                  const int32_t* __restrict__ starts,
                  int32_t* __restrict__ paths, int64_t n_walkers,
                  int walk_length, int64_t gid_base, uint32_t seed,
                  float inv_p, float inv_q, int uniform_bias, int32_t* __restrict__ scans) {
  extern __shared__ int32_t smem[];  // [kWarps][2][p_cols]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (w >= n_walkers) return;  // warp-uniform: no block-level sync below

  const int k = n2v::dense_cols_per_lane(p_cols);
  const int col0 = lane * k;
  int top = 1;  // the largest power of two <= P
  while (2 * top <= p_cols) top *= 2;
  const bool pow2 = top == p_cols;  // the bisection needs no bounds checks
  int32_t* rows = smem + static_cast<int64_t>(warp) * 2 * p_cols;
  int32_t* prev_rows = rows + p_cols;
  int32_t* out = paths + w * (walk_length + 1);

  const int32_t start = starts[w];
  bool alive = start >= 0;
  if (lane == 0) out[0] = alive ? start : -1;
  int32_t cur = alive ? start : 0;
  int32_t prev = -1;
  const uint32_t gid = static_cast<uint32_t>(gid_base + w);
  bool prev_sorted = true;  // whether N(prev) is non-decreasing
  int n_scans = 0;

  int t_dead = 0;  // the step at which the walker died (or 0 for a dead lane)
  for (int t = 0; t < walk_length; ++t) {
    if (!alive) break;
    const float u01 = n2v::hash_uniform(seed, gid, static_cast<uint32_t>(t));
    int32_t ids[kK];
    float bw[kK];
    n2v::dense_load_row_k(adj + static_cast<int64_t>(cur) * 2 * p_cols, p_cols, k, col0, ids, bw,
                          rows);
    // the row's order, for the next step's membership (none at p = q = 1)
    const bool row_sorted = uniform_bias || n2v::dense_row_sorted(ids, p_cols, k, col0);
    __syncwarp();
    // node2vec bias (step 0, prev < 0, is first-order, and p = q = 1 needs
    // no bias at all), the separate total, then prefix and clamped pick
    if (!uniform_bias && prev >= 0) {
      bool found[kK];
      if (prev_sorted && pow2) {
        n2v::dense_members_sorted<kK, true>(prev_rows, p_cols, top, ids, found);
      } else if (prev_sorted) {
        n2v::dense_members_sorted(prev_rows, p_cols, top, ids, found);
      } else {
        ++n_scans;
        n2v::dense_members_scan(prev_rows, p_cols, ids, found);
      }
      n2v::dense_bias(ids, bw, found, prev, p_cols, k, col0, inv_p, inv_q);
    }
    float lane_sum;
    const float total = n2v::dense_total(bw, lane_sum);
    if (!(total > 0.f)) {  // sink (or all-zero weights): the walker dies
      alive = false;
      t_dead = t;
      break;
    }
    const int idx = n2v::dense_pick_k(ids, bw, lane_sum, total, p_cols, k, col0, lane, u01);
    const int32_t nxt = rows[idx];
    if (lane == 0) out[t + 1] = nxt;
    prev = cur;
    cur = nxt;
    prev_sorted = row_sorted;
    __syncwarp();  // every lane is done with prev_rows and rows[idx]
    int32_t* tmp = prev_rows;  // the frontier row becomes next step's N(prev)
    prev_rows = rows;
    rows = tmp;
  }
  if (!alive) {  // dead lanes stay dead: pad the rest of the path with -1
    for (int s = t_dead + 1 + lane; s <= walk_length; s += 32) out[s] = -1;
  }
  if (scans != nullptr && lane == 0 && n_scans) atomicAdd(scans, n_scans);
}

template <int kK>
cudaError_t walk_launch(const int32_t* adj, int p_cols, const int32_t* starts, int32_t* paths,
                        int64_t n_walkers, int walk_length, int64_t gid_base, uint32_t seed,
                        float inv_p, float inv_q, int uniform_bias, int32_t* scans,
                        cudaStream_t stream) {
  const int64_t blocks = (n_walkers + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int32_t) * kWarps * 2 * p_cols;
  dense_walk_kernel<kK><<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      adj, p_cols, starts, paths, n_walkers, walk_length, gid_base, seed, inv_p, inv_q,
      uniform_bias, scans);
  return cudaGetLastError();
}

}  // namespace

// scans: null, or an int32 counter that gains the biased steps whose N(prev)
// was not sorted (those that scanned it whole).
extern "C" int n2v_dense_walk(const int32_t* adj, int p_cols,
                              const int32_t* starts, int32_t* paths,
                              int64_t n_walkers, int walk_length,
                              int64_t gid_base, uint32_t seed, float inv_p,
                              float inv_q, int uniform_bias, int32_t* scans, void* stream) {
  if (p_cols < 1 || p_cols > 32 * kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n_walkers == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int k = n2v::dense_cols_per_lane(p_cols);
  cudaError_t err;
  switch (k) {  // a lane's columns, in arrays of the next power of two
    case 1:
      err = walk_launch<1>(adj, p_cols, starts, paths, n_walkers, walk_length, gid_base, seed,
                           inv_p, inv_q, uniform_bias, scans, s);
      break;
    case 2:
      err = walk_launch<2>(adj, p_cols, starts, paths, n_walkers, walk_length, gid_base, seed,
                           inv_p, inv_q, uniform_bias, scans, s);
      break;
    case 3:
    case 4:
      err = walk_launch<4>(adj, p_cols, starts, paths, n_walkers, walk_length, gid_base, seed,
                           inv_p, inv_q, uniform_bias, scans, s);
      break;
    default:
      err = walk_launch<kMaxK>(adj, p_cols, starts, paths, n_walkers, walk_length, gid_base,
                               seed, inv_p, inv_q, uniform_bias, scans, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* n2v_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
