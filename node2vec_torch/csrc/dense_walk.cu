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
// Design: one warp per walker.  Lane l owns the K = max(1, P/32) contiguous
// columns [l*K, l*K+K) of the [2P] packed row (ids | f32 weight bits), so the
// one row gather per step is a coalesced 2P*4-byte read.  The current and
// previous rows' ids sit in two per-warp shared-memory buffers that swap
// each step, so the previous row is never re-gathered.  Membership of a
// candidate in the previous row is a linear scan of that row (P compares,
// broadcast shared-memory reads; P^2 per walker-step in all).  The prefix
// sum is a per-lane sequential scan plus a warp shuffle scan; counts are
// warp reductions.  Float multiplies and adds use the _rn intrinsics so the
// compiler cannot contract them into FMAs: the kernel then rounds like the
// plain PyTorch version, and on dyadic weights the two agree bit for bit.
//
// Bound on an H100: per live walker-step one 2P*4-byte row read from device
// memory (the P^2 compares run from shared memory), so the kernel is bound
// by the gather bytes at large W and by the compares when P is large.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashrng.cuh"

namespace {

constexpr int32_t kPadId = 0x7FFFFFFF;
constexpr int kWarps = 8;  // walkers per block
constexpr int kMaxK = 8;   // columns per lane: P <= 256
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32)
dense_walk_kernel(const int32_t* __restrict__ adj, int p_cols,
                  const int32_t* __restrict__ starts,
                  int32_t* __restrict__ paths, int64_t n_walkers,
                  int walk_length, int64_t gid_base, uint32_t seed,
                  float inv_p, float inv_q, int uniform_bias) {
  extern __shared__ int32_t smem[];  // [kWarps][2][p_cols]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (w >= n_walkers) return;  // warp-uniform: no block-level sync below

  const int k = p_cols >= 32 ? p_cols / 32 : 1;
  const int col0 = lane * k;
  int32_t* rows = smem + static_cast<int64_t>(warp) * 2 * p_cols;
  int32_t* prev_rows = rows + p_cols;
  int32_t* out = paths + w * (walk_length + 1);

  const int32_t start = starts[w];
  bool alive = start >= 0;
  if (lane == 0) out[0] = alive ? start : -1;
  int32_t cur = alive ? start : 0;
  int32_t prev = -1;
  const uint32_t gid = static_cast<uint32_t>(gid_base + w);

  int t_dead = 0;  // the step at which the walker died (or 0 for a dead lane)
  for (int t = 0; t < walk_length; ++t) {
    if (!alive) break;
    const int32_t* row = adj + static_cast<int64_t>(cur) * 2 * p_cols;
    int32_t ids[kMaxK];
    float bw[kMaxK];
#pragma unroll
    for (int m = 0; m < kMaxK; ++m) {
      ids[m] = kPadId;
      bw[m] = 0.f;
      const int c = col0 + m;
      if (m < k && c < p_cols) {
        ids[m] = row[c];
        bw[m] = __int_as_float(row[p_cols + c]);
        rows[c] = ids[m];
      }
    }
    __syncwarp();

    // node2vec bias: 1/p back edge, 1 shared neighbour, 1/q otherwise;
    // step 0 (prev < 0) is first-order, and p = q = 1 needs no bias at all
    if (!uniform_bias && prev >= 0) {
#pragma unroll
      for (int m = 0; m < kMaxK; ++m) {
        if (m < k && col0 + m < p_cols) {
          float bias;
          if (ids[m] == prev) {
            bias = inv_p;
          } else {
            bool shared = false;
            for (int j = 0; j < p_cols; ++j) shared |= prev_rows[j] == ids[m];
            bias = shared ? 1.f : inv_q;
          }
          bw[m] = __fmul_rn(bw[m], bias);
        }
      }
    }

    // total: a separate warp sum, as dense.py computes it
    float lane_sum = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxK; ++m) lane_sum = __fadd_rn(lane_sum, bw[m]);
    float total = lane_sum;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total = __fadd_rn(total, __shfl_xor_sync(kFull, total, off));

    if (!(total > 0.f)) {  // sink (or all-zero weights): the walker dies
      alive = false;
      t_dead = t;
      break;
    }

    // inclusive prefix sums: warp scan of lane sums, then the lane's columns
    float incl = lane_sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, v);
    }
    float run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = 0.f;

    const float u = __fmul_rn(n2v::hash_uniform(seed, gid, static_cast<uint32_t>(t)), total);
    int below = 0, deg = 0;
#pragma unroll
    for (int m = 0; m < kMaxK; ++m) {
      if (m < k && col0 + m < p_cols) {
        run = __fadd_rn(run, bw[m]);
        below += run < u;
        deg += ids[m] != kPadId;
      }
    }
    below = __reduce_add_sync(kFull, below);
    deg = __reduce_add_sync(kFull, deg);
    // clamp to degree-1: u can land in the ulp gap above cdf[degree-1],
    // where every zero-weight pad column would count
    const int idx = min(below, max(deg - 1, 0));
    const int32_t nxt = rows[idx];
    if (lane == 0) out[t + 1] = nxt;
    prev = cur;
    cur = nxt;
    __syncwarp();  // every lane is done with prev_rows and rows[idx]
    int32_t* tmp = prev_rows;  // the frontier row becomes next step's N(prev)
    prev_rows = rows;
    rows = tmp;
  }
  if (!alive) {  // dead lanes stay dead: pad the rest of the path with -1
    for (int s = t_dead + 1 + lane; s <= walk_length; s += 32) out[s] = -1;
  }
}

}  // namespace

extern "C" int n2v_dense_walk(const int32_t* adj, int p_cols,
                              const int32_t* starts, int32_t* paths,
                              int64_t n_walkers, int walk_length,
                              int64_t gid_base, uint32_t seed, float inv_p,
                              float inv_q, int uniform_bias, void* stream) {
  if (p_cols < 1 || p_cols > 32 * kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n_walkers == 0) return 0;
  const int64_t blocks = (n_walkers + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int32_t) * kWarps * 2 * p_cols;
  dense_walk_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      adj, p_cols, starts, paths, n_walkers, walk_length, gid_base, seed,
      inv_p, inv_q, uniform_bias);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* n2v_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
