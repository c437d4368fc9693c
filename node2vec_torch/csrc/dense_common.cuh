// The dense engine's step, shared by K1 (dense_walk.cu, one warp a walker
// for a whole walk) and the dense graph-sharded walk's owner kernel K25
// (epd_walk.cu, a warp a request at a time), so that both make the same
// float operations in the same order: for the same packed row, N(prev),
// prev and uniform they pick the same neighbour, bit for bit.
//
// Layout: lane l owns the k = ceil(P/32) contiguous columns [l*k, l*k+k)
// of the [2P] packed row (ids | f32 weight bits), held in arrays of kK >= k
// (the next power of two, so that a narrow row keeps few registers; each
// kernel has a launch form a kK).  The row's ids also go to a per-warp
// shared buffer, where the pick reads its neighbour; N(prev) is another
// per-warp shared buffer of P ids.  Membership in N(prev) is a bisection
// where N(prev) is non-decreasing (rows built from a CSR are: ascending
// ids, INT32_MAX pads at the tail) and the whole scan where it is not;
// both give the same answer.
//
// Rounding: every float op is a _rn intrinsic (nvcc cannot contract it
// into an FMA), so the kernels round like the plain PyTorch versions, and
// on dyadic weights (every partial sum exact) they agree bit for bit.
// Every function is called by a whole warp with warp-uniform arguments.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace n2v {

constexpr int32_t kDensePad = 0x7FFFFFFF;
constexpr int kDenseMaxK = 8;  // columns per lane: P <= 256
constexpr unsigned kDenseFull = 0xFFFFFFFFu;

// Columns a lane owns: K = ceil(P / 32), so that every column of any P <=
// 256 has a lane (at a power of two P >= 32, P / 32; below 32, one).
__host__ __device__ __forceinline__ int dense_cols_per_lane(int p_cols) {
  return (p_cols + 31) >> 5;
}

// The lane's columns of a packed row in global memory (K1): ids and
// weights, pads beyond P, the ids also stored into the warp's shared
// ``rows`` buffer.
template <int kK>
__device__ __forceinline__ void dense_load_row_k(const int32_t* row, int p_cols, int k, int col0,
                                                 int32_t (&ids)[kK], float (&bw)[kK],
                                                 int32_t* rows) {
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    ids[m] = kDensePad;
    bw[m] = 0.f;
    const int c = col0 + m;
    if (m < k && c < p_cols) {
      ids[m] = row[c];
      bw[m] = __int_as_float(row[p_cols + c]);
      rows[c] = ids[m];
    }
  }
}

// Is a loaded row non-decreasing?  From the lanes' registers: each lane's
// contiguous columns, its last against the next lane's first (one
// shuffle), one ballot; a warp-uniform answer.
template <int kK>
__device__ __forceinline__ bool dense_row_sorted(const int32_t (&ids)[kK], int p_cols, int k,
                                                 int col0) {
  bool bad = false;
  int32_t last = ids[0];
#pragma unroll
  for (int m = 1; m < kK; ++m) {
    if (m < k && col0 + m < p_cols) {
      bad |= last > ids[m];
      last = ids[m];
    }
  }
  const int32_t next = __shfl_down_sync(kDenseFull, ids[0], 1);
  if (col0 + k < p_cols) bad |= last > next;  // the next lane owns a column
  return !__any_sync(kDenseFull, bad);
}

// The lane's columns of a row staged in shared memory ([2P]: ids | weight
// bits), pads beyond P.
template <int kK>
__device__ __forceinline__ void dense_row_from_shared(const int32_t* srow, int p_cols, int k,
                                                      int col0, int32_t (&ids)[kK],
                                                      float (&bw)[kK]) {
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    const bool on = m < k && col0 + m < p_cols;
    ids[m] = on ? srow[col0 + m] : kDensePad;
    bw[m] = on ? __int_as_float(srow[p_cols + col0 + m]) : 0.f;
  }
}

// Is N(prev) (P ids in shared memory) non-decreasing?  One ballot over its
// adjacent pairs.
__device__ __forceinline__ bool dense_nprev_sorted(const int32_t* nprev, int p_cols, int lane) {
  bool bad = false;
  for (int c = lane; c + 1 < p_cols; c += 32) bad |= nprev[c] > nprev[c + 1];
  return !__any_sync(kDenseFull, bad);
}

// Each of the lane's ids in a sorted N(prev): lower bounds by steps of top,
// top / 2, ..., 1 (top the largest power of two <= P), the kK searches in
// lockstep so their loads overlap, then one compare each; log2(P) + 2 loads
// a column.  kPow2, where P is a power of two (P == top): steps of P / 2,
// ..., 1, which never pass the end, then one compare; log2(P) + 1 loads.
template <int kK, bool kPow2 = false>
__device__ __forceinline__ void dense_members_sorted(const int32_t* nprev, int p_cols, int top,
                                                     const int32_t (&ids)[kK],
                                                     bool (&found)[kK]) {
  int pos[kK];  // the entries below ids[m] found so far
#pragma unroll
  for (int m = 0; m < kK; ++m) pos[m] = 0;
  for (int step = kPow2 ? top >> 1 : top; step > 0; step >>= 1) {
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      const int s = pos[m] + step;
      if ((kPow2 || s <= p_cols) && nprev[s - 1] < ids[m]) pos[m] = s;
    }
  }
#pragma unroll
  for (int m = 0; m < kK; ++m)
    found[m] = (kPow2 || pos[m] < p_cols) && nprev[pos[m]] == ids[m];
}

// The same answers for any N(prev): the whole scan, P compares a column.
template <int kK>
__device__ __forceinline__ void dense_members_scan(const int32_t* nprev, int p_cols,
                                                   const int32_t (&ids)[kK], bool (&found)[kK]) {
#pragma unroll
  for (int m = 0; m < kK; ++m) found[m] = false;
  for (int j = 0; j < p_cols; ++j) {
    const int32_t v = nprev[j];
#pragma unroll
    for (int m = 0; m < kK; ++m) found[m] |= v == ids[m];
  }
}

// The node2vec bias, in place on ``bw``: 1/p on the back edge, 1 for a
// neighbour in N(prev), 1/q otherwise; call only at second order (prev >=
// 0) with p, q not both 1 (the uniform bias leaves the weights as they are).
template <int kK>
__device__ __forceinline__ void dense_bias(const int32_t (&ids)[kK], float (&bw)[kK],
                                           const bool (&found)[kK], int32_t prev, int p_cols,
                                           int k, int col0, float inv_p, float inv_q) {
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    if (m < k && col0 + m < p_cols) {
      const float bias = ids[m] == prev ? inv_p : (found[m] ? 1.f : inv_q);
      bw[m] = __fmul_rn(bw[m], bias);
    }
  }
}

// The sums: the lane's own (``lane_sum``, where the pick's prefix starts)
// and the total, a separate xor-sum over the warp, as dense.py computes it.
template <int kK>
__device__ __forceinline__ float dense_total(const float (&bw)[kK], float& lane_sum) {
  lane_sum = 0.f;
#pragma unroll
  for (int m = 0; m < kK; ++m) lane_sum = __fadd_rn(lane_sum, bw[m]);
  float total = lane_sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total = __fadd_rn(total, __shfl_xor_sync(kDenseFull, total, off));
  return total;
}

// The inclusive prefix of the biased weights (a warp scan of the lane sums,
// then the lane's columns) and the pick of u01 * total clamped to degree -
// 1 (u can land in the ulp gap above cdf[degree-1], where every zero-weight
// pad column would count).  Returns the picked column.  Call only when
// total > 0: at total <= 0 (a sink, or all-zero weights) the walker dies.
template <int kK>
__device__ __forceinline__ int dense_pick_k(const int32_t (&ids)[kK], const float (&bw)[kK],
                                            float lane_sum, float total, int p_cols, int k,
                                            int col0, int lane, float u01) {
  float incl = lane_sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kDenseFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, v);
  }
  float run = __shfl_up_sync(kDenseFull, incl, 1);
  if (lane == 0) run = 0.f;
  const float u = __fmul_rn(u01, total);
  int below = 0, deg = 0;
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    if (m < k && col0 + m < p_cols) {
      run = __fadd_rn(run, bw[m]);
      below += run < u;
      deg += ids[m] != kDensePad;
    }
  }
  below = __reduce_add_sync(kDenseFull, below);
  deg = __reduce_add_sync(kDenseFull, deg);
  return min(below, max(deg - 1, 0));
}

}  // namespace n2v
