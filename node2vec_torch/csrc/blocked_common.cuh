// Device functions of the blocked tables' samplers, shared by K5
// (blocked_walk.cu, one warp a walker) and the graph-sharded walk's owner
// kernels K21 and K22 (ep_walk.cu, one warp a request), so that the three
// make the same float operations in the same order: their proposals and
// membership answers are then the same bits wherever the tables and draws
// are.  Every function is called by a whole warp with warp-uniform
// arguments; a row pointer may point to shared or to global memory.
//
// Rounding: every float op is a _rn intrinsic (nvcc cannot contract it
// into an FMA).  Prefix sums are warp scans, in another order than
// torch.cumsum, so they equal the plain versions' where every partial sum
// is exact (dyadic weights).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace n2v {

constexpr int32_t kPadId = 0x7FFFFFFF;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kLightRow = 128;  // lanes of a light row (P <= 32, no ebase lane past 128)

__device__ __forceinline__ float warp_incl_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = __fadd_rn(v, u);
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Copy a 128-lane row into a warp's 16-byte aligned shared buffer, one int4 a lane.
__device__ __forceinline__ void load_row(int32_t* dst, const int32_t* row_g, int lane) {
  __syncwarp();  // every lane is done with the buffer overwritten here
  reinterpret_cast<int4*>(dst)[lane] = __ldg(reinterpret_cast<const int4*>(row_g) + lane);
  __syncwarp();
}

// A light row's P columns, lane j holding column j: its id, weight and
// inclusive weight prefix; the row's degree (real ids: not PAD, and >= 0
// where the tables hold heavy headers) and total weight.
struct LightCols {
  int32_t id;
  float w, cdf;
  int degree;
  float wtot;
};

__device__ __forceinline__ LightCols light_cols(const int32_t* row, int lane, int p_l,
                                                bool has_heavy) {
  LightCols lc;
  lc.id = lane < p_l ? row[lane] : kPadId;
  lc.w = lane < p_l ? __int_as_float(row[p_l + lane]) : 0.f;
  const bool real = lane < p_l && lc.id != kPadId && (!has_heavy || lc.id >= 0);
  lc.degree = __popc(__ballot_sync(kFullMask, real));
  lc.wtot = warp_sum(lc.w);
  lc.cdf = warp_incl_scan(lc.w, lane);
  return lc;
}

// count(cdf < target) over a light row's P columns.
__device__ __forceinline__ int light_below(float cdf, float target, int lane, int p_l) {
  return __popc(__ballot_sync(kFullMask, lane < p_l && cdf < target));
}

// A heavy header's block CDF entries lane and lane + 32 (MAXB <= 61).
__device__ __forceinline__ void header_cum(const int32_t* row, int lane, int maxb, float* cum0,
                                           float* cum1) {
  *cum0 = lane < maxb ? __int_as_float(row[5 + maxb + lane]) : 0.f;
  *cum1 = lane + 32 < maxb ? __int_as_float(row[5 + maxb + lane + 32]) : 0.f;
}

// count(block CDF < target) over the header's MAXB entries.
__device__ __forceinline__ int header_below(float cum0, float cum1, float target, int lane,
                                            int maxb) {
  return __popc(__ballot_sync(kFullMask, lane < maxb && cum0 < target)) +
         __popc(__ballot_sync(kFullMask, lane + 32 < maxb && cum1 < target));
}

// A block's C weights read C/32 contiguous columns a lane (col0 = lane * k):
// returns count(block CDF < resid) and this lane's exclusive prefix in *excl.
__device__ __forceinline__ int block_below(const int32_t* w_row, int col0, int k, float resid,
                                           int lane, float* excl) {
  float lsum = 0.f;
  for (int m = 0; m < k; ++m) lsum = __fadd_rn(lsum, __int_as_float(__ldg(w_row + col0 + m)));
  float ex = __shfl_up_sync(kFullMask, warp_incl_scan(lsum, lane), 1);
  if (lane == 0) ex = 0.f;
  float run = ex;
  int below = 0;
  for (int m = 0; m < k; ++m) {
    run = __fadd_rn(run, __int_as_float(__ldg(w_row + col0 + m)));
    below += run < resid;
  }
  *excl = ex;
  return __reduce_add_sync(kFullMask, below);
}

// The block CDF at slot - 1 (0 for slot 0), recomputed by the lane that owns it.
__device__ __forceinline__ float block_prefix_before(const int32_t* w_row, int col0, int k,
                                                     float excl, int slot, int lane) {
  float pc = 0.f;
  if (slot > 0) {
    const int j = slot - 1;
    const int owner = j / k;
    if (lane == owner) {
      pc = excl;
      for (int m = col0; m <= j; ++m) pc = __fadd_rn(pc, __int_as_float(__ldg(w_row + m)));
    }
    pc = __shfl_sync(kFullMask, pc, owner);
  }
  return pc;
}

// The (rev±, pfx) pair of global block slot gslot: brp's flat index 2 * gslot.
__device__ __forceinline__ int2 brp_pair(const int32_t* brp, int64_t gslot) {
  return __ldg(reinterpret_cast<const int2*>(brp) + gslot);
}

// Is cand in N(prev)?  A heavy prev's block is picked from its header's
// block minima and its bids row compared, coalesced; a light prev's P ids.
__device__ __forceinline__ bool prev_member(const int32_t* prev_row, const int32_t* bids,
                                            int32_t cand, int lane, int p_l, int c,
                                            bool has_heavy) {
  if (has_heavy && prev_row[0] < -1) {
    const int maxb = (4 * p_l - 5) / 2;
    const int32_t p_bs = prev_row[1];
    const int32_t p_nb = prev_row[2];
    int jm = __popc(__ballot_sync(kFullMask, lane < maxb && prev_row[5 + lane] <= cand)) +
             __popc(__ballot_sync(kFullMask, lane + 32 < maxb && prev_row[5 + lane + 32] <= cand)) -
             1;
    jm = min(max(jm, 0), max(p_nb - 1, 0));
    const int32_t* mrow = bids + (static_cast<int64_t>(p_bs) + jm) * c;
    bool hit = false;
    for (int i = lane; i < c; i += 32) hit |= __ldg(mrow + i) == cand;
    return __any_sync(kFullMask, hit);
  }
  return __any_sync(kFullMask, lane < p_l && prev_row[lane] == cand);
}

}  // namespace n2v
