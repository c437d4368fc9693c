// Device functions of the blocked tables' samplers, shared by K5
// (blocked_walk.cu, an 8-lane group a walker, four walkers a warp) and the
// graph-sharded walk's owner kernels K21 and K22 (ep_walk.cu, an 8-lane
// group a request, four requests a warp), so that the three
// make the same float operations in the same order: their proposals and
// membership answers are then the same bits wherever the tables and draws
// are.
//
// A walker (or request) is served by a group of kGroup = 8 lanes, lane r =
// threadIdx.x % 8 of it.  Every function is called by all 32 lanes of a warp
// at once: its shuffles and ballots are full-mask, in segments of 8 lanes,
// and a group with nothing to do passes on = false, which masks its loads
// but not its shuffles.  Arguments are uniform within a group.
//
// Rounding: every float op is a _rn intrinsic (nvcc cannot contract it
// into an FMA).  A prefix sum is a lane's partial sum of its own columns
// plus the 8-lane exclusive scan of the lanes' totals, in another order
// than torch.cumsum, so it equals the plain versions' where every partial
// sum is exact (dyadic weights).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace n2v {

constexpr int32_t kPadId = 0x7FFFFFFF;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kLightRow = 128;  // lanes of a light row (P <= 32, no ebase lane past 128)
constexpr int kGroup = 8;       // lanes a walker or a request
constexpr int kGroupCols = 4;   // light columns a group lane holds: 4 * 8 >= P
constexpr int kHeaderCols = 8;  // header entries a group lane counts: 8 * 8 >= MAXB (<= 61)

__device__ __forceinline__ unsigned group_bits(unsigned ballot) {
  return (ballot >> (threadIdx.x & 31 & ~(kGroup - 1))) & 0xFFu;
}

// count of the group's lanes where b holds
__device__ __forceinline__ int group_count(bool b) {
  return __popc(group_bits(__ballot_sync(kFullMask, b)));
}

__device__ __forceinline__ bool group_any(bool b) {
  return group_bits(__ballot_sync(kFullMask, b)) != 0;
}

__device__ __forceinline__ int group_isum(int v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off, kGroup);
  return v;
}

// the group's sum, the same bits in every lane (each step adds a commuted pair)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off, kGroup));
  return v;
}

__device__ __forceinline__ float group_incl_scan(float v, int r) {
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, off, kGroup);
    if (r >= off) v = __fadd_rn(v, u);
  }
  return v;
}

__device__ __forceinline__ float group_excl_scan(float v, int r) {
  const float ex = __shfl_up_sync(kFullMask, group_incl_scan(v, r), 1, kGroup);
  return r == 0 ? 0.f : ex;
}

__device__ __forceinline__ float pick4(const float (&v)[4], int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

// 16-byte asynchronous copies global -> shared (through L2), and their wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying a 128-lane row into a group's 16-byte aligned shared buffer:
// lane r copies int4s r, r + 8, r + 16, r + 24 (coalesced).  Complete it
// with copies_wait.
__device__ __forceinline__ void row_issue(int32_t* dst, const int32_t* row_g, int r, bool on) {
  if (on) {
#pragma unroll
    for (int i = 0; i < kLightRow / 4 / kGroup; ++i)
      cp_async16(dst + 4 * (r + kGroup * i), row_g + 4 * (r + kGroup * i));
  }
}

// Every copy this lane issued has landed and the warp's lanes see each
// other's; also orders earlier reads of a buffer before its overwrite.
__device__ __forceinline__ void copies_wait() {
  cp_async_wait_all();
  __syncwarp();
}

// A light row's P columns, lane r holding columns 4r .. 4r + 3: their CDF
// in the block CDF's form (ex_r + L_r(j), below); the row's degree (real ids: not PAD, and >= 0
// where the tables hold heavy headers) and total weight.
struct LightCols {
  float cdf[kGroupCols];
  int degree;
  float wtot;
};

__device__ __forceinline__ LightCols light_cols(const int32_t* row, int r, int p_l,
                                                bool has_heavy) {
  LightCols lc;
  float l[kGroupCols];
  float s = 0.f;
  int real = 0;
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) {
    const int col = kGroupCols * r + j;
    const int32_t id = col < p_l ? row[col] : kPadId;
    s = __fadd_rn(s, col < p_l ? __int_as_float(row[p_l + col]) : 0.f);
    l[j] = s;
    real += col < p_l && id != kPadId && (!has_heavy || id >= 0);
  }
  const float ex = group_excl_scan(s, r);
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) lc.cdf[j] = __fadd_rn(ex, l[j]);
  lc.degree = group_isum(real);
  lc.wtot = group_sum(s);
  return lc;
}

// count(cdf < target) over a light row's P columns.
__device__ __forceinline__ int light_below(const float (&cdf)[kGroupCols], float target, int r,
                                           int p_l) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) n += kGroupCols * r + j < p_l && cdf[j] < target;
  return group_isum(n);
}

// The light CDF at column s (0 <= s < 32, uniform in the group).
__device__ __forceinline__ float light_cdf_at(const float (&cdf)[kGroupCols], int s) {
  return __shfl_sync(kFullMask, pick4(cdf, s & (kGroupCols - 1)), s / kGroupCols, kGroup);
}

// count(block CDF < target) over a heavy header's MAXB entries (lane r
// counts entries r, r + 8, ...).
__device__ __forceinline__ int header_below(const int32_t* row, float target, int r, int maxb) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kHeaderCols; ++j) {
    const int i = r + kGroup * j;
    n += i < maxb && __int_as_float(row[5 + maxb + i]) < target;
  }
  return group_isum(n);
}

// A heavy block's CDF.  Lane r owns the k4 = C / 32 int4s of columns
// [r C/8, (r+1) C/8); L_r(j) is the sum of its columns up to column j, added
// in order from 0; ex_r is the group's exclusive scan of the lanes' totals;
// the CDF at column j is ex_r + L_r(j), one add (so monotone in j within a
// lane).  block_below and block_prefix_before read the block from global
// memory (K21: twice, and a prefix recomputed by its owner); K5 makes the
// same float operations from a table of each block's (ex_r, ex_r + L_r(last))
// and the columns of the one lane the residual falls in (blocked_walk.cu).
// Ld(m) returns the calling lane's m-th int4 of columns.
struct GlobalCols {
  const int4* base;  // the lane's first int4
  __device__ __forceinline__ int4 operator()(int m) const { return __ldg(base + m); }
};

__device__ __forceinline__ GlobalCols global_cols(const int32_t* row, int k4, int r) {
  return GlobalCols{reinterpret_cast<const int4*>(row) + r * k4};
}

// A block row in shared memory (blocked_walk.cu's lane buffer), the same way.
struct SharedCols {
  const int4* base;
  __device__ __forceinline__ int4 operator()(int m) const { return base[m]; }
};

// L_r at the lane's last column: its n4 int4s summed in order from 0.
template <class Ld>
__device__ __forceinline__ float lane_sum(const Ld& ld, int n4) {
  float l = 0.f;
#pragma unroll 4
  for (int m = 0; m < n4; ++m) {
    const int4 v = ld(m);
    l = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(l, __int_as_float(v.x)), __int_as_float(v.y)),
                            __int_as_float(v.z)),
                  __int_as_float(v.w));
  }
  return l;
}

// count(ex + L_r(j) < resid) over the lane's n4 int4s of columns.
template <class Ld>
__device__ __forceinline__ int lane_below(const Ld& ld, int n4, float ex, float resid) {
  float l = 0.f;
  int below = 0;
#pragma unroll 4
  for (int m = 0; m < n4; ++m) {
    const int4 v = ld(m);
    l = __fadd_rn(l, __int_as_float(v.x));
    below += __fadd_rn(ex, l) < resid;
    l = __fadd_rn(l, __int_as_float(v.y));
    below += __fadd_rn(ex, l) < resid;
    l = __fadd_rn(l, __int_as_float(v.z));
    below += __fadd_rn(ex, l) < resid;
    l = __fadd_rn(l, __int_as_float(v.w));
    below += __fadd_rn(ex, l) < resid;
  }
  return below;
}

// L_r at the lane's column `last`.
template <class Ld>
__device__ __forceinline__ float lane_prefix(const Ld& ld, int last) {
  float l = 0.f;
  for (int m = 0; m <= last / 4; ++m) {
    const int4 v = ld(m);
    l = __fadd_rn(l, __int_as_float(v.x));
    if (4 * m + 1 <= last) l = __fadd_rn(l, __int_as_float(v.y));
    if (4 * m + 2 <= last) l = __fadd_rn(l, __int_as_float(v.z));
    if (4 * m + 3 <= last) l = __fadd_rn(l, __int_as_float(v.w));
  }
  return l;
}

// count(block CDF < resid); this lane's ex_r in *excl.
template <class Ld>
__device__ __forceinline__ int block_below(const Ld& ld, int k4, float resid, int r, bool on,
                                           float* excl) {
  const int n4 = on ? k4 : 0;
  const float ex = group_excl_scan(lane_sum(ld, n4), r);
  *excl = ex;
  return group_isum(lane_below(ld, n4, ex, resid));
}

// The block CDF at slot - 1 (0 for slot 0), recomputed by the lane that owns
// column slot - 1.
template <class Ld>
__device__ __forceinline__ float block_prefix_before(const Ld& ld, int k4, float excl, int slot,
                                                     int r, bool on) {
  const int j = max(slot - 1, 0);
  const int owner = j / (4 * k4);
  float pc = 0.f;
  if (on && slot > 0 && r == owner) pc = __fadd_rn(excl, lane_prefix(ld, j - owner * 4 * k4));
  pc = __shfl_sync(kFullMask, pc, owner, kGroup);
  return slot > 0 ? pc : 0.f;
}

// The (rev±, pfx) pair of global block slot gslot: brp's flat index 2 * gslot.
__device__ __forceinline__ int2 brp_pair(const int32_t* brp, int64_t gslot) {
  return __ldg(reinterpret_cast<const int2*>(brp) + gslot);
}

// The bids row a heavy prev's membership test reads (its block picked by
// the header's block minima), or nullptr for a light prev.
__device__ __forceinline__ const int32_t* member_row(const int32_t* prev_row,
                                                     const int32_t* bids, int32_t cand, int r,
                                                     int p_l, int c, bool has_heavy) {
  const int maxb = (4 * p_l - 5) / 2;
  int n = 0;
#pragma unroll
  for (int j = 0; j < kHeaderCols; ++j) {
    const int i = r + kGroup * j;
    n += i < maxb && prev_row[5 + i] <= cand;
  }
  int jm = group_isum(n) - 1;
  if (!(has_heavy && prev_row[0] < -1)) return nullptr;
  jm = min(max(jm, 0), max(prev_row[2] - 1, 0));
  return bids + (static_cast<int64_t>(prev_row[1]) + jm) * c;
}

// Is cand in N(prev)?  A heavy prev's bids row (mrow, from member_row; a
// light prev passes nullptr) holds its C ids ascending, PAD last (the CSR's
// rows are sorted), so two trips answer: lane r reads the first id of the
// r-th eighth of the row, and the eighth that can hold cand (the last whose
// first id is <= cand) is read whole, C/32 int4s spread over the group:
// 8 sectors and C/2 bytes instead of the row's C*4.  A light prev: its P ids.
__device__ __forceinline__ bool prev_member(const int32_t* prev_row, const int32_t* mrow, int c,
                                            int32_t cand, int r, int p_l, bool on) {
  const bool heavy = mrow != nullptr;
  const int seg = c / kGroup;  // ids an eighth
  const int32_t first = on && heavy ? __ldg(mrow + r * seg) : kPadId;
  const int n = group_count(first <= cand);
  bool hit = false;
  if (on && heavy && n > 0) {
    const int4* p = reinterpret_cast<const int4*>(mrow + (n - 1) * seg);
    for (int i = r; i < seg / 4; i += kGroup) {
      const int4 v = __ldg(p + i);
      hit |= v.x == cand || v.y == cand || v.z == cand || v.w == cand;
    }
  }
  if (on && !heavy) {
#pragma unroll
    for (int j = 0; j < kGroupCols; ++j) {
      const int col = kGroupCols * r + j;
      hit |= col < p_l && prev_row[col] == cand;
    }
  }
  return group_any(hit);
}

}  // namespace n2v
