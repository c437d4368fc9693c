// K12 csr_walk: second-order alias-proposal rejection walks over the
// sorted CSR, the whole walk inside one launch.
//
// Replaces node2vec_tpu/walk/engine.py:66 walk_chunk_impl, together with
// node2vec_tpu/ops/sampling.py:16 searchsorted_in_segments and
// :46 contains_in_segments.  It computes what the plain version
// walk/csr.py:csr_walk_chunk_plain computes, walker by walker.
//
// Per step, from cur with previous vertex prev:
//   - a vertex of degree 0 ends the walk (-1 from this step on);
//   - the back-edge atom: one lower-bound search for prev in cur's row gives
//     w_back, and m1 = w_back / p (0 at step 0 and when p = q = 1);
//   - a degree-1 vertex whose neighbour is prev moves back at once, with no
//     draw and no attempt counted;
//   - otherwise rounds of K proposals: proposal k draws counters
//     (att + k) * 4 + {0, 1} for an alias draw in cur's row, + 2 for the
//     branch coin (take prev with probability m1 / max(m1 + m2, 1e-30),
//     m2 = wtot[cur] * max(1, 1/q)), + 3 for acceptance (a non-return
//     proposal is accepted when u * max(1, 1/q) <= bias, bias 1 if it lies
//     in prev's row, a second lower-bound search, and 1/q otherwise); step
//     0 and p = q = 1 accept every proposal.  The first accepted proposal of
//     a round wins; a round without one keeps its last proposal and, after
//     n_rounds rounds, the walker takes it.  att advances by K a round.
// The JAX program runs every lane through a shared while_loop; a lane's
// draws depend only on its own att, which advances only while it attempts,
// so a per-walker loop that stops at its first acceptance gives the same
// paths.  K and n_rounds come from the wrapper: the JAX sizing uses
// Python's round (half to even), which C's lround does not.
//
// Design: one thread per walker, state in registers, the row reads as
// gathers through L1 (__ldg).  Rounding: every float op is a _rn intrinsic
// (no FMA contraction), on the plain version's operands; the uniforms come
// from hashrng.cuh, shared with K1 and K5, so paths are bit-equal to the
// plain version's wherever its float32 arithmetic is (always: there are no
// sums here besides wtot, which the host computes).
//
// Bound on an H100: bytes, as dependent gathers.  Per step two indptr
// entries, wtot[cur], the back-edge search (log2(deg) probes) and per
// proposal a prob, maybe an alias and an index entry, plus a membership
// search in prev's row; the paths written.  Each is a 32-byte sector at
// best; the kernel's time is the latency of these chains.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashrng.cuh"

namespace {

constexpr int kThreads = 128;

// lower bound of v in data[lo, lo + len): the first position whose entry is
// >= v, after at most n_iters halvings (the plain version's fixed loop;
// iterations after lo == hi change nothing)
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ data, int64_t lo,
                                               int64_t len, int32_t v, int n_iters) {
  int64_t hi = lo + len;
  for (int i = 0; i < n_iters && lo < hi; ++i) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(data + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
csr_walk_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const float* __restrict__ weights, const int32_t* __restrict__ alias,
                const float* __restrict__ prob, const float* __restrict__ wtot,
                const int32_t* __restrict__ starts, int32_t* __restrict__ paths,
                int64_t n_walkers, int walk_length, int64_t gid_base, uint32_t seed,
                float inv_p, float inv_q, float alpha2_max, int kb, int n_rounds,
                int search_iters, int uniform_bias) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= n_walkers) return;
  int32_t* out = paths + w * (walk_length + 1);
  const uint32_t gid = static_cast<uint32_t>(gid_base + w);
  const int32_t start = starts[w];
  out[0] = start >= 0 ? start : -1;
  int t = 0;
  if (start >= 0) {
    int32_t cur = start;
    int32_t prev = -1;
    uint32_t att = 0;
    for (; t < walk_length; ++t) {
      const int64_t seg = __ldg(indptr + cur);
      const int64_t degree = __ldg(indptr + cur + 1) - seg;
      if (degree <= 0) break;  // the walk ends here: -1 from step t + 1
      const bool first_order = prev < 0;
      const bool biased = !uniform_bias && !first_order;
      float m1 = 0.f;
      bool only_back = false;
      int64_t p_seg = 0, p_deg = 0;
      if (biased) {
        const int64_t pos = lower_bound(indices, seg, degree, prev, search_iters);
        const bool has_back = pos < seg + degree && __ldg(indices + pos) == prev;
        m1 = __fmul_rn(has_back ? __ldg(weights + pos) : 0.f, inv_p);
        only_back = has_back && degree == 1;
        p_seg = __ldg(indptr + prev);
        p_deg = __ldg(indptr + prev + 1) - p_seg;
      }
      int32_t nxt = prev;
      if (!only_back) {
        const float m2 = __fmul_rn(__ldg(wtot + cur), alpha2_max);
        const float p_branch1 = __fdiv_rn(m1, fmaxf(__fadd_rn(m1, m2), 1e-30f));
        const float deg_f = static_cast<float>(degree);
        bool accepted = false;
        for (int round = 0; round < n_rounds && !accepted; ++round) {
          for (int k = 0; k < kb; ++k) {
            const uint32_t ctr = (att + static_cast<uint32_t>(k)) * 4u;
            const float r1 = n2v::hash_uniform(seed, gid, ctr);
            const float r2 = n2v::hash_uniform(seed, gid, ctr + 1u);
            const int64_t slot =
                min(static_cast<int64_t>(__fmul_rn(r1, deg_f)), degree - 1);
            const int64_t e = seg + slot;
            const int64_t j = r2 < __ldg(prob + e) ? slot : __ldg(alias + e);
            int32_t proposal = __ldg(indices + seg + j);
            bool accept = true;
            if (biased) {
              const bool take_back = n2v::hash_uniform(seed, gid, ctr + 2u) < p_branch1;
              if (take_back) {
                proposal = prev;
              } else if (proposal == prev) {
                accept = false;
              } else {
                const int64_t q = lower_bound(indices, p_seg, p_deg, proposal, search_iters);
                const bool shared = q < p_seg + p_deg && __ldg(indices + q) == proposal;
                const float u = n2v::hash_uniform(seed, gid, ctr + 3u);
                accept = __fmul_rn(u, alpha2_max) <= (shared ? 1.f : inv_q);
              }
            }
            nxt = proposal;  // the round's last proposal unless one is accepted first
            if (accept) {
              accepted = true;
              break;
            }
          }
          att += static_cast<uint32_t>(kb);
        }
      }
      out[t + 1] = nxt;
      prev = cur;
      cur = nxt;
    }
  }
  for (int s = t + 1; s <= walk_length; ++s) out[s] = -1;
}

}  // namespace

extern "C" int n2v_csr_walk(const int32_t* indptr, const int32_t* indices, const float* weights,
                            const int32_t* alias, const float* prob, const float* wtot,
                            int64_t n_edges, const int32_t* starts, int32_t* paths,
                            int64_t n_walkers, int walk_length, int64_t gid_base, uint32_t seed,
                            float inv_p, float inv_q, float alpha2_max, int kb, int n_rounds,
                            int search_iters, int uniform_bias, void* stream) {
  if (kb < 1 || n_rounds < 1 || search_iters < 1 || walk_length < 0 || n_edges < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_walkers == 0) return 0;
  const int64_t blocks = (n_walkers + kThreads - 1) / kThreads;
  csr_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, weights, alias, prob, wtot, starts, paths, n_walkers, walk_length,
      gid_base, seed, inv_p, inv_q, alpha2_max, kb, n_rounds, search_iters, uniform_bias);
  return static_cast<int>(cudaGetLastError());
}
