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
// What holds it on an H100, from clock64() phases and variants
// (experiments/csr_attribution.py) of the first design (one thread a
// walker, a step a loop pass, every search a fixed bisection): the
// membership searches (the launch takes 0.66 ms without them, 1.07 with),
// then the back search and the proposals' loads; a lane waits at the end of
// each step for the warp's other walkers (47% of lane 0's cycles), but that
// wait is hidden by the other warps: 8,192 walkers take 73% of the time of
// 131,072, and at the main path's 131,072 the launch is held by the number
// of the walkers' scattered loads, not by any one walker's chain.  Two
// redesigns that shortened the chains and added loads were slower (1.83
// and 1.13 ms against 1.07): 16 entries of each row kept in shared memory
// with 4-ary searches, and a round a loop pass with its proposals in
// interleaved pairs and searches ending in one 8-entry read.
//
// Design.  One thread a walker, all of a launch's walkers resident, no
// shared memory (the SM's L1 stays whole for the bisections' last probes),
// positions in 32 bits (indptr's width) so that the loop's state fits the
// registers without spills, and fewer loads a step: a membership search runs only where its answer
// can change the acceptance (u * max(1, 1/q) lies between 1/q and 1:
// elsewhere every proposal is accepted, or every one rejected, whether or
// not it lies in prev's row); a bisection's answer is read from its last
// probe, not loaded again; prev's row bounds are carried from its step;
// the row bounds and wtot[cur] are read together; alias is read only where
// the keep coin needs it.  Every search is the fixed bisection, so its
// answer, truncated where the row is too long for search_iters halvings,
// is the plain version's.
//
// Bound on an H100: bytes, as dependent gathers.  Per step two indptr
// entries, wtot[cur], the back-edge search and per proposal a prob, maybe an
// alias and an index entry, plus a membership search in prev's row where it
// decides; the paths written.  Each is a 32-byte sector at best; at 131,072
// walkers the time is the number of those scattered loads, below that the
// latency of one walker's chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashrng.cuh"

namespace {

constexpr int kThreads = 128;

struct Found {
  int32_t pos;  // the lower bound after at most n_iters halvings
  bool member;  // the entry there is v
};

// lower bound of v in data[lo, lo + len): the first position whose entry is
// >= v, after at most n_iters halvings (the plain version's fixed loop;
// iterations after lo == hi change nothing), and whether v is there: read
// from the last probe that moved hi where the search finished, else loaded.
// Positions are int32: indptr is.
__device__ __forceinline__ Found lower_bound(const int32_t* __restrict__ data, int32_t lo,
                                             int32_t len, int32_t v, int n_iters) {
  const int32_t end = lo + len;
  int32_t hi = end;
  int32_t at_hi = 0;  // data[hi] once a probe has moved hi
  for (int i = 0; i < n_iters && lo < hi; ++i) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const int32_t x = __ldg(data + mid);
    if (x < v) {
      lo = mid + 1;
    } else {
      hi = mid;
      at_hi = x;
    }
  }
  if (lo < hi) return Found{lo, __ldg(data + lo) == v};  // truncated: lo is inside the row
  return Found{lo, lo < end && at_hi == v};
}

__global__ void __launch_bounds__(kThreads, 8)
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
    int32_t p_seg = 0, p_deg = 0;  // prev's row, carried from its step
    for (; t < walk_length; ++t) {
      const int32_t seg = __ldg(indptr + cur);
      const int32_t degree = __ldg(indptr + cur + 1) - seg;
      const float wt = __ldg(wtot + cur);
      if (degree <= 0) break;  // the walk ends here: -1 from step t + 1
      const bool first_order = prev < 0;
      const bool biased = !uniform_bias && !first_order;
      float m1 = 0.f;
      bool only_back = false;
      if (biased) {
        const Found f = lower_bound(indices, seg, degree, prev, search_iters);
        m1 = __fmul_rn(f.member ? __ldg(weights + f.pos) : 0.f, inv_p);
        only_back = f.member && degree == 1;
      }
      int32_t nxt = prev;
      if (!only_back) {
        const float m2 = __fmul_rn(wt, alpha2_max);
        const float p_branch1 = __fdiv_rn(m1, fmaxf(__fadd_rn(m1, m2), 1e-30f));
        const float deg_f = static_cast<float>(degree);
        bool accepted = false;
        for (int round = 0; round < n_rounds && !accepted; ++round) {
          for (int k = 0; k < kb; ++k) {
            const uint32_t ctr = (att + static_cast<uint32_t>(k)) * 4u;
            const float r1 = n2v::hash_uniform(seed, gid, ctr);
            const float r2 = n2v::hash_uniform(seed, gid, ctr + 1u);
            const int32_t slot = min(static_cast<int32_t>(__fmul_rn(r1, deg_f)), degree - 1);
            const int32_t e = seg + slot;
            const int32_t j = r2 < __ldg(prob + e) ? slot : __ldg(alias + e);
            int32_t proposal = __ldg(indices + seg + j);
            bool accept = true;
            if (biased) {
              const bool take_back = n2v::hash_uniform(seed, gid, ctr + 2u) < p_branch1;
              if (take_back) {
                proposal = prev;
              } else if (proposal == prev) {
                accept = false;
              } else {
                const float u = __fmul_rn(n2v::hash_uniform(seed, gid, ctr + 3u), alpha2_max);
                const bool in_q = u <= inv_q, in_1 = u <= 1.f;
                // the membership decides only where the two bounds disagree
                const bool shared =
                    in_q != in_1 &&
                    lower_bound(indices, p_seg, p_deg, proposal, search_iters).member;
                accept = shared ? in_1 : in_q;
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
      p_seg = seg;
      p_deg = degree;
      prev = cur;
      cur = nxt;
    }
  }
  for (int s = t + 1; s <= walk_length; ++s) out[s] = -1;
}

}  // namespace

// K12's launch: out[0] blocks resident an SM, [1] walkers a block, [2] SMs,
// [3] dynamic shared memory a block (B).
extern "C" int n2v_csr_walk_geometry(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csr_walk_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = per_sm;
  out[1] = kThreads;
  out[2] = sms;
  out[3] = 0;
  return 0;
}

extern "C" int n2v_csr_walk(const int32_t* indptr, const int32_t* indices, const float* weights,
                            const int32_t* alias, const float* prob, const float* wtot,
                            int64_t n_edges, const int32_t* starts, int32_t* paths,
                            int64_t n_walkers, int walk_length, int64_t gid_base, uint32_t seed,
                            float inv_p, float inv_q, float alpha2_max, int kb, int n_rounds,
                            int search_iters, int uniform_bias, void* stream) {
  if (kb < 1 || n_rounds < 1 || search_iters < 1 || walk_length < 0 || n_edges < 0 ||
      n_edges >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_walkers == 0) return 0;
  const int64_t blocks = (n_walkers + kThreads - 1) / kThreads;
  csr_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, weights, alias, prob, wtot, starts, paths, n_walkers, walk_length,
      gid_base, seed, inv_p, inv_q, alpha2_max, kb, n_rounds, search_iters, uniform_bias);
  return static_cast<int>(cudaGetLastError());
}
