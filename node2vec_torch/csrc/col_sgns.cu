// K16 col_pair_logits and K17 col_pair_grads: the column-sharded SGNS step.
//
// Replaces node2vec_tpu/parallel/sharded_sgns.py:57 _col_step (driven by
// :284 sharded_sgns_step and :248 col_sgns_epoch), the mesh's default
// trainer.  Each rank holds dims [m * Dm, (m + 1) * Dm) of every row of
// emb_in and emb_out (Dm = D / n_model), so the pair step of K13
// (sgns_pairs.cu) splits at the all-reduce over the model axis: a logit is
// a sum of partial dot products, one a rank.  The step on a rank:
//   K13's first launch  pair lists (centers, contexts; -1 where invalid)
//   K16                 partial logits over this rank's Dm columns
//   all_reduce(model)   full logits
//   K17                 gradients over Dm from the full logits, and the
//                       partial squares of each gradient row
//   all_reduce(model)   full squares (divided by the full D in K3)
//   K3, squares mode    dacc, then all_reduce(data) and acc += dacc
//   K4                  the update, scaled by the final accumulators
//
// K16 writes, for the walk's P lanes in the JAX order (walk, offset,
// position) and for its L1 positions:
//   pos_part[p]         = ci[p] . co[p] over Dm   (0 on an invalid lane)
//   neg_part[b, i, s]   = xin[i] . no[s] over Dm  (0 for a position with no
//                                                  valid lane)
// The negative logits depend only on the center, a walk position, so they
// are computed once a position, as K13 does, and the buffer is [B * L1, S]
// where the JAX step's is [P, S] (2w rows a position, all equal).
//
// K17 takes the all-reduced logits and writes, as K13 does over D:
//   d_ci[p] = g_pos[p] * co[p] + gn[center]      (0 where invalid)
//   d_co[p] = g_pos[p] * ci[p]                   (0 where invalid)
//   d_no    = sum over valid lanes of g_neg^T ci (block partials, one fp32
//             atomic an entry a block)
// beside each lane's partial squares sum_k d_ci[p, k]^2 and sum_k
// d_co[p, k]^2 (a warp writes a lane's row and sums its squares, so no pass
// reads the gradients back), each negative's sum_k d_no[s, k]^2 (the last
// block to finish reads d_no after every block's atomics), and the loss
// partials of each block, as K13's.  At n_model = 1, K16 then K17 is K13's
// function.
//
// Staging: as K13, a walk that exceeds the card's shared memory per block
// stages in a per-block slice of a global workspace (staging.cuh).
//
// Bound on an H100: memory, as K13.  K17 writes 2 * P * Dm * 4 bytes of
// per-lane gradients (275 MB at B = 2,560, L1 = 21, w = 5, Dm = 64) and K3/K4
// read them back; K16 reads the walk's rows and writes P + B * L1 * S
// floats.  Both keep a walk's rows in shared memory and write a walk's lanes
// as one contiguous run.

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// log(sigmoid(x)) = -softplus(-x), in the overflow-safe form
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// offset index o in [0, 2w) -> window offset d in -w..-1, 1..w
__device__ __forceinline__ int offset_of(int o, int window) {
  return o < window ? o - window : o - window + 1;
}

// The walk's vertex rows (0 for a dead position), which lanes are valid, and
// each position's count of valid lanes; then its [L, Dm] rows of both tables.
__device__ __forceinline__ void load_walk(const float* __restrict__ emb_in,
                                          const float* __restrict__ emb_out, int D,
                                          const int32_t* __restrict__ walks,
                                          const int32_t* __restrict__ centers, int64_t base,
                                          int64_t lane0, int L, int W2, float* xin, float* xout,
                                          float* mult, int* rows, int* live) {
  const int tid = threadIdx.x;
  for (int i = tid; i < L; i += kThreads) {
    const int v = walks[base + i];
    rows[i] = v >= 0 ? v : 0;
  }
  for (int q = tid; q < W2 * L; q += kThreads) live[q] = centers[lane0 + q] >= 0;
  __syncthreads();
  for (int i = tid; i < L * D; i += kThreads) {
    const int64_t r = static_cast<int64_t>(rows[i / D]) * D + i % D;
    xin[i] = emb_in[r];
    xout[i] = emb_out[r];
  }
  for (int i = tid; i < L; i += kThreads) {
    float m = 0.f;
    for (int o = 0; o < W2; ++o) m += live[o * L + i] ? 1.f : 0.f;
    mult[i] = m;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K16: partial logits
// ---------------------------------------------------------------------------

__device__ __forceinline__ void
logits_block(float* sm, const float* __restrict__ emb_in, const float* __restrict__ emb_out,
             int dim, const int32_t* __restrict__ walks, const int32_t* __restrict__ centers,
             const int32_t* __restrict__ neg_ids, int n_walks, int length, int window,
             int n_neg, float* __restrict__ pos_part, float* __restrict__ neg_part) {
  const int L = length, D = dim, S = n_neg, W2 = 2 * window;
  float* xin = sm;              // [L, D]
  float* xout = xin + L * D;    // [L, D]
  float* no = xout + L * D;     // [S, D]
  float* mult = no + S * D;     // [L]
  int* rows = reinterpret_cast<int*>(mult + L);  // [L]
  int* live = rows + L;                          // [2w, L]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < S * D; i += kThreads)
    no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * D + i % D];

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    const int64_t lane0 = static_cast<int64_t>(b) * W2 * L;
    load_walk(emb_in, emb_out, D, walks, centers, base, lane0, L, W2, xin, xout, mult, rows,
              live);
    for (int q = warp; q < W2 * L; q += kWarps) {
      float acc = 0.f;
      if (live[q]) {
        const int o = q / L, i = q % L;
        const int j = i + offset_of(o, window);
        for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * xout[j * D + k];
        acc = warp_sum(acc);
      }
      if (lane == 0) pos_part[lane0 + q] = acc;
    }
    float* neg_out = neg_part + base * S;
    for (int q = warp; q < L * S; q += kWarps) {
      const int i = q / S, s = q % S;
      float acc = 0.f;
      if (mult[i] > 0.f) {
        for (int k = lane; k < D; k += 32) acc += xin[i * D + k] * no[s * D + k];
        acc = warp_sum(acc);
      }
      if (lane == 0) neg_out[q] = acc;
    }
    __syncthreads();  // the next walk overwrites the shared rows
  }
}

__global__ void __launch_bounds__(kThreads)
logits_kernel(const float* __restrict__ emb_in, const float* __restrict__ emb_out, int dim,
              const int32_t* __restrict__ walks, const int32_t* __restrict__ centers,
              const int32_t* __restrict__ neg_ids, int n_walks, int length, int window,
              int n_neg, float* __restrict__ pos_part, float* __restrict__ neg_part) {
  extern __shared__ float sm[];
  logits_block(sm, emb_in, emb_out, dim, walks, centers, neg_ids, n_walks, length, window,
               n_neg, pos_part, neg_part);
}

__global__ void __launch_bounds__(kThreads)
logits_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                     int dim, const int32_t* __restrict__ walks,
                     const int32_t* __restrict__ centers, const int32_t* __restrict__ neg_ids,
                     int n_walks, int length, int window, int n_neg,
                     float* __restrict__ pos_part, float* __restrict__ neg_part,
                     float* __restrict__ ws, int64_t ws_stride) {
  logits_block(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in, emb_out, dim, walks,
               centers, neg_ids, n_walks, length, window, n_neg, pos_part, neg_part);
}

size_t logits_smem(int length, int dim, int n_neg, int window) {
  const size_t floats = 2 * static_cast<size_t>(length) * dim +
                        static_cast<size_t>(n_neg) * dim + length;
  return floats * sizeof(float) +
         sizeof(int) * (static_cast<size_t>(length) + 2 * window * length);
}

// ---------------------------------------------------------------------------
// K17: gradients and partial squares from the full logits
// ---------------------------------------------------------------------------

__device__ __forceinline__ void
grads_block(float* sm, const float* __restrict__ emb_in, const float* __restrict__ emb_out,
            int dim, const int32_t* __restrict__ walks, const int32_t* __restrict__ centers,
            const int32_t* __restrict__ neg_ids, const float* __restrict__ pos_logit,
            const float* __restrict__ neg_logit, int n_walks, int length, int window,
            int n_neg, float neg_scale, float* __restrict__ d_ci, float* __restrict__ d_co,
            float* __restrict__ d_no, float* __restrict__ sq_ci, float* __restrict__ sq_co,
            float* __restrict__ sq_no, float* __restrict__ loss_parts,
            unsigned* __restrict__ done) {
  const int L = length, D = dim, S = n_neg, W2 = 2 * window;
  float* xin = sm;              // [L, D]
  float* xout = xin + L * D;    // [L, D]
  float* gn = xout + L * D;     // [L, D] g_neg . no of each center
  float* no = gn + L * D;       // [S, D]
  float* dno = no + S * D;      // [S, D] block partial of d_no
  float* gneg = dno + S * D;    // [L, S] sigmoid(nl) * K/S, 0 for a dead center
  float* gpos = gneg + L * S;   // [2w, L] sigmoid(pos) - 1, 0 where invalid
  float* mult = gpos + W2 * L;  // [L]
  float* red = mult + L;        // [3 * kWarps]
  int* rows = reinterpret_cast<int*>(red + 3 * kWarps);  // [L]
  int* live = rows + L;                                  // [2w, L]
  int* last = live + W2 * L;                             // [1] this block finished last

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < S * D; i += kThreads) {
    no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * D + i % D];
    dno[i] = 0.f;
  }
  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;

  for (int b = blockIdx.x; b < n_walks; b += gridDim.x) {
    const int64_t base = static_cast<int64_t>(b) * L;
    const int64_t lane0 = static_cast<int64_t>(b) * W2 * L;
    load_walk(emb_in, emb_out, D, walks, centers, base, lane0, L, W2, xin, xout, mult, rows,
              live);
    for (int i = tid; i < L; i += kThreads) mult_acc += mult[i];
    for (int q = tid; q < W2 * L; q += kThreads) {
      float g = 0.f;
      if (live[q]) {
        const float logit = pos_logit[lane0 + q];
        g = sigmoid(logit) - 1.f;
        pos_acc += log_sigmoid(logit);
      }
      gpos[q] = g;
    }
    const float* nl_in = neg_logit + base * S;
    for (int q = tid; q < L * S; q += kThreads) {
      const int i = q / S;
      float g = 0.f;
      if (mult[i] > 0.f) {
        const float nl = nl_in[q];
        g = sigmoid(nl) * neg_scale;
        neg_acc += log_sigmoid(-nl) * mult[i];
      }
      gneg[q] = g;
    }
    __syncthreads();

    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D, k = e % D;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += gneg[i * S + s] * no[s * D + k];
      gn[e] = acc;
    }
    for (int e = tid; e < S * D; e += kThreads) {
      const int s = e / D, k = e % D;
      float acc = 0.f;
      for (int i = 0; i < L; ++i) acc += mult[i] * gneg[i * S + s] * xin[i * D + k];
      dno[e] += acc;
    }
    __syncthreads();

    // a warp a lane: its two gradient rows, then their sums of squares
    for (int q = warp; q < W2 * L; q += kWarps) {
      const int o = q / L, i = q % L;
      const int64_t out = (lane0 + q) * D;
      float sa = 0.f, sc = 0.f;
      if (live[q]) {
        const int j = i + offset_of(o, window);
        const float gp = gpos[q];
        for (int k = lane; k < D; k += 32) {
          const float a = gp * xout[j * D + k] + gn[i * D + k];
          const float c = gp * xin[i * D + k];
          d_ci[out + k] = a;
          d_co[out + k] = c;
          sa += a * a;
          sc += c * c;
        }
        sa = warp_sum(sa);
        sc = warp_sum(sc);
      } else {
        for (int k = lane; k < D; k += 32) {
          d_ci[out + k] = 0.f;
          d_co[out + k] = 0.f;
        }
      }
      if (lane == 0) {
        sq_ci[lane0 + q] = sa;
        sq_co[lane0 + q] = sc;
      }
    }
    __syncthreads();  // the next walk overwrites the shared rows
  }

  for (int i = tid; i < S * D; i += kThreads) atomicAdd(d_no + i, dno[i]);
  pos_acc = warp_sum(pos_acc);
  neg_acc = warp_sum(neg_acc);
  mult_acc = warp_sum(mult_acc);
  if (lane == 0) {
    red[warp] = pos_acc;
    red[kWarps + warp] = neg_acc;
    red[2 * kWarps + warp] = mult_acc;
  }
  __threadfence();  // this block's d_no atomics land before its ticket
  __syncthreads();
  if (tid < 3) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    loss_parts[3 * blockIdx.x + tid] = t;
  }
  if (tid == 0) *last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  // the last block: every block's d_no is in, read it from L2
  for (int s = warp; s < S; s += kWarps) {
    float acc = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float v = __ldcg(d_no + static_cast<int64_t>(s) * D + k);
      acc += v * v;
    }
    acc = warp_sum(acc);
    if (lane == 0) sq_no[s] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
grads_kernel(const float* __restrict__ emb_in, const float* __restrict__ emb_out, int dim,
             const int32_t* __restrict__ walks, const int32_t* __restrict__ centers,
             const int32_t* __restrict__ neg_ids, const float* __restrict__ pos_logit,
             const float* __restrict__ neg_logit, int n_walks, int length, int window,
             int n_neg, float neg_scale, float* __restrict__ d_ci, float* __restrict__ d_co,
             float* __restrict__ d_no, float* __restrict__ sq_ci, float* __restrict__ sq_co,
             float* __restrict__ sq_no, float* __restrict__ loss_parts,
             unsigned* __restrict__ done) {
  extern __shared__ float sm[];
  grads_block(sm, emb_in, emb_out, dim, walks, centers, neg_ids, pos_logit, neg_logit, n_walks,
              length, window, n_neg, neg_scale, d_ci, d_co, d_no, sq_ci, sq_co, sq_no,
              loss_parts, done);
}

__global__ void __launch_bounds__(kThreads)
grads_kernel_staged(const float* __restrict__ emb_in, const float* __restrict__ emb_out,
                    int dim, const int32_t* __restrict__ walks,
                    const int32_t* __restrict__ centers, const int32_t* __restrict__ neg_ids,
                    const float* __restrict__ pos_logit, const float* __restrict__ neg_logit,
                    int n_walks, int length, int window, int n_neg, float neg_scale,
                    float* __restrict__ d_ci, float* __restrict__ d_co,
                    float* __restrict__ d_no, float* __restrict__ sq_ci,
                    float* __restrict__ sq_co, float* __restrict__ sq_no,
                    float* __restrict__ loss_parts, unsigned* __restrict__ done,
                    float* __restrict__ ws, int64_t ws_stride) {
  grads_block(ws + static_cast<int64_t>(blockIdx.x) * ws_stride, emb_in, emb_out, dim, walks,
              centers, neg_ids, pos_logit, neg_logit, n_walks, length, window, n_neg,
              neg_scale, d_ci, d_co, d_no, sq_ci, sq_co, sq_no, loss_parts, done);
}

size_t grads_smem(int length, int dim, int n_neg, int window) {
  const size_t floats = 3 * static_cast<size_t>(length) * dim +
                        2 * static_cast<size_t>(n_neg) * dim +
                        static_cast<size_t>(length) * n_neg +
                        static_cast<size_t>(length) * 2 * window + length +
                        3 * kWarps;
  return floats * sizeof(float) +
         sizeof(int) * (static_cast<size_t>(length) + 2 * window * length + 1);
}

}  // namespace

extern "C" size_t n2v_col_pair_logits_smem(int length, int dim, int n_neg, int window) {
  return logits_smem(length, dim, n_neg, window);
}

extern "C" size_t n2v_col_pair_grads_smem(int length, int dim, int n_neg, int window) {
  return grads_smem(length, dim, n_neg, window);
}

// K16 on K13's pair lists: pos_part [n_walks * 2w * length], neg_part
// [n_walks * length, n_neg].  ws null: shared staging; else ws (staging.cuh).
extern "C" int n2v_col_pair_logits(const float* emb_in, const float* emb_out, int dim,
                                   const int32_t* walks, const int32_t* centers,
                                   const int32_t* neg_ids, int n_walks, int length,
                                   int window, int n_neg, float* pos_part, float* neg_part,
                                   float* ws, int ws_blocks, void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      logits_kernel, logits_kernel_staged, kThreads, logits_smem(length, dim, n_neg, window),
      n_walks, ws, ws_blocks, static_cast<cudaStream_t>(stream), emb_in, emb_out, dim, walks,
      centers, neg_ids, n_walks, length, window, n_neg, pos_part, neg_part);
}

// K17 on the model-summed logits.  d_no must be zeroed [n_neg, dim],
// loss_parts must hold 3 * n_walks zeros and done one zero.
extern "C" int n2v_col_pair_grads(const float* emb_in, const float* emb_out, int dim,
                                  const int32_t* walks, const int32_t* centers,
                                  const int32_t* neg_ids, const float* pos_logit,
                                  const float* neg_logit, int n_walks, int length, int window,
                                  int n_neg, float neg_scale, float* d_ci, float* d_co,
                                  float* d_no, float* sq_ci, float* sq_co, float* sq_no,
                                  float* loss_parts, unsigned* done, float* ws, int ws_blocks,
                                  void* stream) {
  if (n_walks == 0) return 0;
  return n2v::launch_staged(
      grads_kernel, grads_kernel_staged, kThreads, grads_smem(length, dim, n_neg, window),
      n_walks, ws, ws_blocks, static_cast<cudaStream_t>(stream), emb_in, emb_out, dim, walks,
      centers, neg_ids, pos_logit, neg_logit, n_walks, length, window, n_neg, neg_scale, d_ci,
      d_co, d_no, sq_ci, sq_co, sq_no, loss_parts, done);
}
