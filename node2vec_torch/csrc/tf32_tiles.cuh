// The walk-group tile machinery of the step kernels that run their products
// on the tensor cores: K2 sgns_grads (sgns.cu), K9 cbow_grads (cbow.cu) and
// K13 sgns_pair_grads (sgns_pairs.cu).  sgns.cu's head comment sets out the
// design; this header holds the pieces the three kernels share:
//
// * the walk-group geometry (Geo): groups of G = 64 / L1 walks (one walk
//   when L1 > 64) whose positions fill the rows of one M-tile of Mt rows, D
//   cut into chunks of KC columns, the strides that keep fragment loads
//   free of bank conflicts;
// * fp32-accurate products on TF32 tensor cores (3xTF32 mma.sync m16n8k8)
//   and their fragment loads and stores;
// * the two-stage ring of gathered [Mt, KC] chunks of X_in and X_out (bulk
//   copies completing on an mbarrier, cp.async, or plain copies into a
//   global workspace), with where each row comes from given by two row
//   tables;
// * a block's walk over its groups and their items (group, pass, chunk);
// * the shared negatives' rows NO and the block's d_no partial, loaded and
//   flushed once a block, and the block's loss partials.
//
// Every kernel that includes it runs kThreads threads a block.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace tiles {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;       // the ring of gathered chunks
constexpr int kGroupRows = 64;   // rows of the M-tile a group of walks fills
constexpr size_t kSmemOptin = 232448;  // an H100's shared memory per block
constexpr unsigned kFull = 0xFFFFFFFFu;

// sigmoid(x) and log(1 + exp(-|x|)) from one exp: log(sigmoid(x)) =
// min(x, 0) - that, the overflow-safe form.  The exp, log and division are
// the fast intrinsics (a few ulp, or 2^-21 absolute for the log on (1, 2];
// e is in (0, 1], so none meets its argument limits).
__device__ __forceinline__ float sigmoid_log1pe(float x, float& log1pe) {
  const float e = __expf(-fabsf(x));
  log1pe = __logf(1.f + e);
  const float inv = __fdividef(1.f, 1.f + e);
  return x >= 0.f ? inv : e * inv;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// the least stride >= n that is 8 mod 32 floats
__host__ __device__ inline int stride8(int n) { return n + ((40 - n % 32) % 32); }

// offset index o in [0, 2w) -> window offset d in -w..-1, 1..w (the JAX order)
__host__ __device__ inline int offset_of(int o, int window) {
  return o < window ? o - window : o - window + 1;
}

// A launch's geometry, computed alike on the host and in the kernel.
struct Geo {
  int L, D, S, W;  // walk length, dim, shared negatives, window
  int G;           // walks a group
  int Mt;          // a group's rows: G * L rounded up to 16
  int Sp;          // S rounded up to 16
  int KC, Dp, nc;  // columns a chunk, D rounded up to KC, chunks a pass
  int ldn;         // row stride of NO and the d_no partial (Dp + 4)
  int ldx;         // row stride of a gathered chunk (KC + 4)
  int ldg, ldb;    // row strides of [Mt, Sp] (NL / Gneg) and [Mt, Mt] arrays (8 mod 32)
  int ldc;         // row stride of a [Mt, KC] result staged for its stores (8 mod 32)
};

inline Geo make_geo(int length, int dim, int n_neg, int window, int kc) {
  Geo g;
  g.L = length;
  g.D = dim;
  g.S = n_neg;
  g.W = window;
  g.G = length >= kGroupRows ? 1 : kGroupRows / length;
  g.Mt = round_up(g.G * length, 16);
  g.Sp = round_up(n_neg, 16);
  g.KC = kc;
  g.Dp = round_up(dim, kc);
  g.nc = g.Dp / kc;
  g.ldn = g.Dp + 4;
  g.ldx = kc + 4;
  g.ldg = stride8(g.Sp);
  g.ldb = stride8(g.Mt);
  g.ldc = stride8(kc);
  return g;
}

// Floats every kernel carves alike: NO and the d_no partial, the ring, and
// the loss reduction and the ring's two mbarriers.
inline size_t common_floats(const Geo& g) {
  return 2 * static_cast<size_t>(g.Sp) * g.ldn +
         static_cast<size_t>(kStages) * 2 * g.Mt * g.ldx + 3 * kWarps + 4;
}

// chunks of 64 columns where smem_bytes(geo) fits the card's shared memory,
// else 32
template <typename SmemBytes>
inline Geo pick_geo(int length, int dim, int n_neg, int window, SmemBytes smem_bytes) {
  if (dim > 32) {
    const Geo g = make_geo(length, dim, n_neg, window, 64);
    if (smem_bytes(g) <= kSmemOptin) return g;
  }
  return make_geo(length, dim, n_neg, window, 32);
}

// ---- TF32 tensor-core products at fp32 accuracy ---------------------------

// x = hi + lo: hi rounded to TF32; lo = x - hi exactly, handed over as it
// is (the tensor cores read a TF32 operand's top 19 bits, so lo is
// truncated there: |error| < 2^-21 |x|, about what rounding it would keep)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (the 16 x 8 tiles at rows m0.., columns n0 + 8j.., j < NT, those
// below n_end) += A[m0:m0+16, k0:k1] . B[k0:k1, n0 + 8j:...], k0 and k1
// multiples of 8.  A(m, k) is A[k * lda + m] when kAK (stored k-major), else
// A[m * lda + k]; B(k, n) is B[k * ldb + n] when kBK, else B[n * ldb + k].
// kPerm: fragment slots t and t + 4 hold k = 2t and 2t + 1 (then a
// row-major A's pair is one 8-byte load).
template <int NT, bool kAK, bool kBK, bool kPerm>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], const float* A, int lda,
                                         const float* B, int ldb, int m0, int n0, int n_end,
                                         int k0, int k1) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ka = kPerm ? 2 * tq : tq, kb = kPerm ? 2 * tq + 1 : tq + 4;
  float small[NT][4] = {};  // the lo terms: chains of their own, added at the end
  for (int k = k0; k < k1; k += 8) {
    float av[4];
    if (kAK) {
      av[0] = A[(k + ka) * lda + m0 + gq];
      av[1] = A[(k + ka) * lda + m0 + gq + 8];
      av[2] = A[(k + kb) * lda + m0 + gq];
      av[3] = A[(k + kb) * lda + m0 + gq + 8];
    } else if (kPerm) {
      const float2 x = *reinterpret_cast<const float2*>(A + (m0 + gq) * lda + k + ka);
      const float2 y = *reinterpret_cast<const float2*>(A + (m0 + gq + 8) * lda + k + ka);
      av[0] = x.x;
      av[2] = x.y;
      av[1] = y.x;
      av[3] = y.y;
    } else {
      av[0] = A[(m0 + gq) * lda + k + ka];
      av[1] = A[(m0 + gq + 8) * lda + k + ka];
      av[2] = A[(m0 + gq) * lda + k + kb];
      av[3] = A[(m0 + gq + 8) * lda + k + kb];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j;
      if (n >= n_end) break;
      float b0, b1;
      if (kBK) {
        b0 = B[(k + ka) * ldb + n + gq];
        b1 = B[(k + kb) * ldb + n + gq];
      } else {
        b0 = B[(n + gq) * ldb + k + ka];
        b1 = B[(n + gq) * ldb + k + kb];
      }
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(small[j], al, bh0, bh1);
      mma_tf32(acc[j], ah, bh0, bh1);
      mma_tf32(small[j], ah, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += small[j][i];
}

// the accumulator fragments of a 16 x 8NT tile from / to a row-major array
template <int NT>
__device__ __forceinline__ void load_acc(float (&acc)[NT][4], const float* C, int ldc, int m0,
                                         int n0, int n_end) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= n_end) break;
    const int col = n0 + 8 * j + 2 * tq;
    const float2 x = *reinterpret_cast<const float2*>(C + (m0 + gq) * ldc + col);
    const float2 y = *reinterpret_cast<const float2*>(C + (m0 + gq + 8) * ldc + col);
    acc[j][0] = x.x;
    acc[j][1] = x.y;
    acc[j][2] = y.x;
    acc[j][3] = y.y;
  }
}

template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* C, int ldc, int m0,
                                          int n0, int n_end) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= n_end) break;
    const int col = n0 + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(C + (m0 + gq) * ldc + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(C + (m0 + gq + 8) * ldc + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// a 16 x 8NT tile of a [rows, D] output: the group's rows below `rows`,
// columns col0.. below D, rows of D floats from out + row0 * D
template <int NT>
__device__ __forceinline__ void store_grads(const float (&acc)[NT][4], float* __restrict__ out,
                                            int64_t row0, int dim, int rows, int m0, int col0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + gq + 8 * h;
    if (r >= rows) continue;
    float* dst = out + (row0 + r) * dim;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + 8 * j + 2 * tq;
      if (dim % 2 == 0 && col + 1 < dim) {  // an 8-byte aligned pair
        *reinterpret_cast<float2*>(dst + col) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        continue;
      }
      if (col < dim) dst[col] = acc[j][2 * h];
      if (col + 1 < dim) dst[col + 1] = acc[j][2 * h + 1];
    }
  }
}

// Four consecutive floats of a [rows, D] output row from column col: one
// 16-byte store where `vec` (D % 4 == 0 and the output 16-byte aligned),
// else those below D one at a time.
__device__ __forceinline__ void store4(float* __restrict__ dst, int col, int dim, bool vec,
                                       float4 v) {
  if (vec) {
    if (col < dim) *reinterpret_cast<float4*>(dst + col) = v;
    return;
  }
  if (col < dim) dst[col] = v.x;
  if (col + 1 < dim) dst[col + 1] = v.y;
  if (col + 2 < dim) dst[col + 2] = v.z;
  if (col + 3 < dim) dst[col + 3] = v.w;
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// ---- the gathers ----------------------------------------------------------

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One int from global memory into a block's array: cp.async into shared
// memory (landing by the next cp_wait_all), a plain copy into a workspace.
template <bool kShared>
__device__ __forceinline__ void copy_int(int* dst, const int32_t* src) {
  if (kShared)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
  else
    *dst = *src;
}

// Which group, pass and chunk the block's item t is.
struct Item {
  int q, pass, chunk;  // q: the block's group index
  int rows;            // the group's positions (G * L1, less in a ragged last group)
  int64_t row0;        // the group's first position
};

__device__ __forceinline__ Item group_of(const Geo& g, int n_walks, int q) {
  Item it;
  it.q = q;
  it.pass = it.chunk = 0;
  const int w0 = (blockIdx.x + q * gridDim.x) * g.G;
  it.rows = min(g.G, n_walks - w0) * g.L;
  it.row0 = static_cast<int64_t>(w0) * g.L;
  return it;
}

__device__ __forceinline__ Item item_of(const Geo& g, int n_walks, int t) {
  Item it = group_of(g, n_walks, t / (2 * g.nc));
  it.pass = (t / g.nc) % 2;
  it.chunk = t % g.nc;
  return it;
}

// the groups this block takes (grid-stride over ceil(n_walks / G) groups)
__device__ __forceinline__ int my_groups(const Geo& g, int n_walks) {
  const int n_groups = (n_walks + g.G - 1) / g.G;
  return n_groups > static_cast<int>(blockIdx.x) ? (n_groups - 1 - blockIdx.x) / gridDim.x + 1
                                                 : 0;
}

// Copy `n` floats of the row at src (null: zeros) from column c0 into dst,
// `piece` the caller's 16 B (vec) or 4 B piece of it: cp.async into shared
// memory, plain copies into a global workspace.
template <bool kShared>
__device__ __forceinline__ void copy_piece(float* dst, const float* src, int c0, int dim,
                                           int piece, bool vec) {
  if (vec) {
    const int col = c0 + 4 * piece;
    float* d = dst + 4 * piece;
    if (src != nullptr && col < dim) {
      if (kShared) {
        const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(d));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + col));
      } else {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src + col);
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const int col = c0 + piece;
    float* d = dst + piece;
    if (src != nullptr && col < dim) {
      if (kShared) {
        const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(d));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + col));
      } else {
        *d = src[col];
      }
    } else {
      *d = 0.f;
    }
  }
}

// Wait until the mbarrier at `mbar` has completed the phase of the given
// parity.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  }
}

// The ring's mbarriers, one a stage, each phase counting one arrival a
// gathered row (2 * Mt); thread 0 initialises them before a barrier.
__device__ __forceinline__ void init_ring(uint64_t* mbars, int mt) {
  if (threadIdx.x != 0) return;
  for (int st = 0; st < kStages; ++st)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(mbars + st)),
                 "r"(2 * mt)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Where a gathered row comes from: row tab_in[r] of x_in and tab_out[r] of
// x_out (row stride ld) for the group's row r; -1 reads as zeros.
struct Rows {
  const float* x_in;
  const float* x_out;
  int ld;
  const int* tab_in;
  const int* tab_out;
};

// Gather item t's [Mt, KC] chunks of X_in and X_out into `stage`.  Rows
// 16-byte aligned in shared memory (`bulk`): one bulk copy a row
// (cp.async.bulk, the copy engine's 1-D form: the issuing thread does not
// wait), completing on the stage's mbarrier, whose phase counts one arrival
// a row; otherwise cp.async (4 B at row stride D + 1) or plain copies into a
// global workspace.
template <bool kShared>
__device__ __forceinline__ void gather(float* stage, const Geo& g, const Rows& src, int t,
                                       bool vec, uint32_t mbar) {
  const int c0 = (t % g.nc) * g.KC;
  if (kShared && vec) {
    // a copy's issue waits for the copy engine to take it, so every warp
    // issues a few rows rather than four warps all of them
    const int n = 4 * min(g.KC, g.D - c0);  // bytes a live row brings
    const int per_warp = (2 * g.Mt + kWarps - 1) / kWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int i = lane; i < per_warp; i += 32) {
      const int rr = warp * per_warp + i;
      if (rr >= 2 * g.Mt) break;
      const int row = rr < g.Mt ? src.tab_in[rr] : src.tab_out[rr - g.Mt];
      const int bytes = row < 0 ? 0 : n;
      float* dst = stage + rr * g.ldx;
      for (int c = bytes / 4; c < g.KC; c += 4)  // dead rows; columns past D
        *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
                   "r"(bytes)
                   : "memory");
      if (bytes > 0) {
        const float* table = rr < g.Mt ? src.x_in : src.x_out;
        const float* from = table + static_cast<int64_t>(row) * src.ld + c0;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(dst)),
            "l"(from), "r"(bytes), "r"(mbar)
            : "memory");
      }
    }
    return;
  }
  const int per_row = vec ? g.KC / 4 : g.KC;  // copies a row
  const int piece = threadIdx.x % per_row;
  for (int rr = threadIdx.x / per_row; rr < 2 * g.Mt; rr += kThreads / per_row) {
    const int row = rr < g.Mt ? src.tab_in[rr] : src.tab_out[rr - g.Mt];
    const float* table = rr < g.Mt ? src.x_in : src.x_out;
    copy_piece<kShared>(stage + rr * g.ldx,
                        row < 0 ? nullptr : table + static_cast<int64_t>(row) * src.ld, c0, g.D,
                        piece, vec);
  }
}

// NO [Sp, ldn]: row s of emb_out is neg_rows[s] (-1 or s >= S: zeros); the
// block's d_no partial zeroed beside it.
template <bool kShared>
__device__ __forceinline__ void load_negatives(float* no, float* dno, const Geo& g,
                                               const float* emb_out, int ld,
                                               const int32_t* neg_rows, bool vec) {
  const int per_row = vec ? g.Dp / 4 : g.Dp;
  for (int i = threadIdx.x; i < g.Sp * per_row; i += kThreads) {
    const int s = i / per_row;
    const int row = s < g.S ? neg_rows[s] : -1;
    copy_piece<kShared>(no + s * g.ldn,
                        row < 0 ? nullptr : emb_out + static_cast<int64_t>(row) * ld, 0, g.D,
                        i % per_row, vec);
  }
  for (int i = threadIdx.x; i < g.Sp * g.ldn; i += kThreads) dno[i] = 0.f;
}

// ---- the products of a pass -------------------------------------------------

// Pass 1 of an item, over the chunk's KC columns: NL (+)= A . NO_c^T in
// 16 x 16 tiles and, where x_out is given, PL (+)= A . X_out^T in the 16 x 8
// tiles that meet the band |i - j| <= W (a warp takes one of each, most
// often).  A is [Mt, KC] at row stride lda, x_out a [Mt, ldx] chunk; chunk 0
// starts the sums.
__device__ __forceinline__ void pass1_products(const Geo& g, int chunk, const float* a, int lda,
                                               const float* no_c, float* nlg, const float* x_out,
                                               float* plb) {
  const int warp = threadIdx.x >> 5;
  const int mt16 = g.Mt / 16, sp16 = g.Sp / 16, W = g.W, Mt = g.Mt;
  const int n_nl = mt16 * sp16;
  // 8-column tiles a row tile's band meets, at most
  const int pl_slots = x_out == nullptr ? 0 : 2 + 2 * ((W + 7) / 8);
  for (int w = warp; w < n_nl + mt16 * pl_slots; w += kWarps) {
    int m0, n0, n_end, ldc, ldbb;
    float* C;
    const float* B;
    if (w < n_nl) {
      m0 = (w / sp16) * 16;
      n0 = (w % sp16) * 16;
      n_end = n0 + 16;
      C = nlg;
      ldc = g.ldg;
      B = no_c;
      ldbb = g.ldn;
    } else {
      const int j = w - n_nl;
      m0 = (j / pl_slots) * 16;
      const int j0 = max(0, m0 - W) / 8, j1 = min(Mt - 1, m0 + 15 + W) / 8;
      n0 = (j0 + j % pl_slots) * 8;
      if (n0 > 8 * j1) continue;
      n_end = n0 + 8;
      C = plb;
      ldc = g.ldb;
      B = x_out;
      ldbb = g.ldx;
    }
    float acc[2][4] = {};
    if (chunk > 0) load_acc(acc, C, ldc, m0, n0, n_end);
    mma_tile<2, false, false, false>(acc, a, lda, B, ldbb, m0, n0, n_end, 0, g.KC);
    store_acc(acc, C, ldc, m0, n0, n_end);
  }
}

// d_no partial's [16, 8NT] tile at (s0, n0) of the chunk += Gk^T . X over
// the group's rows [0, k_live): Gk [Mt, ldg] (Gneg, or a scaled copy), X
// [Mt, KC] at row stride ldx (4 mod 32).
template <int NT>
__device__ __forceinline__ void accumulate_dno(float* dno_c, const Geo& g, const float* gk,
                                               const float* x, int ldx, int s0, int n0,
                                               int k_live) {
  float acc[NT][4] = {};
  load_acc(acc, dno_c, g.ldn, s0, n0, g.KC);
  mma_tile<NT, true, true, true>(acc, gk, g.ldg, x, ldx, s0, n0, g.KC, 0, k_live);
  store_acc(acc, dno_c, g.ldn, s0, n0, g.KC);
}

// ---- the end of a block ---------------------------------------------------

// The block's d_no partial added to the global [S, D] d_no, one 16-byte
// atomic per 4 elements where D and d_no allow it; then the three loss
// partials summed over the block into loss_parts[3 * block ...].  Called by
// every thread after the last item's barrier.
__device__ __forceinline__ void flush_block(const float* dno, const Geo& g, float* d_no,
                                            float* red, float a0, float a1, float a2,
                                            float* loss_parts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = g.S, D = g.D;
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(d_no) % 16 == 0) {  // 16-byte atomics
    for (int i = 4 * tid; i < S * D; i += 4 * kThreads) {
      const float* p = dno + (i / D) * g.ldn + i % D;
      atomicAdd(reinterpret_cast<float4*>(d_no + i), make_float4(p[0], p[1], p[2], p[3]));
    }
  } else {
    for (int i = tid; i < S * D; i += kThreads) atomicAdd(d_no + i, dno[(i / D) * g.ldn + i % D]);
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) {
    red[warp] = a0;
    red[kWarps + warp] = a1;
    red[2 * kWarps + warp] = a2;
  }
  __syncthreads();
  if (tid < 3) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    loss_parts[3 * blockIdx.x + tid] = t;
  }
}

}  // namespace tiles
