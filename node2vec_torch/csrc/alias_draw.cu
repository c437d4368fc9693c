// K15 alias_draw: the batched first-order alias draw over CSR alias tables.
//
// Replaces node2vec_tpu/ops/alias.py:165 alias_draw.  For walker i, with
// its segment start s and degree deg, and the uniforms r1, r2 the caller
// draws (the JAX version splits its key for them):
//   slot = min(int(r1 * deg), deg - 1)          (an fp32 product, truncated)
//   j    = r2 < prob[s + slot] ? slot : alias[s + slot]
//   out  = indices[s + j]
// A degree-0 walker gets -1 (the JAX version returns an unspecified id
// there, which its callers mask).
//
// Bit-equal to the plain version and to JAX given the same uniforms: the
// product is __fmul_rn, so no contraction into an FMA or fast-math
// reciprocal changes it, and the float-to-int conversion truncates as
// astype(int32) does.
//
// Design: a thread a walker, three dependent gathers (prob and alias at the
// slot's edge, then the neighbour id).  Bound on an H100: memory -- 16 B of
// per-walker inputs and 4 B of output, plus the table entries the draws
// touch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
alias_draw_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ degree,
                  const float* __restrict__ r1, const float* __restrict__ r2,
                  const int32_t* __restrict__ alias, const float* __restrict__ prob,
                  const int32_t* __restrict__ indices, int64_t n,
                  int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int deg = degree[i];
  if (deg <= 0) {
    out[i] = -1;
    return;
  }
  const int64_t s = start[i];
  int slot = static_cast<int>(__fmul_rn(r1[i], __int2float_rn(deg)));
  slot = slot < deg - 1 ? slot : deg - 1;
  const int64_t e = s + slot;
  const int j = r2[i] < prob[e] ? slot : alias[e];
  out[i] = indices[s + j];
}

}  // namespace

extern "C" int n2v_alias_draw(const int32_t* start, const int32_t* degree, const float* r1,
                              const float* r2, const int32_t* alias, const float* prob,
                              const int32_t* indices, int64_t n, int32_t* out,
                              void* stream) {
  if (n == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  alias_draw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      start, degree, r1, r2, alias, prob, indices, n, out);
  return static_cast<int>(cudaGetLastError());
}
