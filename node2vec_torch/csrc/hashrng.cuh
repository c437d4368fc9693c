// Counter-based per-walker uniforms, the device twin of ops/hashrng.py
// (and of the JAX package's node2vec_tpu/ops/hashrng.py): two murmur3 fmix32
// rounds over a Weyl mix of (seed, global walker id, counter).  uint32
// arithmetic wraps natively here, so the bits equal the host versions'.
#pragma once

#include <cstdint>

namespace n2v {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t gid,
                                              uint32_t ctr) {
  const uint32_t h = fmix32(ctr * 0x9E3779B9u + seed);
  return fmix32((gid * 0x7FEB352Du) ^ h);
}

// float32 uniform in [0, 1) on the 2^-24 grid (exact: 24-bit integer * 2^-24)
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t gid,
                                              uint32_t ctr) {
  return __fmul_rn(static_cast<float>(hash_bits(seed, gid, ctr) >> 8),
                   5.9604644775390625e-08f);
}

}  // namespace n2v
