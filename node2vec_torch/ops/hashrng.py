"""Counter-based per-walker uniforms (port of ``node2vec_tpu/ops/hashrng.py``).

Every walk draw is a pure function of ``(seed, global walker id, counter)``:
two rounds of the murmur3 finalizer (fmix32) over a Weyl-sequence mix of
the inputs, so walk content is invariant to chunking and padding.

torch has no uint32 arithmetic that wraps the way the JAX version does, and
its int32 ``>>`` is arithmetic, so the values live in int64 tensors masked
to 32 bits after every step.  Multiplications are split into 16-bit halves
so that no intermediate leaves int64.  The results are bit-equal to the JAX
package's.  The kernels use the same hash in ``csrc/hashrng.cuh``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_W1 = 0x7FEB352D


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def _as_u32(v, device) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(int(v), dtype=torch.int64, device=device)
    return v.to(torch.int64) & MASK32


def hash_bits(seed, gid: torch.Tensor, ctr) -> torch.Tensor:
    """uint32 random bits (as int64) for (seed, walker gid, draw counter)."""
    g = _as_u32(gid, gid.device)
    c = _as_u32(ctr, gid.device)
    s = _as_u32(seed, gid.device)
    h = fmix32((_mul32(c, _GOLD) + s) & MASK32)
    return fmix32(_mul32(g, _W1) ^ h)


def hash_uniform(seed, gid: torch.Tensor, ctr) -> torch.Tensor:
    """float32 uniforms in [0, 1) on the 2^-24 grid."""
    bits = hash_bits(seed, gid, ctr)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)
