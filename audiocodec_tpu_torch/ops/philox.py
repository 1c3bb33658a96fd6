"""Philox4x32-10 in torch integer arithmetic: the noise kernel's stream.

The counter-based generator of Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" (SC 2011), as Random123 defines it: multipliers
0xD2511F53 and 0xCD9E8D57, Weyl constants 0x9E3779B9 and 0xBB67AE85, 10
rounds. This module is the plain version of the generator inside
``csrc/noise_kernel.cu``, which it matches bit for bit.

The stream is defined by (seed, flat element index): element i takes the
counter (i mod 2^32, i div 2^32, 0, 0) and the key (seed mod 2^32, 0), and
draws u1 from word 0 and u2 from word 1. It does not depend on how a launch
is tiled. (The TPU kernel seeds its hardware generator by (seed, grid
position), a stream no other hardware reproduces.)

Words are uint32 values held in int64 tensors. A 32 x 32 -> 64-bit product
would overflow int64, so :func:`_mulhilo` splits the constant into 16-bit
halves; every intermediate stays below 2^50.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
TWO_PI = 2.0 * math.pi


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of the 64-bit product a * b, for a uint32
    constant ``a`` and uint32 values ``b`` in int64."""
    p_lo = b * (a & 0xFFFF)  # < 2^48
    p_hi = b * (a >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (t >> 32), t & M32


def philox4x32(counter, key):
    """Philox4x32-10 of four counter words (int64 tensors of uint32
    values, broadcastable) under two key words (Python ints). Returns the
    four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & M32, key[1] & M32
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & M32
        k1 = (k1 + PHILOX_W1) & M32
    return c0, c1, c2, c3


def uniform_open01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms in (0, 1]: the top 23 bits as the
    mantissa of a float in [1, 2), subtracted from 2 (the TPU kernel's map,
    ``audiocodec_tpu/ops/pallas_noise.py::_uniform_open01``)."""
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return 2.0 - one_to_two


def uniforms(seed: int, count: int, device="cpu"):
    """(u1, u2), float32 [count] each: the uniforms of elements 0..count-1
    of the stream of ``seed``."""
    index = torch.arange(count, dtype=torch.int64, device=device)
    zero = torch.zeros_like(index)
    w0, w1, _, _ = philox4x32((index & M32, index >> 32, zero, zero),
                              (seed, 0))
    return uniform_open01(w0), uniform_open01(w1)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals sqrt(-2 ln u1) * cos(2 pi u2), in float32. u1 > 0,
    so the logarithm is finite."""
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def normal(seed: int, count: int, device="cpu") -> torch.Tensor:
    """float32 [count] standard normals of the stream of ``seed``."""
    return box_muller(*uniforms(seed, count, device))
