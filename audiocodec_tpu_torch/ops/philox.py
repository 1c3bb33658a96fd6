"""Philox4x32-10 in torch integer arithmetic: the noise kernel's stream.

The counter-based generator of Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" (SC 2011), as Random123 defines it: multipliers
0xD2511F53 and 0xCD9E8D57, Weyl constants 0x9E3779B9 and 0xBB67AE85, 10
rounds. This module is the plain version of the generator inside
``csrc/noise_kernel.cu``, which it matches bit for bit.

The stream is defined by (seed, flat element index), and no random bit of
it is thrown away: element i = 4j + e belongs to the call with counter
(j mod 2^32, j div 2^32, 0, 0) under the key (seed mod 2^32, 0). Its words
(w0, w1) are the uniform pair (u1, u2) of elements 4j and 4j+1, which take
r cos(2 pi u2) and r sin(2 pi u2), r = sqrt(-2 ln u1); (w2, w3) give
elements 4j+2 and 4j+3 the same way. The stream does not depend on how a
launch is tiled. (The TPU kernel seeds its hardware generator by (seed,
grid position), a stream no other hardware reproduces.)

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


def _calls(seed: int, count: int, device):
    """The uniforms of the calls that cover elements 0..count-1, float32
    [calls, 2, 2]: call j, its pair 0 (w0, w1) or 1 (w2, w3), (u1, u2)."""
    index = torch.arange(-(-count // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(index)
    words = philox4x32((index & M32, index >> 32, zero, zero), (seed, 0))
    return uniform_open01(torch.stack(words, dim=-1)).reshape(-1, 2, 2)


def uniforms(seed: int, count: int, device="cpu"):
    """(u1, u2), float32 [count] each: the uniform pair of each of elements
    0..count-1 of the stream of ``seed`` (elements 2p and 2p+1 share pair
    p: the cosine's and the sine's)."""
    pairs = _calls(seed, count, device).reshape(-1, 2)
    pairs = pairs.repeat_interleave(2, dim=0)[:count]
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """The standard normals (r cos(2 pi u2), r sin(2 pi u2)), r = sqrt(-2 ln
    u1), in float32; both of one rounded angle fl(2 pi u2). u1 > 0, so the
    logarithm is finite."""
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = TWO_PI * u2
    return radius * torch.cos(angle), radius * torch.sin(angle)


def normal(seed: int, count: int, device="cpu") -> torch.Tensor:
    """float32 [count] standard normals of the stream of ``seed``: element
    4j + e is the cosine (e even) or the sine (e odd) of pair e // 2 of
    call j."""
    u = _calls(seed, count, device)
    return torch.stack(box_muller(u[..., 0], u[..., 1]),
                       dim=-1).reshape(-1)[:count]
