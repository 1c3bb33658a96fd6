"""Threefry-2x32 in torch integer arithmetic: the parts of ``jax.random``
that the noise fill (``nf.fill``) and the stream decoder's concealment
(``io/stream_container``: ``rademacher``) draw from.

The JAX package draws its noise-fill uniforms with ``jax.random.uniform``
under keys ``fold_in(fold_in(key(seed), batch), frame)``, and a decoder must
reproduce that noise bit for bit from the container's seed. This module
follows ``jax._src.prng`` (JAX 0.9, ``jax_threefry_partitionable=True``, the
default):

* ``key(seed)`` of a uint32 seed is the word pair (0, seed);
* ``fold_in(key, d)`` is the hash of the counter pair (0, d) under ``key``:
  the new key is the hash's two output words;
* the bits of an array of ``shape`` hash the counters
  ``iota_2x32_shape(shape)``: the row-major flat index i as (i >> 32,
  i mod 2^32); 32-bit bits are ``bits1 ^ bits2``, 8-bit bits the low byte
  of that word, 64-bit bits ``bits1 << 32 | bits2``;
* ``uniform(key, shape, dtype, lo, hi)`` draws bits of the dtype's width,
  except that a dtype with fewer than 8 mantissa bits (bfloat16) draws 8;
  keeps the top ``nmant`` bits of them as the mantissa of a float in
  [1, 2), subtracts 1, scales to [lo, hi) and clamps to lo;
* ``rademacher(key, shape)`` is ``uniform(key, shape, float) < 0.5`` as
  +1/-1, with the float of JAX's default dtype: float32 with x64 off,
  float64 with x64 on, which give other signs.

Threefry-2x32 is the 20-round hash of Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3" (SC 2011), with JAX's rotations and key
schedule. A word is a uint32 held as the int32 of the same bits: sums wrap
modulo 2^32 as uint32 sums do, and the logical right shift of a rotation is
written out (an int32 ``>>`` is arithmetic). Keys are tensors of any shape,
broadcast against the counters, so one call draws the noise of every
(batch, frame) at once.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (nbits, nmant) of the float dtypes uniform draws, as jnp.finfo has them
_FLOAT_BITS = {
    torch.float32: (32, 23),
    torch.bfloat16: (16, 7),
    torch.float64: (64, 52),
}
_ONE_BITS = {torch.float32: 0x3F800000, torch.bfloat16: 0x3F80,
             torch.float64: 0x3FF0000000000000}
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float64: torch.int64}


def word(value):
    """uint32 values (an int, or an integer tensor; taken modulo 2^32) as
    words: the int32 of the same bits."""
    if isinstance(value, torch.Tensor):
        return (((value.to(torch.int64) & M32) ^ 0x80000000)
                - 0x80000000).to(torch.int32)
    return ((value & M32) ^ 0x80000000) - 0x80000000


def unsigned(w: torch.Tensor) -> torch.Tensor:
    """Words -> their uint32 values, in int64."""
    return w.to(torch.int64) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def hash2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` = (k0, k1),
    words all (Python ints or int32 tensors), broadcast together.

    :return: the two output words.
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ word(_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + (group + 1)
    return x0, x1


def key(seed):
    """``jax.random.key(seed)`` of a uint32 seed (an int, or an integer
    tensor of seeds; taken modulo 2^32): the key words (0, seed)."""
    w = word(seed)
    return w * 0, w


def fold_in(k, data: torch.Tensor):
    """``jax.random.fold_in(k, data)`` of uint32 ``data`` (an integer
    tensor), for keys and data of any shapes that broadcast."""
    d = word(data)
    return hash2x32(k, torch.zeros_like(d), d)


def _words(k, shape):
    """The hash words (bits1, bits2) of the counters of ``shape`` under
    every key of ``k`` (key words of shape K, a tensor at least one of
    them): each [*K, prod(shape)], on the keys' device."""
    k0, k1 = torch.broadcast_tensors(
        *(torch.as_tensor(w, dtype=torch.int32) for w in k))
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k1.device)
    return hash2x32((k0.unsqueeze(-1), k1.unsqueeze(-1)), word(idx >> 32),
                    word(idx))


def bits(k, shape, width: int) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16 or 32) for every key of ``k``
    (key words of shape K, a tensor at least one of them): [*K, *shape],
    on the keys' device; 32-bit bits as words, narrower ones as values."""
    b0, b1 = _words(k, shape)
    out = b0 ^ b1
    if width < 32:
        out = out & ((1 << width) - 1)
    return out.reshape(*out.shape[:-1], *shape)


def uniform(k, shape, dtype: torch.dtype, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype, minval, maxval)`` for every key
    of ``k`` (key words of shape K) at once: [*K, *shape] of ``dtype``
    (float32, bfloat16 or float64), on the keys' device."""
    nbits, nmant = _FLOAT_BITS[dtype]
    if nbits == 64:
        # the top 52 bits of the 64-bit bits (bits1 << 32 | bits2)
        b0, b1 = _words(k, shape)
        mant = (unsigned(b0) << 20) | (unsigned(b1) >> 12)
        mant = mant.reshape(*mant.shape[:-1], *shape)
    else:
        rng_bits = 8 if nmant < 8 else nbits
        # a logical shift: the arithmetic one, its sign bits masked off
        mant = ((bits(k, shape, rng_bits) >> (rng_bits - nmant))
                & ((1 << nmant) - 1))
    floats = (mant | _ONE_BITS[dtype]).to(_INT_VIEW[dtype]).view(dtype)
    # the bounds rounded to the dtype, as jax.random converts them
    lo = float(torch.tensor(minval, dtype=dtype))
    span = float(torch.tensor(maxval, dtype=dtype) - lo)
    return torch.clamp_min((floats - 1.0) * span + lo, lo)


def rademacher(k, shape, dtype: torch.dtype, x64: bool = False) -> torch.Tensor:
    """``jax.random.rademacher(k, shape, dtype)``: +1 or -1 of ``dtype`` for
    every key of ``k`` (key words of shape K), [*K, *shape].

    JAX draws it as ``uniform(k, shape, float) < 0.5`` with the float of its
    default dtype, which the process's x64 flag sets: float32 draws (x64
    off, the default) and float64 draws (``x64=True``) give other signs."""
    u = uniform(k, shape, torch.float64 if x64 else torch.float32)
    return torch.where(u < 0.5, 1, -1).to(dtype)
