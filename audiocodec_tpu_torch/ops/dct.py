"""Orthonormal DCT-IV as a matmul, with the port's precision tiers.

DCT-IV:  y_k = sqrt(2/N) * sum_n x_n cos(pi/N (n+1/2)(k+1/2))

The tiers are defined by their error, not by how a TPU reaches it:

* ``highest`` and ``high``: float32 products and sums. On the card TF32 is
  switched off (``torch.backends.cuda.matmul.allow_tf32 = False``) before
  every float32 matmul of this module, since TF32 keeps only ~3 digits.
  ``high`` takes the same float32 path; it meets the tier's ~7e-7 bound.
* ``default``: operands rounded to bfloat16, products and sums in float32.
* ``int8``: the :func:`int8_rowquant` recipe, int8 x int8 products, exact
  int32 sums, one float32 rescale.

A float64 pipeline runs every float tier in float64 (as the JAX package's
float64 matmuls do on the CPU). bfloat16 inputs are upcast to the matrix
dtype around the matmul unless ``fast_bf16`` is set, which runs the
``default`` tier on them.
"""

from __future__ import annotations

import numpy as np
import torch


def dct4_matrix(filters_n: int) -> np.ndarray:
    """The [N, N] orthonormal DCT-IV matrix in float64 (host precompute)."""
    n = np.arange(filters_n, dtype=np.float64) + 0.5
    return np.sqrt(2.0 / filters_n) * np.cos(
        np.pi / filters_n * np.outer(n, n)
    )


PRECISIONS = ("highest", "high", "default")
MDCT_PRECISIONS = frozenset(PRECISIONS) | {"int8"}


def to_bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and held in float32: an operand of the
    ``default`` tier (the product of two such values is exact in float32)."""
    return t.to(torch.bfloat16).to(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a [..., K] @ b [K, M] at a float tier; float32 out (float64 when
    either operand is float64).

    The leading axes are flattened into one GEMM: a strided ``a`` (the Bark
    contractions' transposed view) would otherwise go to a batched
    matrix-vector product, which on an H100 took 4.1 ms for what one GEMM
    does in microseconds."""
    lead = a.shape[:-1]
    a = a.reshape(-1, a.shape[-1])
    if a.dtype == torch.float64 or b.dtype == torch.float64:
        out = a.to(torch.float64) @ b.to(torch.float64)
    else:
        if a.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        if precision == "default":
            out = to_bf16_operand(a) @ to_bf16_operand(b)
        else:
            out = a.to(torch.float32) @ b.to(torch.float32)
    return out.reshape(*lead, b.shape[-1])


def _127_over(s: torch.Tensor) -> torch.Tensor:
    # a true division: ``127.0 / s`` would be reciprocal-then-multiply in
    # torch, which rounds twice. The 0-d dividend stays on the host, which a
    # CUDA kernel takes as an argument (no copy to the device).
    return torch.div(torch.tensor(127.0), s)


def int8_rowquant(u: torch.Tensor):
    """Symmetric per-row (last-axis) dynamic int8 quantization.

    scale = max|row| + 1e-12, codes = clip(round(u * (127 / scale)), ±127)
    with round-half-to-even. Returns (int8 codes, float32 scale with the
    last axis kept)."""
    uf = u.to(torch.float32)
    s = torch.amax(torch.abs(uf), dim=-1, keepdim=True) + 1e-12
    q = torch.clamp(torch.round(uf * _127_over(s)), -127.0, 127.0)
    return q.to(torch.int8), s


def int_matmul(q: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 x int8 products, q [..., K] @ qm [K, M].

    Computed as a float64 matmul, which is exact while |sum| < 2^53
    (127^2 * K is far below it), because torch has no int32 matmul on the
    card."""
    return (q.to(torch.float64) @ qm.to(torch.float64)).to(torch.int32)


def _int8_matmul(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ mat [K, M] at the int8 tier, float32 out: the signal is
    quantized per row, the matrix against one global scale."""
    q, s_r = int8_rowquant(x)
    mf = mat.to(torch.float32)
    s_m = torch.amax(torch.abs(mf)) + 1e-12
    qm = torch.clamp(torch.round(mf * _127_over(s_m)), -127.0, 127.0)
    y32 = int_matmul(q, qm.to(torch.int8))
    inv = torch.tensor(1.0 / (127.0 * 127.0), dtype=torch.float32)
    return y32.to(torch.float32) * (s_r * (s_m * inv))


def dct4(
    x: torch.Tensor,
    dct_mat: torch.Tensor,
    *,
    fast_bf16: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """Apply DCT-IV along the last axis: x [..., N] @ dct_mat [N, N], in
    x's dtype."""
    if precision == "int8":
        return _int8_matmul(x, dct_mat).to(x.dtype)
    if x.dtype == torch.bfloat16:
        if fast_bf16:
            return matmul(x, dct_mat, "default").to(torch.bfloat16)
        return matmul(x.to(dct_mat.dtype), dct_mat, precision).to(
            torch.bfloat16
        )
    return matmul(x, dct_mat, precision).to(x.dtype)
