"""The radix-2 split of the DCT-IV: float64 host builders and torch pieces.

The orthonormal DCT-IV of length N decomposes over the pairs
(f_n, f_{N-1-n}), n < M = N/2, of its input into a per-pair rotation by
phi_n = pi/(2N) (n + 1/2),

    r_n  = a_n cos(phi_n) + b_n sin(phi_n)
    t~_n = (-1)^n (b_n cos(phi_n) - a_n sin(phi_n)),     a_n = f_n, b_n = f_{N-1-n}

two shared [M, M] DCT-II-kernel products (the sqrt(2/N) scale folded in),

    U_j  = sum_n r_n  cos(pi j (n+1/2) / M)
    V2_j = sum_n t~_n cos(pi (M-1-j)(n+1/2) / M),

and a one-lane-shift butterfly, X_{2j} = U_j + V2_{j-1} and
X_{2j+1} = U_{j+1} - V2_j, with zero beyond the edges (exact: the dropped
boundary terms vanish, cos(pi (n+1/2)) = sin(0) = 0). That is N^2/2 MACs a
frame, half the mono design's [N, N] product. The synthesis runs the
transpose: butterfly, transposed products, transposed rotation.

The builders are the port's copies of ``audiocodec_tpu/ops/pallas_mdct.py``
``_radix_pieces``, ``radix_forward_params`` and ``radix_inverse_params``.
The rotation vectors and the [M, M] factors are defined on the pairs and
carry over as they are; the TPU kernels read the pairs from a swizzled lane
layout, the port from the mirrored address of the natural order, with the
MDCT's own fold weights (ops/folding.py). Both the spectrum and the
synthesis input are in standard order.

The torch pieces round as the JAX kernels do: the rotation and the
transposed butterfly in the input's dtype, one product and one sum at a
time; the products' outputs, the forward butterfly and the transposed
rotation in float32 (float64 for float64 factors).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _pieces(filters_n: int):
    """(phi, sign, base, flip) in float64: the rotation angles, (-1)^n and
    the two [M, M] cosine kernels."""
    m = filters_n // 2
    n_ = np.arange(m, dtype=np.float64)
    phi = np.pi / (2.0 * filters_n) * (n_ + 0.5)
    sgn = (-1.0) ** n_
    j_ = np.arange(m, dtype=np.float64)
    base = np.cos(np.pi / m * np.outer(n_ + 0.5, j_))
    flip = np.cos(np.pi / m * np.outer(n_ + 0.5, m - 1 - j_))
    return phi, sgn, base, flip


def forward_params(filters_n: int):
    """(rot [2, N], mats [2, M, M]) float64 of the analysis: rot = [rot1;
    rot2] with rot1 = [cos phi, cos phi (-1)^n], rot2 = [sin phi,
    -sin phi (-1)^n]; mats = [P; Q], scaled by sqrt(2/N) / sqrt(4N)."""
    phi, sgn, base, flip = _pieces(filters_n)
    rot1 = np.concatenate([np.cos(phi), np.cos(phi) * sgn])
    rot2 = np.concatenate([np.sin(phi), -np.sin(phi) * sgn])
    s = math.sqrt(2.0 / filters_n) / math.sqrt(4.0 * filters_n)
    return np.stack([rot1, rot2]), np.stack([base * s, flip * s])


def inverse_params(filters_n: int):
    """(rot [2, N], mats [2, M, M]) float64 of the synthesis: the
    transposed factors, rot = [rotA; rotB] with rotA = [cos phi, sin phi],
    rotB = [-sin phi (-1)^n, cos phi (-1)^n]; mats = [P^T; Q^T], scaled by
    sqrt(2/N) sqrt(4N)."""
    phi, sgn, base, flip = _pieces(filters_n)
    rot_a = np.concatenate([np.cos(phi), np.sin(phi)])
    rot_b = np.concatenate([-np.sin(phi) * sgn, np.cos(phi) * sgn])
    s = math.sqrt(2.0 / filters_n) * math.sqrt(4.0 * filters_n)
    mats = np.stack([base.T * s, flip.T * s])
    return np.stack([rot_a, rot_b]), np.ascontiguousarray(mats)


def rotate(folded: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Analysis rotation: [..., N] folded frames -> [r | t~], [..., N], in
    the input's dtype."""
    h = folded.shape[-1] // 2
    a = folded[..., :h]
    b = torch.flip(folded[..., h:], (-1,))
    r = a * rot[0, :h] + b * rot[1, :h]
    t = b * rot[0, h:] + a * rot[1, h:]
    return torch.cat([r, t], dim=-1)


def butterfly(u: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Analysis butterfly: U, V2 [..., M] -> X [..., 2M] in standard order,
    X_{2j} = U_j + V2_{j-1}, X_{2j+1} = U_{j+1} - V2_j."""
    even = u + F.pad(v2[..., :-1], (1, 0))
    odd = F.pad(u[..., 1:], (0, 1)) - v2
    return torch.stack([even, odd], dim=-1).flatten(-2)


def butterfly_t(y: torch.Tensor):
    """Synthesis butterfly (the transpose of :func:`butterfly`): y [..., N]
    in standard order -> (us, vs) [..., M] in y's dtype,
    us_j = y_{2j} + y_{2j-1}, vs_j = y_{2j+2} - y_{2j+1}."""
    ye, yo = y[..., 0::2], y[..., 1::2]
    us = ye + F.pad(yo[..., :-1], (1, 0))
    vs = F.pad(ye[..., 1:], (0, 1)) - yo
    return us, vs


def rotate_t(rs: torch.Tensor, ts: torch.Tensor,
             rot: torch.Tensor) -> torch.Tensor:
    """Synthesis rotation (the transpose of :func:`rotate`): the products
    rs, ts [..., M] -> z [..., N] in natural order, in rs's dtype:
    z_n = rs_n rotA_n + ts_n rotB_n and z_{N-1-n} = rs_n rotA_{M+n} +
    ts_n rotB_{M+n}."""
    h = rs.shape[-1]
    ra, rb = rot[0].to(rs.dtype), rot[1].to(rs.dtype)
    low = rs * ra[:h] + ts * rb[:h]
    high = rs * ra[h:] + ts * rb[h:]
    return torch.cat([low, torch.flip(high, (-1,))], dim=-1)
