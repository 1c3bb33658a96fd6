"""MDCT window builders (host-side, numpy float64).

A copy of audiocodec_tpu/ops/windows.py: the port must not import the
JAX package, and the tests hold the two copies to exact equality.

The analysis/synthesis filter bank uses a length-2N window w satisfying

  1. w_n = w_{2N-1-n}          (symmetry)
  2. w_n^2 + w_{n+N}^2 = 1     (Princen-Bradley)

Only the first 3N/2 coefficients are generated explicitly; the last quarter
is implied by a consistency (completion) rule so that perfect reconstruction
holds for *any* generated prefix — including the all-ones window.
(Behavioral parity with reference audiocodec/mdctransformer.py:192-229.)

Supported window types: 'sine', 'vorbis' (default), and None / any other
string for the unmodified all-ones window. Unlike the reference — whose
docstring advertises None but crashes on it (mdctransformer.py:21 vs :199) —
None is handled properly here.
"""

from __future__ import annotations

import numpy as np


def window_coefficients(filters_n: int, window_type) -> np.ndarray:
    """First 3N/2 window coefficients in float64.

    :param filters_n: number of filter bands N (must be even).
    :param window_type: 'sine', 'vorbis', or None (all-ones / rectangular).
        Any other string also selects the all-ones window, matching the
        reference's else-branch (audiocodec/mdctransformer.py:209-211).
    :return: float64 array of shape [3N/2].
    """
    if filters_n % 2 != 0:
        raise ValueError(
            f"filters_n must be even, got {filters_n}"
        )
    n = np.arange(0.5, (3 * filters_n) // 2 + 0.5, dtype=np.float64)
    name = window_type.lower() if isinstance(window_type, str) else window_type
    if name == "sine":
        return np.sin(np.pi / (2.0 * filters_n) * n)
    if name == "vorbis":
        return np.sin(
            np.pi / 2.0 * np.sin(np.pi / (2.0 * filters_n) * n) ** 2
        )
    # Unmodified (all-ones) window; poorer stop-band attenuation but still
    # perfectly reconstructing thanks to the completion rule below.
    return np.ones(filters_n + filters_n // 2, dtype=np.float64)


def window_completion(w: np.ndarray, filters_n: int) -> np.ndarray:
    """The implied last-quarter coefficients ff (length N/2, reversed order).

    ff[j] = (1 - w[N + i] * w[N-1-i]) / w[i]  evaluated at i = N/2-1-j.

    These complete the diamond folding matrix so that analysis∘synthesis is
    the identity regardless of whether the generated prefix satisfies
    Princen-Bradley exactly (reference audiocodec/mdctransformer.py:217-226).
    """
    half = filters_n // 2
    i = np.arange(half)
    e = (1.0 - w[filters_n + i] * w[filters_n - 1 - i]) / w[i]
    return e[::-1].copy()
