"""Sidecar quantization in PyTorch (counterpart of ``audiocodec_tpu/scq.py``):
the Bark sidecar on a coarse log grid.

Values snap to ``2^(level / K2)`` with K2 integer levels per octave of
intensity (K2=4: 0.75 dB steps), and the wire carries the levels. Encoder
and decoder must derive bit-identical bfloat16 sidecar values, so both map
a level to its value through one table (:func:`table`), computed on the
host in float64 and rounded to bfloat16 as the JAX package's table is; the
encoder gathers from it and never re-evaluates exp2 on the device.

The levels' byte coding (``encode_levels``/``decode_levels``) is the
container's 2-D delta + run-length Rice coder, ``io/bitstream.encode_int2d``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Allowed levels per octave of intensity (one octave ~ 3.01 dB): 4 -> 0.75
# dB (the default), 2 -> 1.5 dB (the AAC scalefactor grid), 1 -> 3 dB. 0 in
# a codec means raw bfloat16 sidecars.
ALLOWED_K2 = (1, 2, 4, 8)
DEFAULT_K2 = 4

# Level bounds in octaves of intensity, shared by every K2: the
# psychoacoustic floor 1e-14 is 2^-46.5, normalized intensities top out
# near 1. Values outside clip to the edge.
_OCT_MIN, _OCT_MAX = -52, 12


def validate_k2(k2: int) -> None:
    if k2 not in ALLOWED_K2:
        raise ValueError(
            f"sidecar grid {k2!r} not supported; expected one of "
            f"{ALLOWED_K2} (levels per octave) or 0 for legacy bfloat16"
        )


def level_bounds(k2: int) -> tuple[int, int]:
    return _OCT_MIN * k2, _OCT_MAX * k2


@functools.lru_cache(maxsize=None)
def _table(k2: int, device: torch.device) -> torch.Tensor:
    validate_k2(k2)
    lo, hi = level_bounds(k2)
    vals = 2.0 ** (np.arange(lo, hi + 1, dtype=np.float64) / k2)
    return torch.from_numpy(vals).to(torch.bfloat16).to(device)


def table(k2: int, device="cuda") -> torch.Tensor:
    """bfloat16 grid values of every legal level, lowest first: the one
    artifact both sides map levels through. Built once per (k2, device)."""
    return _table(k2, torch.device(device))


def _floor(lo: int) -> float:
    """2^lo as the JAX package's float32 ``2.0 ** lo`` gives it: 0 where
    2^-lo overflows float32 (every K2 above 2)."""
    return 2.0 ** lo if -lo < 128 else 0.0


def snap(bark: torch.Tensor, k2: int) -> torch.Tensor:
    """Device-side: intensities -> the nearest grid value, as bfloat16.

    The level math runs in float32 whatever the pipeline's dtype (a bf16
    log2 would move borderline levels; the result only picks a table
    entry)."""
    validate_k2(k2)
    lo, hi = level_bounds(k2)
    b = torch.clamp_min(bark.to(torch.float32), _floor(lo))
    lvl = torch.clamp(torch.round(k2 * torch.log2(b)), lo, hi)
    return table(k2, bark.device)[lvl.to(torch.int64) - lo]


def levels_from_bark16(bark16: torch.Tensor, k2: int) -> np.ndarray:
    """Host-side exact inverse of the table gather, for packing: the levels
    (int32) of a sidecar that holds only table values.

    :raises ValueError: unless ``bark16`` is bfloat16 and every value lies
        on the grid.
    """
    if bark16.dtype != torch.bfloat16:
        raise ValueError(f"sidecar must be bfloat16, got {bark16.dtype}")
    t = table(k2, "cpu").to(torch.float32).numpy()
    lo, _ = level_bounds(k2)
    vals = bark16.detach().cpu().to(torch.float32).numpy()
    idx = np.clip(np.searchsorted(t, vals), 0, len(t) - 1)
    # searchsorted gives the left insertion point: take the exact one of
    # it and its lower neighbour
    down = np.clip(idx - 1, 0, len(t) - 1)
    exact_here = t[idx] == vals
    exact_down = t[down] == vals
    if not np.logical_or(exact_here, exact_down).all():
        raise ValueError(
            "sidecar values are not on the declared grid — the array "
            "was not produced by a grid-snapping encoder (scq mismatch)"
        )
    return np.where(exact_here, idx, down).astype(np.int32) + lo


def bark16_from_levels(levels, k2: int, shape, device="cuda") -> torch.Tensor:
    """Decoder-side reconstruction: wire levels -> bfloat16 sidecar of
    ``shape`` on ``device``.

    :raises ValueError: if a level lies outside the grid's range.
    """
    lo, hi = level_bounds(k2)
    lv = np.asarray(levels, dtype=np.int64).reshape(shape)
    if lv.min() < lo or lv.max() > hi:
        raise ValueError(
            f"sidecar levels outside the grid's [{lo}, {hi}] range — "
            "corrupt container"
        )
    return table(k2, device)[torch.from_numpy(lv - lo).to(device)]


def encode_levels(levels: np.ndarray, block_axis: int) -> bytes:
    """Grid levels -> bytes through THE shared 2-D MED-delta + run-length-
    Rice integer coder (``io/bitstream.encode_int2d``, the same coding the
    bfloat16 sidecar's "rrice2d" mode uses)."""
    from audiocodec_tpu_torch.io import bitstream

    return bitstream.encode_int2d(levels, block_axis)


def decode_levels(data: bytes, shape, block_axis: int) -> np.ndarray:
    """Inverse of :func:`encode_levels` -> int32 levels of ``shape``."""
    from audiocodec_tpu_torch.io import bitstream

    return bitstream.decode_int2d(data, shape, block_axis)
