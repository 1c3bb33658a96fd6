"""Dtype policy of the PyTorch port.

Host precomputes are numpy float64 and are downcast to the compute dtype
exactly once, when a module is built. Inputs must already be in the compute
dtype: nothing is cast implicitly. float16 is rejected: its 5-bit exponent
cannot represent the 1e-14 intensity floor of the psychoacoustic model
(bfloat16's 8-bit exponent can).
"""

from __future__ import annotations

import torch

ALLOWED_COMPUTE_DTYPES = (torch.float64, torch.float32, torch.bfloat16)

_BY_NAME = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def canonicalize_compute_dtype(compute_dtype) -> torch.dtype:
    """Validate a compute dtype given as a ``torch.dtype`` or its name.

    :raises TypeError: unless it is float64, float32 or bfloat16.
    """
    dtype = _BY_NAME.get(str(compute_dtype).removeprefix("torch."))
    if dtype not in ALLOWED_COMPUTE_DTYPES:
        raise TypeError(
            "compute_dtype must be float64, float32 or bfloat16, got "
            f"{compute_dtype}. (float16 lacks the exponent range for the "
            "intensity floor of 1e-14 used by the psychoacoustic model.)"
        )
    return dtype


def check_input_dtype(x: torch.Tensor, compute_dtype, what: str = "input"):
    """Raise unless ``x`` already has the compute dtype."""
    if x.dtype != compute_dtype:
        raise TypeError(
            f"{what} must be of compute_dtype {compute_dtype}, got "
            f"{x.dtype}; this framework never casts implicitly."
        )


def scalar(value: float, dtype, device=None) -> torch.Tensor:
    """A 0-d constant rounded to ``dtype``, so that arithmetic with it
    rounds as the JAX package's numpy constants do."""
    return torch.tensor(value, dtype=dtype, device=device)
