"""Dtype policy of the PyTorch port.

Host precomputes are numpy float64 and are downcast to the compute dtype
exactly once, when a module is built. Inputs must already be in the compute
dtype: nothing is cast implicitly. float16 is rejected: its 5-bit exponent
cannot represent the 1e-14 intensity floor of the psychoacoustic model
(bfloat16's 8-bit exponent can).
"""

from __future__ import annotations

import functools

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


def sidecar_work_dtype(spec: torch.Tensor) -> torch.dtype:
    """Work dtype of the sidecar-steering math (the nf, bwe and intensity
    analyses and fills): float32, which only picks a uint8 wire value,
    except that a float64 pipeline stays float64. One definition, so that
    the three modules' encoder-side gains agree."""
    return torch.float64 if spec.dtype == torch.float64 else torch.float32


def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: multiplying a
    tensor by it rounds as the JAX package's ``jnp.asarray(value, dtype)``
    does (torch would hold a Python scalar in float32 for a bfloat16
    tensor)."""
    return float(torch.tensor(value, dtype=dtype))


@functools.lru_cache(maxsize=None)
def divisor(value: float, dtype, device) -> torch.Tensor:
    """A 0-d divisor on ``device``, made once: CUDA divides by a host
    scalar through its reciprocal, which rounds twice, and by a device
    tensor truly."""
    return torch.tensor(value, dtype=dtype, device=device)
