"""The masked-noise kernel: wrapper, plain version and launch count.

``add_masked_noise`` replaces the Pallas kernel of
``audiocodec_tpu/ops/pallas_noise.py``: spectrum + threshold * N(0, 1) *
sigma_scale in one pass. A wrapper given a CUDA tensor launches the
hand-written kernel of ``csrc/noise_kernel.cu`` or raises; given a CPU tensor
it runs the plain torch version beside it, which draws the same Philox
stream (ops/philox.py) and does the same float32 arithmetic.
"""

from __future__ import annotations

import torch

from audiocodec_tpu_torch.ops import philox as _philox

SIGMA_SCALE = 1.0 / 6.0  # sigma = threshold / 6: "3 sigma both directions"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def add_masked_noise_reference(spectrum, threshold, seed: int,
                               sigma_scale: float = SIGMA_SCALE):
    """Plain version of :func:`add_masked_noise`: float32 arithmetic (float64
    for a float64 spectrum) in the kernel's order, one rounding to the
    spectrum's dtype."""
    ct = torch.float64 if spectrum.dtype == torch.float64 else torch.float32
    z = _philox.normal(seed, spectrum.numel(), spectrum.device)
    noise = threshold.to(ct) * (sigma_scale * z.reshape(spectrum.shape))
    return (spectrum.to(ct) + noise).to(spectrum.dtype)


def _check(spectrum, threshold):
    if spectrum.device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {spectrum.device}")
    if spectrum.dtype not in _DTYPES:
        raise TypeError("noise kernel input must be float32 or bfloat16, got "
                        f"{spectrum.dtype}")
    if threshold.shape != spectrum.shape or threshold.dtype != spectrum.dtype:
        raise ValueError("threshold must have the spectrum's shape and dtype, "
                         f"got {tuple(threshold.shape)} {threshold.dtype}")
    for t in (spectrum, threshold):
        if t.device != spectrum.device or not t.is_contiguous():
            raise ValueError("noise kernel operands must be contiguous and on "
                             f"{spectrum.device}")
        if t.requires_grad:
            raise NotImplementedError(
                "the noise kernel has no backward; pass tensors that do not "
                "require grad"
            )


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def add_masked_noise(spectrum, threshold, seed: int,
                     sigma_scale: float = SIGMA_SCALE):
    """spectrum + threshold * (sigma_scale * z), z standard normal from the
    Philox stream of ``seed`` (taken mod 2^32) indexed by the flat element
    index (ops/philox.py: one call a four elements); out in the spectrum's
    dtype."""
    if spectrum.device.type == "cpu":
        return add_masked_noise_reference(spectrum, threshold, seed,
                                          sigma_scale)
    _check(spectrum, threshold)
    from audiocodec_tpu_torch.ops import _build

    out = torch.empty_like(spectrum)
    if out.numel() == 0:
        return out
    rc = _build.library().acx_add_masked_noise(
        spectrum.data_ptr(), threshold.data_ptr(), out.data_ptr(),
        spectrum.numel(), seed & _philox.M32, _DTYPES[spectrum.dtype],
        float(sigma_scale), _stream(spectrum),
    )
    if rc:
        raise RuntimeError(f"noise kernel launch failed: CUDA error {rc}")
    add_masked_noise.launches += 1
    return out


def uniforms(seed: int, count: int, device="cuda"):
    """(u1, u2), float32 [count]: the kernel's uniform pair of each of
    elements 0..count-1 (elements 2p and 2p+1 share pair p) on a CUDA
    device (a launch of the same generator, not counted), ops/philox.py's
    on the CPU. The card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return _philox.uniforms(seed, count)
    if device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {device}")
    from audiocodec_tpu_torch.ops import _build

    u1 = torch.empty(count, dtype=torch.float32, device=device)
    u2 = torch.empty_like(u1)
    rc = _build.library().acx_philox_uniforms(
        u1.data_ptr(), u2.data_ptr(), count, seed & _philox.M32, _stream(u1),
    )
    if rc:
        raise RuntimeError(f"uniforms kernel launch failed: CUDA error {rc}")
    return u1, u2


def reset_launch_counts() -> None:
    add_masked_noise.launches = 0


def launch_counts() -> dict:
    return {"add_masked_noise": add_masked_noise.launches}


reset_launch_counts()
