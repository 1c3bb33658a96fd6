"""Device helpers shared by serving and the corpus path: the current CUDA
device around a thread's device work, and the int16 PCM wire's
dequantization."""

from __future__ import annotations

import contextlib

import torch


def on_device(device):
    """A context that makes ``device`` the current CUDA device (the kernels'
    launches go to the current device), or nothing for another device: the
    corpus and serving threads never rely on a thread's current device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def dequant_wire(b: torch.Tensor, dtype) -> torch.Tensor:
    """int16 wire -> compute-dtype amplitudes, where ``b`` lives:
    int16/32768 is exact in float32, so the wire is bit-exact for PCM16
    sources."""
    return (b.to(torch.float32) * (1.0 / 32768.0)).to(dtype)
