"""The run-length Rice coder of a stream chunk's codes: wrapper, plain
version and launch count.

``rrice_encode`` codes int32 codes into the bytes of
``native.rrice_encode`` (the ``.acs`` chunk's codes member), byte for byte.
A wrapper given a CUDA tensor launches the hand-written kernel of
``csrc/rice_kernel.cu`` (one launch a call) or raises; given a CPU tensor it
runs the plain version beside it, the host coder. The kernel replaces no TPU
kernel: the JAX package codes on the host.
"""

from __future__ import annotations

import torch

from audiocodec_tpu_torch import native

GROUP = native.RICE_GROUP  # the kernel's group: 8 values a lane of a warp


def bound(n: int) -> int:
    """The most bytes the coding of ``n`` values takes: ``entropy.cpp``'s
    ``acx_rrice_bound(n, 256)``; a stream longer than this is an error
    there and here."""
    groups = -(-n // GROUP)
    rice = (groups * 4 + n * (48 + 1 + 32)) // 8 + 16
    return rice + groups // 8 + 16


def rrice_encode_reference(codes):
    """Plain version of :func:`rrice_encode`: ``native.rrice_encode`` of the
    codes on the host -> (bytes uint8, their count int64 [1]), both on the
    codes' device."""
    data = native.rrice_encode(codes.cpu().numpy())
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else (
        torch.empty(0, dtype=torch.uint8))
    return (buf.to(codes.device),
            torch.tensor([len(data)], dtype=torch.int64, device=codes.device))


def _check(codes):
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {codes.device}")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise ValueError("the Rice kernel takes contiguous int32 codes, got "
                         f"{codes.dtype}, strides {codes.stride()}")


def rrice_encode(codes):
    """The run-length Rice coding of ``codes`` (int32, any shape, flattened
    row-major), queued on the current stream without waiting for it.

    :return: (a new buffer, whose first ``nbytes`` bytes are the coding;
        ``nbytes``, int64 [1]), both on the codes' device. ``nbytes`` reads
        -1 if the coding would exceed :func:`bound` (the host coder raises
        there).
    """
    if codes.device.type == "cpu":
        return rrice_encode_reference(codes)
    _check(codes)
    from audiocodec_tpu_torch.ops import _build

    n = codes.numel()
    # the kernel writes whole 4-byte words; it zeroes the words it ORs into
    out = torch.empty(-(-bound(n) // 4) * 4, dtype=torch.uint8,
                      device=codes.device)
    groups = -(-n // GROUP)
    # the groups' scratch, then the byte count
    aux = torch.empty(groups + 1, dtype=torch.int64, device=codes.device)
    rc = _build.library().acx_rrice_encode_cuda(
        codes.data_ptr(), n, out.data_ptr(), bound(n), aux.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    if rc:
        raise RuntimeError(f"Rice kernel launch failed: CUDA error {rc}")
    rrice_encode.launches += 1
    return out, aux[groups:]


def reset_launch_counts() -> None:
    rrice_encode.launches = 0


def launch_counts() -> dict:
    return {"rrice_encode": rrice_encode.launches}


reset_launch_counts()
