"""The int8 probe's kernels: wrappers, plain versions and launch counts.

``probe_bf16``, ``probe_int8`` and ``probe_int8_grouped`` replace the three
bodies of the Pallas kernel of ``benchmarks/pallas_int8_probe.py``
(``make_call`` with ``bf16_kernel``, ``int8_kernel`` and
``int8_grouped_kernel``): x [rows, 1024] float32 @ the [1024, 1024] DCT-IV
matrix in bfloat16 or as int8 codes -> float32 [rows, 1024]. A wrapper given a
CUDA tensor launches the hand-written kernel of ``csrc/probe_kernels.cu`` or
raises; given a CPU tensor it runs the plain torch version beside it, which
has the kernel's exact numerics at the int8 tiers (the integer sums are a
float64 matmul) and float32 sums of bf16 operands at ``bf16``.

The kernels read the matrix in its operand form (:func:`operand`: [N, K], K
contiguous) through a TMA map; the plain versions take and ignore it. A CTA
of a kernel holds ``TILE_ROWS`` rows of x (their share of K when ``KSPLIT``
CTAs split it) as a 128 KB shared A tile and streams the operand through a
ring of ``STAGES`` stages of ``TILE_COLUMNS`` operand rows
(:func:`shared_bytes`).
"""

from __future__ import annotations

import numpy as np
import torch

from audiocodec_tpu_torch.ops import cuda_mdct as _cuda_mdct
from audiocodec_tpu_torch.ops import dct as _dct

N = 1024  # K and N of the probe (csrc/probe_kernels.cu PK)
# The kernels' geometry (csrc/probe_kernels.cu BM, IC, Cfg<..>): rows of x
# a CTA holds (a 128 KB shared A tile), output columns of a work item (a
# ring stage holds that many operand rows of 128 bytes of K), the ring's
# stages, and the CTAs of a cluster that split K (bf16: two, each holding
# its rows' half of K and receiving the other's partial sums of half of
# the rows)
TILE_ROWS = {"bf16": 128, "int8": 128, "int8_grouped": 128}
TILE_COLUMNS = {"bf16": 128, "int8": 128, "int8_grouped": 128}
STAGES = {"bf16": 4, "int8": 5, "int8_grouped": 5}
KSPLIT = {"bf16": 2, "int8": 1, "int8_grouped": 1}
_VARIANTS = {"bf16": 0, "int8": 1, "int8_grouped": 2}
_ESIZE = {"bf16": 2, "int8": 1, "int8_grouped": 1}


def shared_bytes(variant: str) -> int:
    """The dynamic shared memory of a CTA of ``variant``'s kernel, from the
    geometry above (csrc Layout<..>::SMEM, which ``acx_probe_shared_bytes``
    reports): 1024 bytes of alignment, the A tile, the ring, 128 bytes of
    barriers, the int8 tiers' scales (a row's 8 groups) and, where K is
    split, the partial sums a warpgroup receives (64 rows)."""
    rows, cols = TILE_ROWS[variant], TILE_COLUMNS[variant]
    a = rows * N // KSPLIT[variant] * _ESIZE[variant]
    ring = STAGES[variant] * cols * 128
    scales = 0 if variant == "bf16" else 4 * rows * 8
    landing = 4 * 64 * cols if KSPLIT[variant] > 1 else 0
    return 1024 + a + ring + 128 + scales + landing


def probe_matrices(n: int = N) -> dict:
    """The probe's matrices, as ``pallas_int8_probe.py`` builds them: the
    float64 DCT-IV ``mat`` from its own expression, ``f32`` (its float32
    rounding), ``bf16`` (rounded float64 -> float32 -> bfloat16), ``int8``
    (clip(round(mat / s_m * 127)), s_m = max|mat|, in float64) and the
    rescale s_m / 127^2 as a Python float; tensors on the CPU."""
    k = np.arange(n)
    mat = np.sqrt(2.0 / n) * np.cos(
        np.pi / n * (k[:, None] + 0.5) * (k[None, :] + 0.5)
    )
    s_m = float(np.max(np.abs(mat)))
    f32 = torch.from_numpy(mat.astype(np.float32))
    codes = np.clip(np.round(mat / s_m * 127.0), -127, 127).astype(np.int8)
    return dict(mat=mat, f32=f32, bf16=f32.to(torch.bfloat16),
                int8=torch.from_numpy(codes),
                rescale=s_m / (127.0 * 127.0))


def operand(mat: torch.Tensor) -> torch.Tensor:
    """The kernels' form of ``mat`` [K, N]: [N, K], K contiguous."""
    return mat.T.contiguous()


def probe_bf16_reference(x, mat, operand=None):
    """Plain version of :func:`probe_bf16`: x and the bf16 matrix as bf16
    operands (RNE), float32 products and sums."""
    return _dct.matmul(x, mat, "default")


def probe_int8_reference(x, mat, rescale, operand=None):
    """Plain version of :func:`probe_int8`: ``ops/dct.py::int8_rowquant``
    per row, exact int32 sums, float(y) * (s * rescale)."""
    return _cuda_mdct.tier_matmul(x, mat, "int8", rescale, grouped=False)


def probe_int8_grouped_reference(x, mat, rescale, operand=None):
    """Plain version of :func:`probe_int8_grouped`: the same per row and
    128-column group, the groups' float(y_g) * s_g summed in order, times
    rescale."""
    return _cuda_mdct.tier_matmul(x, mat, "int8", rescale, grouped=True)


def _check(variant, x, operand):
    """What the kernels take: x float32 [rows>=1, 1024], the matrix's
    operand form of the variant, both contiguous, 16-byte aligned and on
    one device, neither requiring grad."""
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] < 1
            or x.shape[1] != N or x.numel() >= 2**31):
        raise ValueError(f"probe kernel input must be float32 [rows>=1, {N}], "
                         f"got {tuple(x.shape)} {x.dtype}")
    want = torch.bfloat16 if variant == "bf16" else torch.int8
    if (operand is None or operand.shape != (N, N) or operand.dtype != want):
        got = None if operand is None else (tuple(operand.shape),
                                            operand.dtype)
        raise ValueError(f"the {variant!r} kernel takes the matrix's operand "
                         f"form, a contiguous [{N}, {N}] {want} "
                         f"(cuda_probe.operand), got {got}")
    for t in (x, operand):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("probe kernel operands must be contiguous, "
                             f"16-byte aligned and on {x.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError("the probe kernels have no backward")


def _launch(variant, x, operand, rescale=0.0):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {x.device}")
    _check(variant, x, operand)
    from audiocodec_tpu_torch.ops import _build

    out = torch.empty(x.shape[0], N, dtype=torch.float32, device=x.device)
    rc = _build.library().acx_probe_gemm(
        x.data_ptr(), operand.data_ptr(), out.data_ptr(), x.shape[0],
        _VARIANTS[variant], float(rescale),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"probe {variant} kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def probe_bf16(x, mat, operand=None):
    """x [rows, 1024] float32 @ ``mat`` [1024, 1024] bfloat16 -> float32:
    x rounded to bf16, float32 sums. The kernel reads ``operand``,
    :func:`operand` of ``mat``."""
    if x.device.type == "cpu":
        return probe_bf16_reference(x, mat)
    out = _launch("bf16", x, operand)
    probe_bf16.launches += 1
    return out


def probe_int8(x, mat, rescale, operand=None):
    """x [rows, 1024] float32 @ the int8 codes ``mat`` -> float32: one
    dynamic int8 scale per row, exact integer sums, ``rescale`` the matrix's
    s_m / 127^2."""
    if x.device.type == "cpu":
        return probe_int8_reference(x, mat, rescale)
    out = _launch("int8", x, operand, rescale)
    probe_int8.launches += 1
    return out


def probe_int8_grouped(x, mat, rescale, operand=None):
    """As :func:`probe_int8`, with one scale per row and 128-column group
    (int8g)."""
    if x.device.type == "cpu":
        return probe_int8_grouped_reference(x, mat, rescale)
    out = _launch("int8_grouped", x, operand, rescale)
    probe_int8_grouped.launches += 1
    return out


KERNELS = (probe_bf16, probe_int8, probe_int8_grouped)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
