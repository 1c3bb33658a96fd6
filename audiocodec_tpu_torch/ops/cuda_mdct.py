"""The MDCT's kernels: wrappers, plain versions and launch counts.

The mono design's ``fold_matmul`` (analysis) and ``matmul_scatter``
(synthesis), and the radix design's ``radix_fold_matmul`` and
``radix_matmul_scatter`` (ops/radix.py), replace the Pallas kernels of
``audiocodec_tpu/ops/pallas_mdct.py``. A wrapper given a CUDA tensor
launches the hand-written kernel of ``csrc/mdct_kernels.cu`` or raises;
given a CPU tensor it runs the plain torch version beside it, which has each
tier's exact numerics and is what the kernel is held against.

All take rows = batch x channels in the natural sample order, [rows, T, N]
-> [rows, T+1, N], and the MDCT's own fold weights; spectra are in standard
order. Tiers: ``highest`` and ``high`` (float32), ``default`` (bf16
operands, float32 sums) and, in the mono design only, ``int8``, which is one
scale per frame in the analysis and one per frame and 128-column group
(``int8g``) in the synthesis, against a matrix quantized on the host
(:func:`host_int8`) with the static rescale ``mat_scale``.
"""

from __future__ import annotations

import numpy as np
import torch

from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.ops import folding as _folding
from audiocodec_tpu_torch.ops import radix as _radix

GROUP = 128  # int8g column group of the synthesis
_TIERS = {"highest": 0, "high": 0, "default": 1, "int8": 2}
_RADIX_TIERS = {t: v for t, v in _TIERS.items() if t != "int8"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def host_int8(m64: np.ndarray):
    """Quantize a float64 matrix to int8 against its max: returns (int8
    codes, the exact rescale s_m / 127^2 as a Python float)."""
    s_m = float(np.max(np.abs(m64)))
    q = np.clip(np.round(m64 * (127.0 / s_m)), -127, 127).astype(np.int8)
    return q, s_m / (127.0 * 127.0)


def _tier_matmul(u, mat, precision, mat_scale, grouped):
    """u [..., K] @ mat [K, M] at the kernel's tier; float32 out."""
    if precision != "int8":
        return _dct.matmul(u, mat, precision)
    ms = torch.tensor(mat_scale, dtype=torch.float32)  # on the host
    if not grouped:
        q, s = _dct.int8_rowquant(u)
        return _dct.int_matmul(q, mat).to(torch.float32) * (s * ms)
    acc = None
    for j in range(u.shape[-1] // GROUP):
        part = slice(j * GROUP, (j + 1) * GROUP)
        q, s = _dct.int8_rowquant(u[..., part])
        term = _dct.int_matmul(q, mat[part]).to(torch.float32) * s
        acc = term if acc is None else acc + term
    return acc * ms


def fold_matmul_reference(x, wa_r, wb, wc, ffr, mat, precision="highest",
                          mat_scale=1.0):
    """Plain version of :func:`fold_matmul`: the fold in x's dtype, then the
    tier's matmul; out in x's dtype."""
    folded = _folding.fold(x, wa_r, wb, wc, ffr)
    y = _tier_matmul(folded, mat, precision, mat_scale, grouped=False)
    return y.to(x.dtype)


def matmul_scatter_reference(y, p, q, r, s_r, mat, precision="highest",
                             mat_scale=1.0):
    """Plain version of :func:`matmul_scatter`: z = y @ mat at the tier
    (kept in float32 at int8, else rounded to y's dtype), then the overlap
    scatter in z's dtype; out in y's dtype."""
    z = _tier_matmul(y, mat, precision, mat_scale, grouped=True)
    zt = torch.float32 if precision == "int8" else y.dtype
    z = z.to(zt)
    out = _folding.unfold(z, p.to(zt), q.to(zt), r.to(zt), s_r.to(zt))
    return out.to(y.dtype)


def radix_fold_matmul_reference(x, wa_r, wb, wc, ffr, rot, mats,
                                precision="highest"):
    """Plain version of :func:`radix_fold_matmul`: the fold and the
    rotation in x's dtype, the two products at the tier and the butterfly
    in float32; out in x's dtype."""
    _check_tier(precision, _RADIX_TIERS)
    h = x.shape[-1] // 2
    rt = _radix.rotate(_folding.fold(x, wa_r, wb, wc, ffr), rot)
    u = _dct.matmul(rt[..., :h], mats[0], precision)
    v2 = _dct.matmul(rt[..., h:], mats[1], precision)
    return _radix.butterfly(u, v2).to(x.dtype)


def radix_matmul_scatter_reference(y, p, q, r, s_r, rot, mats,
                                   precision="highest"):
    """Plain version of :func:`radix_matmul_scatter`: the transposed
    butterfly in y's dtype, the two products at the tier and the transposed
    rotation in float32, rounded to y's dtype, then the overlap scatter in
    y's dtype."""
    _check_tier(precision, _RADIX_TIERS)
    us, vs = _radix.butterfly_t(y)
    rs = _dct.matmul(us, mats[0], precision)
    ts = _dct.matmul(vs, mats[1], precision)
    z = _radix.rotate_t(rs, ts, rot).to(y.dtype)
    return _folding.unfold(z, p, q, r, s_r).to(y.dtype)


def _check_tier(precision, tiers=_TIERS):
    if precision not in tiers:
        raise ValueError(f"precision {precision!r} is not one of the "
                         f"kernel's tiers {sorted(tiers)}")


def _check(x, weights, mat, precision, mat_shape=None, tiers=_TIERS):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel input must be float32 or bfloat16, got "
                        f"{x.dtype}")
    _check_tier(precision, tiers)
    if x.dim() != 3 or x.shape[1] < 1 or x.shape[2] % 256:
        raise ValueError("kernel input must be [rows, T>=1, N] with N a "
                         f"multiple of 256, got {tuple(x.shape)}")
    rows, t, n = x.shape
    if rows * (t + 1) * n >= 2**31:
        raise ValueError(f"{tuple(x.shape)} is too large for 32-bit indices")
    for w in weights:
        if w.shape != (n // 2,) or w.dtype != x.dtype:
            raise ValueError(f"fold weights must be [{n // 2}] {x.dtype}, got "
                             f"{tuple(w.shape)} {w.dtype}")
    want = torch.int8 if precision == "int8" else torch.float32
    mat_shape = mat_shape or (n, n)
    if mat.shape != mat_shape or mat.dtype != want:
        raise ValueError(f"matrix must be {list(mat_shape)} {want} at "
                         f"{precision!r}, got {tuple(mat.shape)} {mat.dtype}")
    for t_ in (x, *weights, mat):
        if t_.device != x.device or not t_.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on "
                             f"{x.device}")
        if t_.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned "
                             "(the kernels load 16-byte vectors)")
        if t_.requires_grad:
            raise NotImplementedError(
                "the MDCT kernels have no backward yet; pass tensors that "
                "do not require grad"
            )


def kernel_input(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous and 16-byte aligned (a view at an odd
    offset is copied), as the kernels take it."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def fold_matmul(x, wa_r, wb, wc, ffr, mat, precision="highest",
                mat_scale=1.0):
    """Analysis: y[n] = fold(x)[n] @ mat, [rows, T, N] -> [rows, T+1, N].

    At ``int8``, ``mat`` is the host-quantized int8 matrix and
    ``mat_scale`` its rescale."""
    if x.device.type == "cpu":
        return fold_matmul_reference(x, wa_r, wb, wc, ffr, mat, precision,
                                     mat_scale)
    weights = (wa_r, wb, wc, ffr)
    _check(x, weights, mat, precision)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = x.shape
    out = torch.empty(rows, t + 1, n, dtype=x.dtype, device=x.device)
    scales = torch.empty(
        rows * (t + 1) if precision == "int8" else 1,
        dtype=torch.float32, device=x.device,
    )
    rc = _build.library().acx_fold_matmul(
        x.data_ptr(), *(w.data_ptr() for w in weights), mat.data_ptr(),
        scales.data_ptr(), out.data_ptr(), rows, t, n, _DTYPES[x.dtype],
        _TIERS[precision], float(mat_scale), _stream(x),
    )
    if rc:
        raise RuntimeError(f"fold_matmul kernel launch failed: CUDA error {rc}")
    fold_matmul.launches += 1
    return out


def matmul_scatter(y, p, q, r, s_r, mat, precision="highest", mat_scale=1.0):
    """Synthesis: z = y @ mat, then the overlap scatter, [rows, T, N] ->
    [rows, T+1, N]. At ``int8`` the tier is int8g (per frame and
    128-column group)."""
    if y.device.type == "cpu":
        return matmul_scatter_reference(y, p, q, r, s_r, mat, precision,
                                        mat_scale)
    weights = (p, q, r, s_r)
    _check(y, weights, mat, precision)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = y.shape
    int8 = precision == "int8"
    out = torch.empty(rows, t + 1, n, dtype=y.dtype, device=y.device)
    z = torch.empty(rows, t, n, dtype=torch.float32 if int8 else y.dtype,
                    device=y.device)
    scales = torch.empty(rows * t * (n // GROUP) if int8 else 1,
                         dtype=torch.float32, device=y.device)
    rc = _build.library().acx_matmul_scatter(
        y.data_ptr(), *(w.data_ptr() for w in weights), mat.data_ptr(),
        scales.data_ptr(), z.data_ptr(), out.data_ptr(), rows, t, n,
        _DTYPES[y.dtype], _TIERS[precision], float(mat_scale), _stream(y),
    )
    if rc:
        raise RuntimeError(
            f"matmul_scatter kernel launch failed: CUDA error {rc}"
        )
    matmul_scatter.launches += 1
    return out


def _check_radix(x, weights, rot, mats, precision):
    n = x.shape[-1]
    _check(x, weights, mats, precision, mat_shape=(2, n // 2, n // 2),
           tiers=_RADIX_TIERS)
    if (rot.shape != (2, n) or rot.dtype != x.dtype
            or rot.device != x.device or not rot.is_contiguous()):
        raise ValueError(f"rotation must be a contiguous [2, {n}] {x.dtype} "
                         f"on {x.device}, got {tuple(rot.shape)} {rot.dtype}")
    if rot.requires_grad:
        raise NotImplementedError("the MDCT kernels have no backward yet; "
                                  "pass tensors that do not require grad")


def radix_fold_matmul(x, wa_r, wb, wc, ffr, rot, mats, precision="highest"):
    """Radix analysis, [rows, T, N] -> [rows, T+1, N] in standard order:
    the fold, the rotation ``rot`` [2, N] (x's dtype), the two [M, M]
    products ``mats`` [2, M, M] (float32) and the butterfly."""
    if x.device.type == "cpu":
        return radix_fold_matmul_reference(x, wa_r, wb, wc, ffr, rot, mats,
                                           precision)
    weights = (wa_r, wb, wc, ffr)
    _check_radix(x, weights, rot, mats, precision)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = x.shape
    out = torch.empty(rows, t + 1, n, dtype=x.dtype, device=x.device)
    rt = torch.empty_like(out)
    uv = torch.empty(rows, t + 1, n, dtype=torch.float32, device=x.device)
    rc = _build.library().acx_radix_fold_matmul(
        x.data_ptr(), *(w.data_ptr() for w in weights), rot.data_ptr(),
        mats.data_ptr(), rt.data_ptr(), uv.data_ptr(), out.data_ptr(), rows,
        t, n, _DTYPES[x.dtype], _TIERS[precision], _stream(x),
    )
    if rc:
        raise RuntimeError(
            f"radix_fold_matmul kernel launch failed: CUDA error {rc}"
        )
    radix_fold_matmul.launches += 1
    return out


def radix_matmul_scatter(y, p, q, r, s_r, rot, mats, precision="highest"):
    """Radix synthesis, [rows, T, N] in standard order -> [rows, T+1, N]:
    the transposed butterfly, the two [M, M] products ``mats`` [2, M, M]
    (float32), the transposed rotation ``rot`` [2, N] (y's dtype) and the
    overlap scatter."""
    if y.device.type == "cpu":
        return radix_matmul_scatter_reference(y, p, q, r, s_r, rot, mats,
                                              precision)
    weights = (p, q, r, s_r)
    _check_radix(y, weights, rot, mats, precision)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = y.shape
    out = torch.empty(rows, t + 1, n, dtype=y.dtype, device=y.device)
    usvs = torch.empty_like(y)
    rsts = torch.empty(rows, t, n, dtype=torch.float32, device=y.device)
    rc = _build.library().acx_radix_matmul_scatter(
        y.data_ptr(), *(w.data_ptr() for w in weights), rot.data_ptr(),
        mats.data_ptr(), usvs.data_ptr(), rsts.data_ptr(), out.data_ptr(),
        rows, t, n, _DTYPES[y.dtype], _TIERS[precision], _stream(y),
    )
    if rc:
        raise RuntimeError(
            f"radix_matmul_scatter kernel launch failed: CUDA error {rc}"
        )
    radix_matmul_scatter.launches += 1
    return out


KERNELS = (fold_matmul, matmul_scatter, radix_fold_matmul,
           radix_matmul_scatter)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
