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

The mono kernels run every tier on the tensor cores and read the matrix in
its operand form, built once beside it (:func:`analysis_operand`,
:func:`synthesis_operand`), transposed to [N_out, K]: in bfloat16 (the
kernel's RNE rounding of the float32 matrix) at ``default``, as the int8
codes at ``int8``, the synthesis's output columns there in pair order
(:func:`pair_permutation`); and at the split tiers ``highest``/``high`` as
three bf16 planes [3, N_out, K] (:func:`split_planes`), whose products the
kernels sum in six passes. The radix kernels run their two [N/2, N/2]
products on the same split GEMM, and read the factors as
:func:`radix_operand` [2, P, N/2, N/2] (P = ``RADIX_PLANES[precision]``:
three planes at the split tiers, one, the bf16 rounding, at ``default``).
The wrappers take the operand form as their last argument; the plain
versions take and ignore it.

Each kernel has a ``torch.autograd.Function`` (:data:`FUNCTIONS`) whose
backward is its VJP wrapper (``*_vjp``, replacing ``pallas_mdct.py``
``_fold_matmul_bwd`` and its three siblings): the other direction's kernel
on the block-reversed cotangent with remapped residents, counted apart
from the forward launches; the plain versions ``*_vjp_reference`` run the
other direction's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.ops import folding as _folding
from audiocodec_tpu_torch.ops import radix as _radix

GROUP = 128  # int8g column group of the synthesis
PAIR_BLOCK = 64  # synthesis operand columns that close over their outputs
# bf16 planes of a float32 operand at the split tiers, whose kernels sum the
# products of the plane pairs (i, j) with i + j < planes: six passes on
# three planes. `high` runs six too (csrc/mdct_kernels.cu HIGH_PASSES:
# three passes on two planes miss 1e-5 of the peak on the synthesis)
SPLIT_PLANES = {"highest": 3, "high": 3}
# bf16 planes of each radix factor (and of its A): the split tiers', and one
# pass on one plane at `default`
RADIX_PLANES = {**SPLIT_PLANES, "default": 1}
SPLIT_ROWS = 128  # A rows of a split_gemm_kernel block (csrc SPLIT_BM)
_TIERS = {"highest": 0, "default": 1, "int8": 2, "high": 3}
_RADIX_TIERS = {t: v for t, v in _TIERS.items() if t != "int8"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def host_int8(m64: np.ndarray):
    """Quantize a float64 matrix to int8 against its max: returns (int8
    codes, the exact rescale s_m / 127^2 as a Python float)."""
    s_m = float(np.max(np.abs(m64)))
    q = np.clip(np.round(m64 * (127.0 / s_m)), -127, 127).astype(np.int8)
    return q, s_m / (127.0 * 127.0)


def pair_permutation(n: int) -> torch.Tensor:
    """The synthesis operand's column order: pair block b (PAIR_BLOCK
    columns) holds z columns c = b * PAIR_BLOCK/2 + u, u < PAIR_BLOCK/2,
    then their mirrors N-1-c, which are all that output columns h-1-c and
    h+c of the overlap scatter read."""
    half = PAIR_BLOCK // 2
    c = torch.arange(n // 2).reshape(-1, half)
    return torch.cat([c, n - 1 - c], dim=1).reshape(-1)


def split_planes(a: torch.Tensor, planes: int) -> torch.Tensor:
    """float32 ``a`` as ``planes`` bfloat16 planes [planes, *a.shape]:
    a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1), each rounded
    to nearest even. Every residual is exact in float32, so three planes sum
    to a exactly for normal a (|a| >= 2^-110: a2's last bit stays above
    bf16's least subnormal), and two leave about 2^-16 |a| out. The
    kernels' split (csrc split3) does the same operations."""
    out, r = [], a.to(torch.float32)
    for _ in range(planes):
        h = r.to(torch.bfloat16)
        out.append(h)
        r = r - h.to(torch.float32)
    return torch.stack(out)


def _operand(mat, precision, columns=None):
    m = mat if columns is None else mat[:, columns]
    if precision in SPLIT_PLANES:
        return split_planes(m.T, SPLIT_PLANES[precision]).contiguous()
    m = m.T if precision == "int8" else m.T.to(torch.bfloat16)
    return m.contiguous()


def analysis_operand(mat: torch.Tensor, precision: str):
    """The analysis kernel's form of ``mat`` (float32 [K, N], or the int8
    codes at ``int8``), K contiguous: [N, K] in bfloat16 at ``default``,
    int8 at ``int8``, and the bf16 planes [P, N, K] of :func:`split_planes`
    at the split tiers (P = ``SPLIT_PLANES[precision]``)."""
    return _operand(mat, precision)


def synthesis_operand(mat: torch.Tensor, precision: str):
    """The synthesis kernel's form of ``mat``: as :func:`analysis_operand`,
    with the output columns in :func:`pair_permutation` order at the
    one-pass tiers, whose kernel scatters in its epilogue (the split tiers'
    product goes through a z scratch in natural order)."""
    pairs = precision not in SPLIT_PLANES
    return _operand(mat, precision,
                    pair_permutation(mat.shape[1]) if pairs else None)


def radix_operand(mats: torch.Tensor, precision: str) -> torch.Tensor:
    """The radix kernels' form of the two factors ``mats`` [2, M, M]
    (float32): each factor transposed to [M_out, K] (K contiguous) as
    :func:`split_planes`, [2, P, M, M] bf16 with P =
    ``RADIX_PLANES[precision]``."""
    planes = RADIX_PLANES[precision]
    return torch.stack([split_planes(m.T, planes) for m in mats]).contiguous()


def tier_matmul(u, mat, precision, mat_scale, grouped):
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
                          mat_scale=1.0, operand=None):
    """Plain version of :func:`fold_matmul`: the fold in x's dtype, then the
    tier's matmul; out in x's dtype. ``operand`` is not read."""
    folded = _folding.fold(x, wa_r, wb, wc, ffr)
    y = tier_matmul(folded, mat, precision, mat_scale, grouped=False)
    return y.to(x.dtype)


def matmul_scatter_reference(y, p, q, r, s_r, mat, precision="highest",
                             mat_scale=1.0, operand=None):
    """Plain version of :func:`matmul_scatter`: z = y @ mat at the tier
    (kept in float32 at int8, else rounded to y's dtype), then the overlap
    scatter in z's dtype; out in y's dtype. ``operand`` is not read."""
    z = tier_matmul(y, mat, precision, mat_scale, grouped=True)
    zt = torch.float32 if precision == "int8" else y.dtype
    z = z.to(zt)
    out = _folding.unfold(z, p.to(zt), q.to(zt), r.to(zt), s_r.to(zt))
    return out.to(y.dtype)


def radix_fold_matmul_reference(x, wa_r, wb, wc, ffr, rot, mats,
                                precision="highest", operand=None):
    """Plain version of :func:`radix_fold_matmul`: the fold and the
    rotation in x's dtype, the two products at the tier and the butterfly
    in float32; out in x's dtype. ``operand`` is not read."""
    _check_tier(precision, _RADIX_TIERS)
    h = x.shape[-1] // 2
    rt = _radix.rotate(_folding.fold(x, wa_r, wb, wc, ffr), rot)
    u = _dct.matmul(rt[..., :h], mats[0], precision)
    v2 = _dct.matmul(rt[..., h:], mats[1], precision)
    return _radix.butterfly(u, v2).to(x.dtype)


def radix_matmul_scatter_reference(y, p, q, r, s_r, rot, mats,
                                   precision="highest", operand=None):
    """Plain version of :func:`radix_matmul_scatter`: the transposed
    butterfly in y's dtype, the two products at the tier and the transposed
    rotation in float32, rounded to y's dtype, then the overlap scatter in
    y's dtype. ``operand`` is not read."""
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
    _check_grad(x, (*weights, mat))


def _check_grad(x, constants):
    """The weights, rotations and matrices are never trained; a signal that
    requires grad goes through the Functions (:data:`FUNCTIONS`), whose
    forward runs with grad off: a wrapper called on it with grad on would
    drop its gradient."""
    if any(c.requires_grad for c in constants):
        raise NotImplementedError(
            "the MDCT kernels' weights, rotations and matrices are constants "
            "with no gradient; pass tensors that do not require grad"
        )
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "a wrapper has no backward: call the kernel through its "
            "autograd Function (cuda_mdct.FUNCTIONS) for a gradient"
        )


def kernel_input(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous and 16-byte aligned (a view at an odd
    offset is copied), as the kernels take it."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_operand(x, operand, precision, radix=False):
    """The matrix's operand form, as the mono kernels take it
    (:func:`analysis_operand`, :func:`synthesis_operand`) or the radix ones
    (:func:`radix_operand`); the split tiers take float32 input only
    (bfloat16 operands admit one pass)."""
    n = x.shape[-1]
    if precision in SPLIT_PLANES and x.dtype != torch.float32:
        raise TypeError(f"the {precision!r} tier's kernels take float32 "
                        f"input, got {x.dtype} (bfloat16 runs 'default')")
    want = torch.int8 if precision == "int8" else torch.bfloat16
    if radix:
        shape = (2, RADIX_PLANES[precision], n // 2, n // 2)
        builder = "radix_operand"
    else:
        shape, builder = (n, n), "analysis_operand / synthesis_operand"
        if precision in SPLIT_PLANES:
            shape = (SPLIT_PLANES[precision], n, n)
    if (operand is None or operand.shape != shape or operand.dtype != want
            or operand.device != x.device or not operand.is_contiguous()
            or operand.data_ptr() % 16):
        got = None if operand is None else (tuple(operand.shape),
                                            operand.dtype)
        raise ValueError(f"the {precision!r} tier takes the matrix's "
                         f"operand form, a contiguous {list(shape)} {want} "
                         f"on {x.device} (cuda_mdct.{builder}), got {got}")
    _check_grad(x, (operand,))


def _split_scratch(x, a_rows, planes):
    """The split GEMM's A planes [planes, a_rows rounded up to SPLIT_ROWS,
    N] (bf16, written by the kernels' pass before the GEMM); None without
    planes (the mono one-pass tiers)."""
    if not planes:
        return None
    m_pad = -(-a_rows // SPLIT_ROWS) * SPLIT_ROWS
    return torch.empty(planes, m_pad, x.shape[-1], dtype=torch.bfloat16,
                       device=x.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fold_matmul(x, wa_r, wb, wc, ffr, mat, precision, mat_scale,
                        operand=None):
    weights = (wa_r, wb, wc, ffr)
    _check(x, weights, mat, precision)
    _check_operand(x, operand, precision)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = x.shape
    out = torch.empty(rows, t + 1, n, dtype=x.dtype, device=x.device)
    planes = _split_scratch(x, rows * (t + 1), SPLIT_PLANES.get(precision))
    rc = _build.library().acx_fold_matmul(
        x.data_ptr(), *(w.data_ptr() for w in weights), operand.data_ptr(),
        _ptr(planes), out.data_ptr(), rows, t, n, _DTYPES[x.dtype],
        _TIERS[precision], float(mat_scale), _stream(x),
    )
    if rc:
        raise RuntimeError(f"fold_matmul kernel launch failed: CUDA error {rc}")
    return out


def fold_matmul(x, wa_r, wb, wc, ffr, mat, precision="highest",
                mat_scale=1.0, operand=None):
    """Analysis: y[n] = fold(x)[n] @ mat, [rows, T, N] -> [rows, T+1, N].

    At ``int8``, ``mat`` is the host-quantized int8 matrix and
    ``mat_scale`` its rescale. The kernel reads ``operand``,
    :func:`analysis_operand` of ``mat``."""
    if x.device.type == "cpu":
        return fold_matmul_reference(x, wa_r, wb, wc, ffr, mat, precision,
                                     mat_scale)
    out = _launch_fold_matmul(x, wa_r, wb, wc, ffr, mat, precision,
                              mat_scale, operand)
    fold_matmul.launches += 1
    return out


def _launch_matmul_scatter(y, p, q, r, s_r, mat, precision, mat_scale,
                           operand=None):
    weights = (p, q, r, s_r)
    _check(y, weights, mat, precision)
    _check_operand(y, operand, precision)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = y.shape
    out = torch.empty(rows, t + 1, n, dtype=y.dtype, device=y.device)
    # the split tiers' product goes through z (float32); the one-pass tiers
    # scatter in the kernel's epilogue
    planes = _split_scratch(y, rows * t, SPLIT_PLANES.get(precision))
    z = None if planes is None else torch.empty(rows, t, n, dtype=y.dtype,
                                                device=y.device)
    rc = _build.library().acx_matmul_scatter(
        y.data_ptr(), *(w.data_ptr() for w in weights), operand.data_ptr(),
        _ptr(planes), _ptr(z), out.data_ptr(), rows, t, n, _DTYPES[y.dtype],
        _TIERS[precision], float(mat_scale), _stream(y),
    )
    if rc:
        raise RuntimeError(
            f"matmul_scatter kernel launch failed: CUDA error {rc}"
        )
    return out


def matmul_scatter(y, p, q, r, s_r, mat, precision="highest", mat_scale=1.0,
                   operand=None):
    """Synthesis: z = y @ mat, then the overlap scatter, [rows, T, N] ->
    [rows, T+1, N]. At ``int8`` the tier is int8g (per frame and
    128-column group). The kernel reads ``operand``,
    :func:`synthesis_operand` of ``mat``."""
    if y.device.type == "cpu":
        return matmul_scatter_reference(y, p, q, r, s_r, mat, precision,
                                        mat_scale)
    out = _launch_matmul_scatter(y, p, q, r, s_r, mat, precision, mat_scale,
                                 operand)
    matmul_scatter.launches += 1
    return out


def _check_radix(x, weights, rot, mats, precision, operand):
    n = x.shape[-1]
    _check(x, weights, mats, precision, mat_shape=(2, n // 2, n // 2),
           tiers=_RADIX_TIERS)
    if (rot.shape != (2, n) or rot.dtype != x.dtype
            or rot.device != x.device or not rot.is_contiguous()):
        raise ValueError(f"rotation must be a contiguous [2, {n}] {x.dtype} "
                         f"on {x.device}, got {tuple(rot.shape)} {rot.dtype}")
    _check_grad(x, (rot,))
    _check_operand(x, operand, precision, radix=True)


def _launch_radix(entry, x, weights, rot, mats, precision, operand, frames):
    """One radix direction: ``entry`` of the library on x [rows, T, N], its
    split GEMM's A planes over ``frames`` frames a row, the float products
    [rows, frames, N] and the output [rows, T+1, N]."""
    _check_radix(x, weights, rot, mats, precision, operand)
    from audiocodec_tpu_torch.ops import _build

    rows, t, n = x.shape
    out = torch.empty(rows, t + 1, n, dtype=x.dtype, device=x.device)
    planes = _split_scratch(x, rows * frames, RADIX_PLANES[precision])
    prod = torch.empty(rows, frames, n, dtype=torch.float32, device=x.device)
    rc = getattr(_build.library(), entry)(
        x.data_ptr(), *(w.data_ptr() for w in weights), rot.data_ptr(),
        operand.data_ptr(), planes.data_ptr(), prod.data_ptr(),
        out.data_ptr(), rows, t, n, _DTYPES[x.dtype], _TIERS[precision],
        _stream(x),
    )
    if rc:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def _launch_radix_fold_matmul(x, wa_r, wb, wc, ffr, rot, mats, precision,
                              operand=None):
    return _launch_radix("acx_radix_fold_matmul", x, (wa_r, wb, wc, ffr),
                         rot, mats, precision, operand, x.shape[1] + 1)


def radix_fold_matmul(x, wa_r, wb, wc, ffr, rot, mats, precision="highest",
                      operand=None):
    """Radix analysis, [rows, T, N] -> [rows, T+1, N] in standard order:
    the fold, the rotation ``rot`` [2, N] (x's dtype), the two [M, M]
    products ``mats`` [2, M, M] (float32) and the butterfly. The kernel
    reads ``operand``, :func:`radix_operand` of ``mats``."""
    if x.device.type == "cpu":
        return radix_fold_matmul_reference(x, wa_r, wb, wc, ffr, rot, mats,
                                           precision)
    out = _launch_radix_fold_matmul(x, wa_r, wb, wc, ffr, rot, mats,
                                    precision, operand)
    radix_fold_matmul.launches += 1
    return out


def _launch_radix_matmul_scatter(y, p, q, r, s_r, rot, mats, precision,
                                 operand=None):
    return _launch_radix("acx_radix_matmul_scatter", y, (p, q, r, s_r), rot,
                         mats, precision, operand, y.shape[1])


def radix_matmul_scatter(y, p, q, r, s_r, rot, mats, precision="highest",
                         operand=None):
    """Radix synthesis, [rows, T, N] in standard order -> [rows, T+1, N]:
    the transposed butterfly, the two [M, M] products ``mats`` [2, M, M]
    (float32), the transposed rotation ``rot`` [2, N] (y's dtype) and the
    overlap scatter. The kernel reads ``operand``, :func:`radix_operand` of
    ``mats``."""
    if y.device.type == "cpu":
        return radix_matmul_scatter_reference(y, p, q, r, s_r, rot, mats,
                                              precision)
    out = _launch_radix_matmul_scatter(y, p, q, r, s_r, rot, mats, precision,
                                       operand)
    radix_matmul_scatter.launches += 1
    return out


# ---- The VJPs -------------------------------------------------------------
#
# The transpose of each direction is the other direction's kernel on the
# block-reversed cotangent (as ``pallas_mdct.py`` _fold_matmul_bwd and its
# three siblings), with residents remapped for the port's natural order and
# [N/2] half-vectors; h = N/2:
#
#   VJP of fold_matmul: matmul_scatter with p=-ffr, q=wc, r=wb,
#     s_r=flip(wa_r) and the matrix [M[h:]^T | M[:h]^T] (M the analysis's);
#   VJP of matmul_scatter: fold_matmul with wa_r=flip(s_r), wb=r, wc=q,
#     ffr=-p and the matrix [Mi[:, h:]^T ; Mi[:, :h]^T] (Mi the synthesis's);
#   the radix pair: the same weights, the factors transposed and reversed
#     along one axis, the rotation's quarters reversed and exchanged
#     (:func:`radix_fold_vjp_residents`, :func:`radix_unfold_vjp_residents`).
#
# The analysis VJP swaps the lane halves of its output, the synthesis VJP
# those of its input; both reverse the blocks of the result and drop its
# first and last frame. Every remapping is a sign, a permutation or a
# transpose, exact in bfloat16, built once on the host side of a module
# (mdct.py). At int8 the backward is straight-through: the ``default`` tier
# on the dequantized matrix, q * (mat_scale * 127).


def _swap(t: torch.Tensor) -> torch.Tensor:
    """The two halves of the last axis exchanged."""
    h = t.shape[-1] // 2
    return torch.cat([t[..., h:], t[..., :h]], dim=-1)


def _flip(t: torch.Tensor) -> torch.Tensor:
    return torch.flip(t, (-1,))


def fold_vjp_weights(wa_r, wb, wc, ffr):
    """The unfold weights (p, q, r, s_r) of the analysis VJP."""
    return -ffr, wc, wb, _flip(wa_r)


def unfold_vjp_weights(p, q, r, s_r):
    """The fold weights (wa_r, wb, wc, ffr) of the synthesis VJP."""
    return _flip(s_r), r, q, -p


def fold_vjp_matrix(mat: torch.Tensor) -> torch.Tensor:
    """The synthesis matrix of the analysis VJP, from the analysis matrix."""
    h = mat.shape[0] // 2
    return torch.cat([mat[h:].T, mat[:h].T], dim=1).contiguous()


def unfold_vjp_matrix(mat: torch.Tensor) -> torch.Tensor:
    """The analysis matrix of the synthesis VJP, from the synthesis matrix."""
    h = mat.shape[1] // 2
    return torch.cat([mat[:, h:].T, mat[:, :h].T], dim=0).contiguous()


def radix_fold_vjp_residents(rot: torch.Tensor, mats: torch.Tensor):
    """(rotation, factors) of the radix analysis VJP, from the analysis's
    ``rot`` = [r0; r1] and ``mats`` = [P; Q]."""
    h = rot.shape[1] // 2
    r0, r1 = rot
    vrot = torch.stack([
        torch.cat([_flip(r1[:h]), _flip(r0[:h])]),
        torch.cat([_flip(r0[h:]), _flip(r1[h:])]),
    ])
    return vrot, torch.stack([m.T.flip(1) for m in mats]).contiguous()


def radix_unfold_vjp_residents(rot: torch.Tensor, mats: torch.Tensor):
    """(rotation, factors) of the radix synthesis VJP, from the synthesis's
    ``rot`` = [ra; rb] and ``mats`` = [A; B]."""
    h = rot.shape[1] // 2
    ra, rb = rot
    vrot = torch.stack([
        torch.cat([_flip(ra[h:]), _flip(rb[:h])]),
        torch.cat([_flip(ra[:h]), _flip(rb[h:])]),
    ])
    return vrot, torch.stack([m.T.flip(0) for m in mats]).contiguous()


def dequantized(q: torch.Tensor, mat_scale: float) -> torch.Tensor:
    """The float32 matrix of the int8 tier's straight-through backward."""
    return q.to(torch.float32) * torch.tensor(mat_scale * 127.0,
                                              dtype=torch.float32)


def _vjp(g, run, args, analysis):
    """The VJP of an analysis (``analysis``) or synthesis kernel, through
    ``run``, the other direction's kernel or plain version, with its
    remapped residents ``args``."""
    gr = torch.flip(g, (1,))
    if not analysis:
        gr = _swap(gr)
    full = torch.flip(run(kernel_input(gr, g.dtype), *args), (1,))[:, 1:-1]
    return _swap(full) if analysis else full


def fold_matmul_vjp_reference(g, p, q, r, s_r, mat, precision="highest",
                              operand=None):
    """Plain version of :func:`fold_matmul_vjp`."""
    return _vjp(g, matmul_scatter_reference, (p, q, r, s_r, mat, precision),
                True)


def fold_matmul_vjp(g, p, q, r, s_r, mat, precision="highest",
                    operand=None):
    """The VJP of :func:`fold_matmul`: the cotangent [rows, T+1, N] ->
    [rows, T, N] through the synthesis kernel, with the residents of
    :func:`fold_vjp_weights` and :func:`fold_vjp_matrix` and that matrix's
    :func:`synthesis_operand`."""
    if g.device.type == "cpu":
        return fold_matmul_vjp_reference(g, p, q, r, s_r, mat, precision)
    out = _vjp(g, _launch_matmul_scatter,
               (p, q, r, s_r, mat, precision, 1.0, operand), True)
    fold_matmul_vjp.launches += 1
    return out


def matmul_scatter_vjp_reference(g, wa_r, wb, wc, ffr, mat,
                                 precision="highest", operand=None):
    """Plain version of :func:`matmul_scatter_vjp`."""
    return _vjp(g, fold_matmul_reference, (wa_r, wb, wc, ffr, mat, precision),
                False)


def matmul_scatter_vjp(g, wa_r, wb, wc, ffr, mat, precision="highest",
                       operand=None):
    """The VJP of :func:`matmul_scatter`: the cotangent [rows, T+1, N] ->
    [rows, T, N] through the analysis kernel, with the residents of
    :func:`unfold_vjp_weights` and :func:`unfold_vjp_matrix` and that
    matrix's :func:`analysis_operand`."""
    if g.device.type == "cpu":
        return matmul_scatter_vjp_reference(g, wa_r, wb, wc, ffr, mat,
                                            precision)
    out = _vjp(g, _launch_fold_matmul,
               (wa_r, wb, wc, ffr, mat, precision, 1.0, operand), False)
    matmul_scatter_vjp.launches += 1
    return out


def radix_fold_matmul_vjp_reference(g, p, q, r, s_r, rot, mats,
                                    precision="highest", operand=None):
    """Plain version of :func:`radix_fold_matmul_vjp`."""
    return _vjp(g, radix_matmul_scatter_reference,
                (p, q, r, s_r, rot, mats, precision), True)


def radix_fold_matmul_vjp(g, p, q, r, s_r, rot, mats, precision="highest",
                          operand=None):
    """The VJP of :func:`radix_fold_matmul` through the radix synthesis
    kernel, with the residents of :func:`fold_vjp_weights` and
    :func:`radix_fold_vjp_residents` and those factors'
    :func:`radix_operand`."""
    if g.device.type == "cpu":
        return radix_fold_matmul_vjp_reference(g, p, q, r, s_r, rot, mats,
                                               precision)
    out = _vjp(g, _launch_radix_matmul_scatter,
               (p, q, r, s_r, rot, mats, precision, operand), True)
    radix_fold_matmul_vjp.launches += 1
    return out


def radix_matmul_scatter_vjp_reference(g, wa_r, wb, wc, ffr, rot, mats,
                                       precision="highest", operand=None):
    """Plain version of :func:`radix_matmul_scatter_vjp`."""
    return _vjp(g, radix_fold_matmul_reference,
                (wa_r, wb, wc, ffr, rot, mats, precision), False)


def radix_matmul_scatter_vjp(g, wa_r, wb, wc, ffr, rot, mats,
                             precision="highest", operand=None):
    """The VJP of :func:`radix_matmul_scatter` through the radix analysis
    kernel, with the residents of :func:`unfold_vjp_weights` and
    :func:`radix_unfold_vjp_residents` and those factors'
    :func:`radix_operand`."""
    if g.device.type == "cpu":
        return radix_matmul_scatter_vjp_reference(g, wa_r, wb, wc, ffr, rot,
                                                  mats, precision)
    out = _vjp(g, _launch_radix_fold_matmul,
               (wa_r, wb, wc, ffr, rot, mats, precision, operand), False)
    radix_matmul_scatter_vjp.launches += 1
    return out


def _function(name: str):
    """The ``torch.autograd.Function`` of the kernel ``name``: its forward
    is the wrapper ``name``, its backward the wrapper ``{name}_vjp``, both
    looked up at each call (so a caller can swap in the plain versions).
    ``apply(x, args, vjp_args)`` takes the wrapper's arguments after the
    signal and the VJP's after the cotangent; only the signal has a
    gradient."""

    def forward(ctx, x, args, vjp_args):
        if any(isinstance(a, torch.Tensor) and a.requires_grad
               for a in (*args, *vjp_args)):
            raise NotImplementedError(
                "the MDCT kernels' weights, rotations and matrices are "
                "constants with no gradient; pass tensors that do not "
                "require grad"
            )
        ctx.vjp_args = vjp_args
        return globals()[name](x, *args)

    def backward(ctx, g):
        return globals()[f"{name}_vjp"](g.contiguous(), *ctx.vjp_args), \
            None, None

    camel = "".join(part.title() for part in name.split("_"))
    return type(camel, (torch.autograd.Function,), dict(
        forward=staticmethod(forward), backward=staticmethod(backward),
        __doc__=f"{name} with its VJP as the backward.",
    ))


KERNELS = (fold_matmul, matmul_scatter, radix_fold_matmul,
           radix_matmul_scatter)
VJPS = (fold_matmul_vjp, matmul_scatter_vjp, radix_fold_matmul_vjp,
        radix_matmul_scatter_vjp)
FUNCTIONS = {k.__name__: _function(k.__name__) for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS + VJPS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS + VJPS}


reset_launch_counts()
