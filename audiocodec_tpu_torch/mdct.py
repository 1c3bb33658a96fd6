"""MDCT analysis/synthesis filter bank in PyTorch.

The counterpart of ``audiocodec_tpu/mdct.py``. The sparse fold
(ops/folding.py) feeds one [N, N] DCT-IV matmul; at the one-pass tiers
(``default``, ``int8``) the fold is collapsed into two dense matmuls
(cur @ (H0 M) + prev @ (H1 M)); and where ``use_kernel`` is on, a direction
runs a hand-written CUDA kernel of ops/cuda_mdct.py, of the mono design (one
[N, N] product) or the radix design (ops/radix.py: a rotation, two
[N/2, N/2] products and a butterfly). A direction on a kernel runs
through its ``torch.autograd.Function`` (``cuda_mdct.FUNCTIONS``), whose
backward is the other direction's kernel with the VJP residents this
module builds once, as buffers.

Shape contract:

  transform:          [batches_n, samples_n, channels_n]  (samples multiple of N)
                  ->  [batches_n, blocks_n + 1, filters_n, channels_n]
  inverse_transform:  [batches_n, blocks_n, filters_n, channels_n]
                  ->  [batches_n, (blocks_n + 1) * filters_n, channels_n]
"""

from __future__ import annotations

import math

import torch
from torch import nn

from audiocodec_tpu_torch.ops import cuda_mdct as _kernels
from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.ops import folding as _folding
from audiocodec_tpu_torch.ops import radix as _radix
from audiocodec_tpu_torch.utils import dtypes as _dtypes

_FOLD_WEIGHTS = ("wa_r", "wb", "wc", "ffr")
_UNFOLD_WEIGHTS = ("p", "q", "r", "s_r")
_KERNEL_DESIGNS = ("auto", "mono", "radix")


class MDCT(nn.Module):
    """MDCT filter bank; its precomputes are registered buffers.

    :param filters_n: number of filter bands N (even).
    :param window_type: 'sine', 'vorbis' (default) or None (all-ones).
    :param compute_dtype: float64, float32 or bfloat16; inputs must already
        have it.
    :param fast_bf16: with bfloat16 compute, run the DCT natively at the
        ``default`` tier instead of upcasting to float32.
    :param use_kernel: which directions run the CUDA kernels: True (both),
        "forward", "inverse", False, or "auto" (the default), which turns
        both on when ``device`` is CUDA and the configuration is eligible:
        N a multiple of 256 and a compute dtype other than float64. It
        never depends on whether the kernels build.
    :param dct_precision: "highest", "high", "default" or "int8".
    :param kernel_design: the kernels' design, "mono", "radix" (no int8
        tier) or "auto" (the default), which is "mono" until a benchmark
        decides between the two on the card.
    :param device: where the buffers live: the card unless the caller
        asks for the CPU.
    """

    def __init__(
        self,
        filters_n: int = 1024,
        window_type="vorbis",
        compute_dtype=torch.float32,
        fast_bf16: bool = False,
        use_kernel="auto",
        dct_precision: str = "highest",
        kernel_design: str = "auto",
        device="cuda",
    ):
        super().__init__()
        if filters_n % 2 != 0:
            raise ValueError(
                "number of filters used in mdct transformation needs to be "
                f"even, got {filters_n}"
            )
        dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
        device = torch.device(device)
        if use_kernel not in (False, True, "auto", "forward", "inverse"):
            raise ValueError(
                "use_kernel must be one of False, True, 'auto', 'forward', "
                f"'inverse'; got {use_kernel!r}"
            )
        if dct_precision not in _dct.MDCT_PRECISIONS:
            raise ValueError(
                "dct_precision must be one of "
                f"{sorted(_dct.MDCT_PRECISIONS)}, got {dct_precision!r}"
            )
        if dct_precision == "int8" and dtype == torch.float64:
            raise ValueError(
                "dct_precision='int8' is not available with a float64 "
                "compute dtype"
            )
        if kernel_design not in _KERNEL_DESIGNS:
            raise ValueError(
                f"kernel_design must be one of {_KERNEL_DESIGNS}; got "
                f"{kernel_design!r}"
            )
        if kernel_design == "radix" and dct_precision == "int8":
            raise ValueError(
                "the radix kernel design has no int8 tier; use "
                "kernel_design='mono' or 'auto' with dct_precision='int8'"
            )
        eligible = filters_n % 256 == 0 and dtype != torch.float64
        if use_kernel == "auto":
            use_kernel = eligible and device.type == "cuda"
        elif use_kernel and not eligible:
            raise ValueError(
                "use_kernel requires filters_n to be a multiple of 256 and a "
                f"non-float64 compute dtype; got filters_n={filters_n}, "
                f"compute_dtype={dtype}"
            )
        self.filters_n = filters_n
        self.window_type = window_type
        self.compute_dtype = dtype
        self.fast_bf16 = fast_bf16
        self.use_kernel = use_kernel
        self.dct_precision = dct_precision
        self.kernel_design = "mono" if kernel_design == "auto" else kernel_design
        radix = self.kernel_design == "radix"
        self.kernel_fwd = use_kernel in (True, "forward")
        self.kernel_inv = use_kernel in (True, "inverse")
        # kernels run natively in bf16 only on the fast path, else in f32
        self.kernel_dtype = (
            dtype if dtype != torch.bfloat16 or fast_bf16 else torch.float32
        )
        self.int8_scale = None

        coeffs = _folding.make_fold_coefficients(filters_n, window_type)
        mat_dtype = torch.float64 if dtype == torch.float64 else torch.float32

        def buf(name, value, as_dtype):
            self.register_buffer(
                name,
                None if value is None
                else torch.as_tensor(value, dtype=as_dtype, device=device),
            )

        for name in _FOLD_WEIGHTS + _UNFOLD_WEIGHTS:
            buf(name, getattr(coeffs, name), dtype)
        m64 = _dct.dct4_matrix(filters_n)
        s = math.sqrt(4.0 * filters_n)
        buf("dct_mat_fwd", m64 / s, mat_dtype)
        buf("dct_mat_inv", m64 * s, mat_dtype)

        # int8 kernel residents, quantized on the host with an exact scale
        # (the JAX package's _host_int8 at mdct.py:283-288)
        q_fwd = q_inv = None
        if dct_precision == "int8" and (self.kernel_fwd or self.kernel_inv):
            # never radix: that design has no int8 tier
            scales = [None, None]
            if self.kernel_fwd:
                q_fwd, scales[0] = _kernels.host_int8(m64 * (1.0 / s))
            if self.kernel_inv:
                q_inv, scales[1] = _kernels.host_int8(m64 * s)
            self.int8_scale = tuple(scales)
        buf("kernel_q_fwd", q_fwd, torch.int8)
        buf("kernel_q_inv", q_inv, torch.int8)

        # radix residents: the rotation [2, N] in the kernel dtype (the
        # rotation runs in it) and the two [N/2, N/2] factors
        for direction, on, params in (
            ("fwd", self.kernel_fwd, _radix.forward_params),
            ("inv", self.kernel_inv, _radix.inverse_params),
        ):
            rot, mats = params(filters_n) if radix and on else (None, None)
            buf(f"radix_rot_{direction}", rot, self.kernel_dtype)
            buf(f"radix_mat_{direction}", mats, mat_dtype)

        # Dense two-matmul formulation at the one-pass tiers, for the
        # directions not on a kernel
        dense = dict(fwd_cur=None, fwd_prev=None, inv_cur=None, inv_prev=None)
        if dct_precision in ("default", "int8") and dtype != torch.float64:
            h0, h1 = _folding.dense_fold_matrices(filters_n, window_type)
            g0, g1 = _folding.dense_unfold_matrices(filters_n, window_type)
            if not self.kernel_fwd:
                dense.update(fwd_cur=h0 @ m64 / s, fwd_prev=h1 @ m64 / s)
            if not self.kernel_inv:
                dense.update(inv_cur=m64 @ g0 * s, inv_prev=m64 @ g1 * s)
        for name, value in dense.items():
            buf(f"dense_{name}", value, mat_dtype)
        self.build_kernel_residents()

    def build_kernel_residents(self) -> None:
        """(Re)build what the kernels derive from the forward residents.
        The operand forms of the mono matrices (``kernel_op_{fwd,inv}``:
        ``cuda_mdct.analysis_operand`` / ``synthesis_operand`` of the matrix
        or its int8 codes, bf16 planes at ``highest``/``high``). The VJP
        residents of the directions on a kernel (``cuda_mdct``'s
        remappings, exact): the weights ``vjp_weights_*`` [4, N/2] and the
        rotation ``vjp_rot_*`` in the kernel dtype, the matrix ``vjp_mat_*``
        in float32, dequantized at int8, and its operand form
        ``vjp_op_*``. Call it after replacing a forward resident."""
        radix = self.kernel_design == "radix"
        tier = self.kernel_precision
        for d, on, build in (("fwd", self.kernel_fwd,
                              _kernels.analysis_operand),
                             ("inv", self.kernel_inv,
                              _kernels.synthesis_operand)):
            op = None
            if on and not radix:
                mat = getattr(self, f"kernel_q_{d}" if tier == "int8"
                              else f"dct_mat_{d}")
                op = build(mat, tier)
            self.register_buffer(f"kernel_op_{d}", op)
        for d, on, names in (("fwd", self.kernel_fwd, _FOLD_WEIGHTS),
                             ("inv", self.kernel_inv, _UNFOLD_WEIGHTS)):
            weights = rot = mat = op = None
            if on:
                w = [getattr(self, n).to(self.kernel_dtype) for n in names]
                remap = (_kernels.fold_vjp_weights if d == "fwd"
                         else _kernels.unfold_vjp_weights)
                weights = torch.stack(remap(*w))
                if radix:
                    rot, mat = (_kernels.radix_fold_vjp_residents if d == "fwd"
                                else _kernels.radix_unfold_vjp_residents)(
                        getattr(self, f"radix_rot_{d}"),
                        getattr(self, f"radix_mat_{d}"))
                else:
                    mat = getattr(self, f"dct_mat_{d}")
                    if self.dct_precision == "int8":
                        mat = _kernels.dequantized(
                            getattr(self, f"kernel_q_{d}"),
                            self.int8_scale[0 if d == "fwd" else 1])
                    mat = (_kernels.fold_vjp_matrix if d == "fwd"
                           else _kernels.unfold_vjp_matrix)(mat)
                    # the analysis VJP runs the synthesis kernel and back
                    op = (_kernels.synthesis_operand if d == "fwd"
                          else _kernels.analysis_operand)(
                              mat, self.vjp_precision)
            self.register_buffer(f"vjp_weights_{d}", weights)
            self.register_buffer(f"vjp_rot_{d}", rot)
            self.register_buffer(f"vjp_mat_{d}", mat)
            self.register_buffer(f"vjp_op_{d}", op)

    @property
    def inv_precision(self) -> str:
        """Tier of the synthesis outside the kernel: int8 is analysis-only
        there (the kernel restores it with grouped scales)."""
        return "default" if self.dct_precision == "int8" else self.dct_precision

    @property
    def kernel_precision(self) -> str:
        """The kernels' tier: bfloat16 operands admit one pass only, so
        ``highest``/``high`` become ``default`` for bf16 kernel inputs."""
        if self.kernel_dtype == torch.bfloat16 and self.dct_precision in (
            "highest", "high"
        ):
            return "default"
        return self.dct_precision

    def kernel_name(self, direction: str) -> str:
        """The name of the ``"forward"`` or ``"inverse"`` kernel of the
        design in ops/cuda_mdct.py."""
        name = "fold_matmul" if direction == "forward" else "matmul_scatter"
        return f"radix_{name}" if self.kernel_design == "radix" else name

    def kernel(self, direction: str):
        """The wrapper of the ``"forward"`` or ``"inverse"`` kernel of the
        design, looked up at each call."""
        return getattr(_kernels, self.kernel_name(direction))

    def kernel_args(self, direction: str) -> tuple:
        """The arguments after the signal of :meth:`kernel`: fold weights in
        the kernel dtype, then the matrix, tier, int8 rescale and the
        matrix's operand form (mono) or the rotation, the two factors and
        the tier (radix)."""
        fwd = direction == "forward"
        names = _FOLD_WEIGHTS if fwd else _UNFOLD_WEIGHTS
        weights = tuple(getattr(self, n).to(self.kernel_dtype) for n in names)
        if self.kernel_design == "radix":
            return (
                *weights,
                self.radix_rot_fwd if fwd else self.radix_rot_inv,
                self.radix_mat_fwd if fwd else self.radix_mat_inv,
                self.kernel_precision,
            )
        int8 = self.kernel_precision == "int8"
        if int8:
            mat = self.kernel_q_fwd if fwd else self.kernel_q_inv
        else:
            mat = self.dct_mat_fwd if fwd else self.dct_mat_inv
        return (
            *weights,
            mat,
            self.kernel_precision,
            self.int8_scale[0 if fwd else 1] if int8 else 1.0,
            self.kernel_op_fwd if fwd else self.kernel_op_inv,
        )

    @property
    def vjp_precision(self) -> str:
        """The VJPs' tier: the kernels', except that int8 runs
        straight-through at ``default``."""
        p = self.kernel_precision
        return "default" if p == "int8" else p

    def vjp_args(self, direction: str) -> tuple:
        """The arguments after the cotangent of the VJP of :meth:`kernel`
        (``cuda_mdct.*_vjp``)."""
        d = "fwd" if direction == "forward" else "inv"
        mono = self.kernel_design == "mono"
        rot = () if mono else (getattr(self, f"vjp_rot_{d}"),)
        op = (getattr(self, f"vjp_op_{d}"),) if mono else ()
        return (*getattr(self, f"vjp_weights_{d}").unbind(),
                *rot, getattr(self, f"vjp_mat_{d}"), self.vjp_precision, *op)

    def _run_kernel(self, direction: str, rows: torch.Tensor):
        """rows [B*C, T, N] through the direction's autograd Function."""
        function = _kernels.FUNCTIONS[self.kernel_name(direction)]
        return function.apply(
            _kernels.kernel_input(rows, self.kernel_dtype),
            self.kernel_args(direction), self.vjp_args(direction),
        )

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """MDCT analysis: [B, S, C] -> [B, S/N + 1, N, C]."""
        _dtypes.check_input_dtype(x, self.compute_dtype, "transform input")
        n = self.filters_n
        batches_n, samples_n, channels_n = x.shape
        if samples_n % n != 0 or samples_n == 0:
            raise ValueError(
                f"samples_n={samples_n} must be a nonzero multiple of "
                f"filters_n={n}"
            )
        blocks_n = samples_n // n
        xb = x.permute(0, 2, 1).reshape(batches_n, channels_n, blocks_n, n)
        if self.kernel_fwd:
            rows = xb.reshape(batches_n * channels_n, blocks_n, n)
            y = self._run_kernel("forward", rows).to(self.compute_dtype)
            y = y.reshape(batches_n, channels_n, blocks_n + 1, n)
        elif self.dense_fwd_cur is not None:
            zero = torch.zeros_like(xb[:, :, :1])
            cur = torch.cat([xb, zero], dim=2)
            prev = torch.cat([zero, xb], dim=2)
            y = _dct.dct4(
                cur, self.dense_fwd_cur, fast_bf16=self.fast_bf16,
                precision=self.dct_precision,
            ) + _dct.dct4(
                prev, self.dense_fwd_prev, fast_bf16=self.fast_bf16,
                precision=self.dct_precision,
            )
        else:
            folded = _folding.fold(xb, self.wa_r, self.wb, self.wc, self.ffr)
            y = _dct.dct4(
                folded, self.dct_mat_fwd, fast_bf16=self.fast_bf16,
                precision=self.dct_precision,
            )
        return y.permute(0, 2, 3, 1)

    def inverse_transform(self, mdct_amplitudes: torch.Tensor) -> torch.Tensor:
        """MDCT synthesis: [B, T, N, C] -> [B, (T + 1) * N, C]."""
        _dtypes.check_input_dtype(
            mdct_amplitudes, self.compute_dtype, "inverse_transform input"
        )
        n = self.filters_n
        batches_n, blocks_n, filters_n, channels_n = mdct_amplitudes.shape
        if filters_n != n:
            raise ValueError(
                f"expected filters_n={n} on axis 2, got {filters_n}"
            )
        if blocks_n == 0:
            raise ValueError("need at least one spectral frame to invert")
        yb = mdct_amplitudes.permute(0, 3, 1, 2)
        if self.kernel_inv:
            rows = yb.reshape(batches_n * channels_n, blocks_n, n)
            out = self._run_kernel("inverse", rows).to(self.compute_dtype)
        elif self.dense_inv_cur is not None:
            zero = torch.zeros_like(yb[:, :, :1])
            cur = torch.cat([yb, zero], dim=2)
            prev = torch.cat([zero, yb], dim=2)
            out = _dct.dct4(
                cur, self.dense_inv_cur, fast_bf16=self.fast_bf16,
                precision=self.inv_precision,
            ) + _dct.dct4(
                prev, self.dense_inv_prev, fast_bf16=self.fast_bf16,
                precision=self.inv_precision,
            )
        else:
            z = _dct.dct4(
                yb, self.dct_mat_inv, fast_bf16=self.fast_bf16,
                precision=self.inv_precision,
            )
            out = _folding.unfold(z, self.p, self.q, self.r, self.s_r)
        return out.reshape(
            batches_n, channels_n, (blocks_n + 1) * n
        ).permute(0, 2, 1)
