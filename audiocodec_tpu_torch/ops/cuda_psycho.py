"""The fused psychoacoustic model and quantizer: wrapper, plain version and
launch count.

``psycho_quantize`` runs the deterministic chain between the two transforms
of ``Codec.encode_quantized`` and ``Codec.round_trip_quantized``: tonality,
the global masking threshold, the step sizes and the codes, and for the
round trip the dequantized spectrum. A wrapper given a CUDA tensor launches
the hand-written kernel of ``csrc/psycho_kernel.cu`` (one launch a call) or
raises; given a CPU tensor it runs the plain version beside it, the
composition of the stage functions (``PsychoacousticModel.tonality``,
``global_masking_threshold``, ``quantize.quantize``, ``quantize.dequantize``).
The kernel replaces no TPU kernel: the JAX package leaves this chain to XLA,
which fuses it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch.utils.profiling import span

# the Bark contractions' tiers that the kernel's float32 products compute
PRECISIONS = ("highest", "high")
_f32 = np.float32


def psycho_quantize_reference(model, spectrum, drown=0.0,
                              encode: bool = False):
    """Plain version of :func:`psycho_quantize`: the stage functions, one
    after another."""
    tonality = model.tonality(spectrum)
    threshold = model.global_masking_threshold(spectrum, tonality, drown)
    codes, delta = _quantize.quantize(spectrum, threshold)
    if encode:
        return codes, delta, threshold
    return _quantize.dequantize(codes, delta, dtype=spectrum.dtype)


def _padded(lo, off, vals):
    """The ranges of :func:`_band_ranges` as rows of one width, the widest,
    padded with zeros: [columns, width]."""
    lens = np.diff(off)
    width = max(1, int(lens.max(initial=0)))
    rows = np.zeros((len(lo), width), vals.dtype)
    for j, (a, n) in enumerate(zip(off[:-1], lens)):
        rows[j, :n] = vals[a:a + n]
    return rows


def _band_ranges(m: np.ndarray):
    """(first row, value offsets [cols + 1], values) of each column of
    ``m`` over the range from its first to its last nonzero row; zeros
    inside a range are kept (an exact zero changes no sum)."""
    nz = m != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, m.shape[0] - nz[::-1].argmax(axis=0), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)])
    vals = np.concatenate([m[a:b, j] for j, (a, b) in enumerate(zip(lo, hi))]
                          + [np.zeros(0, m.dtype)])
    return lo, off, vals


def _tables(model):
    """The kernel's constant operands of ``model`` on its device, made from
    its buffers at the first call and again whenever a buffer is replaced or
    changed in place: (tensors in the order of csrc's Tables, the floor or
    None last; the model's float32 constants). W's columns are kept as
    their nonzero ranges, W_inv's as rows of the widest range, padded with
    zeros."""
    sources = (model.W, model.W_inv, model.spreading_matrix, model.bark_grid,
               model.quiet_threshold_intensity,
               model.quiet_threshold_freq_amp)
    key = tuple((id(t), t._version) for t in sources if t is not None)
    cached = getattr(model, "_psycho_quantize_tables", None)
    if cached is not None and cached[0] == key:
        return cached[2]
    dev = model.W.device
    w_lo, w_off, w_val = _band_ranges(model.W.cpu().numpy())
    v_lo, v_off, v_val = _band_ranges(model.W_inv.cpu().numpy())

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    floor = model.quiet_threshold_freq_amp
    tensors = (ints(w_lo), ints(w_off), torch.as_tensor(w_val, device=dev),
               ints(v_lo),
               torch.as_tensor(_padded(v_lo, v_off, v_val), device=dev),
               model.spreading_matrix.contiguous(),
               model.bark_grid.contiguous(),
               model.quiet_threshold_intensity.reshape(-1).contiguous(),
               None if floor is None else floor.reshape(-1).contiguous())
    consts = [float(getattr(model, f"c_{name}"))
              for name in ("eps", "alpha", "inv_alpha", "neg_alpha", "ln10")]
    # the key's tensors are held, so that no id is reused while cached
    model._psycho_quantize_tables = (key, sources, (tensors, consts))
    return model._psycho_quantize_tables[2]


def _scalars(consts, spectrum, drown):
    """The Scalars of csrc/psycho_kernel.cu: the model's constants, then
    those the stagewise path rounds on the card. torch's mean on the card
    multiplies the sum by float(outputs) / numel; a division by a host
    scalar multiplies by the float32 reciprocal; a host scalar factor is
    rounded to float32."""
    numel = spectrum.numel()
    mean = _f32(numel // spectrum.shape[2]) / _f32(numel)
    return (ctypes.c_float * 11)(
        *consts, mean, _f32(1.0 - drown), _f32(1) / _f32(-60.0),
        _f32(1) / _f32(10.0), _f32(1.0 / math.sqrt(3.0)), _f32(1e-12))


def _dense(shape, stride) -> bool:
    """Whether a tensor of ``shape`` and ``stride`` covers its memory once:
    its strides, in order, are those of some permutation of it made
    contiguous."""
    if 0 in shape:
        return True
    expect = 1
    for st, size in sorted((st, size) for st, size in zip(stride, shape)
                           if size != 1):
        if st != expect:
            return False
        expect *= size
    return True


def _check(model, spectrum):
    if spectrum.device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {spectrum.device}")
    if spectrum.dtype != torch.float32 or model.compute_dtype != torch.float32:
        raise TypeError("the psycho/quantize kernel takes float32 spectra of "
                        f"a float32 model, got {spectrum.dtype} and "
                        f"{model.compute_dtype}")
    if model.bark_precision not in PRECISIONS:
        raise ValueError("the kernel's Bark products are float32: "
                         f"bark_precision must be one of {PRECISIONS}, got "
                         f"{model.bark_precision!r}")
    if spectrum.dim() != 4 or spectrum.shape[2] != model.filter_bands_n:
        raise ValueError("spectrum must be [batches, frames, "
                         f"{model.filter_bands_n}, channels], got "
                         f"{tuple(spectrum.shape)}")
    if spectrum.requires_grad:
        raise NotImplementedError(
            "the psycho/quantize kernel has no backward; pass a spectrum "
            "that does not require grad"
        )
    if not _dense(spectrum.shape, spectrum.stride()):
        raise ValueError("the spectrum must be dense (no gaps, no overlaps): "
                         f"strides {spectrum.stride()}")
    if spectrum.stride(2) != 1:
        raise ValueError("the bins of a row must be contiguous (as "
                         f"MDCT.transform returns them): strides "
                         f"{spectrum.stride()}")
    if spectrum.shape[2] % 4 or spectrum.data_ptr() % 16:
        raise ValueError("every row must start 16-byte aligned: rows of a "
                         "multiple of 4 bins from an aligned first element, "
                         f"got {spectrum.shape[2]} bins from "
                         f"{spectrum.data_ptr():#x}")
    if model.W.device != spectrum.device:
        raise ValueError(f"the model is on {model.W.device}, the spectrum on "
                         f"{spectrum.device}")


@span("psycho.fused")
def psycho_quantize(model, spectrum, drown=0.0, encode: bool = False):
    """The masking threshold of ``spectrum`` [B, frames, N, C] under the
    psychoacoustic ``model``, its step sizes and its codes, in one kernel
    launch.

    :return: with ``encode``, (codes int32, step sizes, threshold) as
        ``quantize.quantize`` and ``global_masking_threshold`` give them;
        else the dequantized spectrum. Every output has the spectrum's
        shape and strides.
    """
    if spectrum.device.type == "cpu":
        return psycho_quantize_reference(model, spectrum, drown, encode)
    _check(model, spectrum)
    from audiocodec_tpu_torch.ops import _build

    lib = _build.library()
    tensors, consts = _tables(model)
    bin_bands = tensors[4].shape[1]
    dtypes = (torch.int32, torch.float32, torch.float32) if encode else (
        torch.float32,)
    outs = [torch.empty_strided(spectrum.shape, spectrum.stride(), dtype=d,
                                device=spectrum.device) for d in dtypes]
    first = outs[0]
    if spectrum.numel() == 0:
        return (*outs,) if encode else first
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    b, f, n, c = spectrum.shape
    sb, sf, _, sc = spectrum.stride()
    layout = (ctypes.c_longlong * 5)(f, c, sb, sf, sc)
    rc = lib.acx_psycho_quantize(
        spectrum.data_ptr(), *(o.data_ptr() for o in outs),
        *([None, None] if not encode else []), ptrs,
        _scalars(consts, spectrum, drown), layout, b * f * c, n,
        model.bark_bands_n, bin_bands, int(encode),
        torch.cuda.current_stream(spectrum.device).cuda_stream,
    )
    if rc:
        # 1, cudaErrorInvalidValue: more shared memory than a block has
        raise RuntimeError(
            f"psycho/quantize kernel launch failed: CUDA error {rc}"
            + (f" (a row of {n} bins and {model.bark_bands_n} bands needs "
               "more shared memory than a block has)" if rc == 1 else ""))
    psycho_quantize.launches += 1
    return (*outs,) if encode else first


def reset_launch_counts() -> None:
    psycho_quantize.launches = 0


def launch_counts() -> dict:
    return {"psycho_quantize": psycho_quantize.launches}


reset_launch_counts()
