"""Carry a JAX ``Codec``'s state into the port's ``Codec``.

The JAX package's ``Codec`` is a pytree; its leaves, handed over as numpy
arrays, become the port's buffers. The only change of layout is in the int8
kernel matrices: the TPU kernels took them permuted (the analysis matrix
with its upper half of rows reversed, the synthesis matrix with its upper
half of columns reversed, ``audiocodec_tpu/ops/pallas_mdct.py``
forward_params/inverse_params); the port's kernels take them unpermuted.
The radix design's residents carry over as they are (ops/radix.py): the
rotation vectors and the [N/2, N/2] factors are defined on the pairs
(f_n, f_{N-1-n}), which the TPU's swizzled layout and the port's natural
order both hold. Each leaf takes the dtype of the buffer it fills.

The kernels' operand forms and VJP residents have no JAX leaves: the port
rebuilds them from the forward residents it has set
(``MDCT.build_kernel_residents``), so that a converted codec's kernels and
backward pair with its forward. A calibrated psychoacoustic model carries
its fine-grid quiet floor; a calibrated flag without the floor, or the
floor without the flag, is refused. Model parameters and trained gains,
plain dicts of arrays in the JAX package, carry over by name
(:func:`params_from_arrays`), and an RVQ state by its keys
(:func:`rvq_state_from_arrays`).
"""

from __future__ import annotations

import numpy as np
import torch

from audiocodec_tpu_torch.codec import Codec

_MDCT_LEAVES = (
    "wa_r", "wb", "wc", "ffr", "p", "q", "r", "s_r",
    "dct_mat_fwd", "dct_mat_inv",
    "dense_fwd_cur", "dense_fwd_prev", "dense_inv_cur", "dense_inv_prev",
)
_PSYCHO_LEAVES = (
    "W", "W_inv", "spreading_matrix", "quiet_threshold_intensity",
    "bark_grid",
)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def unpermute_forward(m: np.ndarray) -> np.ndarray:
    """Undo the analysis permutation: rows h.. were stored reversed."""
    h = m.shape[0] // 2
    return np.concatenate([m[:h], m[h:][::-1]], axis=0)


def unpermute_inverse(m: np.ndarray) -> np.ndarray:
    """Undo the synthesis permutation: columns h.. were stored reversed."""
    h = m.shape[1] // 2
    return np.concatenate([m[:, :h], m[:, h:][:, ::-1]], axis=1)


def codec_from_arrays(leaves: dict, meta: dict, device="cuda") -> Codec:
    """Build the port's ``Codec`` from a JAX ``Codec``'s state.

    :param leaves: numpy arrays keyed "mdct.<field>" and "psycho.<field>"
        by the JAX dataclasses' field names: ``wa_r`` ... ``s_r``,
        ``dct_mat_fwd``, ``dct_mat_inv``, the ``dense_*`` matrices where the
        configuration has them, the kernel residents ``pfwd_mat``/
        ``pinv_mat`` at ``dct_precision="int8"`` and, with
        ``pfwd_rot``/``pinv_rot``, in the radix design, and ``W``,
        ``W_inv``, ``spreading_matrix``, ``quiet_threshold_intensity``,
        ``bark_grid`` and, for a calibrated model,
        ``quiet_threshold_freq_amp``.
    :param meta: the static fields: ``sample_rate``, ``filters_n``,
        ``bark_bands_n``, ``alpha``, ``window_type``, ``compute_dtype``
        (name), ``fast_bf16``, ``use_pallas`` and ``pallas_kernel``
        (resolved), ``dct_precision``, ``bark_precision``,
        ``pallas_int8_scale`` and the psychoacoustic model's ``calibrated``
        (False when absent).
    :param device: the card unless the caller asks for the CPU.
    :raises ValueError: if ``calibrated`` and the presence of
        ``psycho.quiet_threshold_freq_amp`` disagree.

    The kernels' operand forms and VJP residents are rebuilt from the
    leaves set here, through ``MDCT.build_kernel_residents`` (the helper the
    MDCT's constructor calls), not kept from the port's own coefficients.
    """
    calibrated = bool(meta.get("calibrated", False))
    floor = leaves.get("psycho.quiet_threshold_freq_amp")
    if calibrated != (floor is not None):
        raise ValueError(
            f"meta says calibrated={calibrated} but the leaves "
            f"{'lack' if calibrated else 'hold'} the calibrated quiet floor "
            "psycho.quiet_threshold_freq_amp"
        )
    codec = Codec.create(
        meta["sample_rate"],
        filters_n=meta["filters_n"],
        bark_bands_n=meta["bark_bands_n"],
        alpha=meta["alpha"],
        window_type=meta["window_type"],
        compute_dtype=meta["compute_dtype"],
        fast_bf16=meta["fast_bf16"],
        use_kernel=meta["use_pallas"],
        dct_precision=meta["dct_precision"],
        bark_precision=meta["bark_precision"],
        kernel_design=meta["pallas_kernel"],
        calibrated=calibrated,
        device=device,
    )
    mdct, psycho = codec.mdct, codec.psycho
    arrays = {}
    for name in _MDCT_LEAVES:
        if getattr(mdct, name) is not None:
            arrays[(mdct, name)] = leaves[f"mdct.{name}"]
    if mdct.kernel_q_fwd is not None:
        arrays[(mdct, "kernel_q_fwd")] = unpermute_forward(
            leaves["mdct.pfwd_mat"]
        )
    if mdct.kernel_q_inv is not None:
        arrays[(mdct, "kernel_q_inv")] = unpermute_inverse(
            leaves["mdct.pinv_mat"]
        )
    for d in ("fwd", "inv"):
        if getattr(mdct, f"radix_rot_{d}") is not None:
            arrays[(mdct, f"radix_rot_{d}")] = leaves[f"mdct.p{d}_rot"]
            arrays[(mdct, f"radix_mat_{d}")] = leaves[f"mdct.p{d}_mat"]
    floor_leaf = ("quiet_threshold_freq_amp",) if calibrated else ()
    for name in _PSYCHO_LEAVES + floor_leaf:
        arrays[(psycho, name)] = leaves[f"psycho.{name}"]
    for (module, name), arr in arrays.items():
        dtype = getattr(module, name).dtype
        setattr(module, name, _tensor(arr, device).to(dtype))
    if meta.get("pallas_int8_scale") is not None:
        mdct.int8_scale = tuple(meta["pallas_int8_scale"])
    mdct.build_kernel_residents()
    return codec


def params_from_arrays(arrays: dict, device="cuda") -> dict:
    """A JAX params dict (numpy arrays, bf16 as ml_dtypes arrays) -> the
    port's: the same names and layouts (``[fan_in, fan_out]`` weights), as
    leaf tensors that require grad. Serves ``models.spectral_ae``,
    ``models.post_filter`` and the gains of ``parallel.train``
    (``{"gains": ...}``).

    :param device: the card unless the caller asks for the CPU.
    """
    return {name: _tensor(arr, device).requires_grad_()
            for name, arr in arrays.items()}


def rvq_state_from_arrays(arrays: dict, device="cuda") -> dict:
    """A JAX RVQ state (``codebooks`` [S, K, D], ``ema_count`` [S, K],
    ``ema_sum`` [S, K, D] as numpy arrays) -> the port's
    (``models.rvq``): the same keys, tensors that do not require grad
    (the codebooks learn by the EMA update, not by gradients).

    :param device: the card unless the caller asks for the CPU.
    """
    return {name: _tensor(arrays[name], device)
            for name in ("codebooks", "ema_count", "ema_sum")}
