"""Checkpoints of codecs, model and optimizer state, and streams
(counterpart of ``audiocodec_tpu/utils/serialization.py``).

A codec is a deterministic precompute from its constructor arguments, so
its checkpoint is those arguments as JSON, the same file as the JAX
package's both ways: ``pallas_kernel`` names the kernel design, and the
``use_pallas`` a codec was saved with (resolved on the machine that saved
it) is a perf knob, so a loaded codec picks its kernels on this machine
(``use_kernel="auto"``).

Trees of tensors (model parameters, RVQ state, a ``torch.optim``
``state_dict()``) are a flat ``.npz`` of leaves in ``jax.tree_util``'s
order (dict keys sorted, None no leaf), bfloat16 as uint16 bits, so a
file the JAX package's ``save_pytree`` wrote from the same parameters
loads into the port's template and the port's files load in JAX. No
pickle: the structure comes from a template or, in the port's own files,
from a JSON member beside the leaves. Optimizer states do not cross
packages (optax's and ``torch.optim``'s differ), nor do stream carries.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from audiocodec_tpu_torch.codec import Codec

_DTYPE_NAMES = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16}
_SCALARS = {"bool": bool, "int": int, "float": float}


def codec_config(codec: Codec) -> dict:
    """The constructor arguments that fully determine a codec, under the
    JAX package's names (``calibrated`` only where it is set: the JAX
    ``Codec.create`` has no such argument)."""
    mdct, psycho = codec.mdct, codec.psycho
    cfg = {
        "sample_rate": psycho.sample_rate,
        "filters_n": mdct.filters_n,
        "bark_bands_n": psycho.bark_bands_n,
        "alpha": psycho.alpha,
        "window_type": mdct.window_type,
        "compute_dtype": str(mdct.compute_dtype).removeprefix("torch."),
        "fast_bf16": mdct.fast_bf16,
        "use_pallas": mdct.use_kernel,
        "dct_precision": mdct.dct_precision,
        "bark_precision": psycho.bark_precision,
        "pallas_kernel": mdct.kernel_design,
        "sidecar_grid": codec.sidecar_grid,
    }
    if psycho.calibrated:
        cfg["calibrated"] = True
    return cfg


def save_codec(path: str, codec: Codec) -> None:
    with open(path, "w") as f:
        json.dump(codec_config(codec), f, indent=2)


def load_codec(path: str, device="cuda") -> Codec:
    """Rebuild the codec a :func:`save_codec` (or the JAX package's) file
    names, on ``device``: the card unless the caller asks for the CPU."""
    with open(path) as f:
        cfg = json.load(f)
    dtype = _DTYPE_NAMES[cfg.pop("compute_dtype")]
    cfg.setdefault("dct_precision", "highest")  # older checkpoints
    # Configs saved before bark_precision existed were written by codecs
    # that always ran the Bark matmuls at highest: defaulting to None
    # (follow dct_precision) would rebuild other thresholds and step sizes
    # than those of the checkpoint's bitstreams.
    cfg.setdefault("bark_precision", "highest")
    # Configs saved before the radix design existed used the single-matmul
    # design; a perf knob, never quantization-affecting.
    cfg.setdefault("pallas_kernel", "mono")
    # Configs saved before sidecar quantization existed shipped raw
    # bfloat16 sidecars; the new grid would change their step sizes.
    cfg.setdefault("sidecar_grid", 0)
    # The saved kernel choice was resolved where it was saved; it never
    # affects quantization, so this machine picks its own.
    cfg.pop("use_pallas", None)
    return Codec.create(compute_dtype=dtype, use_kernel="auto",
                        kernel_design=cfg.pop("pallas_kernel"),
                        device=device, **cfg)


def _flatten(tree, leaves: list):
    """The leaves of ``tree`` appended to ``leaves`` in jax.tree_util's
    order (by sorted key); returns the tree's structure as JSON-able data,
    each dict's items in its own order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        subs = {k: _flatten(tree[k], leaves) for k in sorted(tree)}
        return {"dict": [[k, subs[k]] for k in tree]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(t, leaves) for t in tree]}
    if isinstance(tree, torch.Tensor):
        kind = "tensor"
    elif isinstance(tree, (bool, int, float)):
        kind = type(tree).__name__
    else:
        raise TypeError(f"no checkpoint leaf of type {type(tree).__name__}")
    leaves.append(tree)
    return {"leaf": kind}


def _by_key(items):
    return sorted(items, key=lambda item: item[0])


def _unflatten(structure, leaves):
    """``structure`` (of :func:`_flatten`) filled from the iterator
    ``leaves``."""
    if structure is None:
        return None
    (kind, body), = structure.items()
    if kind == "dict":  # leaves by sorted key, the dict in its own order
        made = {k: _unflatten(s, leaves) for k, s in _by_key(body)}
        return {k: made[k] for k, _ in body}
    if kind in ("list", "tuple"):
        items = [_unflatten(s, leaves) for s in body]
        return items if kind == "list" else tuple(items)
    return next(leaves)


def _to_numpy(leaf):
    """(array, dtype name) of a leaf; bfloat16 as its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, arr.dtype.name
    t = leaf.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_pytree(path: str, tree) -> None:
    """Persist a tree (nested dict, list, tuple; None is no leaf) of tensors
    and Python scalars as a flat .npz: ``count``, then ``leaf_i`` and its
    dtype name ``dtype_i`` in jax.tree_util's order, and the port's own
    ``structure`` (JSON) that :func:`load_pytree` reads without a
    template."""
    leaves = []
    structure = _flatten(tree, leaves)
    payload = {
        "count": np.asarray([len(leaves)], dtype=np.int64),
        "structure": np.frombuffer(json.dumps(structure).encode(),
                                   dtype=np.uint8),
    }
    for i, leaf in enumerate(leaves):
        arr, name = _to_numpy(leaf)
        payload[f"dtype_{i}"] = np.frombuffer(name.encode(), dtype=np.uint8)
        payload[f"leaf_{i}"] = arr
    np.savez(path, **payload)


def load_pytree(path: str, template=None, device="cpu"):
    """Rebuild a tree saved by :func:`save_pytree` (or the JAX package's).

    :param template: a tree of the saved structure (e.g. ``init_params``
        of the architecture): its containers are rebuilt, each tensor leaf
        lands on the template leaf's device and requires grad if it does;
        shapes and dtypes come from the file. None reads the structure the
        port saved beside the leaves (an optimizer's ``state_dict()``,
        whose lazily made state a fresh optimizer lacks), tensors on
        ``device``.
    :raises ValueError: when the file's leaf count does not match the
        template (the checkpoint of another architecture), or without a
        template on a file that holds no structure.
    """
    with np.load(path) as z:
        n = int(z["count"][0])
        if template is None:
            if "structure" not in z.files:
                raise ValueError(
                    f"{path} holds no structure (the JAX package wrote "
                    "it): pass a template")
            structure = json.loads(bytes(z["structure"]).decode())
            targets = [None] * n
        else:
            targets = []
            structure = _flatten(template, targets)
            if n != len(targets):
                raise ValueError(
                    f"checkpoint has {n} leaves but the template has "
                    f"{len(targets)} — wrong architecture config for this "
                    "checkpoint"
                )
        kinds = []
        _kinds(structure, kinds)
        leaves = []
        for i, (kind, target) in enumerate(zip(kinds, targets)):
            name = bytes(z[f"dtype_{i}"]).decode()
            arr = z[f"leaf_{i}"]
            if kind in _SCALARS:
                leaves.append(_SCALARS[kind](arr.item()))
                continue
            t = _tensor(arr, name)
            if target is None:
                leaves.append(t.to(device))
            else:
                t = t.to(target.device)
                leaves.append(t.requires_grad_() if target.requires_grad
                              else t)
    return _unflatten(structure, iter(leaves))


def _kinds(structure, out: list) -> None:
    """The leaf kinds of ``structure`` in leaf order."""
    if structure is None:
        return
    (kind, body), = structure.items()
    if kind == "leaf":
        out.append(body)
    elif kind == "dict":
        for _, s in _by_key(body):
            _kinds(s, out)
    else:
        for s in body:
            _kinds(s, out)


def save_stream_state(path: str, enc_carry, dec_carry=None, offset=0) -> None:
    """Persist a stream's carries (``streaming``: (carry, offset) is the
    whole resumable state at a chunk boundary), each with its dtype."""
    payload = {"offset": np.asarray([offset], dtype=np.int64)}
    for name, carry in (("enc", enc_carry), ("dec", dec_carry)):
        arr, dtype = ((np.zeros(0, np.float32), "float32") if carry is None
                      else _to_numpy(carry))
        payload[f"{name}_carry"] = arr
        payload[f"{name}_dtype"] = np.frombuffer(dtype.encode(),
                                                 dtype=np.uint8)
    np.savez(path, **payload)


def load_stream_state(path: str, device="cuda"):
    """(encoder carry, decoder carry or None, offset) of
    :func:`save_stream_state`, the carries on ``device``: the card unless
    the caller asks for the CPU."""
    with np.load(path) as z:
        enc, dec = (_tensor(z[f"{k}_carry"],
                            bytes(z[f"{k}_dtype"]).decode()).to(device)
                    for k in ("enc", "dec"))
        offset = int(z["offset"][0])
    return enc, (dec if dec.numel() else None), offset
