"""Numerical debugging: NaN/Inf guards.

The reference's NaN story is the intensity floors of the psychoacoustic
model (reference psychoacoustic.py:206-208,311); those are kept, and this
module adds what TF eager gave its users for free: the ability to localize
a non-finite value when it does appear. torch has no checkify, so
:func:`checked` records device booleans (each floating leaf of the output
finite, each :func:`assert_finite` inside the call) and reads them on the
host once, in ``get()`` or ``throw()``.

    checked = debug.checked(codec.round_trip)
    err, out = checked(x, generator)
    err.throw()   # raises FloatingPointError naming the failed check
"""

from __future__ import annotations

import contextvars
import functools

import numpy as np
import torch
from torch import nn

# the checks of the innermost checked() call running in this context
_CHECKS = contextvars.ContextVar("audiocodec_tpu_torch_checks", default=None)


class Error:
    """The checks of one :func:`checked` call: (message, finite flag)."""

    def __init__(self, checks):
        self._checks = checks

    def get(self) -> str | None:
        """The first failed check's message, or None (one device sync)."""
        if not self._checks:
            return None
        device = self._checks[0][1].device
        ok = torch.stack([flag.to(device) for _, flag in self._checks]).cpu()
        failed = (~ok).nonzero()
        return self._checks[int(failed[0])][0] if len(failed) else None

    def throw(self) -> None:
        """Raise FloatingPointError if a check failed."""
        message = self.get()
        if message is not None:
            raise FloatingPointError(message)


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts, lists, tuples, NamedTuples and
    modules; paths as ``jax.tree_util.keystr`` writes them (``['key']``,
    ``[0]``, ``.field``; a module's tensors by their ``state_dict``
    names)."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield f"{path}.{name}", t
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for key, value in zip(tree._fields, tree):
            yield from _leaves(value, f"{path}.{key}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, tree


def checked(fn):
    """Wrap a pipeline function: the wrapper returns ``(error, out)``,
    where ``error`` holds whether every floating leaf of ``out`` is finite
    and every :func:`assert_finite` inside the call held. Call
    ``error.throw()`` to raise on failure."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        checks = []
        token = _CHECKS.set(checks)
        try:
            out = fn(*args, **kwargs)
        finally:
            _CHECKS.reset(token)
        for path, leaf in _leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                checks.append((f"non-finite value in output{path}",
                               torch.isfinite(leaf).all()))
        return Error(checks), out

    return run


def assert_finite(x, name: str = "tensor"):
    """Record a check that ``x`` is finite. Use inside custom pipelines; a
    no-op (nothing launched) unless run through :func:`checked`."""
    checks = _CHECKS.get()
    if checks is not None:
        checks.append((f"{name} contains NaN/Inf", torch.isfinite(x).all()))
    return x


def find_nonfinite(tree) -> dict:
    """Host-side sweep: leaf path -> count of non-finite values."""
    bad = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            n = int((~torch.isfinite(leaf)).sum())
        elif isinstance(leaf, np.ndarray) and np.issubdtype(
                leaf.dtype, np.floating):
            n = int((~np.isfinite(leaf)).sum())
        else:
            continue
        if n:
            bad[path] = n
    return bad
