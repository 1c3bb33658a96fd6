"""Observability: profiler traces, spans and device timing.

The reference's only tracing hook is a single tf.name_scope
(psychoacoustic.py:138). Here the port's host stages run under
:func:`span` (a ``torch.profiler`` label while a profiler records, and an
NVTX range once CUDA is initialised): the codec's seven stages
(``mdct.analysis``, ``mdct.synthesis``, ``psycho.tonality``,
``psycho.masking``, ``psycho.threshold``, ``quantize.quantize``,
``quantize.dequantize``; none runs inside another), the feature
ladder's encode stages (``ladder.ms``, ``ladder.tmask``, ``ladder.bs``,
``ladder.tns``, ``ladder.nf``, ``ladder.bwe``, ``ladder.intensity``; each
entered only when its feature is on, none inside another or inside a
codec stage), the stream container's ``stream.*`` and the rate search's
``rate.*``. This module
adds the user-facing entry points: a trace context manager writing a
chrome trace, a best-of timer of one blocking call (:func:`time_fn`), and
the device time of a call: the mean over calls queued back to back
(:func:`cuda_ms`) and the union of its kernels' spans in a trace
(:func:`covered`, :func:`device_busy_ms`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# whether a torch profiler records on this thread (~0.1 us)
_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block: CPU
    activity, plus CUDA activity when CUDA is initialised. Writes
    ``trace-<pid>-<ns>.json`` (chrome trace format: chrome://tracing,
    Perfetto) into ``log_dir``; yields the profiler.

        with trace("/tmp/codec-trace"): codec.round_trip_fast(x, 0)
    """
    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class span:
    """Label the enclosed host work ``name`` in a ``torch.profiler`` trace
    and, once CUDA is initialised, as an NVTX range. Changes nothing that
    computes. ``with span(name):`` labels a block; ``@span(name)`` labels
    every call of a function, its whole body.

    Free when nothing records: the profiler's label (a dispatcher op and a
    ``RecordFunction`` each time) is entered only while a torch profiler
    records on this thread, where it is the same label, nesting and clock
    as always. The NVTX range, Nsight's route, is pushed whenever CUDA is
    initialised."""

    __slots__ = ("name", "_label", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._label = None
        if _profiler_enabled():
            self._label = record_function(self.name)
            self._label.__enter__()

    def __exit__(self, *exc):
        try:
            if self._label is not None:
                self._label.__exit__(*exc)
        finally:
            if self._nvtx:
                torch.cuda.nvtx.range_pop()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def labelled(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return labelled


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _call_ms(fn, calls: int, blocking: bool) -> list:
    """ms of each of ``calls`` calls of ``fn()`` between a CUDA event
    recorded before it and one after. ``blocking``: each call starts on an
    idle device after the previous one has ended, so its time holds the
    host's enqueue of its work; else the calls queue back to back and one
    call's end event is the next one's start."""
    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    torch.cuda.synchronize()
    pairs, start = [], event()
    for _ in range(calls):
        fn()
        end = event()
        pairs.append((start, end))
        if blocking:
            end.synchronize()
            start = event()
        else:
            start = end
    pairs[-1][1].synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def time_fn(fn, *args, iters: int = 10, **kwargs) -> float:
    """Best-of-``iters`` seconds of one blocking call of
    ``fn(*args, **kwargs)`` after one warm call: the call from its start
    to its results, the host's enqueue of its work included. When the
    output's first tensor is on the card, each call runs on an idle device
    between two CUDA events; otherwise the host clock times it."""
    first = _first_tensor(fn(*args, **kwargs))
    if first is not None and first.is_cuda:
        return min(_call_ms(lambda: fn(*args, **kwargs), iters,
                            blocking=True)) / 1e3
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return best


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms a call of ``fn()`` over ``iters`` calls queued back to back
    on the card, after ``warmup`` calls: the steady rate of a loop, where
    the device's queue hides the host's enqueue."""
    for _ in range(warmup):
        fn()
    return sum(_call_ms(fn, iters, blocking=False)) / iters


def covered(spans):
    """(time some span covers, the spans' whole extent) of
    [(start, end)]."""
    spans = sorted(spans)
    busy, reach = 0.0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy, max(end for _, end in spans) - spans[0][0]


def kernel_events(prof) -> list:
    """The device's events (its kernels and copies) in a
    ``torch.profiler`` trace. A host label (a :func:`span`, a
    ``record_function``) also gets a row on the device's timeline, from
    its first kernel's start to its last one's end: that row is no device
    work, and is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    labels = {e.name for e in events if e.device_type != cuda
              and getattr(e, "is_user_annotation", False)}
    return [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in labels]


def device_busy_ms(fn, calls: int = 10) -> float:
    """Device busy ms a call of ``fn()``: the union of its kernels' spans
    in a ``torch.profiler`` trace of ``calls`` calls, after one warm
    call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end)
             for e in kernel_events(prof)]
    return covered(spans)[0] / 1e3 / calls
