"""Observability: profiler traces, spans and device timing.

The reference's only tracing hook is a single tf.name_scope
(psychoacoustic.py:138). Here the port's host stages run under
:func:`span` (a ``torch.profiler`` label, and an NVTX range once CUDA is
initialised), and this module adds the user-facing entry points: a trace
context manager writing a chrome trace, a best-of timer of one blocking
call (:func:`time_fn`), and the device time of a call: the mean over
calls queued back to back (:func:`cuda_ms`) and the union of its kernels'
spans in a trace (:func:`covered`, :func:`device_busy_ms`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


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


@contextlib.contextmanager
def span(name: str):
    """Label the enclosed host work ``name`` in a ``torch.profiler`` trace
    and, once CUDA is initialised, as an NVTX range. Changes nothing that
    computes."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
    ``torch.profiler`` trace."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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
