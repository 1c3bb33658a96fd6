"""The traced window and what the per-layer readers take from it.

A traced run records CPU and CUDA activity with ``torch.profiler`` over
the window, inside a ``portbench.window`` label whose span is the window
on the profiler's clock. :func:`summarize` keeps what the readers need as
plain data (so a child process can hand it over as JSON): every device
event (kernels, copies, sets) with its span, each host name's count, self
and total time, and the host spans long enough to name an idle gap. The
arithmetic of the device's busy time (``covered``) is a copy of the
program's ``utils.profiling.covered``.
"""

from __future__ import annotations

import contextlib
import re

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
HOST_SPAN_US = 50.0  # shorter host spans are not kept for naming gaps
TOP = 10


@contextlib.contextmanager
def traced(device):
    """Profile the enclosed block; yields a dict that holds the summary
    once the block has ended (the device synchronised first)."""
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    out = {}
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield out
            if cuda:
                torch.cuda.synchronize()
    out.update(summarize(prof))


def short_name(name: str) -> str:
    """A device function's name without its return type, namespace
    wrappers and arguments."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return name.split("(")[0][:120]


def summarize(prof) -> dict:
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # a host label also shows on the device's timeline: it is no device work
    labels = {e.name for e in events if e.device_type != cuda
              and getattr(e, "is_user_annotation", False)}
    device, hosts, keys, window = [], [], {}, None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in labels):
                device.append((short_name(e.name), start, end))
            continue
        if e.name == WINDOW:
            window = (start, end)
        k = keys.setdefault(e.name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += e.self_cpu_time_total
        k[2] += e.cpu_time_total
        if end - start >= HOST_SPAN_US or getattr(e, "is_user_annotation",
                                                    False):
            hosts.append((e.name, start, end))
    return {"device": device, "host": hosts, "keys": keys, "window": window}


def covered(spans):
    """(time some span covers, the spans' whole extent) of [(start, end)]."""
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


def device_spans(summary: dict):
    """The device events' spans clipped to the window."""
    lo, hi = summary["window"]
    return [(max(s, lo), min(e, hi)) for _, s, e in summary["device"]
            if e > lo and s < hi]


def busy_us(summary: dict) -> float:
    spans = device_spans(summary)
    return covered(spans)[0] if spans else 0.0


def window_us(summary: dict) -> float:
    lo, hi = summary["window"]
    return hi - lo


def idle_percent(summary: dict):
    """Share of the window with nothing on the device, or None when no
    device event was recorded."""
    busy = busy_us(summary)
    if not busy:
        return None
    return 100.0 * (1.0 - busy / window_us(summary))


def breakdown(summary: dict) -> dict:
    """The device functions that took most time, and the longest idle
    gaps, each named by the host span that overlaps it most (the
    innermost of equals)."""
    per = {}
    for name, s, e in summary["device"]:
        per[name] = per.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    lo, hi = summary["window"]
    gaps, reach = [], lo
    for s, e in sorted(device_spans(summary)):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for g0, g1 in gaps:
        best, label, best_len = 0.0, "idle host", float("inf")
        for name, s, e in summary["host"]:
            if name == WINDOW:
                continue
            ov = min(e, g1) - max(s, g0)
            # equal overlaps: the shorter (inner) span names the gap
            if ov > best or (ov == best > 0 and e - s < best_len):
                best, label, best_len = ov, name, e - s
        named.append([label, (g1 - g0) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
