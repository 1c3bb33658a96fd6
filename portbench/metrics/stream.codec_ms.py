"""``stream.codec_ms``: host ms a chunk inside the program's codec stage
spans (``codec.host_ms``'s seven) that lie within a ``stream.step`` span,
over the count of ``stream.step`` spans, in the traced window. The flush
frame's stages, outside every step, are not counted."""

import bisect


def read(t):
    if not t.summary["device"]:
        return None
    stages = set(t.metric("codec.host_ms").STAGES)
    steps = sorted((s, e) for name, s, e in t.summary["host"]
                   if name == "stream.step")
    if not steps:
        return None
    starts = [s for s, _ in steps]
    inside = []
    for name, s, e in t.summary["host"]:
        if name not in stages:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= steps[i][1]:
            inside.append(e - s)
    if not inside:
        return None  # a program without the stage spans
    return sum(inside) / len(steps) / 1e3
