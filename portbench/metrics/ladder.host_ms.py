"""``ladder.host_ms``: host ms a chunk inside the program's seven feature
ladder spans (``ladder.ms``, ``ladder.tmask``, ``ladder.bs``,
``ladder.tns``, ``ladder.nf``, ``ladder.bwe``, ``ladder.intensity``; none
runs inside another or inside a codec stage span) that lie within a
``stream.step`` span, over the count of ``stream.step`` spans, in the
traced window. The flush frame's stages, outside every step, are not
counted."""

import bisect

STAGES = ("ladder.ms", "ladder.tmask", "ladder.bs", "ladder.tns",
          "ladder.nf", "ladder.bwe", "ladder.intensity")


def per_stage(t):
    """{stage: host us inside the steps}, and the count of steps; None
    where the window has no device event or no step."""
    if not t.summary["device"]:
        return None
    steps = sorted((s, e) for name, s, e in t.summary["host"]
                   if name == "stream.step")
    if not steps:
        return None
    starts = [s for s, _ in steps]
    inside = {}
    for name, s, e in t.summary["host"]:
        if name not in STAGES:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= steps[i][1]:
            inside[name] = inside.get(name, 0.0) + e - s
    return inside, len(steps)


def read(t):
    found = per_stage(t)
    if not found or not found[0]:
        return None  # a program without the ladder's spans
    inside, steps = found
    return sum(inside.values()) / steps / 1e3
