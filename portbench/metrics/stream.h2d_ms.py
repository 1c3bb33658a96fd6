"""``stream.h2d_ms``: ms a chunk of the program's ``stream.h2d`` span
(the chunk's copy from host memory to the card, inside ``stream.step``),
in the traced window."""


def read(t):
    if not t.summary["device"]:
        return None
    key = t.summary["keys"].get("stream.h2d")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
