"""``stream.step_ms``: host ms a chunk of the program's ``stream.step``
span (the enqueue of the chunk's device step), in the traced window."""


def read(t):
    key = t.summary["keys"].get("stream.step")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
