"""``stream.pack_ms``: self ms a chunk of the program's ``stream.pack``
span (the chunk's Rice coding and write), in the traced window."""


def read(t):
    key = t.summary["keys"].get("stream.pack")
    if not key or not key[0]:
        return None
    count, self_us, _ = key
    return self_us / count / 1e3
