"""``ladder.members_ms``: host ms a chunk of the program's
``stream.members`` span (the coding of the ladder's members inside the
writer's ``append``), in the traced window."""


def read(t):
    if not t.summary["device"]:
        return None
    key = t.summary["keys"].get("stream.members")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
