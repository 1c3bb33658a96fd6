"""``rate.passes``: stream encodes a CBR stream (its corrective passes and
a best-of re-encode included), from the program's ``rate.counts()`` before
and after the window (``passes``) over the streams the window completed. A
program without the counters reads None."""


def read(t):
    before, after = t.counters.get("before"), t.counters.get("after")
    streams = t.counters.get("streams")
    if not before or not after or not streams:
        return None
    return (after["passes"] - before["passes"]) / streams
