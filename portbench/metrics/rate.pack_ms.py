"""``rate.pack_ms``: host ms a stream inside the program's ``rate.pack``
span (the rate search's host packs of its trials and its final packs, in a
thread pool), over the ``rate.cbr`` spans (one a CBR stream encode) in the
traced window. A program without these spans reads None."""


def read(t):
    streams = t.summary["keys"].get("rate.cbr")
    key = t.summary["keys"].get("rate.pack")
    if not streams or not streams[0] or not key or not key[0]:
        return None
    return key[2] / streams[0] / 1e3
