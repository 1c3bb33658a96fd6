"""``rate.trials_ms``: host ms a stream inside the program's
``rate.trials`` span (the rate search's batched quantize of every trial row
on the card and the trials' copy back to the host), over the ``rate.cbr``
spans (one a CBR stream encode) in the traced window. A program without
these spans reads None."""


def read(t):
    streams = t.summary["keys"].get("rate.cbr")
    key = t.summary["keys"].get("rate.trials")
    if not streams or not streams[0] or not key or not key[0]:
        return None
    return key[2] / streams[0] / 1e3
