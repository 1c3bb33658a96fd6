"""``train.forward_ms``: host ms a step inside the program's
``train.forward`` span (the loss: the codec chain, the autoencoder and the
RVQ's search enqueued, with their waits), in the traced window."""


def read(t):
    key = t.summary["keys"].get("train.forward")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
