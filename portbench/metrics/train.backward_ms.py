"""``train.backward_ms``: host ms a step inside the program's
``train.backward`` span (autograd's backward of the loss: the synthesis
VJP, the dense layers' gradients, enqueued), in the traced window."""


def read(t):
    key = t.summary["keys"].get("train.backward")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
