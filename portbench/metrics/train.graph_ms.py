"""``train.graph_ms``: host ms a step inside the program's ``train.graph``
span (a train step replayed from a CUDA graph: the loads of the batch and
the codebooks, the graph's launch and the copy of the loss), in the traced
window. A program whose step replays no graph has no such span, and the
reading is None."""


def read(t):
    key = t.summary["keys"].get("train.graph")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
