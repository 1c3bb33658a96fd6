"""``rvq.ema_ms``: host ms a step inside the program's ``rvq.ema`` span
(the EMA k-means step of every stage after the optimizer's; it holds the
waits of ``torch.bincount``, which reads its input's largest value back on
the card), in the traced window."""


def read(t):
    key = t.summary["keys"].get("rvq.ema")
    if not key or not key[0]:
        return None
    count, _, total_us = key
    return total_us / count / 1e3
