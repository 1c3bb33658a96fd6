"""``serve.batch_size``: requests a batch group, from the server's 'Q'
counters before and after the window (``encode_requests``,
``encode_batches``)."""


def read(t):
    before, after = t.counters.get("before"), t.counters.get("after")
    if not before or not after:
        return None
    batches = after["encode_batches"] - before["encode_batches"]
    if batches <= 0:
        return None
    return (after["encode_requests"] - before["encode_requests"]) / batches
