"""``serve.pack_ms``: the server's pack seconds a request, from its 'Q'
stage seconds ``t_pack_s`` and ``encode_requests`` before and after the
window."""


def read(t):
    before, after = t.counters.get("before"), t.counters.get("after")
    if not before or not after:
        return None
    requests = after["encode_requests"] - before["encode_requests"]
    if requests <= 0:
        return None
    pack = after.get("t_pack_s", 0.0) - before.get("t_pack_s", 0.0)
    return 1e3 * pack / requests
