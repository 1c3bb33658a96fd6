"""``codec.host_ms``: host ms a call inside the program's seven codec
stage spans (``mdct.analysis``, ``mdct.synthesis``, ``psycho.tonality``,
``psycho.masking``, ``psycho.threshold``, ``quantize.quantize``,
``quantize.dequantize``; none runs inside another, so their totals add up
without counting anything twice), in the traced window: the host's
dispatch of the codec's work, the profiler's cost of each op included."""

STAGES = ("mdct.analysis", "mdct.synthesis", "psycho.tonality",
          "psycho.masking", "psycho.threshold", "quantize.quantize",
          "quantize.dequantize")


def read(t):
    if not t.ops or not t.summary["device"]:
        return None
    keys = t.summary["keys"]
    total_us = sum(keys[s][2] for s in STAGES if s in keys)
    if not total_us:
        return None
    return total_us / t.ops / 1e3
