"""``device.idle``: share of the traced window with no kernel or copy on
the card (``lib/trace.py``'s copy of ``covered``), in the cells whose pace
the card sets (they report ``audio_s_per_s``)."""

from portbench.lib import trace


def read(t):
    return trace.idle_percent(t.summary)
