"""``device.idle.host``: ``device.idle`` in the cells whose pace the
host sets (they report ``audio_s_per_s.host``)."""

from portbench.lib import trace


def read(t):
    return trace.idle_percent(t.summary)
