"""``device.idle.serve``: ``device.idle`` in the server's process, over
the window of the served traffic."""

from portbench.lib import trace


def read(t):
    return trace.idle_percent(t.summary)
