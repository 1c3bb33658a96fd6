"""CUDA graphs of steps that repeat: where they replay, the one switch that
turns them all off, and a keyed cache of them, least recently used first
out.

Two steps replay from such a cache: the .acs encoder's chunk step
(``io/stream_container._StepGraph``, a cache a codec) and the RVQ codec's
train step (``parallel/train.LossGraph``, a cache a step closure). A step
replays only on a tensor of :data:`DEVICE`'s type while :data:`ENABLED`
holds; every other step runs op by op. A replay runs the kernels its
capture recorded, never a kernel wrapper swapped in since: a check that
swaps wrappers sets :data:`ENABLED` to False.
"""

from __future__ import annotations

import collections

import torch

# the device type whose steps replay (the CPU runs every step op by op)
DEVICE = "cuda"
# False runs every step op by op, on every device
ENABLED = True


def engaged(x: torch.Tensor) -> bool:
    """Whether a step on ``x``'s device may replay a graph."""
    return ENABLED and x.device.type == DEVICE


class Cache:
    """Graphs (or whatever a step keeps with one) by key, the least
    recently used dropped beyond a count of slots."""

    def __init__(self):
        self._graphs = collections.OrderedDict()

    def __iter__(self):
        """The keys, least recently used first."""
        return iter(self._graphs)

    def values(self):
        return self._graphs.values()

    def get(self, key):
        """The graph of ``key``, now the most recently used, or None."""
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
        return graph

    def put(self, key, graph, slots: int) -> None:
        """Keep ``graph`` under ``key``, and no more than ``slots``
        graphs."""
        self._graphs[key] = graph
        while len(self._graphs) > slots:
            self._graphs.popitem(last=False)
