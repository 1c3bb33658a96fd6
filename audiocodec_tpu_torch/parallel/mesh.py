"""Device meshes of one process (counterpart of
``audiocodec_tpu/parallel/mesh.py``).

A mesh is a (dp, sp) grid of this process's ``torch.device``s:

* ``dp`` (data / clip parallelism) splits a batch of clips into contiguous
  shards, one a device; nothing crosses devices but the gather of the
  results.
* ``sp`` (sequence parallelism) would split the samples axis with a
  one-block halo. It needs ``torch.distributed`` and is not ported: a mesh
  with ``sp`` > 1 is refused.

JAX's ``NamedSharding`` layouts have no counterpart: :meth:`Mesh.split`
places a host batch's shards on their devices and :meth:`Mesh.gather`
brings results back to the first device. One process needs no process
group, so no ``torch.distributed`` ``DeviceMesh`` is built.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of devices, ``devices[i][j]`` at dp row i."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def dp_devices(self) -> list:
        """The device of each dp row."""
        return [row[0] for row in self.devices]

    def split(self, batch: torch.Tensor) -> list:
        """``batch`` [B, ...] -> its dp shards, contiguous rows of B / dp,
        each on its device (copied without blocking the host where the
        batch is in pinned memory)."""
        dp = self.shape["dp"]
        if batch.shape[0] % dp:
            raise ValueError(
                f"batch of {batch.shape[0]} does not split over dp={dp}; "
                "pad it first (pad_batch_to)")
        rows = batch.shape[0] // dp
        return [batch[i * rows:(i + 1) * rows].to(dev, non_blocking=True)
                for i, dev in enumerate(self.dp_devices)]

    def gather(self, shards) -> torch.Tensor:
        """Per-dp-row results -> one tensor on the first device, in row
        order."""
        first = self.dp_devices[0]
        if len(shards) == 1:
            return shards[0]
        return torch.cat([s.to(first) for s in shards])


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over this process's devices.

    :param n_devices: devices to use (default: all of ``devices``).
    :param dp: data-parallel extent (default: n_devices // sp).
    :param sp: sequence-parallel extent; only 1 is ported.
    :param devices: a list of ``torch.device`` (default: every visible CUDA
        device; the tests pass ``[torch.device("cpu")] * 2``).
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "no CUDA device: pass devices= for a mesh of other devices")
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"n_devices={n_devices} > the {len(devices)} devices given")
    devices = devices[:n_devices]
    if dp is None:
        if n_devices % sp != 0:
            raise ValueError(f"n_devices={n_devices} not divisible by sp={sp}")
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp={dp * sp} != n_devices={n_devices}")
    if sp != 1:
        raise ValueError(
            f"sp={sp}: sequence parallelism is not ported; it comes with "
            "torch.distributed in the next slice of ROADMAP §1.9")
    return Mesh(tuple((d,) for d in devices))


def pad_batch_to(n: int, multiple: int) -> int:
    """Smallest batch size >= n divisible by ``multiple`` (for even dp)."""
    return int(math.ceil(n / multiple) * multiple)
