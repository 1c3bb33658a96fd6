"""Device meshes (counterpart of ``audiocodec_tpu/parallel/mesh.py``).

A mesh is a (dp, sp) grid of this process's ``torch.device``s:

* ``dp`` (data / clip parallelism) splits a batch of clips into contiguous
  shards, one a row; nothing crosses rows but the gather of the results
  and, in training, the sum of the rows' shares of the loss.
* ``sp`` (sequence parallelism) splits a row's samples axis over the row's
  devices at block boundaries (``parallel.sequence``). The MDCT's fold
  couples adjacent blocks only, so each shard but the first takes the
  previous shard's last block as a halo: a device-to-device copy inside
  the process, whose gradient autograd carries back.

As in the JAX package, ``sp`` stays within a process and ``dp`` may span
processes (``parallel.multihost.global_mesh``): each process then runs
its own grid on its share of the batch, and the mesh records the process
group, its rank and world size, over which the training steps average
gradients and losses. JAX's ``NamedSharding`` layouts have no counterpart:
:meth:`Mesh.split` places a host batch's dp shards on their rows and
:meth:`Mesh.gather` brings results back to the first device.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of this process's devices, ``devices[i][j]`` at dp
    row i, sequence shard j.

    :param rank: this process's rank in ``group``.
    :param world: the processes in ``group``, each running such a grid.
    :param group: the ``torch.distributed`` process group; None for a mesh
        of this process alone (no collective runs).
    """

    devices: tuple
    rank: int = 0
    world: int = 1
    group: object = None

    @property
    def shape(self) -> dict:
        """This process's grid."""
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def dp_devices(self) -> list:
        """The first device of each dp row, where its shard of a batch
        lands and its results come back."""
        return [row[0] for row in self.devices]

    def split(self, batch: torch.Tensor) -> list:
        """``batch`` [B, ...] -> its dp shards, contiguous rows of B / dp,
        each on its row's first device (copied without blocking the host
        where the batch is in pinned memory)."""
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

    def all_sum(self, tensors) -> None:
        """Sum each tensor over the mesh's processes, in place; nothing
        without a group. Only ``all_reduce`` runs, which gloo also takes on
        CUDA tensors."""
        if self.group is None:
            return
        import torch.distributed as dist

        for t in tensors:
            dist.all_reduce(t, group=self.group)

    def broadcast(self, tensor) -> None:
        """Overwrite ``tensor`` with the group's rank 0's, in place."""
        import torch.distributed as dist

        dist.broadcast(tensor, src=dist.get_global_rank(self.group, 0),
                       group=self.group)

    def all_mean(self, tensors) -> None:
        """Average each tensor over the mesh's processes, in place."""
        if self.group is None:
            return
        self.all_sum(tensors)
        for t in tensors:
            t.div_(self.world)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over this process's devices.

    :param n_devices: devices to use (default: all of ``devices``).
    :param dp: data-parallel extent (default: n_devices // sp).
    :param sp: sequence-parallel extent (default 1).
    :param devices: a list of ``torch.device`` (default: every visible CUDA
        device); a device may repeat, as the tests' ``[cpu] * 8`` and one
        card's ``[cuda:0] * 4`` do.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "no CUDA device: pass devices= for a mesh of other devices")
    devices = [_indexed(torch.device(d)) for d in devices]
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
    return Mesh(tuple(tuple(devices[i * sp:(i + 1) * sp]) for i in range(dp)))


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def pad_batch_to(n: int, multiple: int) -> int:
    """Smallest batch size >= n divisible by ``multiple`` (for even dp)."""
    return int(math.ceil(n / multiple) * multiple)
