"""Multi-process initialization and mesh construction (counterpart of
``audiocodec_tpu/parallel/multihost.py``).

One process needs nothing special: ``parallel.mesh.make_mesh`` over its
devices. Several processes (one a host, or one a card) join a
``torch.distributed`` process group once, before any collective; each then
runs its own (dp, sp) grid on its share of the batch, and the training
steps average gradients and losses over the group
(``parallel.mesh.Mesh.all_mean``).

This module is a thin, testable wrapper: on a single process it is a
no-op, so the same launcher script runs everywhere.

    from audiocodec_tpu_torch.parallel import multihost
    multihost.initialize()               # no-op on a single process
    mesh = multihost.global_mesh(sp=1)   # dp spans every process

As in the JAX package, ``sp`` stays within a process (its halo is a copy
between this process's devices) and ``dp`` spans processes, which
exchange only the gradient and statistics sums.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from audiocodec_tpu_torch.parallel import mesh as _mesh


def local_devices() -> list:
    """This process's CUDA devices: every visible card when it is the only
    process on its host, else its equal, contiguous share of them by
    ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE`` (the variables ``torchrun``
    sets)."""
    count = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    share = count // local_world
    if share == 0:
        raise RuntimeError(
            f"{count} CUDA devices do not go round {local_world} local "
            "processes: pass devices=")
    return [torch.device("cuda", i)
            for i in range(local_rank * share, (local_rank + 1) * share)]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               auto: bool = False, device="cuda", backend=None) -> bool:
    """Join the ``torch.distributed`` process group when running
    multi-process.

    Explicit arguments (or ``WORLD_SIZE`` > 1) trigger initialization;
    ``auto=True`` does whatever the environment says. Without an address
    the rendezvous is ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them):

        multihost.initialize(auto=True)   # under torchrun
        multihost.initialize()            # single process: clean no-op

    :param coordinator_address: ``host:port`` of rank 0's rendezvous
        (``tcp://``).
    :param num_processes: the world size (default ``WORLD_SIZE``).
    :param process_id: this process's rank (default ``RANK``).
    :param device: "cuda" (NCCL; this process's first card becomes the
        current device) or "cpu" (gloo).
    :param backend: an explicit backend in place of the device's, for a
        run that needs another one (gloo between ranks that share one
        card, which NCCL refuses).
    :return: True when the process group was initialized.
    """
    import torch.distributed as dist

    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and coordinator_address is None and not auto:
        return False
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(local_devices()[0])
    rank = int(os.environ.get("RANK", "0")) if process_id is None \
        else process_id
    dist.init_process_group(
        backend, world_size=world, rank=rank,
        init_method=("env://" if coordinator_address is None
                     else f"tcp://{coordinator_address}"))
    return True


def global_mesh(sp: int = 1, devices=None) -> _mesh.Mesh:
    """A (dp, sp) mesh over this process's devices (default
    :func:`local_devices`), as sp-wide rows: dp spans the rows of every
    process in the group. The mesh records the group, its rank and world
    size; without an initialized group it is this process's mesh alone.
    """
    import torch.distributed as dist

    if devices is None:
        devices = local_devices()
    if len(devices) % sp != 0:
        raise ValueError(
            f"total devices {len(devices)} not divisible by sp={sp}")
    mesh = _mesh.make_mesh(sp=sp, devices=devices)
    if not dist.is_initialized():
        return mesh
    return dataclasses.replace(mesh, rank=dist.get_rank(),
                               world=dist.get_world_size(),
                               group=dist.group.WORLD)


def process_local_batch(global_batch: int) -> int:
    """Per-process share of a global batch (for building host-local data)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}"
        )
    return global_batch // n
