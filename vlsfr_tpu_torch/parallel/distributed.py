"""Process-group set-up for the port's sharded paths (counterpart of
``vlsfr_tpu/parallel/distributed.py``).

JAX's runtime joins the chips of a pod itself; here each card is one
process of a ``torch.distributed`` group. Three ways in:

* under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` set) the group is joined from the
  environment (``env://``);
* a caller that starts the ranks itself (the tests spawn them) passes
  ``rank``, ``world_size`` and the path of a ``FileStore`` they share;
* with neither, a world of one over an in-memory store — the sharded route
  on one card (``pool.force_sharded``), its collectives still going
  through the group.

The backend is NCCL for ``cuda`` and gloo for ``cpu``. Importing this
module creates nothing; ``initialize`` is called by the trainer (or the
caller), and the caller that created the group destroys it (``destroy``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def world_size() -> int:
    """The size of the joined group, else the one the environment announces
    (``WORLD_SIZE``), else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(device_type: str = "cuda", *, rank: int | None = None,
               world_size: int | None = None, store_path: str | None = None) -> bool:
    """Join the default process group unless one exists; returns True if
    this call created it (its caller then calls ``destroy``)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if rank is not None:
        if world_size is None or store_path is None:
            raise ValueError("rank needs world_size and store_path")
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_lead_host() -> bool:
    """Rank 0 of the group (or no group): the process that logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device(device: torch.device) -> torch.device:
    """This rank's card, ``cuda:LOCAL_RANK`` (``device`` as given for the
    CPU)."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
