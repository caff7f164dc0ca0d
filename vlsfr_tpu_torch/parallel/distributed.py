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

The backend is NCCL for ``cuda`` and gloo for ``cpu`` unless the caller
names one (gloo carries CUDA tensors through host memory, so several
ranks can share one card, which NCCL refuses). Importing this module
creates nothing; ``initialize`` is called by the trainer (or the caller),
and the caller that created the group destroys it (``destroy``).

The data axis's collectives (``parallel/mesh.py``): ``gather_rows``, an
all_gather of each rank's rows whose backward hands each rank its own
slice of the cotangent; ``reduce_sum``, an all_reduce whose backward
all_reduces the cotangent; and ``sum_`` in place over a group.
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


def initialize(device_type: str = "cuda", *, backend: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               store_path: str | None = None) -> bool:
    """Join the default process group unless one exists; returns True if
    this call created it (its caller then calls ``destroy``). ``backend``
    defaults to NCCL for ``cuda`` and gloo for ``cpu``."""
    if dist.is_initialized():
        return False
    if backend is None:
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


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        ctx.rows = slice(i * x.shape[0], (i + 1) * x.shape[0])
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank computes the same loss of the gathered rows, so each
        # holds the whole cotangent already: its own rows, not a sum
        return g[ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` [b, ...] of ``group`` stacked in group-rank order,
    [n·b, ...]; differentiable: the backward returns this rank's rows of
    the cotangent (the loss being the same on every rank)."""
    return _GatherRows.apply(x, group)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; differentiable: every rank's loss reads
    the sum, so the backward sums the cotangents over the group."""
    return _ReduceSum.apply(x, group)


def sum_(tensors, group) -> None:
    """Sum each of ``tensors`` (one dtype and device) over ``group``, in
    place, through one all_reduce of their concatenation."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    lo = 0
    for t in tensors:
        t.copy_(flat[lo:lo + t.numel()].view_as(t))
        lo += t.numel()
