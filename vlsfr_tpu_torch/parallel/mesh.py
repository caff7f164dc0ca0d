"""The device mesh of the port (counterpart of ``vlsfr_tpu/parallel/mesh.py``).

JAX's mesh is ("data", "model"); the port runs the ``model`` axis — a class
axis (the DCP queue's slots, or the softmax classifier's rows) split over
the ranks of the default process group, one contiguous block of size /
model per rank, in rank order (JAX's ``P(None, "model", None)`` and
``P("model", None)``). The ``data`` axis is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from vlsfr_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    model: int  # ranks along the class axis: the world size
    rank: int
    group: dist.ProcessGroup

    def class_block(self, size: int, what: str = "pool.queue_size") -> tuple[int, int]:
        """(first index, length) of this rank's block of a class axis of
        ``size`` (``what`` names it in the error: the axis must split
        evenly)."""
        if size % self.model:
            raise ValueError(f"{what}={size} must be a multiple of mesh.model={self.model}")
        c_local = size // self.model
        return self.rank * c_local, c_local


def check_shape(data: int, model: int) -> None:
    """Refuse a mesh the port cannot run: ``data`` > 1, or a ``model`` axis
    other than the world size. Creates nothing."""
    if data > 1:
        raise NotImplementedError("mesh.data > 1 (data parallelism, synchronised BN) is not "
                                  "ported yet")
    world = distributed.world_size()
    if model != world:
        raise ValueError(f"mesh.model={model} must equal the world size ({world}): run one "
                         f"process per card, e.g. torchrun --standalone "
                         f"--nproc_per_node={model} -m vlsfr_tpu_torch.train "
                         f"--set mesh.model={model} ...")


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The mesh over the default process group (``distributed.initialize``
    first)."""
    check_shape(data, model)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    return Mesh(model=model, rank=dist.get_rank(), group=dist.group.WORLD)
