"""The device mesh of the port (counterpart of ``vlsfr_tpu/parallel/mesh.py``).

JAX's mesh is ("data", "model") over ``devices.reshape(data, model)``; the
port places global rank ``r`` of the default process group at data index
``r // model`` and model index ``r % model`` alike.

* ``model`` — a class axis (the DCP queue's slots, or the softmax
  classifier's rows) split over the ranks of one data index, one
  contiguous block of size / model per rank, in model-index order (JAX's
  ``P(None, "model", None)`` and ``P("model", None)``);
* ``data`` — the global batch split over the ranks of one model index,
  rows ``[i·B/d, (i+1)·B/d)`` at data index ``i`` (JAX's ``P("data")``).
  Both training steps (``core/ffc.py``, ``train/softmax_head.py``) gather
  the embeddings over it before the head, sum the backbone's gradients
  over it after the backward, and take BatchNorm's statistics over it
  (``models/layers.data_axis_forward``); under GSPMD XLA inserts these
  collectives itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from vlsfr_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    model: int  # ranks along the class axis
    rank: int  # this rank's model index
    group: dist.ProcessGroup  # the ranks of this rank's data index, in model order
    data: int = 1  # ranks along the batch axis
    data_rank: int = 0  # this rank's data index
    data_group: dist.ProcessGroup | None = None  # the ranks of this model index, in data order

    def class_block(self, size: int, what: str = "pool.queue_size") -> tuple[int, int]:
        """(first index, length) of this rank's block of a class axis of
        ``size`` (``what`` names it in the error: the axis must split
        evenly)."""
        if size % self.model:
            raise ValueError(f"{what}={size} must be a multiple of mesh.model={self.model}")
        c_local = size // self.model
        return self.rank * c_local, c_local


def resolve_shape(data: int, model: int) -> tuple[int, int]:
    """(data, model) as JAX's ``make_mesh`` resolves them: ``model`` ≤ 0 is
    1 and ``data`` ≤ 0 (-1) is world // model, the world being the joined
    group's size or the one the environment announces. Creates nothing."""
    model = max(model, 1)
    if data <= 0:
        data = distributed.world_size() // model
    return data, model


def check_shape(data: int, model: int) -> tuple[int, int]:
    """The resolved (data, model) (``resolve_shape``); raises unless
    data · model is the world size. Creates nothing."""
    data, model = resolve_shape(data, model)
    world = distributed.world_size()
    if data * model != world:
        n = max(data, 1) * model
        raise ValueError(f"mesh {data}x{model} (mesh.data x mesh.model) must cover the world "
                         f"size ({world}): run one process per card, e.g. torchrun --standalone "
                         f"--nproc_per_node={n} -m vlsfr_tpu_torch.train "
                         f"--set mesh.data={max(data, 1)} --set mesh.model={model} ...")
    return data, model


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The mesh over the default process group (``distributed.initialize``
    first). Every rank creates every subgroup, in the same order: the
    model groups by data index, then the data groups by model index; an
    axis that spans the world is the default group itself."""
    data, model = check_shape(data, model)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    r = dist.get_rank()
    i, j = divmod(r, model)
    world = dist.group.WORLD
    groups = [world] if data == 1 else [dist.new_group(list(range(k * model, (k + 1) * model)))
                                        for k in range(data)]
    data_groups = [world] if model == 1 else [dist.new_group(list(range(k, data * model, model)))
                                              for k in range(model)]
    return Mesh(model=model, rank=j, group=groups[0 if data == 1 else i], data=data,
                data_rank=i, data_group=data_groups[0 if model == 1 else j])
