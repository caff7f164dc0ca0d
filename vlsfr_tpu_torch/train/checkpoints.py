"""Checkpoint save and restore for real resume (counterpart of
``vlsfr_tpu/train/checkpoints.py``, which saves with orbax; the port has no
orbax and writes with ``torch.save``).

Layout, one directory a step as in JAX:

    <directory>/<step>/replicated.pt   the lead rank: what every rank holds
    <directory>/<step>/rank<m>.pt      model index m's block of the sharded state

``replicated.pt`` holds the modules (BN running stats included), the
optimizer state, the host state (DCP planner, plateau controller), the
step and the world size (``mesh.model``); ``rank<m>.pt`` the block of the
queue (and its int8 scales) or of the classifier (and its momentum and
last-visit steps) of model index m, and the process's global random
generators. On the data axis the data replicas of a block hold it bit for
bit: data index 0 of each model block writes it, the others write
nothing and join the barriers, and every data index restores its model
index's block, generators included (the step's draws need none: dropout's
are seeded from (seed, data index, step), ``models/layers.py``, route D's
tile fill from (seed, step) and the model index, route E's sampled classes
from (seed, step), ``train/softmax_head.py``), so a checkpoint of either
head resumes at any ``mesh.data``.
Everything is a tensor or a plain Python value, and ``restore`` loads with
``weights_only=True``: nothing is unpickled but tensors and containers.

A step is written into ``<directory>/.tmp-<step>`` and renamed to
``<step>`` once every rank has written its part (``os.replace`` of the
directory: atomic), so ``latest_step`` sees only complete steps; a partial
directory left by a crash is ignored and removed at the next save. The
lead keeps the newest ``max_to_keep`` steps.

Resume at another world size re-cuts the blocks, as JAX's orbax restore
re-shards to the running state: each rank reads the old ``rank<r>.pt``
files whose blocks overlap its new block and slices them along the class
axis (``CLASS_AXIS``: the queue and its scales, the classifier, its
momentum and last-visit steps). The whole class axis must be the same in
both runs; a padded class count that differs between the two worlds
raises. A rank past the old world takes rank 0's random generators.
"""

from __future__ import annotations

import os
import shutil

import torch
import torch.distributed as dist

REPLICATED = "replicated.pt"
TMP_PREFIX = ".tmp-"
# the class axis of each sharded tensor of a block: [2, Q, D] queue and
# [2, Q] scales, [C, D] classifier and momentum, [C] last-visit steps
CLASS_AXIS = {"queue": 1, "queue_scales": 1, "classifier": 0, "classifier_mom": 0,
              "classifier_last": 0}


class CheckpointManager:
    """Step directories under ``directory``; on a mesh (``parallel/mesh.py``)
    every rank calls ``save`` and ``restore`` and the ranks share
    ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.world = 1 if mesh is None else mesh.model
        # data index 0 of each model block writes the block
        self.writes = mesh is None or getattr(mesh, "data_rank", 0) == 0
        os.makedirs(self.directory, exist_ok=True)

    def _barrier(self) -> None:
        if self.mesh is not None and dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list[int]:
        """The complete steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, REPLICATED)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, replicated: dict, block: dict) -> None:
        """Write ``replicated`` (taken from the lead rank) and this rank's
        ``block``; returns once the step is complete on disk."""
        tmp = os.path.join(self.directory, f"{TMP_PREFIX}{int(step)}")
        lead = self.writes and self.rank == 0
        if lead:
            for name in os.listdir(self.directory):  # partial steps of an earlier run
                if name.startswith(TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()
        if self.writes:
            os.makedirs(tmp, exist_ok=True)  # ranks with a directory of their own
            torch.save(block, os.path.join(tmp, f"rank{self.rank}.pt"))
        if lead:
            torch.save(dict(replicated, world=self.world), os.path.join(tmp, REPLICATED))
        self._barrier()  # every part written
        if lead:
            self._publish(tmp, step)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self._barrier()  # the step is complete
        if self.writes and not lead and os.path.isdir(tmp):  # a directory of its own
            self._publish(tmp, step)

    def _publish(self, tmp: str, step: int) -> None:
        final = self._step_dir(step)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    def replicated(self, step: int, map_location=None) -> dict:
        """The replicated part of ``step`` alone (modules, optimizer, host
        state), at any world size: what an evaluation needs."""
        return torch.load(os.path.join(self._step_dir(step), REPLICATED),
                          map_location=map_location, weights_only=True)

    def restore(self, step: int, map_location=None, class_sizes: dict | None = None
                ) -> tuple[dict, dict]:
        """(replicated, this rank's block) of ``step``. ``class_sizes``
        names this run's whole class axis per tensor (``CLASS_AXIS``:
        ``queue``, ``classifier``); a saved whole of another size raises,
        naming both. Written at another world size, the block is re-cut
        from the old blocks that overlap it (``_recut``)."""
        d = self._step_dir(step)
        replicated = self.replicated(step, map_location)
        old = replicated["world"]
        files: dict[int, dict] = {}

        def block(rank: int) -> dict:  # mapped, not read, when re-cutting
            if rank not in files:
                files[rank] = torch.load(os.path.join(d, f"rank{rank}.pt"),
                                         map_location=map_location, weights_only=True,
                                         mmap=old != self.world)
            return files[rank]

        sample = block(self.rank if old == self.world else 0)
        for name, want in (class_sizes or {}).items():
            if sample.get(name) is not None:
                have = sample[name].shape[CLASS_AXIS[name]] * old
                if have != want:
                    raise ValueError(
                        f"checkpoint {d} holds {name} over {have} classes (padded for "
                        f"mesh.model={old}); this run has {want} (mesh.model={self.world}): "
                        f"the padded class count differs")
        if old == self.world:
            return replicated, sample
        return replicated, self._recut(block, old)

    def _recut(self, block, old: int) -> dict:
        """This rank's block from the ``old`` ranks' blocks (``block(j)``):
        each sharded tensor sliced along its class axis out of the old
        blocks that overlap the new one; the rest (the random generators)
        from the same old rank, or rank 0 past the old world."""
        own = block(self.rank if self.rank < old else 0)
        out = {}
        for name, value in own.items():
            if name not in CLASS_AXIS or value is None:
                out[name] = value
                continue
            axis = CLASS_AXIS[name]
            n_old = value.shape[axis]
            whole = n_old * old
            if whole % self.world:
                raise ValueError(f"checkpoint's {name} over {whole} classes does not split over "
                                 f"mesh.model={self.world}")
            n = whole // self.world
            lo, hi = self.rank * n, (self.rank + 1) * n
            parts = []
            for j in range(lo // n_old, (hi - 1) // n_old + 1):
                a, e = max(lo, j * n_old) - j * n_old, min(hi, (j + 1) * n_old) - j * n_old
                parts.append(block(j)[name].narrow(axis, a, e - a))
            out[name] = torch.cat(parts, dim=axis)  # a copy: nothing stays mapped
        return out

    def wait(self) -> None:
        """Every save has finished when it returns (``torch.save`` is
        synchronous); kept for the JAX manager's interface."""

    def close(self) -> None:
        self.wait()
