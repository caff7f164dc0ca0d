"""Checkpoint save and restore for real resume (counterpart of
``vlsfr_tpu/train/checkpoints.py``, which saves with orbax; the port has no
orbax and writes with ``torch.save``).

Layout, one directory a step as in JAX:

    <directory>/<step>/replicated.pt   the lead rank: what every rank holds
    <directory>/<step>/rank<r>.pt      rank r's block of the sharded state

``replicated.pt`` holds the modules (BN running stats included), the
optimizer state, the host state (DCP planner, plateau controller), the
step and the world size; ``rank<r>.pt`` the rank's block of the queue (and
its int8 scales) or of the classifier (and its momentum and last-visit
steps), and the rank's global random generators (dropout draws from
them; route D's tile fill and route E's sampled classes need no state,
their generators being seeded from (seed, step), ``train/softmax_head.py``).
Everything is a tensor or a plain Python value, and ``restore`` loads with
``weights_only=True``: nothing is unpickled but tensors and containers.

A step is written into ``<directory>/.tmp-<step>`` and renamed to
``<step>`` once every rank has written its part (``os.replace`` of the
directory: atomic), so ``latest_step`` sees only complete steps; a partial
directory left by a crash is ignored and removed at the next save. The
lead keeps the newest ``max_to_keep`` steps. Resume needs the world size
the checkpoint was written at.
"""

from __future__ import annotations

import os
import shutil

import torch
import torch.distributed as dist

REPLICATED = "replicated.pt"
TMP_PREFIX = ".tmp-"


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
        os.makedirs(self.directory, exist_ok=True)

    def _barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.mesh.group)

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
        lead = self.rank == 0
        if lead:
            for name in os.listdir(self.directory):  # partial steps of an earlier run
                if name.startswith(TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()
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
        if not lead and os.path.isdir(tmp):  # a rank with a directory of its own
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

    def restore(self, step: int, map_location=None) -> tuple[dict, dict]:
        """(replicated, this rank's block) of ``step``; raises if it was
        written at another world size."""
        d = self._step_dir(step)
        replicated = self.replicated(step, map_location)
        if replicated["world"] != self.world:
            raise ValueError(
                f"checkpoint {d} was written by {replicated['world']} rank(s); this run has "
                f"{self.world}: resume needs the same mesh.model")
        block = torch.load(os.path.join(d, f"rank{self.rank}.pt"), map_location=map_location,
                           weights_only=True)
        return replicated, block

    def wait(self) -> None:
        """Every save has finished when it returns (``torch.save`` is
        synchronous); kept for the JAX manager's interface."""

    def close(self) -> None:
        self.wait()
