"""Spawned gloo worlds for the port's CPU tests: ``spawn`` starts the
ranks, ``once`` runs a fixture's work once per test session, also under
pytest-xdist (each worker would otherwise spawn the same world again).
Imports nothing of JAX: the spawned ranks import the test modules."""

import os

import torch.multiprocessing as mp


def spawn(fn, world, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes, joined."""
    mp.spawn(fn, args=(world, *args), nprocs=world, join=True)


def once(tmp_path_factory, name, build):
    """The directory into which ``build(dir)`` wrote, run once per test
    session: under pytest-xdist the first worker to take the lock builds
    into the session's shared temp dir and the others read what it
    wrote."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        d = tmp_path_factory.mktemp(name)
        build(d)
        return d
    from filelock import FileLock

    d = tmp_path_factory.getbasetemp().parent / name
    with FileLock(f"{d}.lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            build(d)
            (d / "done").touch()
    return d
