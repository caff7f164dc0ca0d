"""Checkpoint and resume of the port's Trainer (``train/checkpoints.py``).

The reference for a resumed run is the same run uninterrupted, as in the
JAX package's ``tests/test_trainer.py::test_resume_matches_uninterrupted``,
``::test_resume_mid_epoch`` and ``::test_int8_queue_resume_matches_uninterrupted``;
on the CPU the port's step is deterministic, so both are held bit for bit
(JAX's tests allow 1e-5): every tensor of the state (modules with their BN
running stats, optimizer, queue and its int8 scales or classifier with its
momentum and last-visit steps), the DCP planner, the plateau controller,
the random generators and the step.

Cases: the FFC head on a dense f32 queue (with the plateau scheduler, so
its state moves) and on the fused head's int8 queue; the softmax head's
route A (fused SGD, bare momentum) and route D (sparse rows, last-visit
steps); the sharded FFC head at ``mesh.model = 2`` over 2 spawned gloo
ranks, one block of the queue per rank; and on the data axis the FFC head
and the softmax head's routes A and D (resume at 2 x 1, and at another
``mesh.data``). The spawned ranks import this module by name, so it
imports nothing of JAX.
"""

import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_worlds import once, spawn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.train.checkpoints import CheckpointManager
from vlsfr_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
BASE = ["model.net_type=toy", "model.feat_dim=16", "model.dtype=float32", "data.batch_size=8",
        "data.image_size=16", "data.num_workers=1", "train.print_freq=2", "optim.lr=0.01",
        "train.save_freq=100000", "pool.queue_size=64"]
CASES = {
    "ffc_f32": ["optim.scheduler=plateau", "optim.patience=0"],
    "ffc_int8": ["pool.use_fused=on", "pool.queue_dtype=int8"],
    "softmax_A": ["pool.head=full_softmax", "pool.use_fused=on"],
    "softmax_D": ["pool.head=full_softmax", "pool.use_fused=on", "pool.sparse_update=true"],
}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_store")
    generate_synthetic_store(str(d), num_ids=10, images_per_id=8, image_size=16, seed=0)
    return str(d)


def _cfg(store: str, saved_dir, overrides, epochs: int = 1) -> Config:
    cfg = Config().apply_overrides([*BASE, *overrides, f"optim.epochs={epochs}"])
    cfg.data.sources = [store]
    cfg.train.saved_dir = str(saved_dir)
    return cfg


def _flat(x, prefix=""):
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _flat(x[k], f"{prefix}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, x


def _snapshot(trainer) -> dict:
    """The trainer's whole checkpoint state, flattened to numpy."""
    out = {}
    for key, v in _flat(trainer._checkpoint_state()):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            out[key] = v.numpy().copy()
        elif v is not None:
            out[key] = np.asarray(v)
    out["/start"] = np.asarray([trainer.start_epoch, trainer.start_step])
    return out


def _assert_same(a: dict, b: dict, skip=("/start",)):
    keys = set(a) - set(skip)
    assert keys == set(b) - set(skip)
    for k in sorted(keys):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _train(cfg, max_steps=None) -> dict:
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.train(max_steps=max_steps)
        return _snapshot(trainer)
    finally:
        trainer.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_trip_is_bit_for_bit(case, store, tmp_path):
    """3 steps, ``_save``, then a fresh Trainer restores every tensor and
    host value the first one holds, and starts at step 3."""
    cfg = _cfg(store, tmp_path, CASES[case])
    t1 = Trainer(cfg, device="cpu")
    try:
        t1.train(max_steps=3)
        if case == "ffc_int8":
            assert t1.state.queue.dtype == torch.int8 and t1.state.queue_scales is not None
        if case == "softmax_D":
            assert t1.state.classifier_last is not None and int(t1.state.classifier_last.max()) > 0
        t1._save(3)
        want = _snapshot(t1)
    finally:
        t1.close()
    t2 = Trainer(_cfg(store, tmp_path, CASES[case]), device="cpu")
    try:
        assert t2.state.step == 3 and (t2.start_epoch, t2.start_step) == divmod(
            3, t2.steps_per_epoch)
        _assert_same(want, _snapshot(t2))
    finally:
        t2.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_matches_uninterrupted(case, store, tmp_path):
    """2 epochs straight against 1 epoch, then a fresh Trainer resuming
    for the second: the same final state, bit for bit."""
    straight = _train(_cfg(store, tmp_path / "a", CASES[case], epochs=2))
    _train(_cfg(store, tmp_path / "b", CASES[case], epochs=1))
    t = Trainer(_cfg(store, tmp_path / "b", CASES[case], epochs=2), device="cpu")
    try:
        assert (t.start_epoch, t.start_step) == (1, 0)
        t.train()
        resumed = _snapshot(t)
    finally:
        t.close()
    _assert_same(straight, resumed)


def test_resume_mid_epoch(store, tmp_path):
    """With the final checkpoint removed, the run resumes from the last
    periodic one, inside the epoch, and ends where the uninterrupted run
    ends."""
    ov = [*CASES["ffc_f32"], "train.save_freq=3"]
    cfg = _cfg(store, tmp_path / "mid", ov)
    t1 = Trainer(cfg, device="cpu")
    spe = t1.steps_per_epoch
    try:
        t1.train()
        want = _snapshot(t1)
    finally:
        t1.close()
    ck = CheckpointManager(cfg.train.saved_dir)
    steps = ck.all_steps()
    assert steps[-1] == spe and spe % 3 and steps[-2] == spe // 3 * 3
    shutil.rmtree(os.path.join(ck.directory, str(steps[-1])))
    t2 = Trainer(_cfg(store, tmp_path / "mid", ov), device="cpu")
    try:
        assert (t2.start_epoch, t2.start_step) == (0, steps[-2])
        t2.train()
        _assert_same(want, _snapshot(t2))
    finally:
        t2.close()


def test_keep_checkpoints_and_partial_directories(store, tmp_path):
    """``train.keep_checkpoints`` newest steps survive; a partial step
    (a ``.tmp-`` directory, or a step directory without its replicated
    part) is never the latest, and the next save removes the former."""
    cfg = _cfg(store, tmp_path, ["train.save_freq=2", "train.keep_checkpoints=2"])
    ck = CheckpointManager(cfg.train.saved_dir)
    os.makedirs(os.path.join(ck.directory, ".tmp-9999"))
    os.makedirs(os.path.join(ck.directory, "9998"))
    final = int(_train(cfg)["/0/step"])
    last_even = final - 2 if final % 2 == 0 else final - 1
    assert ck.all_steps() == [last_even, final]
    assert ck.latest_step() == final
    assert not os.path.exists(os.path.join(ck.directory, ".tmp-9999"))
    assert os.path.isdir(os.path.join(ck.directory, "9998"))  # not a step: left alone


def test_restore_refuses_another_world_size(tmp_path):
    """Another world size is refused only where the padded class count
    differs (naming both counts); otherwise each rank gets its block of the
    saved whole, re-cut, and the same world gets the saved block."""
    queue = torch.arange(2 * 6 * 3, dtype=torch.float32).view(2, 6, 3)
    CheckpointManager(str(tmp_path)).save(5, {"step": 5}, {"queue": queue, "rng": "r0"})
    for rank in (0, 1):
        two = CheckpointManager(str(tmp_path), mesh=SimpleNamespace(model=2, rank=rank, group=None))
        with pytest.raises(ValueError, match="over 6 classes .* this run has 8"):
            two.restore(5, class_sizes={"queue": 8})
        rep, block = two.restore(5, class_sizes={"queue": 6})
        assert rep == {"step": 5, "world": 1} and block["rng"] == "r0"
        assert torch.equal(block["queue"], queue[:, 3 * rank:3 * rank + 3])
    rep, block = CheckpointManager(str(tmp_path)).restore(5, class_sizes={"queue": 6})
    assert rep == {"step": 5, "world": 1} and torch.equal(block["queue"], queue)


def test_sigterm_checkpoints_and_the_next_run_resumes(store, tmp_path):
    """The CLI in a subprocess: SIGTERM during training exits 143 after
    writing a checkpoint; the same command again resumes from it."""
    cmd = [sys.executable, "-m", "vlsfr_tpu_torch.train", "--device", "cpu", "--net_type",
           "toy", "--sources", store, "--batch_size", "8", "--feat_dim", "16", "--queue_size",
           "64", "--print_freq", "1", "--saved_dir", str(tmp_path), "--set",
           "data.image_size=16", "--set", "model.dtype=float32", "--set", "data.num_workers=1",
           "--set", "train.save_freq=100000"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([*cmd, "--set", "optim.epochs=1000"], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    try:
        for line in proc.stderr:
            if "train step 3 |" in line:
                break
            assert time.monotonic() < deadline, "no training steps within 120 s"
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 128 + signal.SIGTERM, err
    step = CheckpointManager(str(tmp_path)).latest_step()
    assert step is not None and step >= 3
    again = subprocess.run([*cmd, "--set", "optim.epochs=1"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=180)
    assert again.returncode == 0, again.stderr
    assert f"resumed from checkpoint step {step}" in again.stderr
    assert "training done:" in again.stdout


# ----------------------------------------------------------------------
# the sharded FFC head over 2 gloo ranks
# ----------------------------------------------------------------------

SHARDED = ["pool.use_fused=on", "mesh.model=2", "mesh.data=1"]


def _sharded_rank(rank, world, store_path, data, out_dir):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store_path)
    try:
        out = {}
        for name, run, epochs in (("straight", "a", 2), ("first", "b", 1), ("resumed", "b", 2)):
            t = Trainer(_cfg(data, os.path.join(out_dir, run), SHARDED, epochs), device="cpu")
            try:
                out[f"{name}/start"] = np.asarray([t.start_epoch, t.start_step])
                t.train()
                out.update({f"{name}{k}": v for k, v in _snapshot(t).items()})
            finally:
                t.close()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world2(store, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_world2")
    mp.spawn(_sharded_rank, args=(2, str(tmp / "filestore"), store, str(tmp)), nprocs=2,
             join=True)
    return tmp, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_sharded_resume_matches_uninterrupted(world2):
    """Each rank's resumed state equals its uninterrupted one bit for bit;
    the probes are equal over the ranks and the queue blocks are the
    ranks' own."""
    _, ranks = world2
    for out in ranks:
        assert out["resumed/start"].tolist() == [1, 0]
        straight = {k[len("straight"):]: v for k, v in out.items() if k.startswith("straight/")}
        resumed = {k[len("resumed"):]: v for k, v in out.items() if k.startswith("resumed/")}
        _assert_same(straight, resumed, skip=("/start",))
    probe = [k for k in ranks[0] if k.startswith("resumed/0/probe/")]
    assert probe
    for k in probe:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    assert ranks[0]["resumed/1/queue"].shape == ranks[1]["resumed/1/queue"].shape == (2, 32, 16)
    assert not np.array_equal(ranks[0]["resumed/1/queue"], ranks[1]["resumed/1/queue"])


def test_sharded_checkpoint_layout_and_world_check(world2, store):
    """One replicated part and one block per rank; a world of one resumes
    from it with the whole queue, the two blocks joined, and refuses a
    queue of another size, naming both."""
    tmp, ranks = world2
    ck = CheckpointManager(str(tmp / "b"))
    step = ck.latest_step()
    assert sorted(os.listdir(os.path.join(ck.directory, str(step)))) == [
        "rank0.pt", "rank1.pt", "replicated.pt"]
    t = Trainer(_cfg(store, tmp / "b", ["pool.use_fused=on"], 2), device="cpu")
    try:
        assert t.state.step == step
        np.testing.assert_array_equal(
            t.state.queue.numpy(),
            np.concatenate([r["resumed/1/queue"] for r in ranks], axis=1))
    finally:
        t.close()
    with pytest.raises(ValueError, match="over 64 classes .* this run has 128"):
        Trainer(_cfg(store, tmp / "b", ["pool.use_fused=on", "pool.queue_size=128"], 2),
                device="cpu")


# ----------------------------------------------------------------------
# resume at another mesh.model: the blocks re-cut (gloo ranks)
# ----------------------------------------------------------------------

RECUT = {  # case: overrides; every class axis splits over 1, 2 and 4 ranks
    "ffc_fused": ["pool.use_fused=on"],
    "softmax_A": ["pool.head=full_softmax", "pool.use_fused=on", "pool.num_classes=16"],
    "softmax_E": ["pool.head=full_softmax", "pool.sample_rate=0.75", "pool.sparse_update=true",
                  "pool.num_classes=16"],
}
PADDED = ["pool.head=full_softmax", "pool.use_fused=on", "pool.num_classes=10"]
SAVE_AT = 2


def _recut_cfg(data, saved_dir, case, world):
    overrides = PADDED if case == "padded" else RECUT[case]
    return _cfg(data, saved_dir, [*overrides, f"mesh.model={world}", "mesh.data=1"], epochs=1)


def _blocks(trainer) -> dict:
    """The trainer's sharded tensors, as numpy (bf16 kept as its bits)."""
    block = trainer._checkpoint_state()[1]
    return {k: v.detach().numpy().copy() for k, v in block.items()
            if isinstance(v, torch.Tensor)}


def _save_run(data, root, case, world):
    t = Trainer(_recut_cfg(data, os.path.join(root, f"w{world}", case), case, world),
                device="cpu")
    try:
        t.train(max_steps=SAVE_AT)
        t._save(SAVE_AT)
    finally:
        t.close()


def _resume_run(data, root, case, world, source) -> dict:
    """Resume at ``world`` from the checkpoint written at ``source``: the
    restored blocks, then one more step."""
    t = Trainer(_recut_cfg(data, os.path.join(root, f"w{source}", case), case, world),
                device="cpu")
    try:
        out = {f"{k}": v for k, v in _blocks(t).items()}
        out["start"] = np.asarray(t.state.step)
        res = t.train(max_steps=SAVE_AT + 1)
        out["final_step"], out["loss"] = np.asarray(res["final_step"]), np.asarray(res["loss"])
        return out
    finally:
        t.close()


def _recut_rank(rank, world, store_path, data, root):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store_path)
    try:
        out = {}
        for case in RECUT:
            if world == 2:  # 1 -> 2 and 4 -> 2, then the run 2 -> 1 resumes from
                for source in (1, 4):
                    res = _resume_run(data, root, case, 2, source)
                    out.update({f"{case}/{source}/{k}": v for k, v in res.items()})
            _save_run(data, root, case, world)
        if world == 4:  # 10 classes pad to 12 here, not at world 1
            try:
                Trainer(_recut_cfg(data, os.path.join(root, "w1", "padded"), "padded", 4),
                        device="cpu")
            except ValueError as e:
                out["padded/error"] = np.asarray(str(e))
        np.savez(os.path.join(root, f"w{world}_rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def recut(store, tmp_path_factory):
    """Saves at world 1 (here) and 4 (spawned), resumes from both at world
    2 (spawned, which then saves), and resumes from that here at world 1."""

    def build(tmp):
        root = str(tmp)
        for case in (*RECUT, "padded"):
            _save_run(store, root, case, 1)
        spawn(_recut_rank, 4, str(tmp / "fs4"), store, root)
        spawn(_recut_rank, 2, str(tmp / "fs2"), store, root)
        out = {}
        for case in RECUT:
            out.update({f"{case}/2/{k}": v for k, v in _resume_run(store, root, case, 1,
                                                                     2).items()})
        np.savez(tmp / "w1_rank0.npz", **out)

    tmp = once(tmp_path_factory, "ckpt_recut", build)
    return tmp, {world: [dict(np.load(tmp / f"w{world}_rank{r}.npz")) for r in range(world)]
                 for world in (1, 2, 4)}


def _saved_whole(root, case, source) -> dict:
    """The class-sharded tensors of the checkpoint written at ``source``
    ranks, the blocks joined along their class axis."""
    from vlsfr_tpu_torch.train.checkpoints import CLASS_AXIS

    d = os.path.join(root, f"w{source}", case, str(SAVE_AT))
    blocks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
              for r in range(source)]
    return {k: np.concatenate([b[k].numpy() for b in blocks], axis=CLASS_AXIS[k])
            for k in CLASS_AXIS if blocks[0].get(k) is not None}


@pytest.mark.parametrize("case", sorted(RECUT))
@pytest.mark.parametrize("source,world", [(2, 1), (1, 2), (4, 2)])
def test_resume_at_another_world_recuts_the_blocks(case, source, world, recut):
    """A checkpoint of the sharded fused FFC state (queue), route A
    (classifier, momentum) or route E with sparse rows (classifier,
    momentum, last-visit steps), written at ``source`` ranks, restores at
    ``world``: each rank's blocks are the slices of the saved whole, bit
    for bit, and one more step runs to a finite loss."""
    from vlsfr_tpu_torch.train.checkpoints import CLASS_AXIS

    tmp, runs = recut
    whole = _saved_whole(str(tmp), case, source)
    assert whole and (case != "softmax_E" or "classifier_last" in whole)
    for rank, out in enumerate(runs[world]):
        assert int(out[f"{case}/{source}/start"]) == SAVE_AT
        for name, arr in whole.items():
            axis = CLASS_AXIS[name]
            n = arr.shape[axis] // world
            want = np.take(arr, np.arange(rank * n, (rank + 1) * n), axis=axis)
            np.testing.assert_array_equal(out[f"{case}/{source}/{name}"], want, err_msg=name)
        assert int(out[f"{case}/{source}/final_step"]) == SAVE_AT + 1
        assert np.isfinite(out[f"{case}/{source}/loss"])


def test_resume_refuses_another_padded_class_count(recut):
    """10 classes are 10 at world 1 and pad to 12 at world 4: the resume
    raises and names both counts."""
    _, runs = recut
    for out in runs[4]:
        msg = str(out["padded/error"])
        assert "classifier over 10 classes" in msg and "this run has 12" in msg, msg


# ----------------------------------------------------------------------
# the data axis: resume at another mesh.data (gloo ranks)
# ----------------------------------------------------------------------

DATA_SAVE_AT = 3


SOFTMAX_CASES = ("softmax_A", "softmax_D")  # the softmax head's data axis


def _mesh_cfg(data, saved_dir, shape, epochs=1, case=None):
    extra = ["pool.use_fused=on"] if case is None else CASES[case]
    return _cfg(data, saved_dir, [*extra, f"mesh.data={shape[0]}", f"mesh.model={shape[1]}"],
                epochs)


def _losses_of(trainer, steps) -> np.ndarray:
    """The loss of each step of ``trainer.train(max_steps=steps)``."""
    losses, run = [], trainer.train_step

    def logged(*args):
        m = run(*args)
        losses.append(float(m["loss"]))
        return m

    trainer.train_step = logged
    trainer.train(max_steps=steps)
    return np.asarray(losses)


def _save_at(data, saved_dir, shape, case=None) -> dict:
    """DATA_SAVE_AT steps at ``shape``, ``_save``: the saved state."""
    t = Trainer(_mesh_cfg(data, saved_dir, shape, case=case), device="cpu")
    try:
        t.train(max_steps=DATA_SAVE_AT)
        t._save(DATA_SAVE_AT)
        return _snapshot(t)
    finally:
        t.close()


def _resume_at(data, saved_dir, shape, case=None) -> dict:
    """Resume at ``shape``: the restored state, then the next step's loss."""
    t = Trainer(_mesh_cfg(data, saved_dir, shape, case=case), device="cpu")
    try:
        out = {f"restored{k}": v for k, v in _snapshot(t).items()}
        out["next_loss"] = _losses_of(t, DATA_SAVE_AT + 1)
        return out
    finally:
        t.close()


def _data_axis_rank(rank, world, store_path, data, root):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store_path)
    try:
        out = {}
        if world == 4:  # 2 x 2
            out.update({f"saved22{k}": v for k, v in
                        _save_at(data, os.path.join(root, "m22"), (2, 2)).items()})
            for case in SOFTMAX_CASES:
                out.update({f"{case}/saved22{k}": v for k, v in _save_at(
                    data, os.path.join(root, f"{case}_m22"), (2, 2), case).items()})
        else:
            for name, run, epochs in (("straight", "a", 2), ("first", "b", 1),
                                      ("resumed", "b", 2)):
                t = Trainer(_mesh_cfg(data, os.path.join(root, run), (2, 1), epochs),
                            device="cpu")
                try:
                    out[f"{name}/start"] = np.asarray([t.start_epoch, t.start_step])
                    t.train()
                    out.update({f"{name}{k}": v for k, v in _snapshot(t).items()})
                finally:
                    t.close()
            t = Trainer(_mesh_cfg(data, os.path.join(root, "uninterrupted"), (2, 1)),
                        device="cpu")
            try:
                out["uninterrupted"] = _losses_of(t, DATA_SAVE_AT + 1)
            finally:
                t.close()
            out.update({f"saved21{k}": v for k, v in
                        _save_at(data, os.path.join(root, "m21"), (2, 1)).items()})
            for source in ("m21", "m22"):  # at 1 x 2
                out.update({f"{source}/12/{k}": v for k, v in
                            _resume_at(data, os.path.join(root, source), (1, 2)).items()})
            for case in SOFTMAX_CASES:  # the softmax head: resume at 2 x 1, save, 2 x 2 -> 1 x 2
                for name, run, epochs in (("straight", "a", 2), ("first", "b", 1),
                                          ("resumed", "b", 2)):
                    t = Trainer(_mesh_cfg(data, os.path.join(root, f"{case}_{run}"), (2, 1),
                                          epochs, case), device="cpu")
                    try:
                        t.train()
                        out.update({f"{case}/{name}{k}": v for k, v in _snapshot(t).items()})
                    finally:
                        t.close()
                out.update({f"{case}/saved21{k}": v for k, v in _save_at(
                    data, os.path.join(root, f"{case}_m21"), (2, 1), case).items()})
                out.update({f"{case}/m22/12/{k}": v for k, v in _resume_at(
                    data, os.path.join(root, f"{case}_m22"), (1, 2), case).items()})
        np.savez(os.path.join(root, f"data{world}_rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def data_axis(store, tmp_path_factory):
    """Saves at 2 x 2 (4 spawned ranks), then at 2 x 1 (2 spawned ranks,
    with the uninterrupted and the resumed 2 x 1 runs), resumes both at
    1 x 2 there, and the 2 x 1 one at 1 x 1 here."""

    def build(tmp):
        root = str(tmp)
        spawn(_data_axis_rank, 4, str(tmp / "fs4"), store, root)
        spawn(_data_axis_rank, 2, str(tmp / "fs2"), store, root)
        out = {f"m21/11/{k}": v for k, v in
               _resume_at(store, os.path.join(root, "m21"), (1, 1)).items()}
        for case in SOFTMAX_CASES:
            out.update({f"{case}/m21/11/{k}": v for k, v in _resume_at(
                store, os.path.join(root, f"{case}_m21"), (1, 1), case).items()})
        np.savez(tmp / "data1_rank0.npz", **out)

    tmp = once(tmp_path_factory, "ckpt_data_axis", build)
    return tmp, {world: [dict(np.load(tmp / f"data{world}_rank{r}.npz")) for r in range(world)]
                 for world in (1, 2, 4)}


def _state_of(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix + "/")}


def test_data_axis_resume_matches_uninterrupted(data_axis):
    """At ``mesh = 2 x 1``: 2 epochs straight against 1 epoch, then a fresh
    Trainer resuming for the second: the same final state on both ranks,
    bit for bit, and the two data ranks hold the same state. Data index 1
    resumes with the process generators of data index 0, whose block it
    reads (the step draws nothing from them: dropout's generator is seeded
    per data index and step); its own differed from the start."""
    _, runs = data_axis
    rng = ("/start", "/1/rng/cpu")
    for rank, out in enumerate(runs[2]):
        assert out["resumed/start"].tolist() == [1, 0]
        _assert_same(_state_of(out, "straight"), _state_of(out, "resumed"),
                     skip=("/start",) if rank == 0 else rng)
        _assert_same(_state_of(out, "resumed"), _state_of(runs[2][0], "resumed"))


def test_only_data_index_0_writes_a_block(data_axis):
    """One ``rank<m>.pt`` per model index, written by its data index 0: a
    2 x 1 step holds rank0.pt, a 2 x 2 step rank0.pt and rank1.pt."""
    tmp, _ = data_axis
    for mesh, blocks in (("m21", ["rank0.pt"]), ("m22", ["rank0.pt", "rank1.pt"])):
        d = os.path.join(str(tmp), mesh, str(DATA_SAVE_AT))
        assert sorted(os.listdir(d)) == blocks + ["replicated.pt"], mesh


@pytest.mark.parametrize("source,target", [("m21", "11"), ("m21", "12"), ("m22", "12")])
def test_resume_at_another_data_axis(source, target, data_axis):
    """A checkpoint saved at ``mesh = 2 x 1`` resumes at 1 x 1 and 1 x 2, one
    saved at 2 x 2 at 1 x 2: each rank's restored state is the saved one
    bit for bit (modules, optimizer, DCP planner, plateau, step, the random
    generators of its model index's data index 0, and its block of the
    queue: the saved whole's slice), and the next step's loss is the
    uninterrupted 2 x 1 run's within 1e-5 relative (the same batches; f32
    sums over the data axis in another order)."""
    _, runs = data_axis
    world_saved = 2 if source == "m21" else 4
    saved = runs[world_saved]
    model_saved = 1 if source == "m21" else 2
    model = 1 if target == "11" else 2
    resumed = runs[1] if target == "11" else runs[2]
    queue = np.concatenate([saved[j][f"saved{source[1:]}/1/queue"] for j in range(model_saved)],
                           axis=1)
    for rank, out in enumerate(resumed):
        got = _state_of(out, f"{source}/{target}/restored")
        # the model index's block at data index 0 (past the old model axis, index 0's)
        want = _state_of(saved[rank if rank < model_saved else 0], f"saved{source[1:]}")
        n = queue.shape[1] // model
        assert np.array_equal(got.pop("/1/queue"), queue[:, rank * n:(rank + 1) * n])
        want.pop("/1/queue")
        _assert_same(want, got)
        assert int(got["/0/step"]) == DATA_SAVE_AT
        np.testing.assert_allclose(out[f"{source}/{target}/next_loss"][-1],
                                   runs[2][0]["uninterrupted"][DATA_SAVE_AT], rtol=1e-5)


@pytest.mark.parametrize("case", SOFTMAX_CASES)
def test_softmax_data_axis_resume_matches_uninterrupted(case, data_axis):
    """The softmax head at ``mesh = 2 x 1`` (route A, and route D with its
    last-visit steps): 2 epochs straight against 1 epoch, then a fresh
    Trainer resuming for the second, bit for bit on both ranks; the two data
    ranks hold the same state (data index 1 resumes with data index 0's
    process generators, which the step does not draw from)."""
    _, runs = data_axis
    for rank, out in enumerate(runs[2]):
        assert out[f"{case}/resumed/start"].tolist() == [1, 0]
        _assert_same(_state_of(out, f"{case}/straight"), _state_of(out, f"{case}/resumed"),
                     skip=("/start",) if rank == 0 else ("/start", "/1/rng/cpu"))
        _assert_same(_state_of(out, f"{case}/resumed"), _state_of(runs[2][0], f"{case}/resumed"))
    if case == "softmax_D":
        assert int(runs[2][0][f"{case}/resumed/1/classifier_last"].max()) > 0


@pytest.mark.parametrize("case", SOFTMAX_CASES)
@pytest.mark.parametrize("source,target", [("m21", "11"), ("m22", "12")])
def test_softmax_resume_at_another_data_axis(source, target, case, data_axis):
    """The softmax head saved at ``mesh = 2 x 1`` resumes at 1 x 1, saved at
    2 x 2 at 1 x 2: each rank restores its model index's block at data
    index 0 bit for bit (classifier, momentum, last-visit steps, and the
    modules, optimizer, step and generators), and only data index 0 wrote a
    block; the next step's loss is finite."""
    tmp, runs = data_axis
    saved = runs[2 if source == "m21" else 4]
    resumed = runs[1] if target == "11" else runs[2]
    for rank, out in enumerate(resumed):
        got = _state_of(out, f"{case}/{source}/{target}/restored")
        want = _state_of(saved[rank], f"{case}/saved{source[1:]}")
        for name in ("classifier", "classifier_mom") + (
                ("classifier_last",) if case == "softmax_D" else ()):
            assert f"/1/{name}" in got
        _assert_same(want, got)
        assert int(got["/0/step"]) == DATA_SAVE_AT
        assert np.isfinite(out[f"{case}/{source}/{target}/next_loss"]).all()
    blocks = ["rank0.pt"] if source == "m21" else ["rank0.pt", "rank1.pt"]
    d = os.path.join(str(tmp), f"{case}_{source}", str(DATA_SAVE_AT))
    assert sorted(os.listdir(d)) == blocks + ["replicated.pt"]
