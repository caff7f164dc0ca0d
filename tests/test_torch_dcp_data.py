"""Host-side parts of the port against the JAX package: the DCP planner,
the data index plans, the schedules, the SGD trajectory, the config and
the CLI's flags.
All are exact (integer plans) or f32-exact up to operation order."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlsfr_tpu.config import Config as JConfig
from vlsfr_tpu.core.dcp import DCPManager as JDCP
from vlsfr_tpu.data.pipeline import InstanceStream as JInstance
from vlsfr_tpu.data.pipeline import InstancePipeline as JInstancePipeline
from vlsfr_tpu.data.pipeline import _rng as j_rng
from vlsfr_tpu.data.pipeline import PairStream as JPair
from vlsfr_tpu.data.records import MultiSourceReader as JReader
from vlsfr_tpu.optim import PlateauController as JPlateau
from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
from vlsfr_tpu.optim import make_schedule as j_make_schedule
from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import DCPManager
from vlsfr_tpu_torch.data.pipeline import (
    FFCPipeline,
    InstancePipeline,
    InstanceStream,
    PairStream,
    decode_image,
)
from vlsfr_tpu_torch.data.records import MultiSourceReader
from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store
from vlsfr_tpu_torch.optim import PlateauController, make_optimizer, make_schedule, set_learning_rate


def _assert_plan_equal(got, want):
    for side in ("a", "b"):
        g, w = getattr(got, side), getattr(want, side)
        for f in ("rows", "cols", "seen", "fake_labels"):
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f)),
                                          err_msg=f"{side}.{f}")


@pytest.mark.parametrize("queue_size", [5, 40])
def test_plan_step_matches_jax(queue_size, rng):
    """Random label streams with evictions (small pool) and duplicates,
    plus a state_dict/restore in the middle of the stream."""
    mine, ref = DCPManager(queue_size), JDCP(queue_size)
    for step in range(12):
        x = rng.integers(0, 60, 8)
        y = np.concatenate([x[:4], rng.integers(0, 60, 4)])
        _assert_plan_equal(mine.plan_step(x, y), ref.plan_step(x, y))
        if step == 5:
            restored = DCPManager(queue_size)
            restored.restore(ref.state_dict())
            mine = restored
            assert mine.state_dict()["lru"] == ref.state_dict()["lru"]
    np.testing.assert_array_equal(mine.state_dict()["parity"], ref.state_dict()["parity"])
    with pytest.raises(ValueError):
        DCPManager(queue_size + 1).restore(mine.state_dict())


@pytest.fixture
def raw_store(tmp_path):
    return generate_synthetic_store(str(tmp_path / "syn"), num_ids=13, images_per_id=3,
                                    image_size=16, seed=4)


def test_index_plans_match_jax(raw_store):
    """Same records and pairs per (seed, epoch, step); the store written by
    the port opens in the JAX reader too (same on-disk format)."""
    mine, ref = MultiSourceReader([raw_store]), JReader([raw_store], native=False)
    np.testing.assert_array_equal(mine.labels, ref.labels)
    assert mine.num_class == ref.num_class == 13
    for limit in (None, 30):
        ti, ji = InstanceStream(mine, 6, 3, limit), JInstance(ref, 6, 3, limit)
        tp, jp = PairStream(mine, 3, 3, limit), JPair(ref, 3, 3, limit)
        assert ti.steps_per_epoch() == ji.steps_per_epoch()
        for epoch in range(2):
            for step in range(ti.steps_per_epoch()):
                np.testing.assert_array_equal(ti.batch_indices(epoch, step),
                                              ji.batch_indices(epoch, step))
                for a, b in zip(tp.batch(epoch, step), jp.batch(epoch, step)):
                    np.testing.assert_array_equal(a, b)
    mine.close()
    ref.close()


def test_instance_pipeline_plans_match_jax(raw_store):
    """The full-softmax pipeline draws the same records, labels and flips
    per (seed, epoch, step) as the JAX package's ``InstancePipeline``, and
    its batches are those records, decoded and flipped."""
    mine, ref = MultiSourceReader([raw_store]), JReader([raw_store], native=False)
    pipe = InstancePipeline(mine, 6, 16, seed=5, num_workers=2, prefetch=1, record_limit=30)
    jpipe = JInstancePipeline(ref, 6, 16, seed=5, num_workers=1, record_limit=30)
    try:
        assert pipe.steps_per_epoch() == jpipe.steps_per_epoch() == 5
        assert jpipe.num_class == 13
        for epoch in range(2):
            for step in range(pipe.steps_per_epoch()):
                idx, flips, labels = pipe.batch_plan(epoch, step)
                jidx = jpipe.instance.batch_indices(epoch, step)
                np.testing.assert_array_equal(idx, jidx)
                np.testing.assert_array_equal(labels, np.asarray(ref.labels[jidx], np.int32))
                np.testing.assert_array_equal(
                    flips, j_rng(5, epoch, step, 0xF12).random(len(jidx)) < 0.5)
        batches = list(pipe.epoch_iter(1, start_step=3))
        assert [b.step for b in batches] == [3, 4]
        idx, flips, labels = pipe.batch_plan(1, 3)
        img = decode_image(mine.payload(int(idx[0])), 16)
        want = (img[:, ::-1] if flips[0] else img).astype(np.float32) * 0.0078125 - 127.5 * 0.0078125
        np.testing.assert_allclose(batches[0].images[0], want, atol=1e-6)
        np.testing.assert_array_equal(batches[0].labels, labels)
    finally:
        pipe.close()
        jpipe.close()
        mine.close()
        ref.close()


def test_raw_pipeline_batches(raw_store):
    reader = MultiSourceReader([raw_store])
    pipe = FFCPipeline(reader, 6, 16, seed=1, num_workers=2, prefetch=1)
    try:
        batches = list(pipe.epoch_iter(0))
        assert len(batches) == pipe.steps_per_epoch() == 6
        b = batches[0]
        assert b.x.shape == (6, 16, 16, 3) and b.x.dtype == np.float32
        assert np.all(np.abs(b.x) <= 1.0)
        np.testing.assert_array_equal(b.x_label[:3], b.y_label[:3])  # the identity pairs
        assert len(list(pipe.epoch_iter(0, start_step=2, stop_step=4))) == 2
        img = decode_image(reader.payload(0), 8)  # raw payload, resized on decode
        assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    finally:
        pipe.close()
        reader.close()
    with pytest.raises((RuntimeError, ValueError)):
        decode_image(b"\xff\xd8not-a-jpeg", 16)


SCHEDULES = [
    dict(scheduler="multistep", milestones=[1, 3], gammas=[0.1, 0.5], warmup_epochs=1),
    dict(scheduler="cos", eta_min=1e-3, warmup_epochs=2, epochs=6),
    dict(scheduler="exponential", gamma=0.8),
    dict(scheduler="linear", lr_min=1e-4, epochs=5),
    dict(scheduler="plateau"),
]


@pytest.mark.parametrize("overrides", SCHEDULES)
def test_schedules_match_jax(overrides):
    tc, jc = Config().optim, JConfig().optim
    for k, v in overrides.items():
        setattr(tc, k, v)
        setattr(jc, k, v)
    mine, ref = make_schedule(tc, 7), j_make_schedule(jc, 7)
    for step in range(0, 60, 3):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-6, err_msg=str(step))


def test_plateau_matches_jax():
    mine, ref = PlateauController(patience=2, min_lr=1e-3), JPlateau(patience=2, min_lr=1e-3)
    for loss in [5, 4, 4.5, 4.2, 4.1, 4.3, 4.4, 4.6, 3.9, 4.0, 4.0, 4.0, 4.0]:
        assert mine.observe(loss) == ref.observe(loss)


@pytest.mark.parametrize("nesterov,weight_decay,momentum",
                         [(True, 1e-4, 0.9), (False, 5e-4, 0.9), (False, 0.0, 0.0)])
def test_sgd_trajectory_matches_optax(nesterov, weight_decay, momentum, rng):
    """torch SGD == the optax chain (coupled decay → trace → -lr), with a
    new learning rate each step. f32; 1e-6 relative over 6 steps."""
    cfg = Config().optim
    cfg.nesterov, cfg.weight_decay, cfg.momentum = nesterov, weight_decay, momentum
    jcfg = JConfig().optim
    jcfg.nesterov, jcfg.weight_decay, jcfg.momentum = nesterov, weight_decay, momentum
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = make_optimizer(cfg, tparams)
    jopt = j_make_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = jopt.init(jparams)
    for step in range(6):
        lr = 0.1 / (step + 1)
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in p0]
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        set_learning_rate(topt, lr)
        topt.step()
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, j in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError):
        cfg.optim = "RMSprop"
        make_optimizer(cfg, tparams)


@pytest.mark.parametrize("argv", [
    [],
    ["--net_type", "ir50", "--queue_size", "1048576", "--batch_size", "128", "--alpha", "0.9",
     "--loss_type", "SV", "--margin", "0.3", "--scale", "64", "--print_freq", "5",
     "--synthetic", "--sources", "a", "b", "--set", "pool.fuse_forward=true",
     "--set", "optim.lr=0.05"],
    ["--head", "full_softmax", "--net_type", "toy", "--synthetic", "--set", "pool.num_classes=200",
     "--set", "pool.use_fused=on", "--set", "pool.fused_update=off"],
    ["--head", "full_softmax", "--net_type", "ir50", "--batch_size", "128", "--synthetic",
     "--set", "pool.num_classes=1048576", "--set", "pool.sparse_update=true",
     "--set", "pool.sparse_grad_rate=0.05"],
    ["--net_type", "ir50", "--queue_size", "1048576", "--batch_size", "128", "--synthetic",
     "--set", "mesh.model=4", "--set", "mesh.data=1", "--set", "pool.force_sharded=true"],
])
def test_cli_flags_match_train_py(argv):
    """The port's CLI maps the flags of the JAX package's train.py onto the
    same config; --device defaults to cuda."""
    import train as jtrain
    from vlsfr_tpu_torch.train.cli import build_config

    cfg, device = build_config(argv)
    assert device == "cuda"
    assert cfg.to_dict() == jtrain.build_config(argv).to_dict()
    assert build_config(argv + ["--device", "cpu"])[1] == "cpu"


def test_config_tree_and_overrides_match_jax(tmp_path):
    mine, ref = Config(), JConfig()
    assert mine.to_dict() == ref.to_dict()
    ov = ["pool.queue_size=1048576", "pool.fuse_forward=true", "optim.milestones=[2,4]",
          "loss.scale=64", "model.dtype=float32"]
    mine.apply_overrides(ov)
    ref.apply_overrides(ov)
    assert mine.to_dict() == ref.to_dict()
    path = str(tmp_path / "cfg.json")
    mine.save(path)
    assert Config.load(path).to_dict() == JConfig.load(path).to_dict()
    assert jax.default_backend() == "cpu"
