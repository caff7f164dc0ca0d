"""The port's FFC train step against the JAX package's ``make_train_step``.

A 3-step trajectory on the toy net in f32, with the JAX-initialised
parameters, BN statistics and queue injected into the port (the two
frameworks' RNGs differ), over both heads — the fused quad route
(``use_fused='on'``) and the dense route (``'off'``) — and both
``fuse_forward`` modes. Each step compares the losses and metrics, the
queue after direction B's write, and the probe parameters and BN stats
after the SGD update.

Tolerances: losses 1e-5 relative; the queue 1e-5 absolute (written rows
are gallery embeddings, unit vectors); parameters 1e-5 relative + 2e-5
absolute after 3 momentum steps — the conv gradients' f32 sums differ in
order between XLA's and PyTorch's CPU kernels, ~1e-5 of an update of
lr·|g| ~ 0.5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.config import Config as JConfig
from vlsfr_tpu.core.dcp import DCPManager as JDCP
from vlsfr_tpu.core.ffc import create_ffc_state as j_create_state
from vlsfr_tpu.core.ffc import make_train_step as j_make_step
from vlsfr_tpu.models import create_net as j_create_net
from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
from vlsfr_tpu.optim import make_schedule as j_make_schedule
from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import DCPManager
from vlsfr_tpu_torch.core.ffc import FFCState, make_train_step, write_rows_
from vlsfr_tpu_torch.models import create_net
from vlsfr_tpu_torch.models.from_jax import load_flax_variables, state_dict_from_flax
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.optim import make_optimizer, make_schedule

B, Q, D, SIZE = 8, 64, 16, 16
OVERRIDES = ["model.net_type=toy", f"model.feat_dim={D}", f"pool.queue_size={Q}",
             "model.dtype=float32", "pool.momentum=0.9", "optim.lr=0.05",
             "loss.scale=32", "pool.hard_neg=4"]
NO_LAUNCH = {"quad_fwd": 0, "quad_bwd": 0, "quad_partial_fwd": 0, "quad_partial_bwd": 0}


@pytest.mark.parametrize("use_fused", ["on", "off"])
@pytest.mark.parametrize("fuse_forward", [True, False])
def test_trajectory_matches_jax(use_fused, fuse_forward, rng):
    ov = OVERRIDES + [f"pool.use_fused={use_fused}", f"pool.fuse_forward={fuse_forward}"]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)

    jmodel = j_create_net("toy", feat_dim=D)
    jopt = j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE)
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 10)))

    probe = load_flax_variables(create_net("toy", feat_dim=D), jax.device_get(jstate.probe_params),
                                jax.device_get(jstate.probe_stats))
    state = FFCState(step=0, probe=probe, gallery=copy.deepcopy(probe).requires_grad_(False),
                     queue=torch.from_numpy(np.array(jstate.queue)),
                     optimizer=make_optimizer(cfg.optim, probe.parameters()))
    step = make_train_step(cfg, make_schedule(cfg.optim, 10))
    jdcp, dcp = JDCP(Q), DCPManager(Q)
    ttm.reset_launch_counts()

    for s in range(3):
        ids = rng.integers(0, 40, B // 2)
        xl = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        yl = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        x = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jdcp.plan_step(xl, yl), 1.0)
        m = step(state, x, y, dcp.plan_step(xl, yl), 1.0)
        for k in ("loss", "loss_dir_a", "loss_dir_b", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k}@{s}")
        for k in ("train_acc", "pool_hit_rate", "outlier_frac"):
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-6), f"{k}@{s}"
        np.testing.assert_allclose(state.queue.numpy(), np.asarray(jstate.queue), atol=1e-5)
        want = state_dict_from_flax(probe, jax.device_get(jstate.probe_params),
                                    jax.device_get(jstate.probe_stats))
        for k, v in probe.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"{k}@{s}")
        gwant = state_dict_from_flax(probe, jax.device_get(jstate.gallery_params),
                                     jax.device_get(jstate.gallery_stats))
        for k, v in state.gallery.state_dict().items():
            np.testing.assert_allclose(v.numpy(), gwant[k].numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"gallery {k}@{s}")
    assert state.step == 3
    assert ttm.LAUNCH_COUNTS == NO_LAUNCH  # CPU: plain versions only


def test_write_rows_last_writer_wins():
    queue = torch.zeros(2, 6, 2)
    g = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    rows = torch.tensor([0, 1, 0, 0, 1], dtype=torch.int32)
    cols = torch.tensor([3, 3, 3, 1, 3], dtype=torch.int32)
    write_rows_(queue, g, rows, cols)
    assert queue[0, 3].tolist() == [4.0, 5.0]  # entry 2 beats entry 0
    assert queue[1, 3].tolist() == [8.0, 9.0]  # entry 4 beats entry 1
    assert queue[0, 1].tolist() == [6.0, 7.0]
    assert float(queue.sum()) == 4 + 5 + 8 + 9 + 6 + 7


@pytest.mark.parametrize("use_fused", ["on", "off"])
def test_trainer_synthetic_cpu_run(use_fused, tmp_path):
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(
        ["model.net_type=toy", "model.feat_dim=16", "pool.queue_size=200", "data.batch_size=8",
         "data.image_size=16", "data.synthetic_ids=30", "data.synthetic_images_per_id=3",
         "data.num_workers=2", "model.dtype=float32", "train.print_freq=2",
         f"pool.use_fused={use_fused}", "pool.fuse_forward=true", "optim.lr=0.01"])
    cfg.data.synthetic = True
    cfg.train.saved_dir = str(tmp_path)
    ttm.reset_launch_counts()
    trainer = Trainer(cfg, device="cpu")
    try:
        out = trainer.train(max_steps=4)
    finally:
        trainer.close()
    assert out["final_step"] == 4 and trainer.state.step == 4
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert ttm.LAUNCH_COUNTS == NO_LAUNCH


def test_entry_points_refuse_without_card_or_unported():
    from vlsfr_tpu_torch.core.ffc import create_ffc_state
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(["model.net_type=toy", "model.feat_dim=8",
                                    "pool.queue_size=16"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_ffc_state(create_net("toy", feat_dim=8), cfg)
    for bad in (["pool.head=full_softmax", "pool.classifier_dtype=bfloat16"],
                ["train.eval_freq=10"], ["mesh.data=2"]):
        with pytest.raises(NotImplementedError):
            Trainer(Config().apply_overrides(bad), device="cpu")
    # the sharded head runs one process per card: mesh.model=2 in one process
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=2"):
        Trainer(cfg.apply_overrides(["mesh.model=2", "pool.use_fused=on"]), device="cpu")
    if not torch.cuda.is_available():  # the sharded route too runs on cuda unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(Config().apply_overrides(["pool.use_fused=on", "pool.force_sharded=true"]))
    for bad in (["pool.queue_dtype=int8"], ["pool.gallery_int8=true"]):
        with pytest.raises(NotImplementedError):
            make_train_step(Config().apply_overrides(bad), lambda s: 0.1)
