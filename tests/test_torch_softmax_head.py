"""The port's full-softmax head (vlsfr_tpu_torch/train/softmax_head.py)
against the JAX package's ``make_softmax_train_step``.

Three-step trajectories on the toy net in f32 (feat 32, batch 8, 96
classes, one fixed batch with a repeated class: the setup of
tests/test_fused_update.py), with the JAX-initialised backbone, BN
statistics and classifier injected into the port, over the three ported
routes: A (fused-SGD streaming, ``use_fused=on``, ``fused_update=auto``),
B (streaming + SGD, ``fused_update=off``) and C (dense, ``use_fused=off``).
Each step compares loss, ce, train_acc and lr; after three steps the
classifier, route A's classifier momentum and the backbone parameters and
BN statistics. On the CPU every kernel wrapper runs its plain version.

Tolerances: losses 1e-5 relative, train_acc 1e-6; backbone 1e-5 relative
+ 2e-5 absolute (tests/test_torch_ffc_step.py: XLA's and PyTorch's CPU
convolutions sum in another order). The classifier is held to 2e-5 ×
max|w − w₀|: the head's gradient amplifies those ~1e-7 embedding
differences by scale·cos (p moves by 32·δcos relative) and by 1/‖w‖ ≈ 17
on the 0.01·N(0, 1) rows at init, so the classifier carries f32 noise of
~1e-5 of its update (measured: 1.0e-5 to 1.2e-5 on all three routes,
against updates of 3 to 6). Route A's momentum is held to 1e-4 × max|mom|:
it sums the three steps' gradients without the lr factor, and on a target
row the streamed and label-row terms partly cancel (measured: 2.5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.config import Config as JConfig
from vlsfr_tpu.models import create_net as j_create_net
from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
from vlsfr_tpu.optim import make_schedule as j_make_schedule
from vlsfr_tpu.train.softmax_head import create_softmax_state as j_create_state
from vlsfr_tpu.train.softmax_head import make_softmax_train_step as j_make_step
from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.models import create_net
from vlsfr_tpu_torch.models.from_jax import load_flax_variables, state_dict_from_flax
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.optim import make_schedule
from vlsfr_tpu_torch.train.softmax_head import (
    _fused_update_on,
    create_softmax_state,
    make_softmax_train_step,
)

B, C, D, SIZE = 8, 96, 32, 32
BASE = ["model.net_type=toy", f"model.feat_dim={D}", "model.dtype=float32",
        f"data.batch_size={B}", "pool.head=full_softmax", f"pool.num_classes={C}",
        "optim.lr=0.05"]
ROUTES = {"A": ["pool.use_fused=on", "pool.fused_update=auto"],
          "B": ["pool.use_fused=on", "pool.fused_update=off"],
          "C": ["pool.use_fused=off"]}


def _jax_and_port(route):
    ov = BASE + ROUTES[route]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jmodel = j_create_net("toy", feat_dim=D)
    jopt = j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE, C)
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 100)))
    backbone = load_flax_variables(create_net("toy", feat_dim=D),
                                   jax.device_get(jstate.params["backbone"]),
                                   jax.device_get(jstate.batch_stats))
    state = create_softmax_state(backbone, cfg, C, device="cpu",
                                 classifier=torch.from_numpy(np.array(jstate.params["classifier"])))
    return jstate, jstep, state, make_softmax_train_step(cfg, make_schedule(cfg.optim, 100))


@pytest.mark.parametrize("route", ["A", "B", "C"])
def test_trajectory_matches_jax(route, rng):
    jstate, jstep, state, step = _jax_and_port(route)
    assert (state.classifier_mom is not None) == (route == "A")
    w0 = np.array(jstate.params["classifier"])
    images = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    labels[1] = labels[0]  # a repeated class: both rows' gradients reach its row
    tms.reset_launch_counts()
    losses = []
    for s in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), 1.0)
        m = step(state, images, labels, 1.0)
        for k in ("loss", "ce", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k}@{s}")
        assert float(m["train_acc"]) == pytest.approx(float(jm["train_acc"]), abs=1e-6)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    jw = np.asarray(jstate.params["classifier"])
    np.testing.assert_allclose(state.classifier.detach().numpy(), jw,
                               atol=2e-5 * np.abs(jw - w0).max())
    if route == "A":
        jmom = np.asarray(jstate.opt_state["classifier_mom"])
        np.testing.assert_allclose(state.classifier_mom.numpy(), jmom,
                                   atol=1e-4 * np.abs(jmom).max())
    want = state_dict_from_flax(state.backbone, jax.device_get(jstate.params["backbone"]),
                                jax.device_get(jstate.batch_stats))
    for k, v in state.backbone.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=2e-5, err_msg=k)
    assert state.step == 3
    assert tms.LAUNCH_COUNTS == {"margin_ce_fwd": 0, "margin_ce_bwd": 0,
                                 "margin_ce_bwd_fused_sgd": 0}  # CPU: plain versions only


def test_route_a_matches_route_b():
    """Three steps of the fused-update head == three of streaming + SGD on
    one fixed batch (tests/test_fused_update.py:229), started from the
    same seed, and the loss falls."""
    runs = []
    for route in ("A", "B"):
        cfg = Config().apply_overrides(BASE + ROUTES[route])
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            backbone = create_net("toy", feat_dim=D)
        state = create_softmax_state(backbone, cfg, C, device="cpu", seed=3)
        runs.append((state, make_softmax_train_step(cfg, make_schedule(cfg.optim, 100))))
    (sa, step_a), (sb, step_b) = runs
    assert _fused_update_on(Config().apply_overrides(BASE + ROUTES["A"]))
    npr = np.random.default_rng(7)
    images = npr.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    labels = npr.integers(0, C, B).astype(np.int32)
    losses_a, losses_b = [], []
    for _ in range(3):
        losses_a.append(float(step_a(sa, images, labels)["loss"]))
        losses_b.append(float(step_b(sb, images, labels)["loss"]))
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-5)
    np.testing.assert_allclose(sa.classifier.numpy(), sb.classifier.detach().numpy(),
                               atol=1e-6, rtol=1e-5)
    for pa, pb in zip(sa.backbone.parameters(), sb.backbone.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(), atol=1e-5,
                                   rtol=1e-4)
    assert losses_a[-1] < losses_a[0]  # it learns


@pytest.mark.parametrize("fused_update", ["auto", "off"])
def test_trainer_synthetic_cpu_run(fused_update, tmp_path):
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(
        ["model.net_type=toy", "model.feat_dim=16", "data.batch_size=8", "data.image_size=16",
         "data.synthetic_ids=30", "data.synthetic_images_per_id=3", "data.num_workers=2",
         "model.dtype=float32", "train.print_freq=2", "pool.head=full_softmax",
         "pool.use_fused=on", f"pool.fused_update={fused_update}", "optim.lr=0.01"])
    cfg.data.synthetic = True
    cfg.train.saved_dir = str(tmp_path)
    tms.reset_launch_counts()
    trainer = Trainer(cfg, device="cpu")
    try:
        assert cfg.pool.num_classes == 30  # from the store
        out = trainer.train(max_steps=4)
    finally:
        trainer.close()
    assert out["final_step"] == 4 and trainer.state.step == 4
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert (trainer.state.classifier_mom is not None) == (fused_update == "auto")
    assert tms.LAUNCH_COUNTS == {"margin_ce_fwd": 0, "margin_ce_bwd": 0,
                                 "margin_ce_bwd_fused_sgd": 0}


@pytest.mark.parametrize("bad", [["pool.sample_rate=0.1"], ["pool.sparse_update=true"],
                                 ["pool.classifier_dtype=bfloat16"], ["mesh.model=2"]])
def test_unported_options_raise(bad):
    cfg = Config().apply_overrides(BASE + ROUTES["A"] + bad)
    with pytest.raises(NotImplementedError):
        create_softmax_state(create_net("toy", feat_dim=D), cfg, C, device="cpu")
    with pytest.raises(NotImplementedError):
        make_softmax_train_step(cfg, lambda s: 0.1)


def test_fused_update_eligibility():
    """'on' + an ineligible config raises, as in JAX; 'auto' falls back to
    route B."""
    cfg = Config().apply_overrides(BASE + ROUTES["A"] + ["optim.grad_clip=5.0"])
    assert not _fused_update_on(cfg)
    cfg.pool.fused_update = "on"
    with pytest.raises(ValueError):
        _fused_update_on(cfg)
    with pytest.raises(ValueError):
        make_softmax_train_step(cfg, lambda s: 0.1)
    cfg.optim.grad_clip = 0.0
    assert _fused_update_on(cfg)
