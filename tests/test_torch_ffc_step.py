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
from vlsfr_tpu_torch.core.ffc import FFCState, make_train_step, state_from_jax, write_rows_
from vlsfr_tpu_torch.models import create_net
from vlsfr_tpu_torch.models.from_jax import load_flax_variables, state_dict_from_flax
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.optim import make_optimizer, make_schedule

B, Q, D, SIZE = 8, 64, 16, 16
OVERRIDES = ["model.net_type=toy", f"model.feat_dim={D}", f"pool.queue_size={Q}",
             "model.dtype=float32", "pool.momentum=0.9", "optim.lr=0.05",
             "loss.scale=32", "pool.hard_neg=4"]
NO_LAUNCH = dict.fromkeys(ttm.LAUNCH_COUNTS, 0)


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
    # the softmax head's routes all run on a class-sharded mesh and the FFC
    # head on the data axis (tests/test_torch_data_axis.py); a pretrained
    # backbone is still refused
    for bad in (["train.pretrained_model_path=backbone.pt"],):
        with pytest.raises(NotImplementedError):
            Trainer(Config().apply_overrides(bad), device="cpu")
    # the sharded head runs one process per card: mesh.model=2 in one process
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=2"):
        Trainer(cfg.apply_overrides(["mesh.model=2", "pool.use_fused=on"]), device="cpu")
    if not torch.cuda.is_available():  # the sharded route too runs on cuda unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(Config().apply_overrides(["pool.use_fused=on", "pool.force_sharded=true"]))
    # an int8 queue (with int8 compute) runs on the CPU: its step is the plain versions'
    cfg = Config().apply_overrides(["model.net_type=toy", "model.feat_dim=8",
                                    "pool.queue_size=16", "pool.queue_dtype=int8",
                                    "pool.queue_int8_compute=true", "pool.use_fused=on"])
    state = create_ffc_state(create_net("toy", feat_dim=8), cfg, device="cpu")
    assert state.queue.dtype == torch.int8 and state.queue_scales.shape == (2, 16)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 6, 4)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    m = make_train_step(cfg, lambda s: 0.1)(state, x, x, DCPManager(16).plan_step(labels, labels))
    assert np.isfinite(float(m["loss"])) and state.queue.dtype == torch.int8
    # pool.gallery_int8 runs on the CPU too: the gallery forward on int8 convs
    # (held to JAX's step in tests/test_torch_quant.py)
    from vlsfr_tpu_torch.ops import quant

    cfg = cfg.apply_overrides(["pool.gallery_int8=true"])
    quant.reset_launch_counts()
    m = make_train_step(cfg, lambda s: 0.1)(state, x, x, DCPManager(16).plan_step(labels, labels))
    # the toy net's two convs in each gallery forward, gallery(y) and gallery(x)
    assert np.isfinite(float(m["loss"])) and quant.LAUNCH_COUNTS["int8_conv"] == 4


def test_fused_batch_above_kernel_rows_refused_up_front():
    """On a card the fused head's kernels take any batch: the check the
    Trainer and ``create_ffc_state`` run before anything is built accepts
    the shipped 10M config's 512 (and 256) rows per direction on either
    device and head, and refuses only a feature width the kernels do not
    take (a multiple of 64 up to 512) on a card; the CPU's plain versions
    take any."""
    from vlsfr_tpu_torch.core.ffc import check_kernel_width

    for over in (["data.batch_size=512", "pool.use_fused=on"],
                 ["data.batch_size=256", "pool.use_fused=on"],
                 ["data.batch_size=512", "pool.use_fused=off"],
                 ["data.batch_size=128", "pool.use_fused=on"]):
        for device in ("cpu", torch.device("cuda")):
            check_kernel_width(Config().apply_overrides(over), device)
    narrow = Config().apply_overrides(["data.batch_size=512", "pool.use_fused=on",
                                       "model.feat_dim=96"])
    check_kernel_width(narrow, "cpu")
    with pytest.raises(NotImplementedError, match="feat_dim=96 on the fused FFC head's kernels"):
        check_kernel_width(narrow, torch.device("cuda"))
    check_kernel_width(Config().apply_overrides(["model.feat_dim=96", "pool.use_fused=off"]),
                       "cuda")


class Pinned(torch.nn.Module):
    """A net whose output carries the bits of ``target`` while its gradient
    flows through ``net``: out + (target − out), exact (Sterbenz) where the
    two agree to a factor of 2."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.target = None

    def forward(self, x):
        out = self.net(x)
        pinned = out + (self.target - out).detach()
        assert torch.equal(pinned, self.target)
        return pinned


def test_int8c_trajectory_matches_jax(rng, monkeypatch):
    """The slice as a whole on the toy net: 3 FFC steps on an int8 queue
    with int8 compute (``pool.use_fused=on``) against JAX's
    ``make_train_step``, whose quad head is forced onto its Pallas kernels
    in interpret mode (on the CPU JAX otherwise takes its scan fallback,
    which computes in f32 on the dequantised rows and ignores int8
    compute); the tile is 64 columns on both sides. The JAX-initialised
    queue and scales are carried in.

    The int8-compute head rounds the probes and gallery rows to bf16 (and
    quantises the probes), which turns the two backbones' last-bit
    differences (conv sums in another order) into loss differences of
    1e-5 relative wherever an element straddles a rounding boundary. So
    each step pins both nets' outputs to the bits of JAX's forward of that
    step (``Pinned``; the gradient still flows through the port's nets),
    and the test sees the head, the write and the update: losses and
    metrics 1e-5, the queue and its scales bit-equal after every write,
    parameters as in ``test_trajectory_matches_jax``."""
    from vlsfr_tpu.ops import twin_margin as jtm

    orig_add = jtm.quad_add_margin
    monkeypatch.setattr(jtm, "quad_add_margin",
                        lambda *a, **k: orig_add(*a, **dict(k, use_pallas=True)))
    for name in ("pallas_quad_fwd", "pallas_quad_bwd"):
        orig = getattr(jtm, name)
        monkeypatch.setattr(jtm, name, lambda *a, _f=orig, **k: _f(*a, interpret=True, **k))
    ov = OVERRIDES + ["pool.use_fused=on", "pool.fuse_forward=true", "pool.queue_dtype=int8",
                      "pool.queue_int8_compute=true", "pool.queue_tile=64"]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jmodel = j_create_net("toy", feat_dim=D)
    jopt = j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE)
    jstep = j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 10))

    def jax_forward(params, stats, data):
        return np.array(jmodel.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(data), train=True, mutable=["batch_stats"])[0])

    net = load_flax_variables(create_net("toy", feat_dim=D), jax.device_get(jstate.probe_params),
                              jax.device_get(jstate.probe_stats))
    probe, gallery = Pinned(net), Pinned(copy.deepcopy(net).requires_grad_(False))
    queue, scales = state_from_jax(np.asarray(jstate.queue), np.asarray(jstate.queue_scales))
    assert queue.dtype == torch.int8 and scales.shape == (2, Q)
    state = FFCState(step=0, probe=probe, gallery=gallery, queue=queue,
                     optimizer=make_optimizer(cfg.optim, probe.parameters()), queue_scales=scales)
    step = make_train_step(cfg, make_schedule(cfg.optim, 10))
    jdcp, dcp = JDCP(Q), DCPManager(Q)
    m_ema = jcfg.pool.momentum
    ttm.reset_launch_counts()
    for s in range(3):
        ids = rng.integers(0, 40, B // 2)
        xl = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        yl = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        x = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        g_params = jax.tree.map(lambda g_, p_: m_ema * g_ + (1.0 - m_ema) * p_,
                                jstate.gallery_params, jstate.probe_params)
        probe.target = torch.from_numpy(jax_forward(jstate.probe_params, jstate.probe_stats,
                                                    np.concatenate([x, y])))
        gallery.target = torch.from_numpy(jax_forward(g_params, jstate.gallery_stats,
                                                      np.concatenate([y, x])))
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jdcp.plan_step(xl, yl), 1.0)
        m = step(state, x, y, dcp.plan_step(xl, yl), 1.0)
        for k in ("loss", "loss_dir_a", "loss_dir_b", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k}@{s}")
        for k in ("train_acc", "pool_hit_rate", "outlier_frac"):
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-6), f"{k}@{s}"
        np.testing.assert_array_equal(state.queue.numpy(), np.asarray(jstate.queue))
        np.testing.assert_array_equal(state.queue_scales.numpy(), np.asarray(jstate.queue_scales))
        want = state_dict_from_flax(net, jax.device_get(jstate.probe_params),
                                    jax.device_get(jstate.probe_stats))
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"{k}@{s}")
    assert state.step == 3 and state.queue.dtype == torch.int8
    assert ttm.LAUNCH_COUNTS == NO_LAUNCH


def test_logged_record_keys_match_jax(tmp_path):
    """The Trainer's logged record carries JAX's keys, ``images_per_sec``
    and ``images_per_sec_chip`` included; the rate per card is the rate
    over the cards of the model axis (every rank trains the same batch)."""
    import json

    pytest.importorskip("cv2")  # the JAX package's store encodes JPEG
    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.data.synthetic import generate_synthetic_store
    from vlsfr_tpu.train.trainer import Trainer as JTrainer
    from vlsfr_tpu_torch.train.trainer import Trainer
    from vlsfr_tpu_torch.utils.metrics import Throughput

    ov = ["model.net_type=toy", "model.feat_dim=16", "model.dtype=float32", "data.batch_size=8",
          "data.image_size=16", "data.num_workers=1", "pool.queue_size=64", "optim.epochs=1",
          "train.print_freq=1", "train.steps_per_epoch=2", "train.save_freq=1000",
          "train.eval_freq=0"]
    keys = []
    for name in ("jax", "torch"):
        logs = tmp_path / name
        cfg = (JConfig() if name == "jax" else Config()).apply_overrides(ov)
        cfg.train.saved_dir = str(tmp_path / f"{name}_ckpt")
        cfg.train.log_dir = str(logs)
        if name == "jax":
            store = tmp_path / "store"
            generate_synthetic_store(str(store), num_ids=10, images_per_id=4, image_size=16,
                                     seed=0)
            cfg.data.sources = [str(store)]
            trainer = JTrainer(cfg)
        else:
            cfg.data.synthetic = True
            cfg.data.synthetic_ids, cfg.data.synthetic_images_per_id = 10, 4
            trainer = Trainer(cfg, device="cpu")
        try:
            trainer.train()
        finally:
            trainer.close()
        rows = [json.loads(ln) for ln in open(logs / "metrics.jsonl")]
        keys.append({k for r in rows if r.get("prefix") == "train" for k in r})
    assert "images_per_sec_chip" in keys[0]
    assert keys[1] == keys[0]
    thr = Throughput(4)
    thr.update(256)
    ips, ips_chip = thr.value()
    assert ips_chip == pytest.approx(ips / 4)
