"""The port's full-softmax head (vlsfr_tpu_torch/train/softmax_head.py)
against the JAX package's ``make_softmax_train_step``.

Three-step trajectories on the toy net in f32 (feat 32, batch 8, 96
classes, one fixed batch with a repeated class: the setup of
tests/test_fused_update.py), with the JAX-initialised backbone, BN
statistics and classifier injected into the port, over routes A
(fused-SGD streaming, ``use_fused=on``, ``fused_update=auto``), B
(streaming + SGD, ``fused_update=off``) and C (dense, ``use_fused=off``);
and at 8192 classes over route D (sparse-d_w streaming, ``use_fused=on``,
``sparse_update``, ``sparse_grad_rate=0.25``: 16 tiles of 512, 8 selected,
so truncation, the random fill and the importance weights all take part)
and route E (partial-FC, ``sample_rate=0.1``, with ``sparse_update`` and
with the dense optimizer). Routes D and E take JAX's own random draws
(monkeypatched into ``tile_fill_draws`` / ``sample_draws``). Each step
compares loss, ce, train_acc and lr; after three steps the classifier, the
classifier momentum (routes A, D, sparse E), the last-visit steps
(exactly) and the backbone parameters and BN statistics. On the CPU every
kernel wrapper runs its plain version.

Tolerances: losses 1e-5 relative, train_acc 1e-6; backbone 1e-5 relative
+ 2e-5 absolute (tests/test_torch_ffc_step.py: XLA's and PyTorch's CPU
convolutions sum in another order). The classifier is held to 2e-5 ×
max|w − w₀|: the head's gradient amplifies those ~1e-7 embedding
differences by scale·cos (p moves by 32·δcos relative) and by 1/‖w‖ ≈ 17
on the 0.01·N(0, 1) rows at init, so the classifier carries f32 noise of
~1e-5 of its update (measured: 1.0e-5 to 1.2e-5 on all three routes,
against updates of 3 to 6). Route A's momentum is held to 1e-4 × max|mom|:
it sums the three steps' gradients without the lr factor, and on a target
row the streamed and label-row terms partly cancel (measured: 2.5e-5). On
routes D and E the same noise is there from the first step (1.3e-5 ×
max|w − w₀| on all three at this batch) and grows over the three steps on
route D's importance-weighted rows (measured 2.5e-5 at step 3; 0.5e-5 and
1.4e-5 with two other batches), so their classifier is held to 4e-5 ×
max|w − w₀|; their momentum to 1e-4 × max|mom| as route A's (measured
3.7e-5 on D, 2.8e-5 on E).
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
from vlsfr_tpu_torch.train import softmax_head
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
SPARSE_C = 8192  # below pool.streaming_threshold: route D sets use_fused=on
SPARSE_ROUTES = {
    "D": ["pool.use_fused=on", "pool.sparse_update=true", "pool.sparse_grad_rate=0.25"],
    "E": ["pool.sample_rate=0.1", "pool.sparse_update=true"],
    "E-dense": ["pool.sample_rate=0.1"]}
NO_LAUNCH = {"margin_ce_fwd": 0, "margin_ce_bwd": 0, "margin_ce_bwd_fused_sgd": 0,
             "margin_ce_bwd_sparse": 0, "margin_partial_fwd": 0, "margin_partial_bwd": 0}


def _jax_and_port(route, c=C):
    ov = BASE + (ROUTES[route] if route in ROUTES else SPARSE_ROUTES[route])
    ov += [f"pool.num_classes={c}"]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jmodel = j_create_net("toy", feat_dim=D)
    jopt = j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE, c)
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 100)))
    backbone = load_flax_variables(create_net("toy", feat_dim=D),
                                   jax.device_get(jstate.params["backbone"]),
                                   jax.device_get(jstate.batch_stats))
    state = create_softmax_state(backbone, cfg, c, device="cpu",
                                 classifier=torch.from_numpy(np.array(jstate.params["classifier"])))
    return jstate, jstep, state, make_softmax_train_step(cfg, make_schedule(cfg.optim, 100))


def _jax_draws(monkeypatch):
    """The port's two draw functions return JAX's draws for the step: the
    uniform tile fill of ``fold_in(PRNGKey(23), step)`` and the sampled
    negatives of ``fold_in(PRNGKey(17), step)``."""
    def tile_fill(step, n, device, rank=None):
        key = jax.random.fold_in(jax.random.PRNGKey(23), step)
        if rank is not None:  # a rank of a mesh folds in its model index
            key = jax.random.fold_in(key, rank)
        return torch.from_numpy(np.array(jax.random.uniform(key, (n,)))).to(device)

    def sample(step, n, c, device):
        key = jax.random.fold_in(jax.random.PRNGKey(17), step)
        return torch.from_numpy(np.array(jax.random.randint(key, (n,), 0, c))).to(device)

    monkeypatch.setattr(softmax_head, "tile_fill_draws", tile_fill)
    monkeypatch.setattr(softmax_head, "sample_draws", sample)


def _assert_backbone(state, jstate):
    want = state_dict_from_flax(state.backbone, jax.device_get(jstate.params["backbone"]),
                                jax.device_get(jstate.batch_stats))
    for k, v in state.backbone.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=2e-5, err_msg=k)


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
    _assert_backbone(state, jstate)
    assert state.step == 3
    assert tms.LAUNCH_COUNTS == NO_LAUNCH  # CPU: plain versions only


@pytest.mark.parametrize("route", list(SPARSE_ROUTES))
def test_sparse_route_trajectory_matches_jax(route, rng, monkeypatch):
    """Routes D, E (sparse row update) and E with the dense optimizer:
    three steps against JAX's, on JAX's draws."""
    _jax_draws(monkeypatch)
    jstate, jstep, state, step = _jax_and_port(route, SPARSE_C)
    sparse = route != "E-dense"
    assert (state.classifier_last is not None) == sparse
    assert state.classifier.requires_grad != sparse
    w0 = np.array(jstate.params["classifier"])
    images = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, SPARSE_C, B).astype(np.int32)
    labels[1] = labels[0]
    tms.reset_launch_counts()
    for s in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), 1.0)
        m = step(state, images, labels, 1.0)
        for k in ("loss", "ce", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k}@{s}")
        assert float(m["train_acc"]) == pytest.approx(float(jm["train_acc"]), abs=1e-6)
        extra = "grad_rows" if route == "D" else "sampled_classes"
        assert m[extra] == int(jm[extra]) == (8 * 512 if route == "D" else 819)
    jw = np.asarray(jstate.params["classifier"])
    np.testing.assert_allclose(state.classifier.detach().numpy(), jw,
                               atol=4e-5 * np.abs(jw - w0).max())
    if sparse:
        jmom = np.asarray(jstate.opt_state["classifier_mom"])
        np.testing.assert_allclose(state.classifier_mom.numpy(), jmom,
                                   atol=1e-4 * np.abs(jmom).max())
        np.testing.assert_array_equal(state.classifier_last.numpy(),
                                      np.asarray(jstate.opt_state["classifier_last"]))
        moved = (np.abs(jw - w0).max(axis=1) > 0).sum()
        assert 0 < moved < SPARSE_C  # only the selected rows moved
    _assert_backbone(state, jstate)
    assert tms.LAUNCH_COUNTS == NO_LAUNCH


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
    assert tms.LAUNCH_COUNTS == NO_LAUNCH


@pytest.mark.parametrize("route", ["D", "E"])
def test_trainer_sparse_routes_cpu_run(route, tmp_path):
    """Routes D and E through the Trainer on the CPU (asked for); without
    a card and without ``device="cpu"`` the Trainer raises."""
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(
        ["model.net_type=toy", "model.feat_dim=16", "data.batch_size=8", "data.image_size=16",
         "data.synthetic_ids=30", "data.synthetic_images_per_id=3", "data.num_workers=2",
         "model.dtype=float32", "train.print_freq=2", "pool.head=full_softmax",
         "optim.lr=0.01", *SPARSE_ROUTES[route]])
    cfg.data.synthetic = True
    cfg.train.saved_dir = str(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg)
    tms.reset_launch_counts()
    trainer = Trainer(cfg, device="cpu")
    try:
        out = trainer.train(max_steps=4)
    finally:
        trainer.close()
    assert out["final_step"] == 4 and np.isfinite(out["loss"]) and out["loss"] > 0
    assert int(trainer.state.classifier_last.max()) == 3  # rows visited at the last step
    assert out["grad_rows" if route == "D" else "sampled_classes"] > 0
    assert tms.LAUNCH_COUNTS == NO_LAUNCH


@pytest.mark.parametrize("bad", [["pool.classifier_mom_dtype=bfloat16"],
                                 ["pool.classifier_dtype=bfloat16", "pool.sparse_update=true"],
                                 ["pool.classifier_dtype=bfloat16"],
                                 ["mesh.model=2", "pool.use_fused=off"],
                                 ["mesh.model=2", "pool.sample_rate=0.1"], ["mesh.data=2"]])
def test_unported_options_raise(bad):
    """Still refused: bf16 storage, routes C and E on a class-sharded mesh
    (routes A, B and D run there), and the data axis."""
    cfg = Config().apply_overrides(BASE + ROUTES["A"] + bad)
    with pytest.raises(NotImplementedError):
        create_softmax_state(create_net("toy", feat_dim=D), cfg, C, device="cpu")
    with pytest.raises(NotImplementedError):
        make_softmax_train_step(cfg, lambda s: 0.1)


def test_kernel_batch_limit_and_missing_mesh():
    """On a card the margin_ce kernels take at most 128 rows: a larger
    batch on a kernel route is refused up front (the CPU's plain versions
    take any); a config at mesh.model > 1 without its mesh is refused."""
    cfg = Config().apply_overrides(BASE + ROUTES["A"] + ["data.batch_size=512"])
    softmax_head.check_ported(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="128 rows"):
        softmax_head.check_ported(cfg, torch.device("cuda"))
    softmax_head.check_ported(Config().apply_overrides(BASE + ROUTES["C"] +
                                                       ["data.batch_size=512"]), "cuda")
    with pytest.raises(ValueError, match="needs the mesh"):
        make_softmax_train_step(Config().apply_overrides(BASE + ROUTES["A"] + ["mesh.model=2"]),
                                lambda s: 0.1)


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


@pytest.mark.parametrize("lr", [0.05, 0.005])
def test_drift_batch_is_f32_rounding_at_a_prelu_kink(lr):
    """The batch on which the single-device port and JAX part by 7.5e-4
    in the toy net's first conv after three steps at lr 0.05 (the batch
    tests/test_torch_sharded_softmax.py's model-2 fixture draws from
    default_rng(1), route B): the losses agree to 1e-5 at every step, and
    in the third step's forward one element of bn1's output lies on
    opposite sides of PReLU's kink in the two frameworks (2.4e-7 from it
    in JAX; the two bn1 outputs differ by up to 1.5e-5 after two steps,
    conv sums in another order). PReLU's slope is α on one side and 1 on
    the other, so that step moves conv1 (and bn1's scale) by a finite
    amount on one side only. Pinned here: any parameter outside the usual
    limit (1e-5 relative + 2e-5 absolute) is upstream of prelu1, the
    forward of the step that parts them holds a bn1 element whose sign
    differs between the frameworks, the gap stays below 1e-3, and they
    part in the third step; at lr 0.005 the same batch never parts. Run
    with -s for the readings (parameters max(|diff| - 1e-5 |ref|): 7.5e-4
    after step 3 at lr 0.05, 1.8e-7 at lr 0.005)."""
    jstate, jstep, state, step = _jax_and_port("B")
    jmodel = j_create_net("toy", feat_dim=D)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    labels[1] = labels[0]
    labels[-2:] = C // 2 - 1, C // 2
    acts = []
    hook = state.backbone.bn1.register_forward_hook(
        lambda m, i, o: acts.append(o.detach().permute(0, 2, 3, 1).numpy().copy()))
    lr_scale = lr / 0.05  # the schedule's base lr is 0.05 (BASE)
    parted_at = None
    try:
        for s in range(3):
            _, inter = jmodel.apply(
                {"params": jstate.params["backbone"], "batch_stats": jstate.batch_stats},
                jnp.asarray(images), train=True, mutable=["intermediates", "batch_stats"],
                capture_intermediates=True)
            j_bn1 = np.asarray(inter["intermediates"]["bn1"]["__call__"][0])
            jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), lr_scale)
            m = step(state, images, labels, lr_scale)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5,
                                       err_msg=f"loss@{s}")
            want = state_dict_from_flax(state.backbone, jax.device_get(jstate.params["backbone"]),
                                        jax.device_get(jstate.batch_stats))
            gaps = {k: float((np.abs(v.numpy() - want[k].numpy())
                              - 1e-5 * np.abs(want[k].numpy())).max())
                    for k, v in state.backbone.state_dict().items()}
            outside = {k for k, g in gaps.items() if g > 2e-5}
            if outside and parted_at is None:
                parted_at = s
                flips = np.sign(acts[0]) != np.sign(j_bn1)
                assert flips.any(), (s, gaps)
                assert np.abs(j_bn1[flips]).max() < 1e-5
                print(f"lr {lr}: parted in step {s + 1}; {int(flips.sum())} bn1 element(s) on "
                      f"opposite sides of the kink, at most {np.abs(j_bn1[flips]).max():.2e} "
                      f"from it; bn1 outputs differ by up to "
                      f"{np.abs(acts[0] - j_bn1).max():.2e}")
            if outside:
                assert outside <= {"conv1.weight", "bn1.weight", "bn1.bias"}, gaps
                assert max(gaps.values()) < 1e-3, gaps
            print(f"lr {lr}, step {s + 1}: max(|diff| - 1e-5 |ref|) over the parameters "
                  f"{max(gaps.values()):.2e}")
            acts.clear()
    finally:
        hook.remove()
    assert parted_at == (2 if lr == 0.05 else None)
