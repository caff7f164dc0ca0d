"""The data axis of the softmax head (``pool.head = full_softmax`` at
``mesh.data`` > 1): the global batch split over the data ranks, BatchNorm
synchronised over them, the embeddings gathered before the head, the head
on the global batch and the backbone's gradients summed after the backward
(``vlsfr_tpu_torch/train/softmax_head.py``), against the JAX package's
GSPMD step (``make_softmax_train_step``) on a CPU mesh, the state placed
as JAX's trainer places it and the batch by ``batch_sharding``.

* 3 steps of the toy net (feat 32, global batch 8, one batch with a
  repeated class) over 2 gloo ranks at ``mesh = 2 x 1`` against JAX's step
  on ``make_mesh(2, 1)``, and over 4 ranks at ``2 x 2`` against
  ``make_mesh(2, 2)``: route A (f32, and a bf16 classifier with bf16
  momentum), B with ``optim.grad_clip = 0.5``, C, D (32768 classes at
  ``sparse_grad_rate`` 0.25), E with sparse rows and E with the dense
  optimizer (8192 classes at ``sample_rate`` 0.1), and at 2 x 1 route A at
  ``model.bn_stats_rows = 4`` (stride 2 of the 8 global rows; a rank's 4
  rows would give stride 1). JAX's random draws are fed to the port (route
  D's tile fill per model index at 2 x 2 and the single-device one at 2 x
  1, route E's negatives), as ``tests/test_torch_softmax_head.py`` does.
  Limits: losses, ce and lr 1e-5 relative, train_acc 1e-6; the backbone's
  parameters and BN statistics 1e-5 relative + 2e-5 absolute, last-visit
  steps exactly. The classifier and its momentum are held as
  ``tests/test_torch_softmax_head.py`` holds them on one device, to 2e-5 ×
  max|w − w₀| (4e-5 on routes D and E) and 1e-4 × max|mom|, looser than
  1e-5 relative + 2e-5: the head amplifies the backbones' f32 differences
  (convolutions summed in another order) by scale·cos and 1/‖w‖ ≈ 17, and
  measured 2.6e-5 to 4.6e-5 apart on the classifier (0.5e-5 to 0.8e-5 of
  max|w − w₀|) and 0.9e-4 to 3.5e-4 on the momentum (at most 1.2e-5 of
  max|mom|), the same noise at 2 x 1 and 2 x 2 as on one device. At the bf16
  classifier JAX's heads run their Pallas kernels in interpret mode; its
  first-step classifier (and momentum) are held by ``parity.bf16_ulps``,
  then bf16 noise as ``tests/test_torch_sharded_softmax.py`` holds it:
  losses 1e-3 relative, classifier ``BF16_NOISE`` × max|w − w₀|, momentum
  ``BF16_NOISE`` × max|mom|, backbone 1e-5 relative + 1e-2 absolute. Every
  rank's metrics and backbone are bit-equal, and each data replica's
  classifier block its model index's at data index 0.
* Six planted faults, each of which must fail the check on every rank:
  d_emb summed over the data group instead of sliced, the backbone's
  gradients averaged over it instead of summed, BatchNorm statistics of
  the local rows (these three on the ``bn_stats_rows`` case), the
  classifier's gradient summed over the data group on top of the gathered
  head (route B), route E's draw count from the local batch, and at 2 x 2
  route D's draws keyed on the global rank instead of the model index.
  Measured after 3 steps: the losses 3.5e-4 to 0.82 relative apart and
  the classifier 0.014 to 7.5 (the last fault: data index 1's replicas
  drift from data index 0's, whose own blocks keep JAX's tiles and part
  from JAX through the summed backbone gradient).
* The ``Trainer`` at ``mesh.data = 2`` and at 2 x 2, routes A-E, against the
  ``Trainer`` at ``mesh.data = 1`` on the same synthetic store and global
  batch: 3 steps, each loss 1e-5 relative; and
  ``configs/partial_fc_ir50_5m_ids.json`` (toy net, 96 classes and route
  A by override) at its ``mesh.data = -1``, which resolves to 2 at
  ``mesh.model = 2`` on a world of 4.

The spawned ranks import this module by name, so it imports nothing of JAX
at module level: every JAX import sits inside a test or fixture. Each world
runs once per test session (``torch_worlds.once``).
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_worlds import once, spawn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.models import layers
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel.mesh import make_mesh
from vlsfr_tpu_torch.train import softmax_head

T = torch.from_numpy
B, D, SIZE, STEPS = 8, 32, 32, 3
C_DENSE, C_SPARSE, C_SAMPLED = 96, 32768, 8192
SAMPLE_RATE = 0.1
BASE = ["model.net_type=toy", f"model.feat_dim={D}", "model.dtype=float32",
        f"data.batch_size={B}", "pool.head=full_softmax", "optim.lr=0.05"]
A = ["pool.use_fused=on", "pool.fused_update=auto"]
ROUTES = {  # case: (classes, overrides)
    "A": (C_DENSE, A),
    "A-bf16": (C_DENSE, A + ["pool.classifier_dtype=bfloat16",
                             "pool.classifier_mom_dtype=bfloat16"]),
    "B-clip": (C_DENSE, ["pool.use_fused=on", "pool.fused_update=off", "optim.grad_clip=0.5"]),
    "C": (C_DENSE, ["pool.use_fused=off"]),
    "D": (C_SPARSE, ["pool.use_fused=on", "pool.sparse_update=true",
                     "pool.sparse_grad_rate=0.25"]),
    "E": (C_SAMPLED, [f"pool.sample_rate={SAMPLE_RATE}", "pool.sparse_update=true"]),
    "E-dense": (C_SAMPLED, [f"pool.sample_rate={SAMPLE_RATE}"]),
    "subset": (C_DENSE, A + ["model.bn_stats_rows=4"]),
}
SHAPES = {2: (2, 1), 4: (2, 2)}
CASES = {2: list(ROUTES), 4: [c for c in ROUTES if c != "subset"]}
BF16_NOISE = 2.0**-4  # as tests/test_torch_sharded_softmax.py's bf16 trajectories
TRAINER_ROUTES = {"A": [], "B": ["pool.fused_update=off"], "C": ["pool.use_fused=off"],
                  "D": ["pool.sparse_update=true"],
                  "E": ["pool.sample_rate=0.5", "pool.sparse_update=true"],
                  "E-dense": ["pool.sample_rate=0.5"]}
SHIPPED = "configs/partial_fc_ir50_5m_ids.json"


def _overrides(case, world):
    c, extra = ROUTES[case]
    data, model = SHAPES[world]
    return BASE + extra + [f"pool.num_classes={c}", f"mesh.data={data}", f"mesh.model={model}"]


def _num_sampled():
    return max(B, int(C_SAMPLED * SAMPLE_RATE))


# ----------------------------------------------------------------------
# the planted faults: (case, world, module, attribute, bad(good, mesh))
# ----------------------------------------------------------------------


class _SummedGather(torch.autograd.Function):
    """The gather whose backward sums the cotangent over the group (what
    ``torch.distributed.nn.functional.all_gather`` does)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.b = group, x.shape[0]
        out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return g[i * ctx.b:(i + 1) * ctx.b], None


def _averaged(good, mesh):
    def averaged_sum(tensors, group):
        tensors = list(tensors)
        good(tensors, group)
        for t in tensors:
            t.div_(dist.get_world_size(group))
    return averaged_sum


def _local_moments(good, mesh):
    def moments(x, axes, stats_rows):
        sub = x if stats_rows <= 0 else x[::max(x.shape[0] // stats_rows, 1)]
        return sub.mean(axes), sub.square().mean(axes)
    return moments


def _summed_classifier_grad(good, mesh):
    def leaf_update(p, trace, grad, lr, **kw):
        dist.all_reduce(grad, group=mesh.data_group)
        return good(p, trace, grad, lr, **kw)
    return leaf_update


def _local_batch_draws(good, mesh):
    # num_sampled − b with the rank's b rows: B − b more negatives
    return lambda step, n, c, device: good(step, n + B - B // mesh.data, c, device)


def _global_rank_draws(good, mesh):
    return lambda step, n, device, rank=None: good(step, n, device, dist.get_rank())


FAULTS = {  # fault: (case, world, module, attribute, bad)
    "summed_demb": ("subset", 2, distributed, "gather_rows",
                    lambda good, mesh: lambda x, g: _SummedGather.apply(x, g)),
    "averaged_grads": ("subset", 2, distributed, "sum_", _averaged),
    "local_bn": ("subset", 2, layers, "synced_moments", _local_moments),
    "summed_classifier_grad": ("B-clip", 2, softmax_head, "sgd_leaf_", _summed_classifier_grad),
    "local_batch_draws": ("E", 2, softmax_head, "sample_draws", _local_batch_draws),
    "global_rank_draws": ("D", 4, softmax_head, "tile_fill_draws", _global_rank_draws),
}


# ----------------------------------------------------------------------
# the spawned ranks
# ----------------------------------------------------------------------


def _trajectory(case, world, mesh, tmp, data, out, prefix=""):
    """STEPS steps of ``make_softmax_train_step`` from JAX's initial state
    on this rank's rows of the batch and the global labels."""
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.optim import make_schedule

    c, _ = ROUTES[case]
    cfg = Config().apply_overrides(_overrides(case, world))
    init = dict(np.load(os.path.join(tmp, f"init_{case}.npz")))
    backbone = create_net("toy", feat_dim=D, bn_stats_rows=cfg.model.bn_stats_rows)
    backbone.load_state_dict({k[9:]: T(v) for k, v in init.items() if k.startswith("backbone/")})
    state = softmax_head.create_softmax_state(
        backbone, cfg, c, device="cpu", mesh=mesh,
        classifier=T(init["classifier"]).to(softmax_head.DTYPES[cfg.pool.classifier_dtype]))
    step = softmax_head.make_softmax_train_step(cfg, make_schedule(cfg.optim, 100), mesh=mesh)
    b = B // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    key = f"{prefix}{case}"
    for s in range(STEPS):
        m = step(state, data["images"][rows], data[f"labels_{c}"], 1.0)
        out.update({f"{key}/{s}/m/{k}": np.asarray(float(v)) for k, v in m.items()})
        if s == 0:
            out[f"{key}/classifier1"] = state.classifier.detach().float().numpy().copy()
            if state.classifier_mom is not None:
                out[f"{key}/classifier_mom1"] = state.classifier_mom.float().numpy().copy()
    out[f"{key}/classifier"] = state.classifier.detach().float().numpy().copy()
    for name in ("classifier_mom", "classifier_last"):
        x = getattr(state, name)
        if x is not None:
            out[f"{key}/{name}"] = (x.float() if x.is_floating_point() else x).numpy().copy()
    out.update({f"{key}/p/{k}": v.numpy().copy() for k, v in state.backbone.state_dict().items()})


def _trainer_cfg(world, route, data_axis, saved_dir, config=None):
    data, model = SHAPES[world] if data_axis else (1, 1)
    base = Config() if config is None else Config.load(config)
    cfg = base.apply_overrides(
        ["model.net_type=toy", "model.feat_dim=16", "model.dtype=float32", "data.batch_size=8",
         "data.image_size=16", "data.synthetic_ids=30", "data.synthetic_images_per_id=3",
         "data.num_workers=1", "train.print_freq=1", "train.eval_freq=0",
         "train.holdout_records=0", "train.resume=false", "pool.head=full_softmax",
         "pool.use_fused=on", "optim.lr=0.01", *TRAINER_ROUTES[route],
         *([f"mesh.data={data}", f"mesh.model={model}"] if config is None else
           ["pool.num_classes=96", f"mesh.model={model}"])])
    cfg.data.synthetic = True
    cfg.train.saved_dir = saved_dir
    return cfg


def _trainer_losses(cfg, steps=STEPS):
    """The losses of ``steps`` Trainer steps, the mesh (data, model) and the
    classifier rows the rank holds."""
    from vlsfr_tpu_torch.train.trainer import Trainer

    t = Trainer(cfg, device="cpu")
    losses, run = [], t.train_step

    def logged(*args):
        m = run(*args)
        losses.append(float(m["loss"]))
        return m

    t.train_step = logged
    try:
        t.train(max_steps=steps)
        mesh = (1, 1) if t.mesh is None else (t.mesh.data, t.mesh.model)
        return np.asarray(losses), np.asarray(mesh), np.asarray(t.state.classifier.shape[0])
    finally:
        t.close()


def _rank(rank, world, store, tmp):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    draws = (softmax_head.tile_fill_draws, softmax_head.sample_draws)
    try:
        mesh = make_mesh(*SHAPES[world])
        data = dict(np.load(os.path.join(tmp, "data.npz")))
        out = {"mesh": np.asarray([mesh.data, mesh.data_rank, mesh.model, mesh.rank])}

        def tile_fill(step, n, device, rank=None):  # JAX's draws for (step, model index)
            u = T(data[f"u{step}/{'none' if rank is None else rank}"])
            assert u.shape[0] == n
            return u.to(device)

        softmax_head.tile_fill_draws = tile_fill
        softmax_head.sample_draws = lambda step, n, c, device: T(data[f"e{step}/{n}"]).to(device)
        for case in CASES[world]:
            _trajectory(case, world, mesh, tmp, data, out)
        for fault, (case, w, module, attr, bad) in FAULTS.items():
            if w != world:
                continue
            good = getattr(module, attr)
            setattr(module, attr, bad(good, mesh))
            try:
                _trajectory(case, world, mesh, tmp, data, out, prefix=f"{fault}:")
            finally:
                setattr(module, attr, good)
        softmax_head.tile_fill_draws, softmax_head.sample_draws = draws
        for route in TRAINER_ROUTES:
            res = _trainer_losses(_trainer_cfg(world, route, True,
                                               os.path.join(tmp, f"t{world}_{route}_{rank}")))
            for k, v in zip(("losses", "mesh", "rows"), res):
                out[f"trainer/{route}/{k}"] = v
        if world == 4:  # the shipped config's mesh.data = -1
            res = _trainer_losses(_trainer_cfg(4, "A", True, os.path.join(tmp, f"shipped{rank}"),
                                               config=SHIPPED), steps=2)
            for k, v in zip(("losses", "mesh", "rows"), res):
                out[f"shipped/{k}"] = v
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        softmax_head.tile_fill_draws, softmax_head.sample_draws = draws
        distributed.destroy()


# ----------------------------------------------------------------------
# the worlds: JAX's initial states, the batch and JAX's draws, then the ranks
# ----------------------------------------------------------------------


def _batch():
    """The images and, per class count, the labels (a repeated class, and
    the two model blocks' edge classes)."""
    rng = np.random.default_rng(0)
    data = {"images": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)}
    for c in sorted({c for c, _ in ROUTES.values()}):
        labels = rng.integers(0, c, B).astype(np.int32)
        labels[1] = labels[0]
        labels[-2:] = c // 2 - 1, c // 2
        data[f"labels_{c}"] = labels
    return data


def _jax_state(case):
    """JAX's config, model and initial state of the case (``PRNGKey(0)``)."""
    import jax

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.train.softmax_head import create_softmax_state as j_create_state

    jcfg = JConfig().apply_overrides(_overrides(case, 2))
    jmodel = j_create_net("toy", feat_dim=D, bn_stats_rows=jcfg.model.bn_stats_rows)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, j_make_optimizer(jcfg.optim),
                            SIZE, ROUTES[case][0])
    return jmodel, jstate


def _jax_inputs(tmp, data):
    """JAX's initial states (``init_<case>.npz``) and draws, into the batch
    the ranks read (``data.npz``)."""
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables
    from vlsfr_tpu_torch.ops.margin_stream import sparse_bwd_geometry

    for case in ROUTES:
        _, jstate = _jax_state(case)
        backbone = load_flax_variables(
            create_net("toy", feat_dim=D, bn_stats_rows=4 if case == "subset" else 0),
            jax.device_get(jstate.params["backbone"]), jax.device_get(jstate.batch_stats))
        np.savez(tmp / f"init_{case}.npz",
                 classifier=np.asarray(jstate.params["classifier"].astype(jnp.float32)),
                 **{f"backbone/{k}": v.numpy() for k, v in backbone.state_dict().items()})
    draws = dict(data)
    n_full = sparse_bwd_geometry(B, D, C_SPARSE)[1]
    n_block = sparse_bwd_geometry(B, D, C_SPARSE // 2)[1]
    ns = _num_sampled()
    for s in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(23), s)  # route D: model = 1 takes it as is
        draws[f"u{s}/none"] = np.asarray(jax.random.uniform(key, (n_full,)))
        for r in range(4):  # sharded_sparse.py:156 folds the model index into it
            draws[f"u{s}/{r}"] = np.asarray(jax.random.uniform(jax.random.fold_in(key, r),
                                                               (n_block,)))
        key = jax.random.fold_in(jax.random.PRNGKey(17), s)
        for n in (ns - B, ns - B // 2):  # the global batch's count, and the local one's
            draws[f"e{s}/{n}"] = np.asarray(jax.random.randint(key, (n,), 0, C_SAMPLED))
    np.savez(tmp / "data.npz", **draws)


def _world(tmp_path_factory, world):
    data = _batch()

    def build(tmp):
        _jax_inputs(tmp, data)
        spawn(_rank, world, str(tmp / "store"), str(tmp))

    tmp = once(tmp_path_factory, f"softmax_data_axis_world{world}", build)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


# ----------------------------------------------------------------------
# JAX's GSPMD step on the same mesh
# ----------------------------------------------------------------------

_JAX_RUNS: dict = {}


@contextlib.contextmanager
def _jax_on_pallas(on: bool):
    """JAX's fused head (route A) on its Pallas kernels in interpret mode,
    single-device and class-sharded: its CPU routes take the scan
    references, which do not round at a bf16 classifier."""
    from vlsfr_tpu.ops import margin_pallas as jmp
    from vlsfr_tpu.parallel import sharded_fused as jsf

    saved = [(jmp, n, getattr(jmp, n)) for n in (
        "pallas_margin_ce_fwd", "pallas_margin_ce_bwd", "pallas_margin_ce_bwd_fused_sgd",
        "_stream_fwd", "_stream_bwd", "streaming_margin_grads_fused_sgd")]
    saved.append((jsf, "make_sharded_fused_sgd_head", jsf.make_sharded_fused_sgd_head))
    if on:
        fns = {n: f for _, n, f in saved}
        interp = {n: (lambda *a, _f=fns[n], **k: _f(*a, interpret=True, **k))
                  for n in ("pallas_margin_ce_fwd", "pallas_margin_ce_bwd",
                            "pallas_margin_ce_bwd_fused_sgd")}
        interp["_stream_fwd"] = interp["pallas_margin_ce_fwd"]
        interp["_stream_bwd"] = interp["pallas_margin_ce_bwd"]
        interp["streaming_margin_grads_fused_sgd"] = (
            lambda *a, _f=fns["streaming_margin_grads_fused_sgd"], **k:
            _f(*a, use_pallas=True, **k))
        for n, f in interp.items():
            setattr(jmp, n, f)
        jsf.make_sharded_fused_sgd_head = (
            lambda *a, _f=fns["make_sharded_fused_sgd_head"], **k:
            _f(*a, use_pallas=True, interpret=True, **k))
    try:
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


def _jax_run(case, world):
    """JAX's STEPS steps of the case on its (data, model) mesh of CPU
    devices, the state placed as ``vlsfr_tpu/train/trainer.py`` places it
    and the batch by ``batch_sharding``: per step the metrics, the
    classifier before and after the first step and at the end, its
    momentum and last-visit steps, and the backbone in the port's names."""
    if (case, world) in _JAX_RUNS:
        return _JAX_RUNS[(case, world)]
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.optim import make_schedule as j_make_schedule
    from vlsfr_tpu.parallel.mesh import (
        batch_sharding,
        class_vector_sharding,
        classifier_sharding,
        make_mesh as j_make_mesh,
        replicated,
    )
    from vlsfr_tpu.train.softmax_head import make_softmax_train_step as j_make_step
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import state_dict_from_flax

    f32 = lambda x: np.array(jnp.asarray(x).astype(jnp.float32))  # noqa: E731
    jcfg = JConfig().apply_overrides(_overrides(case, world))
    jmodel, jstate = _jax_state(case)
    mesh = j_make_mesh(*SHAPES[world], devices=jax.devices()[:world])
    jstate = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jstate)
    if jcfg.mesh.model > 1:  # the classifier and its own state sharded by class
        cls = classifier_sharding(mesh)
        jstate = jstate.replace(params=dict(jstate.params, classifier=jax.device_put(
            jstate.params["classifier"], cls)))
        if isinstance(jstate.opt_state, dict):
            opt = dict(jstate.opt_state)
            opt["classifier_mom"] = jax.device_put(opt["classifier_mom"], cls)
            if "classifier_last" in opt:
                opt["classifier_last"] = jax.device_put(opt["classifier_last"],
                                                        class_vector_sharding(mesh))
            jstate = jstate.replace(opt_state=opt)
    data, bs = _batch(), batch_sharding(mesh)
    images = jax.device_put(jnp.asarray(data["images"]), bs)
    labels = jax.device_put(jnp.asarray(data[f"labels_{ROUTES[case][0]}"]), bs)
    run = {"classifier0": f32(jstate.params["classifier"])}
    with _jax_on_pallas(case.endswith("-bf16")):
        jstep = jax.jit(j_make_step(jmodel, jcfg, j_make_optimizer(jcfg.optim),
                                    j_make_schedule(jcfg.optim, 100), mesh=mesh))
        for s in range(STEPS):
            jstate, jm = jstep(jstate, images, labels, 1.0)
            run.update({f"{s}/m/{k}": float(v) for k, v in jm.items()})
            if s == 0:
                run["classifier1"] = f32(jstate.params["classifier"])
                if isinstance(jstate.opt_state, dict):
                    run["classifier_mom1"] = f32(jstate.opt_state["classifier_mom"])
    run["classifier"] = f32(jstate.params["classifier"])
    if isinstance(jstate.opt_state, dict):
        run["classifier_mom"] = f32(jstate.opt_state["classifier_mom"])
        if "classifier_last" in jstate.opt_state:
            run["classifier_last"] = np.asarray(jstate.opt_state["classifier_last"])
    want = state_dict_from_flax(
        create_net("toy", feat_dim=D, bn_stats_rows=jcfg.model.bn_stats_rows),
        jax.device_get(jstate.params["backbone"]), jax.device_get(jstate.batch_stats))
    run.update({f"p/{k}": v.numpy() for k, v in want.items()})
    _JAX_RUNS[(case, world)] = run
    return run


def _block(x, model, j):
    n = x.shape[0] // model
    return x[j * n:(j + 1) * n]


def _check(case, world, ranks, prefix="", own=None):
    """The port's trajectory against JAX's, at the limits of the module
    docstring; with ``own`` (a rank) that rank's metrics, backbone and
    classifier block alone."""
    from vlsfr_tpu_torch.utils import parity

    want = _jax_run(case, world)
    model = SHAPES[world][1]
    bf16 = case.endswith("-bf16")
    key = f"{prefix}{case}"
    for r in range(world) if own is None else [own]:
        out = ranks[r]
        for s in range(STEPS):
            for k in ("loss", "ce", "lr"):
                np.testing.assert_allclose(float(out[f"{key}/{s}/m/{k}"]), want[f"{s}/m/{k}"],
                                           rtol=1e-3 if bf16 and s else 1e-5, err_msg=f"{k}@{s}")
            if f"{s}/m/train_acc" in want:
                assert float(out[f"{key}/{s}/m/train_acc"]) == pytest.approx(
                    want[f"{s}/m/train_acc"], abs=1e-6), f"train_acc@{s}"
            for k in ("grad_rows", "sampled_classes"):
                if f"{s}/m/{k}" in want:
                    assert int(out[f"{key}/{s}/m/{k}"]) == int(want[f"{s}/m/{k}"]), f"{k}@{s}"
        j = r % model
        jw = _block(want["classifier"], model, j)
        if bf16:
            w0 = _block(want["classifier0"], model, j)
            np.testing.assert_allclose(out[f"{key}/classifier"], jw, rtol=0,
                                       atol=BF16_NOISE * np.abs(jw - w0).max(),
                                       err_msg="classifier")
        else:  # the head's own noise (module docstring)
            w0 = _block(want["classifier0"], model, j)
            limit = (4e-5 if case[0] in "DE" else 2e-5) * np.abs(jw - w0).max()
            np.testing.assert_allclose(out[f"{key}/classifier"], jw, rtol=0, atol=limit,
                                       err_msg="classifier")
        if "classifier_mom" in want:
            jm = _block(want["classifier_mom"], model, j)
            limit = (BF16_NOISE if bf16 else 1e-4) * np.abs(jm).max()
            np.testing.assert_allclose(out[f"{key}/classifier_mom"], jm, rtol=0, atol=limit,
                                       err_msg="classifier_mom")
        if "classifier_last" in want:
            np.testing.assert_array_equal(out[f"{key}/classifier_last"],
                                          _block(want["classifier_last"], model, j))
        for k in [k for k in want if k.startswith("p/")]:
            np.testing.assert_allclose(out[f"{key}/{k}"], want[k], rtol=1e-5,
                                       atol=1e-2 if bf16 else 2e-5, err_msg=k)
    if own is None and bf16:  # the first step's rounding points, the blocks joined
        checks = []
        for name in ("classifier", "classifier_mom"):
            got = np.concatenate([ranks[j][f"{key}/{name}1"] for j in range(model)])
            before = want["classifier0"] if name == "classifier" else np.zeros_like(got)
            checks += parity.bf16_ulps(f"{name}'", T(got).bfloat16(),
                                       T(want[f"{name}1"]).bfloat16(), T(before).bfloat16())
        assert not parity.failures(checks), [parity.describe(c) for c in checks]


def _replicas_bit_equal(case, world, ranks):
    """Every rank's metrics and backbone equal rank 0's, and each data
    replica's classifier block its model index's at data index 0, bit for
    bit."""
    model = SHAPES[world][1]
    for r, out in enumerate(ranks):
        for k in out:
            if k.startswith(f"{case}/"):
                ref = ranks[r % model] if "/classifier" in k else ranks[0]
                np.testing.assert_array_equal(out[k], ref[k], err_msg=f"rank {r} {k}")


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES[2])
def test_data2_trajectory_matches_jax(case, world2):
    """3 steps at ``mesh = 2 x 1`` against JAX's GSPMD step on a 2 x 1 CPU
    mesh (limits in the module docstring); the ranks bit-equal."""
    _check(case, 2, world2)
    _replicas_bit_equal(case, 2, world2)


@pytest.mark.parametrize("case", CASES[4])
def test_data2_model2_trajectory_matches_jax(case, world4):
    """3 steps at ``mesh = 2 x 2`` (the class-sharded routes on the gathered
    batch) against JAX's GSPMD step on a 2 x 2 CPU mesh; every data replica
    of a model block bit-equal to it."""
    _check(case, 4, world4)
    _replicas_bit_equal(case, 4, world4)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_on_every_rank(fault, world2, world4):
    """Each planted fault fails the check against JAX on every rank, where
    the clean run of its case passes it."""
    case, world, _, _, _ = FAULTS[fault]
    ranks = world2 if world == 2 else world4
    _check(case, world, ranks)
    for r in range(world):
        with pytest.raises(AssertionError):
            _check(case, world, ranks, prefix=f"{fault}:", own=r)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route", list(TRAINER_ROUTES))
def test_trainer_on_the_data_axis_matches_data1(route, world, world2, world4, tmp_path):
    """The Trainer at ``mesh.data = 2`` (``mesh.model`` 1, then 2) against the
    Trainer at ``mesh.data = 1`` in one process: the same synthetic store
    and global batch of 8, 3 steps, each loss 1e-5 relative; every rank
    logs the same losses and holds its model block of the 30 classes."""
    ranks = world2 if world == 2 else world4
    want, mesh, rows = _trainer_losses(_trainer_cfg(world, route, False, str(tmp_path)))
    assert mesh.tolist() == [1, 1] and int(rows) == 30
    model = SHAPES[world][1]
    for out in ranks:
        assert out[f"trainer/{route}/mesh"].tolist() == list(SHAPES[world])
        assert int(out[f"trainer/{route}/rows"]) == 30 // model
        np.testing.assert_allclose(out[f"trainer/{route}/losses"], want, rtol=1e-5)
        np.testing.assert_array_equal(out[f"trainer/{route}/losses"],
                                      ranks[0][f"trainer/{route}/losses"])


def test_shipped_config_resolves_its_data_axis(world4):
    """``configs/partial_fc_ir50_5m_ids.json`` keeps ``mesh.data = -1``: on a
    world of 4 at ``mesh.model = 2`` it resolves to 2 x 2 and trains (toy
    net, 96 classes, route A), where the data axis was refused before."""
    for out in world4:
        assert out["shipped/mesh"].tolist() == [2, 2]
        assert int(out["shipped/rows"]) == 48
        assert np.isfinite(out["shipped/losses"]).all() and len(out["shipped/losses"]) == 2
        np.testing.assert_array_equal(out["shipped/losses"], world4[0]["shipped/losses"])


def test_the_step_needs_the_mesh_and_the_global_labels(tmp_path):
    """``mesh.data > 1`` without a mesh raises, naming the mesh; on a mesh
    of one data index the labels must be the global batch's."""
    from vlsfr_tpu_torch.models import create_net

    cfg = Config().apply_overrides(_overrides("A", 2))
    with pytest.raises(ValueError, match="needs the mesh"):
        softmax_head.make_softmax_train_step(cfg, lambda s: 0.1)
    cfg = Config().apply_overrides(BASE + A + [f"pool.num_classes={C_DENSE}"])
    state = softmax_head.create_softmax_state(create_net("toy", feat_dim=D), cfg, C_DENSE,
                                              device="cpu")
    step = softmax_head.make_softmax_train_step(cfg, lambda s: 0.1)
    data = _batch()
    with pytest.raises(ValueError, match="the labels are the global batch's"):
        step(state, data["images"][:4], data[f"labels_{C_DENSE}"], 1.0)
