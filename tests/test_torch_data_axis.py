"""The data axis of the FFC step (``mesh.data`` > 1): the global batch split
over the data ranks, BatchNorm synchronised over them with the flax rule,
the embeddings gathered before the head and the gradients summed after the
backward (``vlsfr_tpu_torch/core/ffc.py``, ``models/layers.py``,
``parallel/mesh.py``, ``parallel/distributed.py``), against the JAX
package's GSPMD step on a CPU mesh, with the batch placed by
``batch_sharding``.

* ``sync_batch_norm`` over 2 spawned gloo ranks against one process's
  ``BatchNorm`` over the concatenated batch: the output, d_x, d_scale and
  d_bias (summed over the ranks, as the step sums them) and the running
  statistics, at ``bn_stats_rows = 0`` and at ``bn_stats_rows = 4`` over a
  global batch of 12 (stride 3 of the global rows; a rank's 6 rows would
  give stride 1): 1e-5 relative + 1e-6 absolute (f32 sums in another
  order).
* 3 steps of the toy net over 2 ranks at ``mesh = 2 x 1`` against JAX's
  ``make_train_step`` on ``make_mesh(2, 1)``: the dense head, the quad
  head at an f32 and an int8 queue, each with ``fuse_forward`` on and off,
  and the quad head at ``model.bn_stats_rows = 8`` (stride 2 of the 16
  global rows of ``fuse_forward``; a rank's 8 rows would give stride 1;
  at 2 or 4 rows of this toy's 16 the 3-step trajectory is chaotic: the
  port's single-device and data-axis runs, a step of each from the same
  state within 1.5e-7, part by 2e-3 on a parameter after the second). Limits of
  ``test_torch_sharded_quad.py::test_model2_trajectory_matches_jax_sharded_step``:
  losses, grad_norm and lr 1e-5 relative, train_acc, pool_hit_rate and
  outlier_frac 1e-6 absolute, the queue 1e-5 absolute after every write,
  the parameters and BN statistics 1e-5 relative + 2e-5 absolute. On an
  int8 queue JAX's quad head runs its Pallas kernels in interpret mode at
  the port's 64-column tile, and both of the port's nets are pinned to
  the bits of JAX's forwards of the step (``Pinned``: the head's dots take
  the probes rounded to bf16, where a last-bit difference of the two
  backbones, conv sums in another order, would straddle a rounding
  point); the queue and its scales are then bit-equal after every write.
  With ``fuse_forward`` the probe's forward inside JAX's jitted step has
  other bits than the same forward jitted alone, and JAX's own step reads
  1.8e-5 apart on a loss between its 1 x 1 and 2 x 1 meshes there: losses
  and grad_norm 1e-4 relative, the parameters 1e-5 relative + 1e-3
  absolute (a d_emb element one bf16 spacing off in the rounded backward
  moves ``fc.weight`` by 1.6e-4 a step; measured 6.2e-4 after 3 steps).
  The ranks are bit-equal on the metrics, the parameters and the queue.
* The same over 4 ranks at ``mesh = 2 x 2`` against JAX's 2 x 2 mesh: the
  sharded quad head (partial kernels' plain versions) and the sharded
  dense head, the queue blocks joined over the model ranks.
* The ``Trainer`` at ``mesh.data = 2`` (and 2 x 2), dense and quad heads,
  against the ``Trainer`` at ``mesh.data = 1`` on the same synthetic store
  and global batch: 3 steps, each loss 1e-5 relative, also at a global
  batch of 6 (3 rows a rank: JAX asks only for an even batch that splits
  over the data axis); a batch that does not split over d raises.
* Four planted faults, each of which must fail the 2 x 1 check of the
  ``bn_stats_rows`` case on every rank: d_emb summed over the data group
  instead of sliced, the gradients averaged over it instead of summed,
  BatchNorm statistics of the local rows, and the subset stride taken from
  the local batch.
* Dropout's draws come from (data.seed, data index, step), not from the
  process generator.

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
from vlsfr_tpu_torch.parallel.mesh import make_mesh, resolve_shape

T = torch.from_numpy
B, D, SIZE, Q, STEPS = 8, 16, 16, 64, 3
BASE = ["model.net_type=toy", f"model.feat_dim={D}", f"pool.queue_size={Q}",
        "model.dtype=float32", "pool.momentum=0.9", "optim.lr=0.05", "loss.scale=32",
        "pool.hard_neg=4"]
QUAD, DENSE = ["pool.use_fused=on"], ["pool.use_fused=off"]
FF = ["pool.fuse_forward=true"]
NO_FF = ["pool.fuse_forward=false"]
INT8 = ["pool.use_fused=on", "pool.queue_dtype=int8", "pool.queue_tile=64"]
CASES = {  # mesh 2 x 1
    "dense": DENSE + NO_FF,
    "dense-ff": DENSE + FF,
    "quad": QUAD + NO_FF,
    "quad-ff": QUAD + FF,
    "int8": INT8 + NO_FF,
    "int8-ff": INT8 + FF,
    "subset": QUAD + FF + ["model.bn_stats_rows=8"],
}
CASES4 = {  # mesh 2 x 2
    "sharded-quad": QUAD + FF,
    "sharded-dense": DENSE + NO_FF,
}
SHAPES = {2: (2, 1), 4: (2, 2)}
METRICS = ("loss", "loss_dir_a", "loss_dir_b", "grad_norm", "lr", "train_acc", "pool_hit_rate",
           "outlier_frac")
FAULTS = ("summed_demb", "averaged_grads", "local_bn", "local_stride")
TRAINER_HEADS = {"dense": DENSE, "quad": QUAD}
BN_N, BN_C, BN_ROWS = 12, 3, 4


def _overrides(name, world):
    data, model = SHAPES[world]
    case = CASES[name] if name in CASES else CASES4[name]
    return BASE + case + [f"mesh.data={data}", f"mesh.model={model}"]


# ----------------------------------------------------------------------
# the planted faults
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


_sum = distributed.sum_


def _averaged_sum(tensors, group):
    tensors = list(tensors)
    _sum(tensors, group)
    for t in tensors:
        t.div_(dist.get_world_size(group))


def _local_moments(x, axes, stats_rows):
    sub = x if stats_rows <= 0 else x[::max(x.shape[0] // stats_rows, 1)]
    return sub.mean(axes), sub.square().mean(axes)


def _local_stride(rows, n, stats_rows):
    b = rows.shape[0]
    stride = max(b // stats_rows, 1)
    group = layers._SYNC[0]
    return torch.arange(b, device=rows.device) % stride == 0, \
        dist.get_world_size(group) * -(-b // stride)


PLANTS = {"summed_demb": (distributed, "gather_rows", lambda x, g: _SummedGather.apply(x, g)),
          "averaged_grads": (distributed, "sum_", _averaged_sum),
          "local_bn": (layers, "synced_moments", _local_moments),
          "local_stride": (layers, "subset_rows", _local_stride)}


# ----------------------------------------------------------------------
# the spawned ranks
# ----------------------------------------------------------------------


def _bn_case(rank, world, group, tmp, out):
    """Synchronised BN over the ranks' rows of a seeded [12, 3, 4, 4] batch."""
    data = dict(np.load(os.path.join(tmp, "bn.npz")))
    b = BN_N // world
    rows = torch.arange(rank * b, (rank + 1) * b)
    for stats_rows in (0, BN_ROWS):
        bn = layers.BatchNorm(BN_C, bn_stats_rows=stats_rows)
        with torch.no_grad():
            bn.weight.copy_(T(data["scale"]))
            bn.bias.copy_(T(data["bias"]))
        x = T(data["x"][rank * b:(rank + 1) * b]).clone().requires_grad_(True)
        with layers.sync_batch_norm(group, rows, BN_N):
            y = bn(x)
        (y * T(data["w"][rank * b:(rank + 1) * b])).sum().backward()
        for key, v in (("y", y), ("dx", x.grad), ("dscale", bn.weight.grad),
                       ("dbias", bn.bias.grad), ("mean", bn.running_mean),
                       ("var", bn.running_var)):
            out[f"bn{stats_rows}/{key}"] = v.detach().numpy().copy()


class Pinned(torch.nn.Module):
    """A net whose outputs carry the bits of ``targets`` (one a call, in
    order) while its gradient flows through ``net``: out + (target − out),
    exact (Sterbenz) where the two agree to a factor of 2 (as
    ``test_torch_ffc_step.py``'s)."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.targets = []

    def forward(self, x):
        out = self.net(x)
        target = self.targets.pop(0)
        pinned = out + (target - out).detach()
        assert torch.equal(pinned, target)
        return pinned


def _rank_rows(t, ff, d, i):
    """This data rank's rows of a global forward output."""
    n = t.shape[0] // (2 if ff else 1)
    b = n // d
    rows = [t[i * b:(i + 1) * b]] + ([t[n + i * b:n + (i + 1) * b]] if ff else [])
    return T(np.concatenate(rows))


def _trajectory(name, world, mesh, tmp, out, prefix=""):
    """STEPS steps of ``make_train_step`` from JAX's initial state on this
    rank's rows of the seeded batches; on an int8 queue both nets pinned
    to JAX's forward outputs of the step (``Pinned``)."""
    import copy

    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import FFCState, make_train_step, state_from_jax
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.optim import make_optimizer, make_schedule

    cfg = Config().apply_overrides(_overrides(name, world))
    int8 = cfg.pool.queue_dtype == "int8"
    init = dict(np.load(os.path.join(tmp, f"init_{'int8' if int8 else 'f32'}.npz")))
    data = dict(np.load(os.path.join(tmp, "data.npz")))
    net = create_net("toy", feat_dim=D, bn_stats_rows=cfg.model.bn_stats_rows)
    net.load_state_dict({k[6:]: T(v) for k, v in init.items() if k.startswith("probe/")})
    probe, gallery = net, copy.deepcopy(net).requires_grad_(False)
    if int8:
        probe, gallery = Pinned(probe), Pinned(gallery)
        targets = dict(np.load(os.path.join(tmp, f"targets_{name}.npz")))
    queue, scales = state_from_jax(init["queue"], init.get("scales"))
    c0, cl = mesh.class_block(Q)
    state = FFCState(step=0, probe=probe, gallery=gallery,
                     queue=queue[:, c0:c0 + cl].clone(),
                     optimizer=make_optimizer(cfg.optim, probe.parameters()),
                     queue_scales=None if scales is None else scales[:, c0:c0 + cl].clone())
    step = make_train_step(cfg, make_schedule(cfg.optim, 10), mesh=mesh)
    dcp = DCPManager(Q)
    b = B // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    key = f"{prefix}{name}"
    ff = cfg.pool.fuse_forward
    for s in range(STEPS):
        if int8:  # probe(x), gallery(y), probe(y), gallery(x); or probe(x ⧺ y), gallery(y ⧺ x)
            got = [_rank_rows(targets[f"{s}/target{j}"], ff, mesh.data, mesh.data_rank)
                   for j in range(2 if ff else 4)]
            probe.targets, gallery.targets = got[0::2], got[1::2]
        m = step(state, data[f"x{s}"][rows], data[f"y{s}"][rows],
                 dcp.plan_step(data[f"xl{s}"], data[f"yl{s}"]), 1.0)
        out.update({f"{key}/{s}/m/{k}": np.asarray(float(m[k])) for k in METRICS})
        out[f"{key}/{s}/queue"] = state.queue.numpy().copy()
        if int8:
            out[f"{key}/{s}/scales"] = state.queue_scales.numpy().copy()
        out.update({f"{key}/{s}/p/{k}": v.numpy().copy() for k, v in net.state_dict().items()})


def _trainer_losses(world, head, data_axis, tmp, rank, batch=8):
    """The losses of 3 Trainer steps (the dense or quad head) at the
    world's mesh (``data_axis``) or at mesh.data = 1 (one process)."""
    from vlsfr_tpu_torch.train.trainer import Trainer

    data, model = SHAPES[world] if data_axis else (1, 1)
    cfg = Config().apply_overrides(
        ["model.net_type=toy", f"model.feat_dim={D}", f"data.batch_size={batch}",
         "data.image_size=16",
         "data.synthetic_ids=30", "data.synthetic_images_per_id=3", "data.num_workers=1",
         "model.dtype=float32", "train.print_freq=1", "optim.lr=0.05", "pool.queue_size=64",
         *TRAINER_HEADS[head], f"mesh.data={data}", f"mesh.model={model}"])
    cfg.data.synthetic = True
    cfg.train.saved_dir = os.path.join(tmp, f"trainer_{world}_{head}_{data}_{batch}_{rank}")
    t = Trainer(cfg, device="cpu")
    losses, run = [], t.train_step

    def logged(*args):
        m = run(*args)
        losses.append(float(m["loss"]))
        return m

    t.train_step = logged
    try:
        t.train(max_steps=3)
        return np.asarray(losses), t.state.queue.shape
    finally:
        t.close()


def _rank(rank, world, store, tmp):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(*SHAPES[world])
        out = {"mesh": np.asarray([mesh.data, mesh.data_rank, mesh.model, mesh.rank])}
        if world == 2:
            _bn_case(rank, world, mesh.data_group, tmp, out)
        for name in (CASES if world == 2 else CASES4):
            _trajectory(name, world, mesh, tmp, out)
        if world == 2:
            for fault in FAULTS:
                module, attr, bad = PLANTS[fault]
                good = getattr(module, attr)
                setattr(module, attr, bad)
                try:
                    _trajectory("subset", world, mesh, tmp, out, prefix=f"{fault}:")
                finally:
                    setattr(module, attr, good)
        for head in TRAINER_HEADS:
            losses, shape = _trainer_losses(world, head, True, tmp, rank)
            out[f"trainer/{head}"], out[f"trainer/{head}/queue_shape"] = losses, np.asarray(shape)
        if world == 2:  # 3 rows a rank
            out["trainer/quad-b6"] = _trainer_losses(world, "quad", True, tmp, rank, batch=6)[0]
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


# ----------------------------------------------------------------------
# the worlds: JAX's initial states and the batches, then the ranks
# ----------------------------------------------------------------------


def _inputs():
    """JAX's initial state (f32 and int8 queue), the batches and the BN
    case's tensors, as numpy."""
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.core.ffc import create_ffc_state as j_create_state
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables

    inits = {}
    for kind, extra in (("f32", QUAD), ("int8", INT8)):
        jcfg = JConfig().apply_overrides(BASE + extra)
        jstate = j_create_state(jax.random.PRNGKey(0), j_create_net("toy", feat_dim=D), jcfg,
                                j_make_optimizer(jcfg.optim), SIZE)
        probe = load_flax_variables(create_net("toy", feat_dim=D),
                                    jax.device_get(jstate.probe_params),
                                    jax.device_get(jstate.probe_stats))
        init = {f"probe/{k}": v.numpy() for k, v in probe.state_dict().items()}
        init["queue"] = np.asarray(jstate.queue)
        if jstate.queue_scales is not None:
            init["scales"] = np.asarray(jstate.queue_scales.astype(jnp.float32))
        inits[kind] = init
    rng = np.random.default_rng(0)
    data = {}
    for s in range(STEPS):
        ids = rng.integers(0, 40, B // 2)
        data[f"xl{s}"] = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        data[f"yl{s}"] = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        data[f"x{s}"] = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        data[f"y{s}"] = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    bn = {"x": (rng.standard_normal((BN_N, BN_C, 4, 4)) * 2 + 0.5).astype(np.float32),
          "w": rng.standard_normal((BN_N, BN_C, 4, 4)).astype(np.float32),
          "scale": rng.uniform(0.5, 1.5, BN_C).astype(np.float32),
          "bias": rng.standard_normal(BN_C).astype(np.float32)}
    return inits, data, bn


def _world(tmp_path_factory, world):
    inits, data, bn = _inputs()

    def build(tmp):
        for name in CASES if world == 2 else CASES4:
            if "int8" in name:
                run = _jax_run(name, world, data)
                np.savez(tmp / f"targets_{name}.npz",
                         **{k: v for k, v in run.items() if "/target" in k})
        for kind, init in inits.items():
            np.savez(tmp / f"init_{kind}.npz", **init)
        np.savez(tmp / "data.npz", **data)
        np.savez(tmp / "bn.npz", **bn)
        spawn(_rank, world, str(tmp / "store"), str(tmp))

    tmp = once(tmp_path_factory, f"data_axis_world{world}", build)
    return data, bn, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


_JAX_RUNS: dict = {}


def _jax_run(name, world, data):
    """JAX's STEPS steps of the case on its (data, model) mesh of CPU
    devices, the batch placed by ``batch_sharding``: per step the metrics
    and the queue (and scales) as numpy, and the final probe state dict
    in the port's names."""
    if (name, world) in _JAX_RUNS:
        return _JAX_RUNS[(name, world)]
    import jax

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.core.dcp import DCPManager as JDCP
    from vlsfr_tpu.core.ffc import create_ffc_state as j_create_state
    from vlsfr_tpu.core.ffc import make_train_step as j_make_step
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.optim import make_schedule as j_make_schedule
    from vlsfr_tpu.parallel.mesh import batch_sharding, make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.mesh import queue_scales_sharding, queue_sharding, replicated

    jcfg = JConfig().apply_overrides(_overrides(name, world))
    jmodel = j_create_net("toy", feat_dim=D, bn_stats_rows=jcfg.model.bn_stats_rows)
    jopt = j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE)
    mesh = j_make_mesh(*SHAPES[world], devices=jax.devices()[:world])
    jstate = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jstate)
    jstate = jstate.replace(queue=jax.device_put(jstate.queue, queue_sharding(mesh)))
    if jstate.queue_scales is not None:
        jstate = jstate.replace(queue_scales=jax.device_put(jstate.queue_scales,
                                                            queue_scales_sharding(mesh)))
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 10), mesh=mesh))
    jdcp, bs = JDCP(Q), batch_sharding(mesh)
    run = {}
    int8 = jcfg.pool.queue_dtype == "int8"
    targets = _forward_targets(jmodel, jcfg, mesh) if int8 else None
    with _pallas_interpret(int8):
        _jax_steps(jstep, jstate, jdcp, bs, data, run, targets)
    _JAX_RUNS[(name, world)] = run
    return run


def _forward_targets(jmodel, jcfg, mesh):
    """``targets(state, x, y)``: the outputs of the probe's and the
    gallery's forwards of JAX's step, in the port's call order (``fuse_
    forward``: probe(x ⧺ y), gallery(y ⧺ x); else probe(x), gallery(y),
    probe(y), gallery(x)), from the state before the step, jitted over the
    same mesh with the batch placed by ``batch_sharding``."""
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.parallel.mesh import batch_sharding

    m, ff, bs = jcfg.pool.momentum, jcfg.pool.fuse_forward, batch_sharding(mesh)

    def apply(params, stats, data):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats}, data, train=True,
                                mutable=["batch_stats"])
        return out, mut["batch_stats"]

    @jax.jit
    def run(state, x, y):
        g_params = jax.tree.map(lambda g_, p_: m * g_ + (1.0 - m) * p_, state.gallery_params,
                                state.probe_params)
        if ff:
            return (apply(state.probe_params, state.probe_stats, jnp.concatenate([x, y]))[0],
                    apply(g_params, state.gallery_stats, jnp.concatenate([y, x]))[0])
        p_x, ps = apply(state.probe_params, state.probe_stats, x)
        g_y, gs = apply(g_params, state.gallery_stats, y)
        return p_x, g_y, apply(state.probe_params, ps, y)[0], apply(g_params, gs, x)[0]

    return lambda state, x, y: [np.asarray(t) for t in run(state, jax.device_put(x, bs),
                                                            jax.device_put(y, bs))]


@contextlib.contextmanager
def _pallas_interpret(on: bool):
    """JAX's quad head on its Pallas kernels in interpret mode (on the CPU
    it otherwise takes its scan fallback, which computes an int8 queue's
    dots in f32 on the dequantised rows, not the kernels' bf16 products)."""
    from vlsfr_tpu.ops import twin_margin as jtm

    names = ("quad_add_margin", "pallas_quad_fwd", "pallas_quad_bwd")
    saved = {n: getattr(jtm, n) for n in names}
    if on:
        add = saved["quad_add_margin"]
        jtm.quad_add_margin = lambda *a, **k: add(*a, **dict(k, use_pallas=True))
        for n in names[1:]:
            setattr(jtm, n, lambda *a, _f=saved[n], **k: _f(*a, interpret=True, **k))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(jtm, n, f)


def _jax_steps(jstep, jstate, jdcp, bs, data, run, targets=None):
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import state_dict_from_flax

    for s in range(STEPS):
        if targets is not None:
            for i, t in enumerate(targets(jstate, jnp.asarray(data[f"x{s}"]),
                                          jnp.asarray(data[f"y{s}"]))):
                run[f"{s}/target{i}"] = t
        jstate, jm = jstep(jstate, jax.device_put(jnp.asarray(data[f"x{s}"]), bs),
                           jax.device_put(jnp.asarray(data[f"y{s}"]), bs),
                           jdcp.plan_step(data[f"xl{s}"], data[f"yl{s}"]), 1.0)
        run.update({f"{s}/m/{k}": float(jm[k]) for k in METRICS})
        run[f"{s}/queue"] = np.asarray(jstate.queue)
        if jstate.queue_scales is not None:
            run[f"{s}/scales"] = np.asarray(jstate.queue_scales.astype(jnp.float32))
        want = state_dict_from_flax(create_net("toy", feat_dim=D),
                                    jax.device_get(jstate.probe_params),
                                    jax.device_get(jstate.probe_stats))
        run.update({f"{s}/p/{k}": v.numpy() for k, v in want.items()})


def _blocks(ranks, key, model):
    """The queue of data index 0, its model blocks joined."""
    return np.concatenate([ranks[j][key] for j in range(model)], axis=1)


def _check(name, world, data, ranks, prefix="", own=None):
    """The port's trajectory against JAX's, at the limits of the module
    docstring; with ``own`` the rank's own metrics and parameters, each
    rank held on its own."""
    want = _jax_run(name, world, data)
    model = SHAPES[world][1]
    int8 = "int8" in name
    key = f"{prefix}{name}"
    held = ranks if own is None else [own]
    # the int8 head at fuse_forward: JAX's own 1 x 1 and 2 x 1 steps read
    # 1.8e-5 apart on a loss, and the port's probe differs from the bits of
    # JAX's step (see the module docstring)
    rtol, atol = (1e-4, 1e-3) if name == "int8-ff" else (1e-5, 2e-5)
    for s in range(STEPS):
        for r in held:
            for k in METRICS[:5]:
                np.testing.assert_allclose(float(r[f"{key}/{s}/m/{k}"]), want[f"{s}/m/{k}"],
                                           rtol=rtol, err_msg=f"{k}@{s}")
            for k in METRICS[5:]:
                assert float(r[f"{key}/{s}/m/{k}"]) == pytest.approx(want[f"{s}/m/{k}"],
                                                                     abs=1e-6), f"{k}@{s}"
            for k in [k for k in want if k.startswith(f"{s}/p/")]:
                np.testing.assert_allclose(r[f"{key}/{k}"], want[k], rtol=1e-5, atol=atol,
                                           err_msg=f"{k}")
        if own is not None:
            continue
        got = _blocks(ranks, f"{key}/{s}/queue", model)
        np.testing.assert_allclose(got, want[f"{s}/queue"], atol=0 if int8 else 1e-5,
                                   err_msg=f"queue@{s}")
        if int8:
            np.testing.assert_array_equal(_blocks(ranks, f"{key}/{s}/scales", model),
                                          want[f"{s}/scales"], err_msg=f"scales@{s}")


def _replicas_bit_equal(name, world, ranks):
    """Every rank's metrics and parameters equal rank 0's, and each data
    replica's queue block its model index's at data index 0, bit for bit."""
    model = SHAPES[world][1]
    for r, out in enumerate(ranks):
        for k in out:
            if not k.startswith(f"{name}/"):
                continue
            ref = ranks[r % model] if k.endswith(("/queue", "/scales")) else ranks[0]
            np.testing.assert_array_equal(out[k], ref[k], err_msg=f"rank {r} {k}")


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------


def test_mesh_places_ranks_as_jax_reshapes_devices(world2, world4):
    """Global rank r sits at data index r // model and model index
    r % model, JAX's ``devices.reshape(data, model)``."""
    for world, (_, _, ranks) in ((2, world2), (4, world4)):
        data, model = SHAPES[world]
        for r, out in enumerate(ranks):
            assert out["mesh"].tolist() == [data, r // model, model, r % model]


@pytest.mark.parametrize("stats_rows", [0, BN_ROWS])
def test_synchronised_batch_norm_matches_one_process(stats_rows, world2):
    """Two ranks' synchronised BN against one process's BN over the
    concatenated batch (at ``bn_stats_rows = 4`` the global stride 3, where
    a rank's 6 rows alone would give 1): 1e-5 relative + 1e-6 absolute."""
    _, bn, ranks = world2
    ref = layers.BatchNorm(BN_C, bn_stats_rows=stats_rows)
    with torch.no_grad():
        ref.weight.copy_(T(bn["scale"]))
        ref.bias.copy_(T(bn["bias"]))
    x = T(bn["x"]).clone().requires_grad_(True)
    y = ref(x)
    (y * T(bn["w"])).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    key = f"bn{stats_rows}"
    np.testing.assert_allclose(np.concatenate([r[f"{key}/y"] for r in ranks]),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r[f"{key}/dx"] for r in ranks]),
                               x.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r[f"{key}/dscale"] for r in ranks), ref.weight.grad.numpy(),
                               **tol)
    np.testing.assert_allclose(sum(r[f"{key}/dbias"] for r in ranks), ref.bias.grad.numpy(), **tol)
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/mean"], ref.running_mean.numpy(), **tol)
        np.testing.assert_allclose(r[f"{key}/var"], ref.running_var.numpy(), **tol)
        np.testing.assert_array_equal(r[f"{key}/mean"], ranks[0][f"{key}/mean"])
    if stats_rows:  # the subset's rows are the global stride's, not the local one's
        assert BN_N // stats_rows != BN_N // 2 // stats_rows


@pytest.mark.parametrize("name", list(CASES))
def test_data2_trajectory_matches_jax(name, world2):
    """3 steps at ``mesh = 2 x 1`` against JAX's GSPMD step on a 2 x 1 CPU
    mesh (limits in the module docstring); the ranks bit-equal."""
    data, _, ranks = world2
    _check(name, 2, data, ranks)
    _replicas_bit_equal(name, 2, ranks)


@pytest.mark.parametrize("name", list(CASES4))
def test_data2_model2_trajectory_matches_jax(name, world4):
    """3 steps at ``mesh = 2 x 2`` (the sharded quad head and the sharded
    dense head) against JAX's GSPMD step on a 2 x 2 CPU mesh; every data
    replica of a model block bit-equal to it."""
    data, _, ranks = world4
    _check(name, 4, data, ranks)
    _replicas_bit_equal(name, 4, ranks)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_on_every_rank(fault, world2):
    """Each planted fault in the ``bn_stats_rows`` case fails the check
    against JAX on every rank, which the clean run passes."""
    data, _, ranks = world2
    _check("subset", 2, data, ranks)
    for out in ranks:
        with pytest.raises(AssertionError):
            _check("subset", 2, data, ranks, prefix=f"{fault}:", own=out)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("head", list(TRAINER_HEADS))
def test_trainer_on_the_data_axis_matches_data1(head, world, world2, world4, tmp_path):
    """The Trainer at ``mesh.data = 2`` (``mesh.model`` 1, then 2) against the
    Trainer at ``mesh.data = 1`` in one process: the same synthetic store and
    global batch of 8, 3 steps, each loss 1e-5 relative; every rank logs
    the same losses and holds its model block."""
    ranks = (world2 if world == 2 else world4)[2]
    want, shape = _trainer_losses(world, head, False, str(tmp_path), 0)
    model = SHAPES[world][1]
    for out in ranks:
        np.testing.assert_allclose(out[f"trainer/{head}"], want, rtol=1e-5)
        np.testing.assert_array_equal(out[f"trainer/{head}"], ranks[0][f"trainer/{head}"])
        assert out[f"trainer/{head}/queue_shape"].tolist() == [2, Q // model, D]
    assert list(shape) == [2, Q, D]


def test_trainer_at_three_rows_a_rank_matches_data1(world2, tmp_path):
    """A global batch of 6 over ``mesh.data = 2`` (3 rows a rank: the batch
    need only be even and split over the data axis, as in JAX) against
    ``mesh.data = 1``: the quad head's Trainer, 3 steps, each loss 1e-5
    relative, both ranks the same."""
    want, _ = _trainer_losses(2, "quad", False, str(tmp_path), 0, batch=6)
    ranks = world2[2]
    for out in ranks:
        np.testing.assert_allclose(out["trainer/quad-b6"], want, rtol=1e-5)
        np.testing.assert_array_equal(out["trainer/quad-b6"], ranks[0]["trainer/quad-b6"])


def test_batch_must_split_over_the_data_axis(tmp_path):
    """``data.batch_size % mesh.data`` must be 0 in both pipelines (the
    error names both numbers); each rank decodes its rows, in
    ``batch_sharding`` order, also at 3 rows a rank, and the labels stay
    global."""
    from vlsfr_tpu_torch.data.pipeline import FFCPipeline, InstancePipeline
    from vlsfr_tpu_torch.data.records import MultiSourceReader
    from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store

    generate_synthetic_store(str(tmp_path), num_ids=6, images_per_id=2, image_size=16, seed=0)
    reader = MultiSourceReader([str(tmp_path)])
    made = {}
    try:
        for pipeline in (FFCPipeline, InstancePipeline):
            with pytest.raises(ValueError, match="batch_size=6 must be a multiple of mesh.data=4"):
                pipeline(reader, 6, 16, num_workers=1, data_shard=(0, 4))
            for shard in ((0, 2), (1, 2), (0, 1)):
                pipe = pipeline(reader, 6, 16, num_workers=1, data_shard=shard)
                try:
                    made[pipeline.__name__, shard] = pipe.make_batch(0, 0)
                finally:
                    pipe.close()
    finally:
        reader.close()
    for name, keys, labels in (("FFCPipeline", ("x", "y"), ("x_label", "y_label")),
                               ("InstancePipeline", ("images",), ("labels",))):
        halves, full = [made[name, (i, 2)] for i in range(2)], made[name, (0, 1)]
        for key in keys:
            assert getattr(halves[0], key).shape[0] == 3
            np.testing.assert_array_equal(np.concatenate([getattr(h, key) for h in halves]),
                                          getattr(full, key))
        for h in halves:
            for key in labels:
                np.testing.assert_array_equal(getattr(h, key), getattr(full, key))


def test_mesh_data_resolves_and_refuses_another_world(monkeypatch):
    """``mesh.data = -1`` is world // model (as JAX's ``make_mesh``); a mesh
    whose data · model is not the world raises, naming torchrun with the
    process count it needs."""
    from vlsfr_tpu_torch.parallel.mesh import check_shape
    from vlsfr_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("WORLD_SIZE", "8")
    assert resolve_shape(-1, 2) == (4, 2)
    assert resolve_shape(-1, 8) == (1, 8)
    assert resolve_shape(-1, 0) == (8, 1)
    assert check_shape(-1, 4) == (2, 4)
    assert check_shape(4, 2) == (4, 2)
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=6"):
        check_shape(3, 2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert resolve_shape(-1, 1) == (1, 1)
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=4"):
        Trainer(Config().apply_overrides(["model.net_type=toy", "mesh.data=2", "mesh.model=2",
                                          "pool.use_fused=on"]), device="cpu")
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=2"):
        Trainer(Config().apply_overrides(["model.net_type=toy", "mesh.data=2"]), device="cpu")
    # the softmax head's data axis too (tests/test_torch_softmax_data_axis.py
    # runs it); -1 resolves above 1 there as here
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=2"):
        Trainer(Config().apply_overrides(["model.net_type=toy", "pool.head=full_softmax",
                                          "pool.num_classes=96", "mesh.data=2"]), device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert check_shape(-1, 2) == (2, 2)


def _gather_on_card(rank, world, store, out_dir):
    torch.cuda.set_device(0)
    distributed.initialize("cuda", backend="gloo", rank=rank, world_size=world, store_path=store)
    try:
        x = torch.arange(6.0, device="cuda").view(3, 2).add(10 * rank).requires_grad_(True)
        got = distributed.gather_rows(x, dist.group.WORLD)
        (got * torch.arange(12.0, device="cuda").view(6, 2)).sum().backward()
        total = [torch.full((2,), float(rank + 1), device="cuda")]
        distributed.sum_(total, dist.group.WORLD)
        torch.save({"got": got.detach().cpu(), "grad": x.grad.cpu(), "sum": total[0].cpu()},
                   os.path.join(out_dir, f"gather{rank}.pt"))
    finally:
        distributed.destroy()


@pytest.mark.gpu
def test_data_axis_gather_on_cuda_tensors_over_gloo(tmp_path):
    """Two gloo ranks on one card: ``gather_rows`` of CUDA tensors gives
    both ranks' rows in rank order and hands each its own rows of the
    cotangent; ``sum_`` sums over the group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spawn(_gather_on_card, 2, str(tmp_path / "store"), str(tmp_path))
    want = torch.cat([torch.arange(6.0).view(3, 2) + 10 * r for r in range(2)])
    for r in range(2):
        out = torch.load(tmp_path / f"gather{r}.pt")
        assert torch.equal(out["got"], want)
        assert torch.equal(out["grad"], torch.arange(12.0).view(6, 2)[3 * r:3 * r + 3])
        assert torch.equal(out["sum"], torch.full((2,), 3.0))


def test_dropout_draws_from_the_data_index_and_step():
    """With ``model.dropout`` > 0 the step's draws come from a generator
    seeded by (data.seed, data index, step): the same step twice gives the
    same loss whatever the process generator holds, which it finds as it
    left it; data indices draw apart, and steps too."""
    import copy

    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import create_ffc_state, dropout_seed, make_train_step
    from vlsfr_tpu_torch.models import create_net

    cfg = Config().apply_overrides(["model.net_type=ir18", "model.feat_dim=8",
                                    "pool.queue_size=16", "model.dropout=0.5",
                                    "model.dtype=float32", "pool.use_fused=on"])
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 6, 4)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    torch.manual_seed(0)
    state0 = create_ffc_state(create_net("ir18", feat_dim=8, dropout=0.5, image_size=32), cfg,
                              device="cpu")
    step = make_train_step(cfg, lambda s: 0.1)
    losses = []
    for seed in (1, 2):
        torch.manual_seed(seed)
        before = torch.get_rng_state()
        state = copy.deepcopy(state0)
        losses.append(float(step(state, x, y, DCPManager(16).plan_step(labels, labels))["loss"]))
        assert torch.equal(torch.get_rng_state(), before)
    assert losses[0] == losses[1]
    seeds = {dropout_seed(0, i, s) for i in range(2) for s in range(3)}
    assert len(seeds) == 6 and dropout_seed(0, 1, 2) == dropout_seed(0, 1, 2)
