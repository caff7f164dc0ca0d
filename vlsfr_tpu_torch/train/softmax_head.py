"""Full-softmax margin-classifier training (port of
``vlsfr_tpu/train/softmax_head.py``).

One backbone, one classifier ``[num_classes, feat_dim]`` (rows normalised
on every forward) and the margin-softmax CE, on one of five routes:

* A. fused-SGD streaming — the default at ``num_classes >=
  pool.streaming_threshold`` with SGD and no gradient clipping: the head
  runs outside autograd (``ops/margin_stream.streaming_margin_grads_fused_sgd``),
  the classifier and its bare momentum buffer are updated IN PLACE inside
  the streaming backward, and ``d_emb`` is fed back into the backbone;
* B. streaming + SGD — streaming with ``pool.fused_update=off`` or
  gradient clipping: ``MarginSoftmax`` forward and backward, a dense d_w,
  ``torch.optim.SGD`` on the backbone and optax's chain on the classifier
  (``optim/optimizers.sgd_leaf_``);
* C. dense — below the threshold or ``pool.use_fused=off``: the ``[B, C]``
  cosines in plain PyTorch;
* D. sparse-d_w streaming — streaming with ``pool.sparse_update``: the
  exact loss, the classifier gradient truncated to the most relevant class
  tiles (``ops/margin_stream.streaming_sparse_margin_grads``, rate
  ``pool.sparse_grad_rate``), the exact d_emb, and a sparse row update;
* E. partial-FC sampling — ``pool.sample_rate > 0``: the CE denominator
  over the batch's classes plus sampled negatives
  (``parallel/partial_fc.sample_classes``), with a sparse row update
  (``pool.sparse_update``) or the dense optimizer.

Routes D and E with ``sparse_update`` keep the classifier outside the
optimizer with a bare f32 momentum buffer and a per-row last-visit step
(``train/sparse_classifier.py``).

The classifier is stored in ``pool.classifier_dtype`` (float32 or
bfloat16), drawn as JAX draws it: f32 0.01·N(0, 1), then cast, here in
chunks of rows so the f32 draw never exists whole. Route A's momentum is
stored in ``pool.classifier_mom_dtype``; routes D and sparse E keep f32
momentum for a bf16 classifier, as JAX does. On routes B, C and dense E
the classifier is updated by ``optim/optimizers.sgd_leaf_``, optax's chain
in the leaf's dtype (``torch.optim.SGD``, which keeps the backbone, rounds
elsewhere than optax on a bf16 leaf), with its trace in that dtype as
``classifier_mom``; gradient clipping takes the classifier's share of the
global norm and clips it in its dtype as optax does. Their random draws — route D's random
tile fill, route E's sampled negatives — come from ``tile_fill_draws`` and
``sample_draws``: a generator on the classifier's device seeded from a
fixed seed and the step (JAX folds the step into ``PRNGKey(23)`` and
``PRNGKey(17)``; the two give other numbers, and the tests feed JAX's draws
to both).

Class-sharded (a ``mesh``: ``parallel/mesh.py``, one rank per block of
C / mesh.model classifier rows, as JAX routes at ``mesh.model > 1``), every
route runs per block with collective merges (``parallel/sharded_fused.py``,
``partial_fc.margin_softmax_loss`` with the mesh for B and C,
``parallel/sharded_sparse.py``, and for E ``partial_fc.sharded_margin_softmax``
over the sampled positions whose class lies in the rank's block): the state
holds the rank's block of the classifier the single-device init draws, its
momentum and last-visit steps. Route D's random fill draws per rank; route
E's sampled classes are the same on every rank (``sample_draws`` takes no
rank), and each rank updates the rows of its block among them.

On the data axis (``mesh.data`` > 1: each rank holds rows ``[i·B/d,
(i+1)·B/d)`` of the global batch at data index i, and the global labels)
the step computes the global batch's step, as JAX's GSPMD step does: the
backbone's forward takes BatchNorm statistics over the data group
(``models/layers.data_axis_forward``, which also seeds ``model.dropout``'s
draws by (data.seed, data index, step) on any mesh), the embeddings are gathered over it
(``parallel/distributed.gather_rows``) and the head runs on the global
batch, every data replica of a model block computing the same head (at
``mesh.model = 1`` the single-device route, its draws the single-device
ones, as JAX's route D takes ``mesh=None`` there; at ``mesh.model > 1``
the class-sharded route, route D's draws keyed on the model index). The
head's d_emb returns through the gather, whose backward hands each rank
its own rows, and the backbone's gradients are summed over the data
group before the global norm. The classifier's gradient and update are
already the global batch's on every replica, so they are not summed
again (JAX's route B at ``mesh.model > 1`` takes the other layout, each
data shard's rows' d_w summed over ``data``: the same sum in another
order); the replicas stay bit-equal. The loss's 1/B, route E's
``num_sampled`` and its draw count are the global batch's.

Refused: on a card a feature width the margin_ce kernels do not take (a
multiple of 64 up to 512; any batch is taken), and RMSprop
(``optim/optimizers.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.distributed as dist
from torch import nn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.models.layers import data_axis_forward
from vlsfr_tpu_torch.ops.margin import kernel_width_ok
from vlsfr_tpu_torch.ops.margin_stream import (
    sparse_bwd_geometry,
    sparse_m_tiles,
    streaming_margin_grads_fused_sgd,
    streaming_sparse_margin_grads,
)
from vlsfr_tpu_torch.optim import make_optimizer, set_learning_rate
from vlsfr_tpu_torch.optim.optimizers import clip_by_global_norm_, sgd_leaf_
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel.partial_fc import (
    margin_softmax_loss,
    sample_classes,
    sharded_sampled_loss,
)
from vlsfr_tpu_torch.parallel.sharded_fused import sharded_margin_grads_fused_sgd
from vlsfr_tpu_torch.parallel.sharded_sparse import sharded_sparse_margin_grads
from vlsfr_tpu_torch.train.sparse_classifier import sparse_sgd_rows
from vlsfr_tpu_torch.utils.device import resolve_device

TILE_FILL_SEED = 23  # route D's random tile fill (JAX: PRNGKey(23) folded with the step)
SAMPLE_SEED = 17  # route E's sampled negatives (JAX: PRNGKey(17) folded with the step)
INIT_ROWS = 1 << 18  # classifier rows drawn at a time (512 MiB of f32 at 512 features)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _step_generator(seed: int, step: int, device, rank: int | None = None) -> torch.Generator:
    key = seed * 1_000_003 + int(step)
    if rank is not None:
        key = key * 65_537 + rank + 1
    return torch.Generator(device=device).manual_seed(key)


def tile_fill_draws(step: int, n_tiles: int, device, rank: int | None = None) -> torch.Tensor:
    """Route D's uniform draws [n_tiles] f32 in [0, 1) for step ``step``;
    on a mesh of more than one rank, rank ``rank``'s own (JAX folds the
    model index into the step's key)."""
    return torch.rand((n_tiles,), generator=_step_generator(TILE_FILL_SEED, step, device, rank),
                      device=device)


def sample_draws(step: int, n: int, num_classes: int, device) -> torch.Tensor:
    """Route E's negative class draws [n] int32 in [0, num_classes) for
    step ``step``: the same on every rank of a mesh, which all sample one
    class set (JAX draws it once for the whole sharded classifier)."""
    return torch.randint(0, num_classes, (n,), generator=_step_generator(SAMPLE_SEED, step, device),
                         device=device, dtype=torch.int32)


@dataclass
class SoftmaxState:
    """The training state: modules, classifier and optimizer live on one
    device; on a mesh the classifier (and its momentum and last-visit
    steps) is this rank's block of C / mesh.model rows."""

    step: int
    backbone: nn.Module
    # [C, D] in pool.classifier_dtype; a leaf with a gradient on routes B, C and dense E
    classifier: torch.Tensor
    optimizer: torch.optim.Optimizer  # the backbone
    # [C, D], in place: route A's momentum (pool.classifier_mom_dtype), routes D and
    # sparse E's (f32), or on routes B, C and dense E the trace in the classifier's dtype
    classifier_mom: torch.Tensor | None = None
    classifier_last: torch.Tensor | None = None  # routes D, sparse E: [C] int32 last-visit step


def _streaming_on(cfg: Config) -> bool:
    if cfg.pool.use_fused == "auto":
        return cfg.pool.num_classes >= cfg.pool.streaming_threshold
    return cfg.pool.use_fused == "on"


def _fused_update_on(cfg: Config) -> bool:
    """True on route A: the classifier update runs inside the streaming
    backward. Needs the dense streaming head, SGD and no global-norm
    clipping (it would couple the classifier update to backbone gradients
    that do not exist yet at stream time)."""
    if cfg.pool.fused_update == "off":
        return False
    if not _streaming_on(cfg) or cfg.pool.sample_rate > 0 or cfg.pool.sparse_update:
        return False
    eligible = cfg.optim.optim == "SGD" and cfg.optim.grad_clip == 0
    if cfg.pool.fused_update == "on" and not eligible:
        raise ValueError(
            "pool.fused_update=on requires the dense streaming head, SGD and "
            "optim.grad_clip=0; use 'auto' to fall back")
    return eligible


def _sparse_classifier_mode(cfg: Config) -> bool:
    """True on routes D and sparse E: the classifier is updated by
    ``sparse_sgd_rows`` with a bare momentum buffer, outside the
    optimizer."""
    if not cfg.pool.sparse_update:
        return False
    return cfg.pool.sample_rate > 0 or _streaming_on(cfg)


def check_ported(cfg: Config, device=None) -> None:
    """Raise NotImplementedError for an option of this head that is not
    ported yet; with a CUDA ``device`` also for a feature width the
    margin_ce kernels do not take."""
    pool = cfg.pool
    on_kernels = (_streaming_on(cfg) and pool.sample_rate == 0 and device is not None
                  and torch.device(device).type == "cuda")
    for name in ("classifier_dtype", "classifier_mom_dtype"):
        if getattr(pool, name) not in DTYPES:
            raise ValueError(f"pool.{name} must be float32 or bfloat16, got "
                             f"{getattr(pool, name)!r}")
    for what, on in (
            ("optim.optim='RMSprop'", cfg.optim.optim == "RMSprop"),
            (f"model.feat_dim={cfg.model.feat_dim} on the margin_ce kernels (a multiple of 64 "
             f"up to 512)", on_kernels and not kernel_width_ok(cfg.model.feat_dim))):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def init_classifier(num_classes: int, feat_dim: int, dtype: torch.dtype, *, device,
                    generator: torch.Generator, block: tuple[int, int] | None = None):
    """The classifier as JAX initialises it, f32 0.01·N(0, 1) cast to
    ``dtype``, drawn INIT_ROWS rows at a time so the f32 draw never exists
    whole (8 GiB at 4M × 512). With ``block = (c0, n)`` only the rows
    [c0, c0 + n) are kept, every chunk being drawn all the same, so a
    block is the whole classifier's slice bit for bit."""
    c0, n = (0, num_classes) if block is None else block
    out = torch.empty((n, feat_dim), dtype=dtype, device=device)
    for lo in range(0, num_classes, INIT_ROWS):
        hi = min(num_classes, lo + INIT_ROWS)
        x = torch.randn((hi - lo, feat_dim), generator=generator, device=device).mul_(0.01)
        a, e = max(lo, c0), min(hi, c0 + n)
        if a < e:
            out[a - c0:e - c0] = x[a - lo:e - lo]
    return out


def create_softmax_state(model: nn.Module, cfg: Config, num_classes: int, *, device=None,
                         seed: int = 0, classifier: torch.Tensor | None = None,
                         mesh=None) -> SoftmaxState:
    """Backbone = ``model`` on the device, a classifier in
    ``pool.classifier_dtype`` drawn as 0.01·N(0, 1) from a generator seeded
    with ``seed`` (``init_classifier``; or ``classifier`` as given, in its
    own dtype), and the optimizer; on routes A, D and sparse E a zero
    momentum buffer beside the classifier (optax's trace starts at zero
    too; route A's in ``pool.classifier_mom_dtype``, D's and E's f32), on D
    and sparse E also a zero last-visit step per row; on routes B, C and
    dense E a zero trace in the classifier's dtype when ``optim.momentum``
    is set (module docstring). With a
    ``mesh`` the state keeps this rank's block of that classifier (and a
    momentum and last-visit block). Runs on ``cuda`` unless ``device`` says
    otherwise; raises without a card."""
    dev = resolve_device(device)
    check_ported(cfg, dev)
    backbone = model.to(dev)
    block = None if mesh is None else mesh.class_block(num_classes, "pool.num_classes")
    if classifier is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        classifier = init_classifier(num_classes, cfg.model.feat_dim,
                                     DTYPES[cfg.pool.classifier_dtype], device=dev,
                                     generator=gen, block=block)
    else:
        classifier = classifier.to(dev).contiguous()
        if block is not None:
            classifier = classifier[block[0]:block[0] + block[1]].clone()
    last, mom = None, None
    if _fused_update_on(cfg) or _sparse_classifier_mode(cfg):
        mom_dtype = DTYPES[cfg.pool.classifier_mom_dtype]
        if _sparse_classifier_mode(cfg):
            last = torch.zeros((classifier.shape[0],), dtype=torch.int32, device=dev)
            mom_dtype = torch.float32
        mom = torch.zeros_like(classifier, dtype=mom_dtype)
    else:  # routes B, C, dense E: optax's chain on the leaf (sgd_leaf_)
        classifier.requires_grad_(True)
        if cfg.optim.momentum:
            mom = torch.zeros_like(classifier)
    return SoftmaxState(step=0, backbone=backbone, classifier=classifier,
                        optimizer=make_optimizer(cfg.optim, backbone.parameters()),
                        classifier_mom=mom, classifier_last=last)


def make_softmax_train_step(cfg: Config, schedule, mesh=None):
    """``step(state, images, labels, lr_scale) -> metrics``: one step of the
    route the config selects, updating ``state`` in place. ``images`` are
    an NHWC batch (on the data axis this rank's rows of it), ``labels``
    the global batch's class ids (numpy or tensors). With a ``mesh``
    (``parallel/mesh.py``) the route runs class-sharded over its model
    axis, on the state ``create_softmax_state(..., mesh=mesh)`` makes, and
    over its data axis as the module docstring says; the config's
    ``mesh.model > 1`` or ``mesh.data > 1`` needs one."""
    check_ported(cfg)
    streaming = _streaming_on(cfg)
    fused = _fused_update_on(cfg)
    sparse = _sparse_classifier_mode(cfg)
    c = cfg.pool.num_classes
    c0, c_local, draw_rank = 0, c, None
    if mesh is None and (cfg.mesh.model > 1 or cfg.mesh.data > 1):
        raise ValueError("the class-sharded softmax head (mesh.model > 1) or its data axis "
                         "(mesh.data > 1) needs the mesh: make_softmax_train_step(cfg, schedule, "
                         "mesh)")
    d = 1 if mesh is None else mesh.data
    # the head's mesh: the class-sharded route over the model group; on the
    # data axis at mesh.model = 1 the single-device route on the gathered batch
    head_mesh = None if mesh is None or (d > 1 and mesh.model == 1) else mesh
    if head_mesh is not None:
        c0, c_local = head_mesh.class_block(c, "pool.num_classes")
        draw_rank = head_mesh.rank if head_mesh.model > 1 else None  # the model index
    loss_kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                   mask_svfc=cfg.loss.mask_svfc)
    sgd_kw = dict(momentum=cfg.optim.momentum, nesterov=cfg.optim.nesterov,
                  weight_decay=cfg.optim.weight_decay)
    fused_head, sparse_head = streaming_margin_grads_fused_sgd, streaming_sparse_margin_grads
    if head_mesh is not None:
        fused_head = partial(sharded_margin_grads_fused_sgd, mesh=head_mesh)
        sparse_head = partial(sharded_sparse_margin_grads, mesh=head_mesh)
    grad_clip = cfg.optim.grad_clip
    seed = cfg.data.seed if cfg.model.dropout > 0 else None  # dropout's draws
    num_sampled = 0
    if cfg.pool.sample_rate > 0:  # route E, over the global batch
        num_sampled = max(cfg.data.batch_size, int(c * cfg.pool.sample_rate))
    elif streaming and cfg.pool.sparse_update:  # route D, over this rank's block on a mesh
        tile, n_tiles = sparse_bwd_geometry(cfg.data.batch_size, cfg.model.feat_dim, c_local)
        m_tiles = sparse_m_tiles(cfg.pool.sparse_grad_rate, n_tiles, cfg.data.batch_size)

    def sharded_sampled_head(state, emb, labels, lr) -> tuple[torch.Tensor, dict]:
        """Route E on the mesh (``partial_fc.sharded_sampled_loss``): the
        rank updates the rows of its block among the sampled classes, by
        ``sparse_sgd_rows``, or as the block's gradient (zero elsewhere)
        for the optimizer chain."""
        rand = sample_draws(state.step, num_sampled - emb.shape[0], c, emb.device)
        loss, metrics, rows, w_sub = sharded_sampled_loss(
            emb, state.classifier, c0, labels, rand, c, num_sampled, head_mesh.group, **loss_kw)
        loss.backward()
        with torch.no_grad():
            if sparse:
                sparse_sgd_rows(state.classifier, state.classifier_mom, rows, w_sub.grad, lr=lr,
                                last_visit=state.classifier_last, step=state.step, **sgd_kw)
            else:  # rows are unique: a plain copy, no accumulation
                state.classifier.grad = torch.zeros_like(state.classifier).index_copy_(
                    0, rows, w_sub.grad)
        return loss, metrics

    def head(state, emb, labels, lr, dev) -> tuple[torch.Tensor, dict]:
        """The head's loss and metrics on the global batch's embeddings
        ``emb``; the backbone's gradient is in place afterwards, and on
        routes A and D the classifier's update too."""
        b = emb.shape[0]
        if num_sampled and head_mesh is not None:  # route E over the rank's block
            return sharded_sampled_head(state, emb, labels, lr)
        if num_sampled:  # route E
            rand = sample_draws(state.step, num_sampled - b, c, dev)
            sampled, local_labels, valid = sample_classes(labels, c, num_sampled, rand)
            w_sub = state.classifier[sampled.long()]
            if sparse:
                w_sub = w_sub.detach().requires_grad_(True)
            loss, metrics = margin_softmax_loss(emb, w_sub, local_labels, col_mask=valid,
                                                **loss_kw)
            loss.backward()
            if sparse:  # masked columns carry exact-zero gradients: route them to the drop
                with torch.no_grad():
                    sparse_sgd_rows(state.classifier, state.classifier_mom,
                                    torch.where(valid, sampled, c), w_sub.grad, lr=lr,
                                    last_visit=state.classifier_last, step=state.step, **sgd_kw)
            return loss, dict(metrics, sampled_classes=num_sampled)
        if not (fused or sparse):  # routes B and C
            loss, metrics = margin_softmax_loss(emb, state.classifier, labels,
                                                streaming=streaming, mesh=head_mesh, **loss_kw)
            loss.backward()
            return loss, metrics
        # routes A and D: loss = mean(ce), analytic output cotangents (no outlier rows)
        d_ce = torch.full((b,), 1.0 / b, device=dev)
        d_neg = torch.zeros_like(d_ce)
        with torch.no_grad():
            if fused:
                ce, _neg, topk, gt, d_emb, _, _ = fused_head(
                    emb.detach(), state.classifier, state.classifier_mom, labels, d_ce, d_neg, lr,
                    hard_neg=1, **sgd_kw, **loss_kw)
            else:
                ce, _neg, topk, gt, d_emb, row_idx, d_w_rows = sparse_head(
                    emb.detach(), state.classifier, labels, d_ce, d_neg, m_tiles=m_tiles,
                    hard_neg=1, tile=tile, u=tile_fill_draws(state.step, n_tiles, dev, draw_rank),
                    **loss_kw)
        emb.backward(d_emb.to(emb.dtype))
        loss = ce.mean()
        metrics = {"ce": loss, "train_acc": (gt >= topk[:, 0]).float().mean()}
        if not fused:
            with torch.no_grad():  # row_idx entries >= C (padding) are dropped
                if head_mesh is not None:  # the rank's rows, numbered in its block
                    row_idx = torch.where(row_idx < c, row_idx - c0, c_local)
                sparse_sgd_rows(state.classifier, state.classifier_mom, row_idx, d_w_rows, lr=lr,
                                last_visit=state.classifier_last, step=state.step, **sgd_kw)
            metrics["grad_rows"] = row_idx.shape[0] * (1 if head_mesh is None else head_mesh.model)
        return loss, metrics

    def global_norm(params, classifier):
        """The gradients' global norm; on a mesh the classifier blocks'
        squares are summed over the group once, the replicated backbone's
        taken once. A bf16 classifier's share is optax's: squares and sum
        in bf16 (the sum accumulated in f32 and rounded once)."""
        sq = sum(p.grad.square().sum() for p in params if p is not classifier)
        if classifier.requires_grad:
            grad = classifier.grad
            block = grad.square().sum(dtype=torch.float32)
            if head_mesh is not None:
                dist.all_reduce(block, group=head_mesh.group)
            sq = sq + block.to(grad.dtype).float()
        return torch.sqrt(sq)

    def step(state: SoftmaxState, images, labels, lr_scale: float = 1.0) -> dict:
        dev = state.classifier.device
        images = torch.as_tensor(images).to(dev, non_blocking=True)
        labels = torch.as_tensor(labels).to(dev, non_blocking=True).to(torch.int32)
        b = images.shape[0]
        if labels.shape[0] != d * b:
            raise ValueError(f"{labels.shape[0]} labels for {b} rows a rank over mesh.data={d}: "
                             f"the labels are the global batch's")
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        lr = float(schedule(state.step)) * float(lr_scale)
        state.backbone.train()
        with data_axis_forward(mesh, b, dev, seed=seed, step=state.step):
            emb = state.backbone(images)
        if d > 1:  # the head runs on the global batch; the backward hands back this rank's rows
            emb = distributed.gather_rows(emb, mesh.data_group)
        loss, metrics = head(state, emb, labels, lr, dev)
        # routes B, C, dense E: the classifier takes optax's leaf update
        leaf = state.classifier if state.classifier.requires_grad else None
        with torch.no_grad():
            params = [p for group in opt.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:  # unused parameters still decay, as in optax
                    p.grad = torch.zeros_like(p)
            if d > 1:  # each rank's rows' share of the global batch's gradient
                distributed.sum_([p.grad for p in params], mesh.data_group)
            if leaf is not None:
                params.append(leaf)
            if grad_clip > 0:
                clip_by_global_norm_(params, grad_clip, global_norm(params, state.classifier))
        set_learning_rate(opt, lr)
        opt.step()
        if leaf is not None:
            sgd_leaf_(leaf, state.classifier_mom, leaf.grad, lr, **sgd_kw)
            leaf.grad = None
        state.step += 1
        return dict(metrics, loss=loss.detach(), lr=lr)

    return step
