"""FFC train step (port of ``vlsfr_tpu/core/ffc.py``).

One step of the FFC twin network over a host-planned ``StepIndices``:

1. the EMA gallery update, once, before any gallery forward, on parameters
   only (BN running stats are not averaged);
2. probe forwards (train mode, with grad) and gallery forwards (train mode,
   ``no_grad``) over both batch halves — as one 2B batch per net with
   ``pool.fuse_forward``, else in the reference order probe(x), gallery(y),
   probe(y), gallery(x); with ``pool.gallery_int8`` the gallery forwards
   alone run on int8 convs (``ops/quant.py``);
3. the two directional losses: at ``pool.queue_size >=
   pool.streaming_threshold`` (``use_fused='auto'``) the fused quad head
   (ops/twin_margin.py, CUDA kernels on the card), else the dense head;
   with a mesh whose ``model`` axis is > 1, or ``pool.force_sharded``, the
   fused head runs model-sharded (parallel/sharded_quad.py), and given a
   mesh the dense head does (``make_sharded_dense_loss``,
   parallel/sharded_dense.py): each rank holds one block [2, Q/m, D] of
   the queue. The rounded queue forms' backward rounds per tile of
   ``quad_tile`` as JAX computes it;
4. backward, then direction B's queue write IN PLACE on the [2, Q, D]
   queue (or the rank's block of it) after the backward, which still reads
   the pre-write queue; last writer wins among duplicate slots. A bf16
   queue stores the rounded rows; an int8 queue (``pool.queue_dtype=int8``,
   ops/qqueue.py) stores each written row quantised afresh, with its scale
   in ``queue_scales`` [2, Q], and with ``pool.queue_int8_compute`` the
   head's streamed dots run int8 × int8;
5. lr = schedule(step) × plateau scale, SGD step.

Direction A's writes are never persisted (the reference's rollback pass).
On the model axis every rank runs the same step on the same batch and plan;
the head's collectives make its gradient the same on every rank, so the
probe parameters stay equal across ranks. On the data axis (``mesh.data >
1``) each rank holds its rows of the global batch (``data/pipeline.py``):
the forwards' BatchNorm statistics span the global batch
(``models/layers.sync_batch_norm``), the four embeddings are gathered over
the data group before the head (``parallel/distributed.gather_rows``), so
the head runs on the global batch against the global plan, and after the
backward the probe's gradients are summed over the data group (the loss is
already the global batch's mean), then clipped. Every data replica of a
model block writes the same gathered rows into its queue block, so the
replicas stay equal bit for bit. Dropout draws from a generator seeded by
(``data.seed``, the data index, the step).
"""

from __future__ import annotations

import contextlib
import copy
import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import PassIndices, StepIndices
# dropout_seed is re-exported
from vlsfr_tpu_torch.models.layers import data_axis_forward, dropout_seed  # noqa: F401
from vlsfr_tpu_torch.ops.margin import add_margin, default_hard_neg, kernel_width_ok
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.ops.quant import int8_conv_inference
from vlsfr_tpu_torch.ops.twin_margin import quad_add_margin, reduce_margin_dir, twin_add_margin
from vlsfr_tpu_torch.optim import make_optimizer, set_learning_rate
from vlsfr_tpu_torch.optim.optimizers import clip_by_global_norm_
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel.sharded_dense import ShardedDenseMargin, held_columns, reduce_grad
from vlsfr_tpu_torch.parallel.sharded_quad import make_sharded_quad_loss
from vlsfr_tpu_torch.utils.device import resolve_device


@dataclass
class FFCState:
    """The training state: modules, queue and optimizer live on one device."""

    step: int
    probe: nn.Module
    gallery: nn.Module  # EMA copy of the probe; never optimised
    queue: torch.Tensor  # [2, Q, D] L2-normalised rows; on a mesh this rank's [2, Q/m, D] block
    optimizer: torch.optim.Optimizer
    # [2, Q] (or the rank's [2, Q/m]) per-row dequant scales of an int8
    # queue (ops/qqueue.py); None for float queues
    queue_scales: torch.Tensor | None = None


QUEUE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
INIT_CHUNK = 1 << 16  # rows per draw of the queue


def init_queue(queue_size: int, feat_dim: int, *, device, generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32, block: tuple[int, int] | None = None):
    """Uniform[0, 1) rows L2-normalised over features, drawn INIT_CHUNK rows
    at a time, so no f32 copy of a bf16 or int8 queue exists (42.9 GB at
    10,485,760 slots × 512, against 10.7 GB int8). Returns ``(queue,
    scales)``: the [2, Q, D] queue in ``dtype`` and, for int8, its [2, Q]
    scales (``quantize_rows``; None otherwise). With ``block = (c0, n)``
    only the slots [c0, c0 + n) are kept, every chunk being drawn all the
    same, so a block is the queue's slice bit for bit."""
    c0, n = (0, queue_size) if block is None else block
    queue = torch.empty((2, n, feat_dim), dtype=dtype, device=device)
    scales = torch.empty((2, n), device=device) if dtype == torch.int8 else None
    for lo in range(0, queue_size, INIT_CHUNK):
        hi = min(queue_size, lo + INIT_CHUNK)
        x = torch.rand((2, hi - lo, feat_dim), generator=generator, device=device)
        a, e = max(lo, c0), min(hi, c0 + n)
        if a >= e:
            continue
        x = x[:, a - lo:e - lo]
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        if scales is None:
            queue[:, a - c0:e - c0] = x.to(dtype)
        else:
            queue[:, a - c0:e - c0], scales[:, a - c0:e - c0] = quantize_rows(x)
    return queue, scales


def state_from_jax(queue, scales=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A JAX state's queue and scales (numpy arrays, from ``np.asarray`` of
    the JAX arrays) as the port's tensors, dtype kept: a bf16 array
    carries ml_dtypes' bfloat16, which ``torch.from_numpy`` refuses, so it
    goes through its uint16 bits."""
    import numpy as np

    q = np.array(queue)  # a writable copy
    if q.dtype.name == "bfloat16":
        t = torch.from_numpy(q.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(q)
    return t, None if scales is None else torch.from_numpy(np.array(scales))


def scatter_mask(seen: torch.Tensor, cols: torch.Tensor, queue_size: int,
                 col0: int = 0) -> torch.Tensor:
    """[Q] blend mask: 1 where any batch sample that hit the slot was seen
    (max-scatter, so duplicate slots stay 1). With ``col0`` the mask of the
    block of ``queue_size`` slots from slot ``col0``: the plan's columns
    outside it are dropped."""
    lcol = cols.long() - col0
    lcol = torch.where((lcol >= 0) & (lcol < queue_size), lcol, queue_size)
    mask = torch.zeros(queue_size + 1, device=seen.device)
    return mask.scatter_reduce_(0, lcol, seen.float(), reduce="amax")[:queue_size]


def write_rows_(queue: torch.Tensor, g: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, col0: int = 0, scales: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``queue[rows, cols] = g`` in place, the highest batch index winning
    among duplicate (row, col) entries — resolved here, over the whole
    plan, because an indexed write with duplicate indices leaves the winner
    undefined on CUDA. ``queue`` may be a block of the queue starting at
    slot ``col0``: then only the plan's columns inside it are written. An
    int8 queue takes ``quantize_rows(g)`` into its rows and ``scales``,
    with the same winner for both; a bf16 queue the rounded rows."""
    key = cols.long() * 2 + rows.long()
    later = torch.triu(key[:, None] == key[None, :], diagonal=1).any(dim=1)
    lcol = cols.long() - col0
    keep = torch.nonzero(~later & (lcol >= 0) & (lcol < queue.shape[1])).flatten()
    r, c = rows.long()[keep], lcol[keep]
    if queue.dtype == torch.int8:
        q_rows, s_rows = quantize_rows(g[keep])
        queue[r, c] = q_rows
        scales[r, c] = s_rows
    else:
        queue[r, c] = g[keep].to(queue.dtype)
    return queue


def dense_views(queue, g, rows, cols, seen, col0: int = 0):
    """The dense head's (written copy, view 1, view 2) of ``queue`` [2, Q, D]
    (or of its block of the queue from slot ``col0``) after one direction's
    writes: the copy holds ``g`` in the plan's (row, col) slots it covers,
    view 1 is its row 0, view 2 the parity blend (row 1 where a seen sample
    hit the slot, else row 0), both as f32 [Q, D]."""
    new_queue = write_rows_(queue.clone(), g, rows, cols, col0)
    mask = scatter_mask(seen, cols, queue.shape[1], col0)[:, None]
    weight = mask * new_queue[1] + (1.0 - mask) * new_queue[0]
    return new_queue, new_queue[0].float(), weight.float()


def directional_loss(p, g, queue, rows, cols, seen, fake_labels, *, loss_type, margin, scale,
                     hard_neg, mask_svfc=1.2, use_fused=False, sharded_loss_fn=None,
                     defer_scatter=False, with_acc=False):
    """One direction: write the gallery embeddings, score the probes
    against both queue views, sum the two margin losses (JAX's
    ``directional_loss``). Returns (loss, written_queue[, acc]).

    The dense head writes into a copy of the queue and materialises the
    [B, Q] logits. With ``use_fused`` the twin head streams both views
    with the writes applied in registers (``ops/twin_margin.twin_add_margin``:
    the twin CUDA kernels on the card), or ``sharded_loss_fn(p, queue, g,
    rows, cols, seen, labels)`` does (``parallel/sharded_twin.py``, over
    this rank's block ``queue``); with ``defer_scatter`` the second result
    is the write plan ``(g, rows, cols)`` for the caller to apply after the
    backward, else the written copy of the queue. A sharded loss needs
    ``defer_scatter``: the plan holds global slots, and only the caller
    knows where its block starts (``mesh.class_block``)."""
    g = g.detach()
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, hard_neg=hard_neg,
              mask_svfc=mask_svfc)
    if use_fused:
        if sharded_loss_fn is not None:
            if not defer_scatter:
                raise ValueError(
                    "sharded_loss_fn needs defer_scatter=True: the queue is this rank's "
                    "block and the write plan's slots are global, so the caller applies "
                    "the plan at its block's first slot (mesh.class_block)")
            out = sharded_loss_fn(p, queue, g, rows, cols, seen, fake_labels)
            if with_acc and not isinstance(out, tuple):
                raise TypeError(
                    "with_acc=True but sharded_loss_fn returned a bare loss "
                    "— construct it with with_acc=True as well "
                    "(parallel/sharded_twin.py, sharded_quad.py)")
        else:
            out = twin_add_margin(p, queue, g, rows, cols, seen, fake_labels, with_acc=with_acc,
                                  **kw)
        loss, acc = out if with_acc else (out, None)
        if defer_scatter:
            new_queue = (g, rows, cols)
        else:
            new_queue = write_rows_(queue.clone(), g, rows, cols)
        return (loss, new_queue, acc) if with_acc else (loss, new_queue)
    new_queue, view1, view2 = dense_views(queue, g, rows, cols, seen)
    cos1 = p.float() @ view1.T
    cos2 = p.float() @ view2.T
    loss = add_margin(cos1, fake_labels, **kw) + add_margin(cos2, fake_labels, **kw)
    if not with_acc:
        return loss, new_queue
    pos = fake_labels >= 0
    gt = cos1.gather(1, fake_labels.clamp(min=0).long()[:, None])[:, 0]
    hit = (gt >= cos1.max(dim=1).values) & pos
    acc = hit.float().sum() / pos.float().sum().clamp(min=1.0)
    return loss, new_queue, acc.detach()


def make_sharded_dense_loss(mesh, *, loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10,
                            mask_svfc=1.2, with_acc=False):
    """The dense head over the mesh's model axis (JAX's GSPMD-sharded dense
    ``directional_loss``), with ``make_sharded_quad_loss``'s signature:
    ``loss_fn(emb_x, emb_y, q_l, g_a, g_b, plan_a, plan_b, labels_a,
    labels_b, qscales=None)`` -> (loss_a, loss_b)[, acc] over this rank's
    block ``q_l`` [2, Q/m, D] of an f32 or bf16 queue. Per direction the
    block's two views after the direction's writes to the owned columns
    (``dense_views``) give the [b, Q/m] cosines of both views;
    ``parallel/sharded_dense.ShardedDenseMargin`` merges the four rows of
    statistics in one all_gather, and the embeddings' gradient is
    all_reduced once. The accuracy is JAX's dense one: per direction the
    positive rows whose target cosine is the row's maximum, then the mean
    of the two directions."""
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale),
              mask_svfc=float(mask_svfc))

    def loss_fn(emb_x, emb_y, q_l, g_a, g_b, plan_a, plan_b, labels_a, labels_b, qscales=None):
        if qscales is not None:
            raise ValueError("the dense head takes f32 and bf16 queues only, as in JAX")
        b, c_local = emb_x.shape[0], q_l.shape[1]
        c0, _ = mesh.class_block(c_local * mesh.model)
        e = reduce_grad(torch.cat([emb_x.float(), emb_y.float()]), mesh.group)
        cos = []
        for p, g, (rows, cols, seen) in ((e[:b], g_a, plan_a), (e[b:], g_b, plan_b)):
            _, view1, view2 = dense_views(q_l, g.detach(), rows, cols, seen, c0)
            cos += [p @ view1.T, p @ view2.T]
        labels = torch.stack([labels_a, labels_a, labels_b, labels_b])
        col_ids = torch.arange(c0, c0 + c_local, device=q_l.device)
        ce, neg, gt, top, _ = ShardedDenseMargin.apply(
            torch.stack(cos), held_columns(col_ids, labels), col_ids, mesh.group, kw,
            min(hard_neg, c_local * mesh.model))
        losses = (reduce_margin_dir(ce[0], neg[0], ce[1], neg[1], labels_a),
                  reduce_margin_dir(ce[2], neg[2], ce[3], neg[3], labels_b))
        if not with_acc:
            return losses
        accs = []
        for v, labels_v in ((0, labels_a), (2, labels_b)):
            pos = labels_v >= 0
            hit = (gt[v] >= top[v, :, 0]) & pos
            accs.append(hit.float().sum() / pos.float().sum().clamp(min=1.0))
        return losses, ((accs[0] + accs[1]) / 2).detach()

    return loss_fn


def _pass_to(ix: PassIndices, device) -> PassIndices:
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device, non_blocking=True)  # noqa: E731
    return PassIndices(rows=t(ix.rows), cols=t(ix.cols), seen=t(ix.seen),
                       fake_labels=t(ix.fake_labels))


def use_fused_head(cfg: Config) -> bool:
    if cfg.pool.use_fused == "auto":
        return cfg.pool.queue_size >= cfg.pool.streaming_threshold
    return cfg.pool.use_fused == "on"


def use_sharded_head(cfg: Config) -> bool:
    """The fused head over the mesh's ``model`` axis (``core/ffc.py:221``
    of the JAX package): a model axis > 1, or ``pool.force_sharded`` to run
    the sharded path on one device."""
    return use_fused_head(cfg) and (cfg.mesh.model > 1 or cfg.pool.force_sharded)


def needs_mesh(cfg: Config) -> bool:
    """Whether the FFC step runs over a mesh: the fused head sharded
    (``use_sharded_head``), the dense head at a model axis > 1, or a data
    axis > 1."""
    return use_sharded_head(cfg) or cfg.mesh.model > 1 or cfg.mesh.data > 1


def check_queue_config(cfg: Config) -> None:
    """JAX's queue configuration errors (``vlsfr_tpu/core/ffc.py``
    ``make_ffc_loss_fn``), with its messages."""
    pool = cfg.pool
    if pool.queue_dtype not in QUEUE_DTYPES:
        raise ValueError(f"pool.queue_dtype must be one of {sorted(QUEUE_DTYPES)}, "
                         f"got {pool.queue_dtype!r}")
    if pool.queue_dtype == "int8" and not use_fused_head(cfg):
        raise ValueError(
            "queue_dtype=int8 requires the fused streaming head (the dense "
            "path materializes blended [Q, D] copies the int8 layout exists "
            "to avoid) — set pool.use_fused='on' or raise queue_size past "
            "pool.streaming_threshold")
    if pool.queue_int8_compute and pool.queue_dtype != "int8":
        raise ValueError("pool.queue_int8_compute requires pool.queue_dtype='int8'")
    if pool.queue_tile > 0 and pool.queue_size % pool.queue_tile != 0:
        raise ValueError(f"pool.queue_tile={pool.queue_tile} must divide "
                         f"pool.queue_size={pool.queue_size}")


def quad_tile(cfg: Config) -> int:
    """The fused head's kernel tile request, as JAX's ``make_ffc_loss_fn``
    computes it: ``pool.queue_tile``, or at 0 2048 when the queue divides
    by 1024 and 512 otherwise (the kernels then resolve it,
    ``ops/twin_margin.round_tile``)."""
    if cfg.pool.queue_tile > 0:
        return cfg.pool.queue_tile
    return 2048 if cfg.pool.queue_size % 1024 == 0 else 512


def check_kernel_width(cfg: Config, device) -> None:
    """Refuse, before anything is built, a feature width the fused head's
    kernels do not take on a card (a multiple of 64 up to 512; the CPU's
    plain versions take any). Any batch is taken."""
    on_kernels = use_fused_head(cfg) and torch.device(device).type == "cuda"
    if on_kernels and not kernel_width_ok(cfg.model.feat_dim):
        raise NotImplementedError(
            f"model.feat_dim={cfg.model.feat_dim} on the fused FFC head's kernels (a multiple "
            f"of 64 up to 512) is not ported yet")


def make_train_step(cfg: Config, schedule, mesh=None):
    """``step(state, x, y, idx, lr_scale) -> metrics``: runs one FFC step,
    updating ``state`` in place. ``x``/``y`` are NHWC batches (numpy or
    tensors; on the data axis this rank's rows of them), ``idx`` the host
    plan for this step (global). The sharded head (``use_sharded_head``)
    needs the ``mesh`` (parallel/mesh.py) its state was made for; given a
    ``mesh`` the dense head runs over its model axis
    (``make_sharded_dense_loss``), as it must at ``mesh.model > 1``; at
    ``mesh.model = 1`` with a data axis the heads are the single-device
    ones, on the gathered batch."""
    pool = cfg.pool
    check_queue_config(cfg)
    hard_neg = pool.hard_neg if pool.hard_neg > 0 else default_hard_neg(pool.queue_size)
    loss_kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                   hard_neg=hard_neg, mask_svfc=cfg.loss.mask_svfc)
    int8_compute = pool.queue_int8_compute
    tile = quad_tile(cfg)
    col0 = 0
    # both directions in one call of the head, writes applied after the
    # backward: the quad head, sharded or not, and the dense head on a mesh
    head_loss = None
    if use_fused_head(cfg):
        head_loss = functools.partial(quad_add_margin, with_acc=True,
                                      int8_compute=int8_compute, tile=tile, **loss_kw)
    if needs_mesh(cfg) and mesh is None:
        raise ValueError("the sharded FFC head (mesh.model > 1 or pool.force_sharded) "
                         "needs the mesh: make_train_step(cfg, schedule, mesh)")
    if use_sharded_head(cfg):
        col0, _ = mesh.class_block(pool.queue_size)
        head_loss = make_sharded_quad_loss(mesh, with_acc=True, int8_compute=int8_compute,
                                           tile=tile, **loss_kw)
    elif mesh is not None and (mesh.model > 1 or mesh.data == 1):
        col0, _ = mesh.class_block(pool.queue_size)
        head_loss = make_sharded_dense_loss(mesh, with_acc=True, **loss_kw)
    m = pool.momentum
    fuse_fwd = pool.fuse_forward
    grad_clip = cfg.optim.grad_clip
    # the no-gradient EMA forward on int8 convs (ops/quant.py); BN stays in
    # train mode and the probe's forward is untouched
    gallery_ctx = int8_conv_inference if pool.gallery_int8 else contextlib.nullcontext
    d = 1 if mesh is None else mesh.data
    # dropout's draws (model.dropout > 0) from (data.seed, data index, step)
    seed = cfg.data.seed if cfg.model.dropout > 0 else None

    def step(state: FFCState, x, y, idx: StepIndices, lr_scale: float = 1.0) -> dict:
        dev = state.queue.device
        x = torch.as_tensor(x).to(dev, non_blocking=True)
        y = torch.as_tensor(y).to(dev, non_blocking=True)
        ia, ib = _pass_to(idx.a, dev), _pass_to(idx.b, dev)
        probe, gallery = state.probe, state.gallery
        with torch.no_grad():  # EMA once, before any gallery forward
            for pg, pp in zip(gallery.parameters(), probe.parameters()):
                pg.copy_(m * pg + (1.0 - m) * pp)
        probe.train()
        gallery.train()
        b = x.shape[0]
        # on the data axis BatchNorm over this rank's rows of the global
        # batch (fuse_forward: of two global batches, x ⧺ y)
        with data_axis_forward(mesh, b, dev, segments=2 if fuse_fwd else 1, seed=seed,
                               step=state.step):
            if fuse_fwd:
                # one 2B forward per net; BN statistics then span 2B samples
                p_xy = probe(torch.cat([x, y]))
                with torch.no_grad(), gallery_ctx():
                    g_yx = gallery(torch.cat([y, x]))
                p_x, p_y, g_y, g_x = p_xy[:b], p_xy[b:], g_yx[:b], g_yx[b:]
            else:
                p_x = probe(x)
                with torch.no_grad(), gallery_ctx():
                    g_y = gallery(y)
                p_y = probe(y)
                with torch.no_grad(), gallery_ctx():
                    g_x = gallery(x)
        if d > 1:  # the head runs on the global batch
            p_xy = distributed.gather_rows(torch.stack([p_x, p_y], 1), mesh.data_group)
            with torch.no_grad():
                g_yx = distributed.gather_rows(torch.stack([g_y, g_x], 1), mesh.data_group)
            p_x, p_y, g_y, g_x = (t.contiguous() for t in (*p_xy.unbind(1), *g_yx.unbind(1)))
        if head_loss is not None:
            (loss_a, loss_b), train_acc = head_loss(
                p_x, p_y, state.queue, g_y, g_x, (ia.rows, ia.cols, ia.seen),
                (ib.rows, ib.cols, ib.seen), ia.fake_labels, ib.fake_labels,
                qscales=state.queue_scales)
            new_queue = None
        else:
            loss_a, _, acc_a = directional_loss(p_x, g_y, state.queue, ia.rows, ia.cols,
                                                ia.seen, ia.fake_labels, with_acc=True, **loss_kw)
            loss_b, new_queue, acc_b = directional_loss(p_y, g_x, state.queue, ib.rows, ib.cols,
                                                        ib.seen, ib.fake_labels, with_acc=True,
                                                        **loss_kw)
            train_acc = (acc_a + acc_b) / 2
        loss = loss_a + loss_b
        opt = state.optimizer
        opt.zero_grad(set_to_none=False)
        loss.backward()
        with torch.no_grad():
            if new_queue is None:
                # the backward is done with the pre-write queue: write in place
                write_rows_(state.queue, g_x, ib.rows, ib.cols, col0, state.queue_scales)
            else:
                state.queue = new_queue
            params = list(probe.parameters())
            for p in params:
                if p.grad is None:  # unused parameters still decay, as in optax
                    p.grad = torch.zeros_like(p)
            if d > 1:  # each rank's rows' share of the global batch's gradient
                distributed.sum_([p.grad for p in params], mesh.data_group)
            grad_norm = torch.sqrt(sum(p.grad.square().sum() for p in params))
            if grad_clip > 0:
                clip_by_global_norm_(params, grad_clip, grad_norm)
        lr = float(schedule(state.step)) * float(lr_scale)
        set_learning_rate(opt, lr)
        opt.step()
        state.step += 1
        return {
            "loss": loss.detach(),
            "loss_dir_a": loss_a.detach(),
            "loss_dir_b": loss_b.detach(),
            "train_acc": train_acc,
            "pool_hit_rate": (ia.seen.float().mean() + ib.seen.float().mean()) / 2,
            "outlier_frac": (ia.fake_labels < 0).float().mean(),
            "lr": lr,
            "grad_norm": grad_norm,
        }

    return step


def create_ffc_state(model: nn.Module, cfg: Config, *, device=None, seed: int = 0,
                     mesh=None) -> FFCState:
    """Probe = ``model`` on the device, gallery = its copy, a fresh queue
    (``pool.queue_dtype``, with its scales when int8) from a generator
    seeded with ``seed`` and the optimizer. Runs on ``cuda`` unless
    ``device`` says otherwise; raises without a card. With a ``mesh`` the
    state keeps this rank's block of the queue: the whole queue is drawn as
    on one device (so the blocks are its slices, bit for bit) and only the
    block is kept."""
    check_queue_config(cfg)
    dev = resolve_device(device)
    check_kernel_width(cfg, dev)
    probe = model.to(dev)
    gallery = copy.deepcopy(probe).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = None if mesh is None else mesh.class_block(cfg.pool.queue_size)
    queue, scales = init_queue(cfg.pool.queue_size, cfg.model.feat_dim, device=dev,
                               generator=gen, dtype=QUEUE_DTYPES[cfg.pool.queue_dtype],
                               block=block)
    return FFCState(step=0, probe=probe, gallery=gallery, queue=queue,
                    optimizer=make_optimizer(cfg.optim, probe.parameters()),
                    queue_scales=scales)
