"""FFC train step (port of ``vlsfr_tpu/core/ffc.py``).

One step of the FFC twin network over a host-planned ``StepIndices``:

1. the EMA gallery update, once, before any gallery forward, on parameters
   only (BN running stats are not averaged);
2. probe forwards (train mode, with grad) and gallery forwards (train mode,
   ``no_grad``) over both batch halves — as one 2B batch per net with
   ``pool.fuse_forward``, else in the reference order probe(x), gallery(y),
   probe(y), gallery(x);
3. the two directional losses: at ``pool.queue_size >=
   pool.streaming_threshold`` (``use_fused='auto'``) the fused quad head
   (ops/twin_margin.py, CUDA kernels on the card), else the dense head;
   with a mesh whose ``model`` axis is > 1, or ``pool.force_sharded``, the
   fused head runs model-sharded (parallel/sharded_quad.py): each rank
   holds one block [2, Q/m, D] of the queue;
4. backward, then direction B's queue write IN PLACE on the [2, Q, D]
   queue (or the rank's block of it) after the backward, which still reads
   the pre-write queue; last writer wins among duplicate slots. A bf16
   queue stores the rounded rows; an int8 queue (``pool.queue_dtype=int8``,
   ops/qqueue.py) stores each written row quantised afresh, with its scale
   in ``queue_scales`` [2, Q], and with ``pool.queue_int8_compute`` the
   head's streamed dots run int8 × int8;
5. lr = schedule(step) × plateau scale, SGD step.

Direction A's writes are never persisted (the reference's rollback pass).
On a mesh every rank runs the same step on the same batch and plan; the
head's collectives make its gradient the same on every rank, so the probe
parameters stay equal across ranks.
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import PassIndices, StepIndices
from vlsfr_tpu_torch.ops.margin import add_margin, default_hard_neg
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.ops.twin_margin import quad_add_margin
from vlsfr_tpu_torch.optim import make_optimizer, set_learning_rate
from vlsfr_tpu_torch.optim.optimizers import clip_by_global_norm_
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


def scatter_mask(seen: torch.Tensor, cols: torch.Tensor, queue_size: int) -> torch.Tensor:
    """[Q] blend mask: 1 where any batch sample that hit the slot was seen
    (max-scatter, so duplicate slots stay 1)."""
    mask = torch.zeros(queue_size, device=seen.device)
    return mask.scatter_reduce_(0, cols.long(), seen.float(), reduce="amax")


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


def directional_loss(p, g, queue, rows, cols, seen, fake_labels, *, loss_type, margin, scale,
                     hard_neg, mask_svfc=1.2, with_acc=False):
    """Dense head, one direction: write the gallery embeddings into a copy
    of the queue, score the probes against both views, sum the two margin
    losses. Returns (loss, written_queue[, acc])."""
    g = g.detach()
    new_queue = write_rows_(queue.clone(), g, rows, cols)
    q = queue.shape[1]
    mask = scatter_mask(seen, cols, q)[:, None]
    weight = mask * new_queue[1] + (1.0 - mask) * new_queue[0]
    cos1 = p.float() @ new_queue[0].float().T
    cos2 = p.float() @ weight.float().T
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, hard_neg=hard_neg,
              mask_svfc=mask_svfc)
    loss = add_margin(cos1, fake_labels, **kw) + add_margin(cos2, fake_labels, **kw)
    if not with_acc:
        return loss, new_queue
    pos = fake_labels >= 0
    gt = cos1.gather(1, fake_labels.clamp(min=0).long()[:, None])[:, 0]
    hit = (gt >= cos1.max(dim=1).values) & pos
    acc = hit.float().sum() / pos.float().sum().clamp(min=1.0)
    return loss, new_queue, acc.detach()


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
    # checked as JAX checks it; the port's kernels tile by 64 columns
    # whatever it says (ops/twin_margin.py module docstring)
    if pool.queue_tile > 0 and pool.queue_size % pool.queue_tile != 0:
        raise ValueError(f"pool.queue_tile={pool.queue_tile} must divide "
                         f"pool.queue_size={pool.queue_size}")


def make_train_step(cfg: Config, schedule, mesh=None):
    """``step(state, x, y, idx, lr_scale) -> metrics``: runs one FFC step,
    updating ``state`` in place. ``x``/``y`` are NHWC batches (numpy or
    tensors), ``idx`` the host plan for this step. The sharded head
    (``use_sharded_head``) needs the ``mesh`` (parallel/mesh.py) its state
    was made for."""
    pool = cfg.pool
    if pool.gallery_int8:
        raise NotImplementedError("pool.gallery_int8 is not ported yet")
    check_queue_config(cfg)
    hard_neg = pool.hard_neg if pool.hard_neg > 0 else default_hard_neg(pool.queue_size)
    use_quad = use_fused_head(cfg)
    loss_kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                   hard_neg=hard_neg, mask_svfc=cfg.loss.mask_svfc)
    int8_compute = pool.queue_int8_compute
    col0 = 0
    quad_loss = functools.partial(quad_add_margin, with_acc=True, int8_compute=int8_compute,
                                  **loss_kw)
    if use_sharded_head(cfg):
        if mesh is None:
            raise ValueError("the sharded FFC head (mesh.model > 1 or pool.force_sharded) "
                             "needs the mesh: make_train_step(cfg, schedule, mesh)")
        col0, _ = mesh.class_block(pool.queue_size)
        quad_loss = make_sharded_quad_loss(mesh, with_acc=True, int8_compute=int8_compute,
                                           **loss_kw)
    elif cfg.mesh.model > 1:
        raise NotImplementedError("mesh.model > 1 with the dense FFC head (pool.use_fused off, "
                                  "or queue_size below pool.streaming_threshold) is not "
                                  "ported yet")
    m = pool.momentum
    fuse_fwd = pool.fuse_forward
    grad_clip = cfg.optim.grad_clip

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
        if fuse_fwd:
            # one 2B forward per net; BN statistics then span 2B samples
            b = x.shape[0]
            p_xy = probe(torch.cat([x, y]))
            with torch.no_grad():
                g_yx = gallery(torch.cat([y, x]))
            p_x, p_y, g_y, g_x = p_xy[:b], p_xy[b:], g_yx[:b], g_yx[b:]
        else:
            p_x = probe(x)
            with torch.no_grad():
                g_y = gallery(y)
            p_y = probe(y)
            with torch.no_grad():
                g_x = gallery(x)
        if use_quad:
            (loss_a, loss_b), train_acc = quad_loss(
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
    probe = model.to(dev)
    gallery = copy.deepcopy(probe).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = None
    if mesh is not None and mesh.model > 1:
        block = mesh.class_block(cfg.pool.queue_size)
    queue, scales = init_queue(cfg.pool.queue_size, cfg.model.feat_dim, device=dev,
                               generator=gen, dtype=QUEUE_DTYPES[cfg.pool.queue_dtype],
                               block=block)
    return FFCState(step=0, probe=probe, gallery=gallery, queue=queue,
                    optimizer=make_optimizer(cfg.optim, probe.parameters()),
                    queue_scales=scales)
