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
4. backward, then direction B's queue write IN PLACE on the [2, Q, D]
   queue (after the backward, which still reads the pre-write queue),
   last writer wins among duplicate slots;
5. lr = schedule(step) × plateau scale, SGD step.

Direction A's writes are never persisted (the reference's rollback pass).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import PassIndices, StepIndices
from vlsfr_tpu_torch.ops.margin import add_margin, default_hard_neg
from vlsfr_tpu_torch.ops.twin_margin import quad_add_margin
from vlsfr_tpu_torch.optim import make_optimizer, set_learning_rate
from vlsfr_tpu_torch.optim.optimizers import clip_by_global_norm_
from vlsfr_tpu_torch.utils.device import resolve_device


@dataclass
class FFCState:
    """The training state: modules, queue and optimizer live on one device."""

    step: int
    probe: nn.Module
    gallery: nn.Module  # EMA copy of the probe; never optimised
    queue: torch.Tensor  # [2, Q, D] L2-normalised rows
    optimizer: torch.optim.Optimizer


def init_queue(queue_size: int, feat_dim: int, *, device, generator: torch.Generator | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform[0, 1) rows L2-normalised over features, built in place (one
    [2, Q, D] allocation: 4.3 GB at 2^20 slots × 512)."""
    if dtype != torch.float32:
        raise NotImplementedError("bf16 and int8 queues are not ported yet")
    x = torch.rand((2, queue_size, feat_dim), generator=generator, device=device)
    return x.div_(torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def scatter_mask(seen: torch.Tensor, cols: torch.Tensor, queue_size: int) -> torch.Tensor:
    """[Q] blend mask: 1 where any batch sample that hit the slot was seen
    (max-scatter, so duplicate slots stay 1)."""
    mask = torch.zeros(queue_size, device=seen.device)
    return mask.scatter_reduce_(0, cols.long(), seen.float(), reduce="amax")


def write_rows_(queue: torch.Tensor, g: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor) -> torch.Tensor:
    """``queue[rows, cols] = g`` in place, the highest batch index winning
    among duplicate (row, col) entries — resolved here, because an indexed
    write with duplicate indices leaves the winner undefined on CUDA."""
    key = rows.long() * queue.shape[1] + cols.long()
    later = torch.triu(key[:, None] == key[None, :], diagonal=1).any(dim=1)
    keep = torch.nonzero(~later).flatten()
    queue[rows.long()[keep], cols.long()[keep]] = g[keep].to(queue.dtype)
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


def make_train_step(cfg: Config, schedule):
    """``step(state, x, y, idx, lr_scale) -> metrics``: runs one FFC step,
    updating ``state`` in place. ``x``/``y`` are NHWC batches (numpy or
    tensors), ``idx`` the host plan for this step."""
    pool = cfg.pool
    for flag, on in (("pool.queue_dtype != float32", pool.queue_dtype != "float32"),
                     ("pool.queue_int8_compute", pool.queue_int8_compute),
                     ("pool.gallery_int8", pool.gallery_int8),
                     ("pool.force_sharded", pool.force_sharded)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet")
    hard_neg = pool.hard_neg if pool.hard_neg > 0 else default_hard_neg(pool.queue_size)
    use_quad = use_fused_head(cfg)
    loss_kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                   hard_neg=hard_neg, mask_svfc=cfg.loss.mask_svfc)
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
            (loss_a, loss_b), train_acc = quad_add_margin(
                p_x, p_y, state.queue, g_y, g_x, (ia.rows, ia.cols, ia.seen),
                (ib.rows, ib.cols, ib.seen), ia.fake_labels, ib.fake_labels,
                with_acc=True, **loss_kw)
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
                write_rows_(state.queue, g_x, ib.rows, ib.cols)
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


def create_ffc_state(model: nn.Module, cfg: Config, *, device=None, seed: int = 0) -> FFCState:
    """Probe = ``model`` on the device, gallery = its copy, a fresh queue
    from a generator seeded with ``seed`` and the optimizer. Runs on
    ``cuda`` unless ``device`` says otherwise; raises without a card."""
    dev = resolve_device(device)
    probe = model.to(dev)
    gallery = copy.deepcopy(probe).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    queue = init_queue(cfg.pool.queue_size, cfg.model.feat_dim, device=dev, generator=gen)
    return FFCState(step=0, probe=probe, gallery=gallery, queue=queue,
                    optimizer=make_optimizer(cfg.optim, probe.parameters()))
