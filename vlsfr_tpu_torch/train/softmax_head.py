"""Full-softmax margin-classifier training (port of
``vlsfr_tpu/train/softmax_head.py``, single device).

One backbone, one classifier ``[num_classes, feat_dim]`` (rows normalised
on every forward) and the margin-softmax CE, on one of three routes:

* A. fused-SGD streaming — the default at ``num_classes >=
  pool.streaming_threshold`` with SGD and no gradient clipping: the head
  runs outside autograd (``ops/margin_stream.streaming_margin_grads_fused_sgd``),
  the classifier and its bare momentum buffer are updated IN PLACE inside
  the streaming backward, and ``d_emb`` is fed back into the backbone;
* B. streaming + ``torch.optim.SGD`` — streaming with
  ``pool.fused_update=off`` or gradient clipping: ``MarginSoftmax``
  forward and backward, a dense d_w, one SGD over backbone and classifier;
* C. dense — below the threshold or ``pool.use_fused=off``: the ``[B, C]``
  cosines in plain PyTorch.

Not ported yet, and refused: the sparse-d_w streaming head
(``pool.sparse_update``), partial-FC sampling (``pool.sample_rate > 0``),
bf16 classifier or momentum storage, and a class-sharded mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.ops.margin_stream import streaming_margin_grads_fused_sgd
from vlsfr_tpu_torch.optim import make_optimizer, set_learning_rate
from vlsfr_tpu_torch.optim.optimizers import clip_by_global_norm_
from vlsfr_tpu_torch.parallel.partial_fc import margin_softmax_loss
from vlsfr_tpu_torch.utils.device import resolve_device


@dataclass
class SoftmaxState:
    """The training state: modules, classifier and optimizer live on one
    device."""

    step: int
    backbone: nn.Module
    classifier: torch.Tensor  # [C, D] f32; a leaf with a gradient on routes B and C
    optimizer: torch.optim.Optimizer  # backbone, plus the classifier on routes B and C
    classifier_mom: torch.Tensor | None = None  # route A: [C, D], updated in place


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


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError for an option of this head that is not
    ported yet."""
    pool = cfg.pool
    for what, on in (
            ("pool.sample_rate > 0 (partial-FC sampling)", pool.sample_rate > 0),
            ("pool.sparse_update with the streaming head (sparse d_w)",
             pool.sparse_update and _streaming_on(cfg)),
            ("pool.classifier_dtype=bfloat16", pool.classifier_dtype != "float32"),
            ("pool.classifier_mom_dtype=bfloat16",
             pool.classifier_mom_dtype != "float32" and _fused_update_on(cfg)),
            ("mesh.model > 1 (class-sharded classifier)", cfg.mesh.model > 1)):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def create_softmax_state(model: nn.Module, cfg: Config, num_classes: int, *, device=None,
                         seed: int = 0, classifier: torch.Tensor | None = None) -> SoftmaxState:
    """Backbone = ``model`` on the device, a classifier drawn as 0.01·N(0, 1)
    from a generator seeded with ``seed`` (or ``classifier`` as given), and
    the optimizer; on route A a zero momentum buffer beside the classifier
    (optax's trace starts at zero too). Runs on ``cuda`` unless ``device``
    says otherwise; raises without a card."""
    check_ported(cfg)
    dev = resolve_device(device)
    backbone = model.to(dev)
    if classifier is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        classifier = torch.randn((num_classes, cfg.model.feat_dim), generator=gen,
                                 device=dev).mul_(0.01)
    else:
        classifier = classifier.to(dev, torch.float32).contiguous()
    if _fused_update_on(cfg):
        return SoftmaxState(step=0, backbone=backbone, classifier=classifier,
                            optimizer=make_optimizer(cfg.optim, backbone.parameters()),
                            classifier_mom=torch.zeros_like(classifier))
    classifier.requires_grad_(True)
    return SoftmaxState(step=0, backbone=backbone, classifier=classifier,
                        optimizer=make_optimizer(cfg.optim, [*backbone.parameters(), classifier]))


def make_softmax_train_step(cfg: Config, schedule):
    """``step(state, images, labels, lr_scale) -> metrics``: one step of the
    route the config selects, updating ``state`` in place. ``images`` are
    an NHWC batch, ``labels`` class ids (numpy or tensors)."""
    check_ported(cfg)
    streaming = _streaming_on(cfg)
    fused = _fused_update_on(cfg)
    loss_kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                   mask_svfc=cfg.loss.mask_svfc)
    sgd_kw = dict(momentum=cfg.optim.momentum, nesterov=cfg.optim.nesterov,
                  weight_decay=cfg.optim.weight_decay)
    grad_clip = cfg.optim.grad_clip

    def step(state: SoftmaxState, images, labels, lr_scale: float = 1.0) -> dict:
        dev = state.classifier.device
        images = torch.as_tensor(images).to(dev, non_blocking=True)
        labels = torch.as_tensor(labels).to(dev, non_blocking=True).to(torch.int32)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        lr = float(schedule(state.step)) * float(lr_scale)
        state.backbone.train()
        emb = state.backbone(images)
        if fused:
            # loss = mean(ce): analytic output cotangents (no outlier rows)
            b = emb.shape[0]
            d_ce = torch.full((b,), 1.0 / b, device=dev)
            with torch.no_grad():
                ce, _neg, topk, gt, d_emb, _, _ = streaming_margin_grads_fused_sgd(
                    emb.detach(), state.classifier, state.classifier_mom, labels, d_ce,
                    torch.zeros_like(d_ce), lr, hard_neg=1, **sgd_kw, **loss_kw)
            emb.backward(d_emb.to(emb.dtype))
            loss = ce.mean()
            metrics = {"ce": loss, "train_acc": (gt >= topk[:, 0]).float().mean()}
        else:
            loss, metrics = margin_softmax_loss(emb, state.classifier, labels,
                                                streaming=streaming, **loss_kw)
            loss.backward()
        with torch.no_grad():
            params = [p for group in opt.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:  # unused parameters still decay, as in optax
                    p.grad = torch.zeros_like(p)
            if grad_clip > 0:
                norm = torch.sqrt(sum(p.grad.square().sum() for p in params))
                clip_by_global_norm_(params, grad_clip, norm)
        set_learning_rate(opt, lr)
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), "ce": metrics["ce"], "train_acc": metrics["train_acc"],
                "lr": lr}

    return step
