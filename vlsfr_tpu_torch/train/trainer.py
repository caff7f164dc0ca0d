"""The trainer (port of ``vlsfr_tpu/train/trainer.py``).

What this port runs: the FFC head (``pool.head='ffc'``, with the host DCP
planner) or the full-softmax classifier head (``'full_softmax'``,
``train/softmax_head.py``) on one device, synthetic (raw-pixel) or
record-store data, print-window logging and the plateau LR scale; and
either head model-sharded over ``mesh.model`` ranks of a
``torch.distributed`` group (one process per card under ``torchrun``; the
fused FFC head also with ``pool.force_sharded`` in one process): the FFC
head's queue (fused or dense) or the softmax head's classifier (every
route) split into one block per rank. Both heads also run on the data
axis (``mesh.data`` > 1, or -1 for world // model; ``parallel/mesh.py``),
alone and under the model axis: each rank decodes its rows of the global
batch and the step gathers, synchronises and sums over the data group
(``core/ffc.py``, ``train/softmax_head.py``). Every rank runs the same
pipeline plan (and DCP planner; the labels stay global, as in JAX); only
global rank 0 logs. On a mesh the softmax head's
``pool.num_classes`` is padded up to a multiple of ``mesh.model``, as JAX
pads it: the ghost classes are extra negatives, never targets.

Checkpoints (``train/checkpoints.py``): every ``train.save_freq`` steps,
at the end of ``train()``, and on SIGTERM / SIGINT once the step in
flight has finished (``install_signal_handlers``); with ``train.resume``
the newest one is restored at construction and training goes on from its
step ("resumed from checkpoint step N"), at the ``mesh.model`` it was
written at or another (the blocks are re-cut). A checkpoint holds
everything a step reads, so the resumed run is the uninterrupted one. In-training eval
(``evaluate``) every ``train.eval_freq`` steps: verification pairs from
the held-out tail of the store (``train.holdout_records``) or, with a
warning, from the training records, and ``train.eval_bin``.

What it does not run yet, and refuses rather than fakes: pretrained
backbones (and RMSprop, ``optim/optimizers.py``).
"""

from __future__ import annotations

import signal
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import DCPManager
from vlsfr_tpu_torch.core.ffc import (
    check_kernel_width,
    create_ffc_state,
    make_train_step,
    needs_mesh,
)
from vlsfr_tpu_torch.data.pipeline import FFCPipeline, InstancePipeline
from vlsfr_tpu_torch.data.records import MultiSourceReader
from vlsfr_tpu_torch.models import create_net, native_image_size
from vlsfr_tpu_torch.optim import PlateauController, make_schedule
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel.mesh import check_shape, make_mesh, resolve_shape
from vlsfr_tpu_torch.train.checkpoints import CheckpointManager
from vlsfr_tpu_torch.train.softmax_head import (
    check_ported,
    create_softmax_state,
    make_softmax_train_step,
)
from vlsfr_tpu_torch.utils.device import resolve_device
from vlsfr_tpu_torch.utils.metrics import MetricsLogger, Throughput, logger


def _refuse_unported(cfg: Config) -> None:
    """Refuse what the port does not run yet."""
    if cfg.pool.head not in ("ffc", "full_softmax"):
        raise ValueError(f"pool.head must be ffc or full_softmax, got {cfg.pool.head!r}")
    if cfg.pool.head == "full_softmax":
        check_ported(cfg)
    if cfg.train.pretrained_model_path:
        raise NotImplementedError("train.pretrained_model_path is not ported yet")


class Trainer:
    """``Trainer(cfg, device=...)`` builds data, models and state;
    ``train()`` runs the epochs; ``close()`` releases them (and the process
    group, if this trainer created it). Runs on ``cuda`` unless ``device``
    says otherwise; a sharded run on the rank's card, ``cuda:LOCAL_RANK``."""

    def __init__(self, cfg: Config, reader: MultiSourceReader | None = None, device=None):
        _refuse_unported(cfg)
        data, model = resolve_shape(cfg.mesh.data, cfg.mesh.model)
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.pool.head == "ffc":
            check_kernel_width(cfg, self.device)
        self.mesh, self._owns_group = None, False
        if (needs_mesh(cfg) if cfg.pool.head == "ffc" else model > 1) or data * model > 1:
            check_shape(cfg.mesh.data, cfg.mesh.model)  # before anything is created
            self.device = distributed.local_device(self.device)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                if cfg.mesh.model > 1:
                    # the replicated backbone work must give every rank the
                    # same bits: cuDNN's atomics-based algorithms would let
                    # the ranks' parameters drift apart
                    torch.backends.cudnn.deterministic = True
            self._owns_group = distributed.initialize(self.device.type)
            self.mesh = make_mesh(cfg.mesh.data, cfg.mesh.model)
        self.image_size = cfg.data.image_size or native_image_size(cfg.model.net_type)
        self._tmpdir = None
        if reader is None:
            if cfg.data.synthetic:
                from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store

                self._tmpdir = tempfile.TemporaryDirectory(prefix="vlsfr_torch_syn_")
                generate_synthetic_store(
                    self._tmpdir.name, num_ids=cfg.data.synthetic_ids,
                    images_per_id=cfg.data.synthetic_images_per_id,
                    image_size=self.image_size, seed=cfg.data.seed,
                    hard=cfg.data.synthetic_hard)
                cfg.data.sources = [self._tmpdir.name]
            reader = MultiSourceReader(cfg.data.sources)
        self.reader = reader
        self.record_limit = None
        if cfg.train.holdout_records > 0:
            self.record_limit = max(len(reader) - cfg.train.holdout_records,
                                    cfg.data.batch_size)
        self.is_ffc = cfg.pool.head == "ffc"
        kw = dict(seed=cfg.data.seed, num_workers=cfg.data.num_workers,
                  prefetch=cfg.data.prefetch, record_limit=self.record_limit)
        # every rank plans the global step and decodes its data index's rows
        shard = (0, 1) if self.mesh is None else (self.mesh.data_rank, self.mesh.data)
        pipeline = FFCPipeline if self.is_ffc else InstancePipeline
        self.pipeline = pipeline(reader, cfg.data.batch_size, self.image_size, data_shard=shard,
                                 **kw)
        self.dcp = DCPManager(cfg.pool.queue_size) if self.is_ffc else None
        if not self.is_ffc:
            if cfg.pool.num_classes <= 0:
                cfg.pool.num_classes = reader.num_class
            m = cfg.mesh.model
            if cfg.pool.num_classes % m:
                # the class axis must split evenly over the ranks; the ghost
                # classes are extra negatives, never targets (JAX's trainer)
                padded = (cfg.pool.num_classes + m - 1) // m * m
                logger.info("padding num_classes %d -> %d for %d-way class sharding",
                            cfg.pool.num_classes, padded, m)
                cfg.pool.num_classes = padded
        self.steps_per_epoch = max(cfg.train.steps_per_epoch or self.pipeline.steps_per_epoch(), 1)
        self.schedule = make_schedule(cfg.optim, self.steps_per_epoch)
        self.plateau = PlateauController(patience=cfg.optim.patience, min_lr=cfg.optim.lr_min,
                                         base_lr=cfg.optim.lr)
        self.is_lead = distributed.is_lead_host()
        self.metrics = MetricsLogger(
            (cfg.train.log_dir or f"{cfg.train.saved_dir}/logs") if self.is_lead else "")
        with torch.random.fork_rng(devices=[]):  # model init from the seed, isolated
            torch.manual_seed(cfg.data.seed)
            model = create_net(cfg.model.net_type, feat_dim=cfg.model.feat_dim,
                               dtype=cfg.model.dtype, dropout=cfg.model.dropout,
                               image_size=self.image_size, bn_stats_rows=cfg.model.bn_stats_rows)
        if self.is_ffc:
            self.state = create_ffc_state(model, cfg, device=self.device, seed=cfg.data.seed,
                                          mesh=self.mesh)
            self.train_step = make_train_step(cfg, self.schedule, mesh=self.mesh)
        else:
            self.state = create_softmax_state(model, cfg, cfg.pool.num_classes,
                                              device=self.device, seed=cfg.data.seed,
                                              mesh=self.mesh)
            self.train_step = make_softmax_train_step(cfg, self.schedule, mesh=self.mesh)
        self.ckpt = CheckpointManager(cfg.train.saved_dir, cfg.train.keep_checkpoints,
                                      mesh=self.mesh)
        self.start_epoch, self.start_step = 0, 0
        self._last_saved = None
        self._in_step, self._pending_signal = False, None
        if cfg.train.resume:
            self._maybe_resume()

    # ------------------------------------------------------------------
    def _checkpoint_state(self) -> tuple[dict, dict]:
        """(what every rank holds, this rank's block): tensors and plain
        values only (``train/checkpoints.py``)."""
        st = self.state
        replicated = {"head": self.cfg.pool.head, "step": int(st.step),
                      "optimizer": st.optimizer.state_dict(),
                      "plateau": self.plateau.state_dict()}
        # the process's generators (dropout draws from them): each rank's own
        rng = {"cpu": torch.get_rng_state(),
               "cuda": (torch.cuda.get_rng_state(self.device) if self.device.type == "cuda"
                        else None)}
        if self.is_ffc:
            dcp = self.dcp.state_dict()
            replicated.update(
                probe=st.probe.state_dict(), gallery=st.gallery.state_dict(),
                dcp={"lru": torch.from_numpy(np.asarray(dcp["lru"], np.int64).reshape(-1, 2)),
                     "parity": torch.from_numpy(dcp["parity"]),
                     "queue_size": int(dcp["queue_size"])})
            block = {"queue": st.queue, "queue_scales": st.queue_scales}
        else:
            replicated["backbone"] = st.backbone.state_dict()
            block = {"classifier": st.classifier.detach(), "classifier_mom": st.classifier_mom,
                     "classifier_last": st.classifier_last}
        return replicated, dict(block, rng=rng)

    def _load_checkpoint_state(self, replicated: dict, block: dict) -> None:
        st = self.state
        if replicated["head"] != self.cfg.pool.head:
            raise ValueError(f"the checkpoint is of the {replicated['head']} head, this run's "
                             f"is {self.cfg.pool.head}")
        modules = {"probe": st.probe, "gallery": st.gallery} if self.is_ffc \
            else {"backbone": st.backbone}
        for name, module in modules.items():
            module.load_state_dict(replicated[name])
        st.optimizer.load_state_dict(replicated["optimizer"])
        rng = block.pop("rng")
        with torch.no_grad():
            for name, value in block.items():
                have = getattr(st, name)
                if (have is None) != (value is None):
                    raise ValueError(f"the checkpoint's {name} does not match this run's "
                                     f"configuration")
                if have is not None:
                    have.copy_(value)
        if self.is_ffc:
            dcp = replicated["dcp"]
            self.dcp.restore({"lru": dcp["lru"].tolist(), "parity": dcp["parity"].numpy(),
                              "queue_size": dcp["queue_size"]})
        self.plateau.load_state_dict(replicated["plateau"])
        torch.set_rng_state(rng["cpu"])
        if self.device.type == "cuda" and rng["cuda"] is not None:
            torch.cuda.set_rng_state(rng["cuda"], self.device)
        st.step = int(replicated["step"])

    def _maybe_resume(self) -> None:
        latest = self.ckpt.latest_step()
        if self.mesh is not None and dist.get_world_size() > 1:  # every rank, the same step
            mine = -1 if latest is None else latest
            seen = torch.tensor([mine, -mine], dtype=torch.int64, device=self.device)
            dist.all_reduce(seen, op=dist.ReduceOp.MAX)
            if int(seen[0]) != -int(seen[1]):
                raise RuntimeError(f"the ranks see different checkpoints (steps "
                                   f"{-int(seen[1])} to {int(seen[0])}): they must share "
                                   f"train.saved_dir")
        if latest is None:
            return
        # read to the host: the host state stays there, the tensors are copied in place
        sizes = ({"queue": self.cfg.pool.queue_size} if self.is_ffc
                 else {"classifier": self.cfg.pool.num_classes})
        self._load_checkpoint_state(*self.ckpt.restore(latest, map_location="cpu",
                                                       class_sizes=sizes))
        self._last_saved = latest
        g = self.state.step
        self.start_epoch, self.start_step = divmod(g, self.steps_per_epoch)
        logger.info("resumed from checkpoint step %d (epoch %d, step %d)",
                    g, self.start_epoch, self.start_step)

    def _save(self, global_step: int) -> None:
        if global_step == self._last_saved:  # the state has not moved since
            return
        self.ckpt.save(global_step, *self._checkpoint_state())
        self._last_saved = global_step

    def install_signal_handlers(self) -> None:
        """Preemption: SIGTERM / SIGINT saves a checkpoint, then exits with
        ``SystemExit(128 + signum)``; the next run resumes from it. A signal
        that arrives during a step is acted on once that step has finished,
        so the checkpoint never holds half a step."""

        def handler(signum, frame):
            if self._in_step:
                self._pending_signal = signum
            else:
                self._exit_on_signal(signum)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def _exit_on_signal(self, signum: int):
        logger.warning("signal %d: checkpointing at step %d then exiting", signum,
                       self.state.step)
        self._save(self.state.step)
        raise SystemExit(128 + signum)

    def train(self, max_steps: int | None = None) -> dict:
        """Run ``optim.epochs`` epochs from the resumed step (or stop once
        the global step reaches ``max_steps``: a window for tests and
        timing, which saves only at ``train.save_freq``; the end of the
        epochs saves); returns the last print window's metrics (with its
        ``epoch``, ``images_per_sec`` and ``images_per_sec_chip``) plus
        ``final_step``. The rate is the global batch's; per card it is
        over the mesh's data · model cards."""
        cfg = self.cfg
        thr = Throughput(1 if self.mesh is None else self.mesh.data * self.mesh.model)
        last: dict = {}
        gstep = self.start_epoch * self.steps_per_epoch + self.start_step
        for epoch in range(self.start_epoch, cfg.optim.epochs):
            start = self.start_step if epoch == self.start_epoch else 0
            left = None if max_steps is None else max_steps - gstep
            if left is not None and left <= 0:
                break
            stop = None if left is None else start + left
            for batch in self.pipeline.epoch_iter(epoch, start_step=start, stop_step=stop):
                self._in_step = True
                if self.is_ffc:
                    idx = self.dcp.plan_step(batch.x_label, batch.y_label)
                    m = self.train_step(self.state, batch.x, batch.y, idx, self.plateau.scale)
                    thr.update(batch.x_label.shape[0] * 2)
                else:
                    m = self.train_step(self.state, batch.images, batch.labels,
                                        self.plateau.scale)
                    thr.update(batch.images.shape[0])
                self._in_step = False
                gstep += 1
                if gstep % cfg.train.print_freq == 0 or gstep == max_steps:
                    m = {k: float(v) for k, v in m.items()}  # one sync per window
                    ips, ips_chip = thr.value()
                    last = dict(m, epoch=epoch, images_per_sec=ips, images_per_sec_chip=ips_chip)
                    if self.is_lead:
                        self.metrics.log(gstep, last)
                    if cfg.optim.scheduler == "plateau":
                        self.plateau.observe(m["loss"])
                    thr.reset()
                if self._pending_signal is not None:
                    self._exit_on_signal(self._pending_signal)
                if gstep % cfg.train.save_freq == 0:
                    self._save(gstep)
                if cfg.train.eval_freq and gstep % cfg.train.eval_freq == 0:
                    res = self.evaluate()
                    if self.is_lead:
                        self.metrics.log(gstep, res, prefix="eval")
        if max_steps is None:
            self._save(gstep)
        return dict(last, final_step=gstep)

    def _eval_net(self) -> torch.nn.Module:
        """The net ``evaluate`` embeds with: the FFC head's EMA gallery net
        with ``train.eval_use_ema``, else its probe; the softmax head's
        backbone."""
        if not self.is_ffc:
            return self.state.backbone
        return self.state.gallery if self.cfg.train.eval_use_ema else self.state.probe

    def evaluate(self) -> dict:
        """In-training verification eval, JAX's ``Trainer.evaluate``: with
        ``train.holdout_records`` the pairs come from the held-out tail of
        the store (a real accuracy), else from the training records (a
        smoke signal, warned once); ``eval_records`` records drawn with the
        data seed, ``eval_pairs`` pairs, 10-fold accuracy; ``train.eval_bin``
        also evaluates an insightface ``.bin`` file."""
        from vlsfr_tpu_torch.eval.extract import Embedder
        from vlsfr_tpu_torch.eval.verification import (
            cosine_scores,
            kfold_verification_accuracy,
            make_verification_pairs,
        )

        cfg = self.cfg
        if self.record_limit is not None and self.record_limit < len(self.reader):
            pool = np.arange(self.record_limit, len(self.reader))
            src = "holdout"
        else:
            pool = np.arange(len(self.reader))
            src = "train"
            if not getattr(self, "_warned_train_eval", False):
                self._warned_train_eval = True
                logger.warning("[eval] no holdout split configured (train.holdout_records=0): "
                               "verification pairs are sampled from the TRAIN set; the metric "
                               "is logged as verification_acc_train and is a smoke signal only")
        n = min(len(pool), cfg.train.eval_records)
        idx = np.random.default_rng(cfg.data.seed).choice(pool, n, replace=False)
        labels = np.asarray(self.reader.labels)[idx]
        emb = Embedder(self._eval_net(), batch_size=min(64, n), device=self.device)
        embeddings = emb.from_reader(self.reader, self.image_size, indices=idx)
        try:
            i1, i2, issame = make_verification_pairs(labels, cfg.train.eval_pairs,
                                                     seed=cfg.data.seed)
        except AssertionError:
            return {"verification_acc": float("nan")}
        scores = cosine_scores(embeddings[i1], embeddings[i2])
        acc, std = kfold_verification_accuracy(scores, issame)
        out = {f"verification_acc_{src}": acc, "verification_std": std}
        if cfg.train.eval_bin:
            from vlsfr_tpu_torch.eval.verification import evaluate_bin

            res = evaluate_bin(emb, cfg.train.eval_bin, self.image_size)
            out.update({f"bin_{k}": v for k, v in res.items()})
        return out

    def close(self):
        self.ckpt.close()
        self.pipeline.close()
        self.metrics.close()
        self.reader.close()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
        if self._owns_group:
            distributed.destroy()
            self._owns_group = False
