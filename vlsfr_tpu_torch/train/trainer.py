"""The trainer (port of ``vlsfr_tpu/train/trainer.py``).

What this port runs: the FFC head (``pool.head='ffc'``, with the host DCP
planner) or the full-softmax classifier head (``'full_softmax'``,
``train/softmax_head.py``) on one device, synthetic (raw-pixel) or
record-store data, print-window logging and the plateau LR scale; and
either head model-sharded over ``mesh.model`` ranks of a
``torch.distributed`` group (one process per card under ``torchrun``; the
FFC head also with ``pool.force_sharded`` in one process): the FFC head's
queue or the softmax head's classifier split into one block per rank.
Every rank runs the same pipeline (and DCP planner; the labels stay global,
as in JAX); only rank 0 logs. What it does not run yet, and refuses rather
than fakes: checkpoints and resume, in-training eval, pretrained
backbones, the data axis (``mesh.data > 1``) and the softmax head's
routes C and E on a mesh.
"""

from __future__ import annotations

import tempfile

import torch

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.dcp import DCPManager
from vlsfr_tpu_torch.core.ffc import create_ffc_state, make_train_step, use_sharded_head
from vlsfr_tpu_torch.data.pipeline import FFCPipeline, InstancePipeline
from vlsfr_tpu_torch.data.records import MultiSourceReader
from vlsfr_tpu_torch.models import create_net, native_image_size
from vlsfr_tpu_torch.optim import PlateauController, make_schedule
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel.mesh import check_shape, make_mesh
from vlsfr_tpu_torch.train.softmax_head import (
    check_ported,
    create_softmax_state,
    make_softmax_train_step,
)
from vlsfr_tpu_torch.utils.device import resolve_device
from vlsfr_tpu_torch.utils.metrics import MetricsLogger, Throughput, logger


def _refuse_unported(cfg: Config) -> None:
    if cfg.pool.head not in ("ffc", "full_softmax"):
        raise ValueError(f"pool.head must be ffc or full_softmax, got {cfg.pool.head!r}")
    if cfg.pool.head == "full_softmax":
        check_ported(cfg)
    for what, on in (
            ("train.eval_freq > 0 (in-training eval)", cfg.train.eval_freq > 0),
            ("train.eval_bin", bool(cfg.train.eval_bin)),
            ("train.pretrained_model_path", bool(cfg.train.pretrained_model_path)),
            ("mesh.data > 1", cfg.mesh.data > 1)):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


class Trainer:
    """``Trainer(cfg, device=...)`` builds data, models and state;
    ``train()`` runs the epochs; ``close()`` releases them (and the process
    group, if this trainer created it). Runs on ``cuda`` unless ``device``
    says otherwise; a sharded run on the rank's card, ``cuda:LOCAL_RANK``."""

    def __init__(self, cfg: Config, reader: MultiSourceReader | None = None, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh, self._owns_group = None, False
        if use_sharded_head(cfg) if cfg.pool.head == "ffc" else cfg.mesh.model > 1:
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
        pipe = FFCPipeline if self.is_ffc else InstancePipeline
        self.pipeline = pipe(reader, cfg.data.batch_size, self.image_size, seed=cfg.data.seed,
                             num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
                             record_limit=self.record_limit)
        self.dcp = DCPManager(cfg.pool.queue_size) if self.is_ffc else None
        if not self.is_ffc and cfg.pool.num_classes <= 0:
            cfg.pool.num_classes = reader.num_class
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
        logger.info("no checkpoints are written: checkpoint/resume is not ported yet")

    def train(self, max_steps: int | None = None) -> dict:
        """Run ``optim.epochs`` epochs (or stop after ``max_steps`` steps);
        returns the last print window's metrics (with its ``epoch``,
        ``images_per_sec`` and ``images_per_sec_chip``) plus ``final_step``.
        On a mesh every rank trains the same batch, so the rate per card is
        the group's rate over its ``mesh.model`` cards."""
        cfg = self.cfg
        thr = Throughput(1 if self.mesh is None else self.mesh.model)
        last: dict = {}
        gstep = 0
        for epoch in range(cfg.optim.epochs):
            left = None if max_steps is None else max_steps - gstep
            if left is not None and left <= 0:
                break
            for batch in self.pipeline.epoch_iter(epoch, stop_step=left):
                if self.is_ffc:
                    idx = self.dcp.plan_step(batch.x_label, batch.y_label)
                    m = self.train_step(self.state, batch.x, batch.y, idx, self.plateau.scale)
                    thr.update(batch.x.shape[0] * 2)
                else:
                    m = self.train_step(self.state, batch.images, batch.labels,
                                        self.plateau.scale)
                    thr.update(batch.images.shape[0])
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
        return dict(last, final_step=gstep)

    def close(self):
        self.pipeline.close()
        self.metrics.close()
        self.reader.close()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
        if self._owns_group:
            distributed.destroy()
            self._owns_group = False
