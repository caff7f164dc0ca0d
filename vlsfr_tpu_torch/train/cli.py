"""Training CLI of the port, run as ``python -m vlsfr_tpu_torch.train``
(the counterpart of the JAX package's root ``train.py``; it lives in the
``train`` package because a ``train.py`` module could not sit beside it).

Same flags as the JAX package's ``train.py`` (the reference's CLI plus
``--config``, ``--set section.key=value``, ``--sources``, ``--synthetic``),
and ``--device`` (default ``cuda``; ``cpu`` must be asked for).

    python -m vlsfr_tpu_torch.train --net_type ir50 --queue_size 1048576 \\
        --batch_size 128 --synthetic --set pool.fuse_forward=true
    python -m vlsfr_tpu_torch.train --net_type ir50 --head full_softmax \\
        --batch_size 128 --synthetic --set pool.num_classes=1048576
    # the softmax head's sparse routes: D (sparse d_w) or E (partial-FC)
    python -m vlsfr_tpu_torch.train --net_type ir50 --head full_softmax \\
        --batch_size 128 --synthetic --set pool.num_classes=1048576 \\
        --set pool.sparse_update=true    # or: --set pool.sample_rate=0.1
    # the FFC head model-sharded: one process per card (N cards), or the
    # same path in one process with --set pool.force_sharded=true
    torchrun --standalone --nproc_per_node=N -m vlsfr_tpu_torch.train \\
        --net_type ir50 --queue_size 1048576 --batch_size 128 --synthetic \\
        --set mesh.model=N --set mesh.data=1
    # the softmax head class-sharded (routes A, B with fused_update=off,
    # D with sparse_update): one block of the classifier per card
    torchrun --standalone --nproc_per_node=N -m vlsfr_tpu_torch.train \\
        --net_type ir50 --head full_softmax --batch_size 128 --synthetic \\
        --set pool.num_classes=1048576 --set mesh.model=N --set mesh.data=1
"""

from __future__ import annotations

import argparse

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.parallel.distributed import is_lead_host
from vlsfr_tpu_torch.train.trainer import Trainer


def build_config(argv=None) -> tuple[Config, str]:
    ap = argparse.ArgumentParser(description="very large scale face recognition (PyTorch)")
    ap.add_argument("--saved_dir", type=str, default="checkpoint")
    ap.add_argument("--net_type", type=str, default="r50")
    ap.add_argument("--queue_size", type=int, default=1000)
    ap.add_argument("--print_freq", type=int, default=1000)
    ap.add_argument("--pretrained_model_path", type=str, default="")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.99, help="gallery EMA momentum")
    ap.add_argument("--loss_type", type=str, default="Arc", choices=["Arc", "AM", "SV"])
    ap.add_argument("--margin", type=float, default=0.5)
    ap.add_argument("--scale", type=float, default=32.0)
    ap.add_argument("--neg_margin", type=float, default=0.25)
    ap.add_argument("--feat_dim", type=int, default=512)
    ap.add_argument("--sources", nargs="*", default=[], help="record store dirs")
    ap.add_argument("--optim_config", type=str, default="",
                    help="reference-format typed-JSON optimizer config")
    ap.add_argument("--config", type=str, default="", help="full JSON config file")
    ap.add_argument("--head", type=str, default="ffc", choices=["ffc", "full_softmax"])
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)

    cfg = Config.load(args.config) if args.config else Config()
    cfg.train.saved_dir = args.saved_dir
    cfg.model.net_type = args.net_type
    cfg.model.feat_dim = args.feat_dim
    cfg.pool.queue_size = args.queue_size
    cfg.pool.momentum = args.alpha
    cfg.pool.head = args.head
    cfg.train.print_freq = args.print_freq
    cfg.train.pretrained_model_path = args.pretrained_model_path
    cfg.data.batch_size = args.batch_size
    cfg.data.sources = list(args.sources)
    cfg.data.synthetic = args.synthetic
    cfg.loss.loss_type = args.loss_type
    cfg.loss.margin = args.margin
    cfg.loss.scale = args.scale
    cfg.loss.neg_margin = args.neg_margin
    if args.optim_config:
        cfg.apply_reference_optim_config(args.optim_config)
    cfg.apply_overrides(args.overrides)
    return cfg, args.device


def main(argv=None):
    cfg, device = build_config(argv)
    trainer = Trainer(cfg, device=device)
    try:
        out = trainer.train()
        if is_lead_host():
            print("training done:", out)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
