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
    # either head on the data axis too: the shipped 5M-class config on 8
    # cards (its mesh.data = -1 resolves to world // mesh.model = 2)
    torchrun --standalone --nproc_per_node=8 -m vlsfr_tpu_torch.train \\
        --config configs/partial_fc_ir50_5m_ids.json --synthetic
    # the 10M-identity int8 pool (int8 queue, int8 compute) on one card
    python -m vlsfr_tpu_torch.train --net_type ir50 --batch_size 128 \\
        --queue_size 10485760 --synthetic --set pool.queue_dtype=int8 \\
        --set pool.queue_int8_compute=true
    python -m vlsfr_tpu_torch.train --config configs/ffc_10m_ids.json \\
        --set mesh.model=1 --set data.batch_size=128 --synthetic

Checkpoints go to ``--saved_dir`` every ``train.save_freq`` steps, at the
end and on SIGTERM / SIGINT; running the same command again with the same
``--saved_dir`` resumes from the newest ("resumed from checkpoint step N").
"""

from __future__ import annotations

import argparse

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.parallel.distributed import is_lead_host
from vlsfr_tpu_torch.train.trainer import Trainer


# flag -> (config field, the reference CLI's default)
_FLAGS = {
    "saved_dir": ("train.saved_dir", "checkpoint"),
    "net_type": ("model.net_type", "r50"),
    "queue_size": ("pool.queue_size", 1000),
    "print_freq": ("train.print_freq", 1000),
    "pretrained_model_path": ("train.pretrained_model_path", ""),
    "batch_size": ("data.batch_size", 64),
    "alpha": ("pool.momentum", 0.99),
    "loss_type": ("loss.loss_type", "Arc"),
    "margin": ("loss.margin", 0.5),
    "scale": ("loss.scale", 32.0),
    "neg_margin": ("loss.neg_margin", 0.25),
    "feat_dim": ("model.feat_dim", 512),
    "head": ("pool.head", "ffc"),
}


def build_config(argv=None) -> tuple[Config, str]:
    """The config: ``--config`` (or the defaults), then the reference's
    flags, then ``--set`` overrides. Without ``--config`` every flag takes
    the reference CLI's default, as JAX's ``train.py`` does; with it only
    the flags given on the command line replace the file's values (JAX's
    ``train.py`` writes every flag's default over the file: with
    ``--config configs/ffc_10m_ids.json`` it would train r50 on a
    1000-slot queue)."""
    ap = argparse.ArgumentParser(description="very large scale face recognition (PyTorch)")
    choices = {"loss_type": ["Arc", "AM", "SV"], "head": ["ffc", "full_softmax"]}
    for flag, (_, default) in _FLAGS.items():
        ap.add_argument(f"--{flag}", type=type(default), default=None, choices=choices.get(flag),
                        help="gallery EMA momentum" if flag == "alpha" else None)
    ap.add_argument("--sources", nargs="*", default=None, help="record store dirs")
    ap.add_argument("--optim_config", type=str, default="",
                    help="reference-format typed-JSON optimizer config")
    ap.add_argument("--config", type=str, default="", help="full JSON config file")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)

    cfg = Config.load(args.config) if args.config else Config()
    for flag, (field, default) in _FLAGS.items():
        value = getattr(args, flag)
        if value is None and not args.config:
            value = default
        if value is not None:
            section, key = field.split(".")
            setattr(getattr(cfg, section), key, value)
    if args.sources is not None or not args.config:
        cfg.data.sources = list(args.sources or [])
    if args.synthetic or not args.config:
        cfg.data.synthetic = args.synthetic
    if args.optim_config:
        cfg.apply_reference_optim_config(args.optim_config)
    cfg.apply_overrides(args.overrides)
    return cfg, args.device


def main(argv=None):
    cfg, device = build_config(argv)
    trainer = Trainer(cfg, device=device)
    trainer.install_signal_handlers()
    try:
        out = trainer.train()
        if is_lead_host():
            print("training done:", out)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
