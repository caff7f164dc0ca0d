"""Evaluate a checkpoint of the port: verification (1:1) and
identification (1:N) — the counterpart of the JAX package's
``tools/evaluate.py``.

Loads the newest (or ``--step``) checkpoint a port training run wrote
(``train/checkpoints.py``), extracts flip-averaged embeddings for a record
store and reports, as one JSON line, LFW-protocol verification accuracy,
TAR@FAR 1e-3 and rank-1 identification (the first image of each identity
is the gallery, the rest are probes); insightface ``.bin`` files with
``--bin``.

    python -m vlsfr_tpu_torch.tools.evaluate --ckpt ./checkpoint --store ./store \\
        --net_type r50 --feat_dim 512 [--num_pairs 2000] [--ema] [--int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from vlsfr_tpu_torch.data.records import MultiSourceReader
from vlsfr_tpu_torch.eval.extract import Embedder
from vlsfr_tpu_torch.eval.verification import (
    cosine_scores,
    evaluate_bin,
    identification_topk,
    kfold_verification_accuracy,
    make_verification_pairs,
    tar_at_far,
)
from vlsfr_tpu_torch.models import create_net, native_image_size
from vlsfr_tpu_torch.train.checkpoints import CheckpointManager


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="training saved_dir")
    ap.add_argument("--store", nargs="*", default=[])
    ap.add_argument("--bin", dest="bin_files", nargs="*", default=[],
                    help="insightface-style verification .bin files (lfw.bin ...)")
    ap.add_argument("--net_type", default="r50")
    ap.add_argument("--feat_dim", type=int, default=512)
    ap.add_argument("--image_size", type=int, default=0)
    ap.add_argument("--num_pairs", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--step", type=int, default=-1, help="checkpoint step (-1 = latest)")
    ap.add_argument("--ema", action="store_true",
                    help="FFC checkpoints: evaluate the EMA gallery net instead of the probe net")
    ap.add_argument("--int8", action="store_true",
                    help="serve the net on int8 convs (ops/quant.py: int8 x int8 -> int32 "
                         "with dynamic scales; depthwise convs stay float)")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    size = args.image_size or native_image_size(args.net_type)
    mngr = CheckpointManager(args.ckpt)
    step = args.step if args.step >= 0 else mngr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints in {args.ckpt}")
    state = mngr.replicated(step, map_location="cpu")
    which = "gallery" if args.ema else "probe"
    if state["head"] != "ffc":
        if args.ema:
            raise SystemExit("--ema applies to FFC checkpoints only (a softmax-head checkpoint "
                             "holds one backbone)")
        which = "backbone"
    model = create_net(args.net_type, feat_dim=args.feat_dim, image_size=size)
    model.load_state_dict(state[which])
    emb = Embedder(model, batch_size=args.batch_size, device=args.device, int8=args.int8)
    report = {"checkpoint_step": int(step)}

    if args.store:
        reader = MultiSourceReader(args.store)
        embeddings = emb.from_reader(reader, size)
        labels = np.asarray(reader.labels)
        i1, i2, issame = make_verification_pairs(labels, args.num_pairs)
        scores = cosine_scores(embeddings[i1], embeddings[i2])
        acc, std = kfold_verification_accuracy(scores, issame)
        first, g_idx, p_idx = set(), [], []
        for i, lab in enumerate(labels):  # the first image of an identity is its gallery
            (p_idx if int(lab) in first else g_idx).append(i)
            first.add(int(lab))
        rank1 = identification_topk(embeddings[g_idx], labels[g_idx], embeddings[p_idx],
                                    labels[p_idx], k=1) if p_idx else float("nan")
        report.update(records=len(reader), verification_acc=round(acc, 4),
                      verification_std=round(std, 4),
                      tar_at_far1e_3=round(tar_at_far(scores, issame, 1e-3), 4),
                      rank1_identification=round(rank1, 4))
        reader.close()

    for bin_path in args.bin_files:
        name = os.path.splitext(os.path.basename(bin_path))[0]
        res = evaluate_bin(emb, bin_path, size)
        report[name] = {k: round(v, 4) if isinstance(v, float) else v for k, v in res.items()}

    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
