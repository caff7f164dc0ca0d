"""Every quad / twin and margin_ce kernel of PERF.md §6 timed alone at its
row's shapes, so that two trees' kernels can be compared in turns in one
call on one card:

    python -m vlsfr_tpu_torch.tools.kernel_times [--rows 128] [--out FILE]

Run from a checkout of an earlier commit with this file copied into its
``vlsfr_tpu_torch/tools/``, it times that commit's kernels (the wrappers'
signatures are the same since commit 01496fd). ``--rows`` sets b, the probe rows
per direction of the quad kernels, the twin's rows and the margin_ce
kernels' batch rows (128: the rows of §6; an earlier commit takes no more).

Cases (inputs drawn from a seeded generator on the card; the queue and the
classifier random unit rows, the int8 planes random with row scales, the
write plan 2b consecutive slots as the DCP planner hands them out, with a
duplicate slot): the quad forward and backward in every form (f32 over
2^20 slots, bf16 over 4,194,304, int8 and int8c over 10,485,760; the
backward's tile request 2048) and their partial forms over a quarter of
the queue; the twin's in f32 and bf16 over 2^20 (partial: 2^18); the
margin_ce forward, backward, fused SGD (f32 and bf16 momentum) and sparse
backward (128 tiles of 512) over 2^20 f32 classes, their bf16-classifier
forms, and the partial forward and backward over a 2^20 block. Each time is
``tools.time_ms``'s (two warm-up calls, ten timed). Prints one JSON object
{kernel: ms} and the card line, and writes the object to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.tools import card_line, time_ms

D, K, TILE = 512, 10, 2048
QUAD_Q = {"f32": 1 << 20, "bf16": 4 << 20, "int8": 10 << 20, "int8c": 10 << 20}
TWIN_Q, C = 1 << 20, 1 << 20
KW = dict(loss_type="Arc", margin=0.5, scale=32.0, mask_svfc=1.2)
SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)


def unit(n, gen, dev, dtype=torch.float32):
    x = torch.randn((n, D), generator=gen, device=dev)
    return (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).to(dtype)


def queue_of(form, q, gen, dev):
    """A [2, q, D] queue of the form and its [2, q] scales (int8 forms)."""
    if form in ("f32", "bf16"):
        dt = torch.float32 if form == "f32" else torch.bfloat16
        return torch.stack([unit(q, gen, dev, dt) for _ in range(2)]), None
    plane = torch.randint(-127, 128, (2, q, D), generator=gen, device=dev, dtype=torch.int8)
    scales = torch.rand((2, q), generator=gen, device=dev) * (1.0 / 127 / math.sqrt(D) * 2)
    return plane, scales


def direction(q, b, gen, dev, nd):
    """nd directions' write plans: b consecutive slots each (a duplicate
    slot in each), probes, gallery rows; labels at written slots or -1."""
    rows = torch.randint(0, 2, (nd * b,), generator=gen, device=dev, dtype=torch.int32)
    cols = (torch.arange(nd * b, device=dev, dtype=torch.int32) + q // 3)
    for d_ in range(nd):
        rows[d_ * b + 1], cols[d_ * b + 1] = rows[d_ * b], cols[d_ * b]
    blend = torch.randint(0, 2, (nd * b,), generator=gen, device=dev, dtype=torch.int32)
    labels = torch.where(torch.rand((nd * b,), generator=gen, device=dev) < 0.3, -1, cols)
    E, G, V = (unit(nd * b, gen, dev) for _ in range(3))
    gt = torch.rand((2, nd * b), generator=gen, device=dev) * 0.6 - 0.1
    return E, G, V, rows, cols, blend, labels.to(torch.int32), gt


def quad_times(out, b, gen, dev):
    for form, q in QUAD_Q.items():
        queue, qs = queue_of(form, q, gen, dev)
        E, *rest = direction(q, b, gen, dev, 2)
        fkw = dict(qscales=None if qs is None else qs[0],
                   e8=quantize_rows(E) if form == "int8c" else None)
        kw = dict(KW, k=K, b=b, **fkw)
        _, _, logz, topk = ttm.quad_fwd(E, queue, *rest, **kw)
        kth = topk[:, :, -1].contiguous()
        cot = torch.randn((4, 2 * b), generator=gen, device=dev) / b
        pos = (rest[5] >= 0)[None, :]
        dce, dneg = torch.where(pos, cot[:2], 0.0), torch.where(pos, 0.0, cot[2:])
        tile = dict(tile=TILE) if form != "f32" else {}
        out[ttm.kernel_name("quad_fwd", form)] = time_ms(lambda: ttm.quad_fwd(E, queue, *rest,
                                                                               **kw), dev)
        out[ttm.kernel_name("quad_bwd", form)] = time_ms(lambda: ttm.quad_bwd(
            E, queue, *rest, logz, kth, dce, dneg, **kw, **tile), dev)
        blk = queue[0, :q // 4]
        pkw = dict(kw, bp=b, qscales=None if qs is None else qs[0, :q // 4])
        lrest = (rest[0], rest[1], rest[2], torch.where(rest[3] < q // 4, rest[3], -1),
                 rest[4], torch.where(rest[5] < q // 4, rest[5], -1), rest[6])
        out[ttm.kernel_name("quad_partial_fwd", form)] = time_ms(
            lambda: ttm.quad_partial_fwd(E, blk, *lrest, **pkw), dev)
        out[ttm.kernel_name("quad_partial_bwd", form)] = time_ms(
            lambda: ttm.quad_partial_bwd(E, blk, *lrest, logz, kth, dce, dneg, **pkw, **tile),
            dev)
        del queue, qs, blk
        torch.cuda.empty_cache()


def twin_times(out, b, gen, dev):
    for form in ("f32", "bf16"):
        queue, _ = queue_of(form, TWIN_Q, gen, dev)
        E, *rest = direction(TWIN_Q, b, gen, dev, 1)
        kw = dict(KW, k=K)
        _, _, logz, topk = ttm.twin_fwd(E, queue, *rest, **kw)
        kth = topk[:, :, -1].contiguous()
        cot = torch.randn((4, b), generator=gen, device=dev) / b
        pos = (rest[5] >= 0)[None, :]
        dce, dneg = torch.where(pos, cot[:2], 0.0), torch.where(pos, 0.0, cot[2:])
        name = lambda k_: k_ if form == "f32" else f"{k_}[{form}]"  # noqa: E731
        out[name("twin_fwd")] = time_ms(lambda: ttm.twin_fwd(E, queue, *rest, **kw), dev)
        out[name("twin_bwd")] = time_ms(lambda: ttm.twin_bwd(
            E, queue, *rest, logz, kth, dce, dneg, **kw, tile=512), dev)
        blk = queue[0, :TWIN_Q // 4]
        lrest = (rest[0], rest[1], rest[2], torch.where(rest[3] < TWIN_Q // 4, rest[3], -1),
                 rest[4], torch.where(rest[5] < TWIN_Q // 4, rest[5], -1), rest[6])
        out[name("twin_partial_fwd")] = time_ms(
            lambda: ttm.twin_partial_fwd(E, blk, *lrest, **kw), dev)
        out[name("twin_partial_bwd")] = time_ms(lambda: ttm.twin_partial_bwd(
            E, blk, *lrest, logz, kth, dce, dneg, **kw, tile=512), dev)
        del queue, blk
        torch.cuda.empty_cache()


def margin_times(out, b, gen, dev):
    emb = unit(b, gen, dev)
    labels = torch.randint(0, C, (b,), generator=gen, device=dev, dtype=torch.int32)
    labels[1] = labels[0]
    pos = labels >= 0
    d_ce, d_neg = torch.where(pos, 1.0 / b, 0.0), torch.where(pos, 0.0, 1.0 / b)
    kw = dict(KW, k=1)
    tile, n_tiles = tms.sparse_bwd_geometry(b, D, C)
    tile_idx = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(0))[:128]
    tile_idx = torch.unique(torch.cat([tile_idx.to(dev), labels.long() // tile]))[:128]
    tile_idx = tile_idx.to(torch.int32).contiguous()
    for w_dt, m_dt in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)):
        w = (torch.randn((C, D), generator=gen, device=dev) * 0.01).to(w_dt)
        mom = (torch.randn((C, D), generator=gen, device=dev) * 0.01).to(m_dt)
        gt = tms.compute_gt(emb, w, labels)
        _, _, logz, topk = tms.margin_ce_fwd(emb, w, labels, gt, **kw)
        args = (emb, w, labels, gt, logz, topk, d_ce, d_neg)
        pair = ",".join("f32" if t.dtype == torch.float32 else "bf16" for t in (w, mom))
        fused = "margin_ce_bwd_fused_sgd" + ("" if pair == "f32,f32" else f"[{pair}]")
        out[fused] = time_ms(
            lambda: tms.margin_ce_bwd_fused_sgd(emb, w, mom, *args[2:], 0.1, **SGD, **kw), dev)
        if m_dt != w_dt:
            continue
        sfx = "" if w_dt == torch.float32 else "[bf16]"
        out["margin_ce_fwd" + sfx] = time_ms(lambda: tms.margin_ce_fwd(*args[:4], **kw), dev)
        out["margin_ce_bwd" + sfx] = time_ms(lambda: tms.margin_ce_bwd(*args, **kw), dev)
        out["margin_ce_bwd_sparse" + sfx] = time_ms(
            lambda: tms.margin_ce_bwd_sparse(*args, tile_idx, tile=tile, **kw), dev)
        kth = topk[:, -1].contiguous()
        d_wl = torch.zeros_like(emb)
        out["margin_partial_fwd" + sfx] = time_ms(
            lambda: tms.margin_partial_fwd(emb, w, labels, gt, **kw), dev)
        out["margin_partial_bwd" + sfx] = time_ms(lambda: tms.margin_partial_bwd(
            emb, w, labels, gt, logz, kth, d_ce, d_neg, d_wl, **kw), dev)
        del w, mom
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(("quad_margin", "margin_ce"))
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict[str, float | None] = {}
    quad_times(out, args.rows, gen, dev)
    twin_times(out, args.rows, gen, dev)
    margin_times(out, args.rows, gen, dev)
    print(json.dumps(out))
    print(card_line(dev))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
