"""The margin_ce backward's passes against edited copies of their source,
timed in turns on one card: where the time goes, read as what a pass saves
when one of its phases is left out, and what other staging depths do. A
copy that leaves a phase out computes wrong gradients and is only timed; a
copy with another shape is also held to the plain versions
(``parity.margin_ce_bwd_checks`` at C = 2^17).

    python -m vlsfr_tpu_torch.tools.margin_bwd_variants [--forms f32,bf16] [--real]

Forms. ``f32``: the f32 pass (``csrc/margin_ce.cu: margin_bwd_f32_kernel``,
one pass for d_emb and d_w), each time ``margin_ce_bwd`` with d_w and,
beside it, with ``grad_w=False`` (the pass without d_w_hat and the d_w
epilogue; d_w's share is the difference), and the fused-SGD form (f32 W
and momentum). ``bf16``: the tensor-core d_w pass of a bf16 classifier
(``margin_bwd_dw_bf16_kernel``, every mode), each time ``margin_ce_bwd``
with d_w and with ``grad_w=False`` (the d_emb pass alone), the fused form
with a bf16 and with an f32 momentum, and the sparse backward over route
D's 65,536 rows (tile 512, 128 of 2048 tiles, selected from the forward's
statistics). ``--real`` times the kernels as they are and builds no copy:
run from a checkout of an earlier commit with this file copied into its
``vlsfr_tpu_torch/tools/``, it times that commit's kernels (the wrappers'
signatures are the same).

Case: B = 128, D = 512, C = 2^20, Arc, k = 1 (chip_smoke.py phases 8 and
30). Each copy is built with nvcc beside the real library, all at once;
the times run real, the copies, real, the copies backwards.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import torch

from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.tools import card_line, time_ms
from vlsfr_tpu_torch.utils import parity

B, C, D = 128, 1 << 20, 512
KW = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)

# source edits of csrc/margin_ce.cu and csrc/margin_common.cuh: {name: (shape
# change?, [(file, old, new)])}, each old text once in its file
VARIANTS = {
    "d_w_hat: 8 emb rows a stage": (True, [("margin_ce.cu", "FB_EK = 15,", "FB_EK = 8,")]),
    "cosines: three stages": (True, [("margin_ce.cu", "FB_NST = 2,", "FB_NST = 3,")]),
    "cosines: 16-feature chunks": (True, [("margin_ce.cu", "FB_FK = 32;", "FB_FK = 16;")]),
    "no cosine products": (False, [(
        "margin_common.cuh", "    for (int k = 0; k < FK; k += 4) {\n      float4 x[TI], y[TJ];",
        "    for (int k = 0; k < 0; k += 4) {\n      float4 x[TI], y[TJ];")]),
    "no cosine staging": (False, [(
        "margin_common.cuh",
        "      stage_f32<THREADS>(stg + (kc % NST) * NX * LD, LD, X, x0, nx, NX, D, FK * kc, FK);\n"
        "      stage_f32<THREADS>(yt + FK * kc, ldy, Y, y0, ny, NY, D, FK * kc, FK);\n", "")]),
    "no d_cos arithmetic": (False, [(
        "margin_ce.cu",
        "            d = dcos_of(cv, p0 + c, v.lab, v.gt, v.lz, v.kth, v.dce, v.dneg, a);\n",
        "            d = cv * v.dce;\n")]),
    "no d_w_hat product": (False, [
        ("margin_ce.cu", "for (int bb = 0; bb < nb; ++bb) {", "for (int bb = 0; bb < 0; ++bb) {")]),
    "no d_w epilogue": (False, [
        ("margin_ce.cu",
         "      // d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>), in place, the\n",
         "      float z = 0.f;\n"
         "      for (int i = 0; i < 8; ++i)\n"
         "        for (int j = 0; j < 8; ++j) z += acc3[i][j];\n"
         "      if (z == 1234.5f) dw[tid] = z;\n"),
        ("margin_ce.cu", "      for (int i = 0; i < 8; ++i) {\n        const int t = 8 * g2 + i;\n"
         "        if (t >= n) continue;",
         "      for (int i = 0; i < 0; ++i) {\n        const int t = 8 * g2 + i;\n"
         "        if (t >= n) continue;"),
        ("margin_ce.cu", "      for (int i = 0; i < 8; ++i) {\n        const int t = 8 * g2 + i;\n"
         "        if (t >= nl) continue;",
         "      for (int i = 0; i < 0; ++i) {\n        const int t = 8 * g2 + i;\n"
         "        if (t >= nl) continue;")]),
    "no d_emb product": (False, [
        ("margin_ce.cu", "for (int c = 0; c < n; ++c) {\n          const float* qp",
         "for (int c = 0; c < 0; ++c) {\n          const float* qp")]),
}


# ... of the bf16 d_w pass (margin_bwd_dw_bf16_kernel), each leaving one
# phase out, in every mode: timed only
BF16_VARIANTS = {
    "no cosine product": (False, [(
        "margin_ce.cu", "mma_nt_scaled<2, 2>(acc, Es, rcd, m0, Ws, rcd, n0, D / 16, inv);",
        "mma_nt_scaled<2, 2>(acc, Es, rcd, m0, Ws, rcd, n0, 0, inv);")]),
    "no d_cos arithmetic": (False, [(
        "margin_ce.cu",
        "? dcos_of(acc[mi][ni][2 * h + j], p0 + c + j, v.lab, v.gt, v.lz, v.kth,\n"
        "                                   v.dce, v.dneg, a)",
        "? acc[mi][ni][2 * h + j] * v.dce")]),
    "no next-tile copies": (False, [("margin_ce.cu",
                                     "      stage_rows_bf16(Ws, W, p1, n1, WB_TC, D);\n", "")]),
    "no d_w_hat product": (False, [("margin_ce.cu", "for (int ks = 0; ks < nb; ++ks) {",
                                    "for (int ks = 0; ks < 0; ++ks) {")]),
    "no d_wl rows": (False, [("margin_ce.cu", "for (int k = 1; k <= hits[0]; ++k) {",
                              "for (int k = 1; k <= 0; ++k) {")]),
    "no epilogue": (False, [("margin_ce.cu", "        if (c >= nl) continue;\n",
                             "        if (c >= 0) continue;\n")]),
}
FORMS = {"f32": VARIANTS, "bf16": BF16_VARIANTS}


def edited_sources(edits) -> dict:
    """{file name: text} of margin_ce.cu and margin_common.cuh with the edits."""
    texts = {name: (cuda_build.CSRC / name).read_text()
             for name in ("margin_ce.cu", "margin_common.cuh")}
    for name, old, new in edits:
        if texts[name].count(old) != 1:
            raise RuntimeError(f"the edit {old!r} does not match {name} once")
        texts[name] = texts[name].replace(old, new)
    return texts


def ptxas_report(log: str) -> list[str]:
    """The registers and spills ptxas reports for the backward passes'
    kernels (the f32 pass, the bf16 d_w pass in each mode)."""
    out, kernel = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ("f32 pass" if "margin_bwd_f32_kernel" in ln
                      else "bf16 d_w pass" if "margin_bwd_dw_bf16_kernel" in ln else None)
        elif kernel and ("registers" in ln or "spill" in ln):
            out.append(f"{kernel}: {ln.split(':')[-1].strip()}")
    return out


def build_variants(out: Path, variants: dict) -> dict:
    """{name: the built library of each variant}, compiled in parallel."""
    procs = {}
    for i, (name, (_, edits)) in enumerate(variants.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        for fname, text in edited_sources(edits).items():
            (d / fname).write_text(text)
        procs[name] = (cuda_build.start_nvcc(d / "margin_ce.cu", d / "libmargin_ce.so"),
                       d / "libmargin_ce.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        print(f"  {name}: " + "; ".join(ptxas_report(log)))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def make_case(c: int, seed: int, dev: torch.device):
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((B, D), generator=gen, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    w = torch.randn((c, D), generator=gen, device=dev).mul_(0.01)
    mom = torch.randn((c, D), generator=gen, device=dev).mul_(0.01)
    labels = torch.randint(0, c, (B,), generator=gen, device=dev, dtype=torch.int32)
    labels[1] = labels[0]
    d_ce, d_neg = torch.full((B,), 1.0 / B, device=dev), torch.zeros((B,), device=dev)
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk = tms.margin_ce_fwd_plain(emb, w, labels, gt, **KW)
    return emb, w, mom, labels, gt, logz, topk, d_ce, d_neg


def run(dev: torch.device, real_only: bool = False) -> dict:
    """The f32 form: {variant: [(ms with d_w, ms with grad_w=False, ms
    fused), ...]}, the real kernel under "real"."""
    real = cuda_build.load_library("margin_ce")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **({} if real_only else build_variants(Path(tmp), VARIANTS))}
        order = [n for n in libs if n != "real"]
        try:
            small = make_case(1 << 17, 3, dev)
            for name in order:
                if not VARIANTS[name][0]:
                    continue
                cuda_build._LOADED["margin_ce"] = libs[name]
                emb, w, mom, labels, gt, logz, topk, d_ce, d_neg = small
                bwd, fused = parity.margin_ce_bwd_checks(emb, w.clone(), mom.clone(), labels, gt,
                                                         logz, topk, d_ce, d_neg, KW, 0.1, SGD)
                bad = parity.failures(bwd + fused)
                print(f"  {name} against the plain versions: "
                      + ("every check within its limit" if not bad
                         else "; ".join(map(parity.describe, bad))), flush=True)
            del small
            emb, w, mom, labels, gt, logz, topk, d_ce, d_neg = make_case(C, 2, dev)
            args = (emb, w, labels, gt, logz, topk, d_ce, d_neg)
            for name in ["real", *order, "real", *reversed(order)]:
                cuda_build._LOADED["margin_ce"] = libs[name]
                both = time_ms(lambda: tms.margin_ce_bwd(*args, **KW), dev)
                demb = time_ms(lambda: tms.margin_ce_bwd(*args, grad_w=False, **KW), dev)
                # updates W and mom in place on every call; the work is the same
                fused = time_ms(lambda: tms.margin_ce_bwd_fused_sgd(
                    emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, 0.1, **SGD, **KW), dev)
                out.setdefault(name, []).append((both, demb, fused))
                print(f"  {name}: {both:.3f} ms, grad_w=False {demb:.3f}, d_w's share "
                      f"{both - demb:.3f}, fused {fused:.3f}", flush=True)
        finally:
            cuda_build._LOADED["margin_ce"] = real
    return out


BF16_CASES = ("d_w", "grad_w=False", "fused (bf16, bf16)", "fused (bf16, f32)",
              "sparse 65,536 rows")
# the kernels of a bf16 backward call, by a piece of their name
# (an earlier commit's, with --real: its FMA d_w pass and 1/||w|| launch)
BF16_KERNELS = (("margin_bwd_dw_bf16", "d_w pass"), ("margin_bwd_dw_kernel", "FMA d_w pass"),
                ("margin_bwd_demb_bf16", "d_emb pass"), ("margin_bwd_demb_merge", "d_emb merge"),
                ("inv_norm_bf16", "1/||w||"))


def device_ms(fn, calls: int = 5) -> dict:
    """Device time per call of fn by kernel (torch.profiler, after a warm-up
    call): the margin_ce passes by BF16_KERNELS' names, every other kernel
    (the wrapper's PyTorch work on the B label rows) as "other"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        name = next((n for key, n in BF16_KERNELS if key in ev.key), "other")
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def run_bf16(dev: torch.device, real_only: bool = False) -> dict:
    """The bf16 form: {variant: [(ms of each of BF16_CASES), ...]}, the real
    kernel under "real"."""
    real = cuda_build.load_library("margin_ce")
    out = {}
    emb, w, mom, labels, gt, logz, topk, d_ce, d_neg = make_case(C, 2, dev)
    w = w.bfloat16()
    moms = {"bf16": mom.bfloat16(), "f32": mom}
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk, maxz, maxcos = tms.margin_ce_fwd(emb, w, labels, gt, with_stats=True,
                                                       tile=512, **KW)
    u = torch.rand((maxz.shape[0],), generator=torch.Generator(device=dev).manual_seed(4),
                   device=dev)
    tile_idx, _ = tms.select_relevant_tiles(maxz, maxcos, logz, topk, labels, 128, 512, u=u)
    args = (emb, w, labels, gt, logz, topk, d_ce, d_neg)
    cases = (lambda: tms.margin_ce_bwd(*args, **KW),
             lambda: tms.margin_ce_bwd(*args, grad_w=False, **KW),
             # update W and mom in place on every call; the work is the same
             *(lambda m=moms[t]: tms.margin_ce_bwd_fused_sgd(
                 emb, w, m, labels, gt, logz, topk, d_ce, d_neg, 0.1, **SGD, **KW)
               for t in ("bf16", "f32")),
             lambda: tms.margin_ce_bwd_sparse(*args, tile_idx, tile=512, **KW))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **({} if real_only else build_variants(Path(tmp), BF16_VARIANTS))}
        order = [n for n in libs if n != "real"]
        try:
            for name in ["real", *order, "real", *reversed(order)]:
                cuda_build._LOADED["margin_ce"] = libs[name]
                times = tuple(time_ms(fn, dev) for fn in cases)
                out.setdefault(name, []).append(times)
                print(f"  {name}: " + ", ".join(f"{c} {t:.3f}" for c, t in zip(BF16_CASES, times)),
                      flush=True)
        finally:
            cuda_build._LOADED["margin_ce"] = real
    for case, fn in zip(BF16_CASES, cases):
        dev_ms = device_ms(fn)
        print(f"  real, device time of one call ({case}): {sum(dev_ms.values()):.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in dev_ms.items()), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--forms", default="f32,bf16",
                        help="comma-separated: f32 (the f32 pass), bf16 (the bf16 d_w pass)")
    parser.add_argument("--real", action="store_true",
                        help="time the kernels as they are, no edited copies")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("margin_bwd_variants times CUDA kernels and needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev))
    forms = args.forms.split(",")
    if "f32" in forms:
        times = run(dev, args.real)
        mean = {n: [sum(v[i] for v in t) / len(t) for i in range(3)] for n, t in times.items()}
        b0, d0, f0 = mean["real"]
        for name, (both, demb, fused) in mean.items():
            print(f"f32 {name}: {both:.3f} ms (grad_w=False {demb:.3f}, d_w's share "
                  f"{both - demb:.3f}; fused {fused:.3f}); against real {both - b0:+.3f} ms "
                  f"(grad_w=False {demb - d0:+.3f}, d_w's share {both - demb - b0 + d0:+.3f}, "
                  f"fused {fused - f0:+.3f})")
    if "bf16" in forms:
        times = run_bf16(dev, args.real)
        n = len(BF16_CASES)
        mean = {k: [sum(v[i] for v in t) / len(t) for i in range(n)] for k, t in times.items()}
        for name, ms in mean.items():
            print(f"bf16 {name}: " + ", ".join(
                f"{c} {t:.3f} ms ({t - r:+.3f})" for c, t, r in zip(BF16_CASES, ms, mean["real"])))


if __name__ == "__main__":
    main()
