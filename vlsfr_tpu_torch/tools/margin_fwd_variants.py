"""The margin_ce forward's kernel (``csrc/margin_ce.cu``: ``margin_fwd_kernel``,
every form of ``margin_ce_fwd`` and ``margin_partial_fwd``) against edited
copies of its source, timed in turns on one card: where the time goes, read
as what the kernel saves when one phase is left out (the product's
multiplies, its staging copies, the row pass, its top-k insertions, the
statistics). A copy that
leaves a phase out computes wrong outputs and is only timed. Beside the
times, each case's device time by kernel (torch.profiler: the block pass,
the merge, the statistics' reduction, a bf16 classifier's 1/‖w‖ launch).

    python -m vlsfr_tpu_torch.tools.margin_fwd_variants [--forms f32,bf16] [--real]

``--real`` times the kernels as they are and builds no copy: run from a
checkout of an earlier commit (1d051e5: the forward before its redesign)
with this file copied into its ``vlsfr_tpu_torch/tools/``, it times that
commit's kernels (the wrappers' signatures are the same), so that the
parent's and this tree's forward can be timed in turns in one call.

Cases, each form (an f32 or bf16 classifier): B = 128, D = 512, C = 2^20,
Arc, k = 1 (chip_smoke.py phases 8, 12, 19 and 30): ``margin_ce_fwd``
without and with statistics (tile 512, route D's), and
``margin_partial_fwd`` over a 2^20 block and over a 1,250,000 block (one
card's block of the 5M config), labels block-local. Each copy is built
with nvcc beside the real library, all at once; the times run real, the
copies, real, the copies backwards.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import torch

from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.parallel._shard_common import localize_labels
from vlsfr_tpu_torch.tools import card_line, time_ms

B, C, D = 128, 1 << 20, 512
KW = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
STATS_TILE = 512
BLOCK = 1_250_000  # one card's block of the 5M-class config (4 cards)
CASES = ("fwd", "fwd + statistics", "partial 2^20", "partial 1,250,000")

# source edits of csrc/margin_ce.cu: {name: [(old, new)]}, each old text
# once; a variant's edits cover both W forms
VARIANTS = {
    # the product's multiplies (the chunks still staged; the cosines 0)
    "no product": [
        ("    fdots_chunk<F_ROWS, F_TC, F_TI, F_TJ>(acc, st, ax, by);\n", ""),
        ("    mma_nt<2, NI>(acc, Es, 8, m0, Es + ROWS * 64 * 2, 8, n0, 4);\n", "")],
    # the feature chunks' copies (the product multiplies what the stages hold)
    "no staging copies": [
        ("      if (s < nk)\n        fdots_load<F_THREADS, F_ROWS, F_TC>(",
         "      if (false)\n        fdots_load<F_THREADS, F_ROWS, F_TC>("),
        ("    if (kc + F_NST - 1 < nk)\n      fdots_load<F_THREADS, F_ROWS, F_TC>(",
         "    if (false)\n      fdots_load<F_THREADS, F_ROWS, F_TC>("),
        ("    if (s < n_kc) load_chunk<ROWS, TC>(a, stg, s, r_base, p0, n, s);",
         "    if (false) load_chunk<ROWS, TC>(a, stg, s, r_base, p0, n, s);"),
        ("    if (kc + CH_ST - 1 < n_kc)\n      load_chunk<ROWS, TC>(",
         "    if (false)\n      load_chunk<ROWS, TC>(")],
    # the row pass (the stream, the top-k and the statistics)
    "no row pass": [("    if (ti > 0 && row_ok)\n      row_pass<STATS>(",
                     "    if (false)\n      row_pass<STATS>(")],
    # the row pass's top-k insertions
    "no top-k insertions": [("    if (mx > ln.kth[0]) {", "    if (false) {")],
    # the statistics in the row pass (the reduction launch still runs)
    "no statistics": [("stats != nullptr ? margin_fwd_kernel<TW, true> : margin_fwd_kernel<TW, false>",
                       "margin_fwd_kernel<TW, false>")],
}
# the launches of a forward call, by a piece of their name
KERNELS = (("margin_fwd_kernel", "block pass"), ("margin_fwd_merge", "merge"),
           ("margin_partial_merge", "merge"), ("margin_fwd_stats", "statistics' reduction"),
           ("inv_norm_bf16", "1/||w||"))


def edited_source(edits) -> str:
    """csrc/margin_ce.cu with the edits."""
    text = (cuda_build.CSRC / "margin_ce.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the edit {old!r} does not match margin_ce.cu once")
        text = text.replace(old, new)
    return text


def ptxas_report(log: str) -> list[str]:
    """The registers, stack and spills ptxas reports for the forward's
    block pass (each W form, with and without statistics)."""
    out, kernel = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1] if "margin_fwd_kernel" in ln else None
        elif kernel and ("registers" in ln or "spill" in ln or "stack" in ln):
            out.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    return out


def build_variants(out: Path, variants: dict) -> dict:
    """{name: the built library of each variant}, compiled in parallel."""
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        (d / "margin_ce.cu").write_text(edited_source(edits))
        procs[name] = (cuda_build.start_nvcc(d / "margin_ce.cu", d / "libmargin_ce.so"),
                       d / "libmargin_ce.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def make_cases(w_dtype, dev: torch.device) -> list:
    """The CASES' calls on one seeded case (a 0.01·N(0, 1) classifier, unit
    embeddings, a repeated label)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    emb = torch.randn((B, D), generator=gen, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    blk = torch.randn((BLOCK, D), generator=gen, device=dev).mul_(0.01).to(w_dtype)
    w = blk[:C]  # the whole classifier; the block of 1,250,000 has its columns first
    labels = torch.randint(0, C, (B,), generator=gen, device=dev, dtype=torch.int32)
    labels[1] = labels[0]
    gt = tms.compute_gt(emb, w, labels)
    ll, _ = localize_labels(0, BLOCK, labels)
    return [lambda: tms.margin_ce_fwd(emb, w, labels, gt, **KW),
            lambda: tms.margin_ce_fwd(emb, w, labels, gt, with_stats=True, tile=STATS_TILE, **KW),
            lambda: tms.margin_partial_fwd(emb, w, labels, gt, **KW),
            lambda: tms.margin_partial_fwd(emb, blk, ll, gt, **KW)]


def device_ms(fn, calls: int = 5) -> dict:
    """Device time per call of fn by kernel (torch.profiler, after a warm-up
    call), by KERNELS' names; every other kernel as "other"."""
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
        name = next((n for key, n in KERNELS if key in ev.key), "other")
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def run(form: str, dev: torch.device, real_only: bool = False) -> dict:
    """{variant: [(ms of each of CASES), ...]} of one W form, the real
    kernel under "real"."""
    real = cuda_build.load_library("margin_ce")
    cases = make_cases(torch.bfloat16 if form == "bf16" else torch.float32, dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **({} if real_only else build_variants(Path(tmp), VARIANTS))}
        order = [n for n in libs if n != "real"]
        try:
            for name in ["real", *order, "real", *reversed(order)]:
                cuda_build._LOADED["margin_ce"] = libs[name]
                times = tuple(time_ms(fn, dev) for fn in cases)
                out.setdefault(name, []).append(times)
                print(f"  {form} {name}: " + ", ".join(f"{c} {t:.3f}" for c, t in zip(CASES, times)),
                      flush=True)
        finally:
            cuda_build._LOADED["margin_ce"] = real
    for case, fn in zip(CASES, cases):
        dev_ms = device_ms(fn)
        print(f"  {form} real, device time of one call ({case}): {sum(dev_ms.values()):.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in dev_ms.items()), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--forms", default="f32,bf16", help="comma-separated W forms: f32, bf16")
    parser.add_argument("--real", action="store_true",
                        help="time the kernels as they are, no edited copies")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("margin_fwd_variants times CUDA kernels and needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev))
    for name, log in cuda_build.build_all(["margin_ce"]).items():
        print(f"  {name}.cu: " + "; ".join(ptxas_report(log)))
    for form in args.forms.split(","):
        times = run(form, dev, args.real)
        mean = {k: [sum(v[i] for v in t) / len(t) for i in range(len(CASES))]
                for k, t in times.items()}
        for name, ms in mean.items():
            print(f"{form} {name}: " + ", ".join(
                f"{c} {t:.3f} ms ({t - r:+.3f})" for c, t, r in zip(CASES, ms, mean["real"])))


if __name__ == "__main__":
    main()
