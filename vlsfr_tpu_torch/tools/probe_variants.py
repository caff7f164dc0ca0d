"""The dot probe's kernel (``csrc/dot_probe.cu``: a resident, w through a TMA
ring, ``wgmma``) against edited copies of its source, timed in turns on one
card: where the time goes, read as what the kernel saves when one phase is
left out (its products, its copies of w, i8st's widening, its partial
stores, the merge of the splits), and the kernel with L2 promotion off or a
ring of at most three stages. A copy that leaves a phase out computes wrong
outputs and is only timed. Beside the times, each form's device time by
kernel (torch.profiler: the probe, the merge, the rest).

    python -m vlsfr_tpu_torch.tools.probe_variants [--real]

``--real`` times the kernels as they are and builds no copy: run from a
checkout of an earlier commit (1511855: the probe before its redesign)
with this file copied into its ``vlsfr_tpu_torch/tools/``, it times that
commit's kernel (``probe_dot``'s signature is the same), so that the
parent's and this tree's probe can be timed in turns in one call.

Cases: the three forms at the probe's shapes B, D, T, NT = 128, 512, 1024,
512 (``probe_int8_mxu.make_inputs``, seed 0). Each copy is built with nvcc
beside the real library, all at once; the times run real, the copies,
real, the copies backwards.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import torch

from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.tools import card_line, time_ms
from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

# source edits of csrc/dot_probe.cu: {name: [(old, new)]}, each old text once
VARIANTS = {
    # the products (the stages still waited for and released)
    "no products": [
        ("        if constexpr (FORM == FORM_INT8)\n"
         "          wgmma_ss_m64n256k32_s8(acc, da, db, 1);\n"
         "        else\n"
         "          wgmma_ss_m64n256k16(acc, da, db, 1);\n", ""),
        ("            wgmma_rs_m64n128k16_kmajor(acc, fa[j][sub], sw128_desc(b_kk, 16, 1024), 1);",
         "            if (kk < 0) wgmma_rs_m64n128k16_kmajor(acc, fa[j][sub], sw128_desc(b_kk, 16, "
         "1024), 1);")],
    # the copies of w (each stage's barrier expects no bytes)
    "no copies": [("mbar_expect_tx(&full[st], STG);", "mbar_expect_tx(&full[st], 0);"),
                  ("        tma_load_3d(Ws + st * STG, &tmw, k0, col0 + RB * (c / n), tile, "
                   "&full[st]);\n", "")],
    # i8st's widening of w's int8 (the fragments are the raw words)
    "no widening": [("for (int q = 0; q < 4; ++q) widen4(v[q], lo[q], hi[q]);",
                     "for (int q = 0; q < 4; ++q) lo[q] = v[q], hi[q] = v[q] >> 8;")],
    # the partial stores (behind a test that never holds)
    "no partial stores": [
        ("      if (col < T)\n        *reinterpret_cast<uint4*>(out",
         "      if (col < T * (B < 0))\n        *reinterpret_cast<uint4*>(out"),
        ("if (row < B) out[(long long)row * T + col] = acc[4 * i + 2 * h + e];",
         "if (row < B * (T < 0)) out[(long long)row * T + col] = acc[4 * i + 2 * h + e];")],
    # the merge of the splits, cut to one block of its outputs
    "merge one block": [("const unsigned blocks = (unsigned)((n4 + 255) / 256);",
                         "const unsigned blocks = 1;")],
    # w's boxes without L2 promotion
    "no L2 promotion": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    # a ring of at most three stages (int8: 96 KB in flight, not 160)
    "three stages": [("constexpr int MAX_NST = 8;", "constexpr int MAX_NST = 3;")],
}
# the launches of a probe call, by a piece of their name
KERNELS = (("dot_probe_kernel", "probe"), ("dot_probe_merge", "merge"))


def edited_source(edits) -> str:
    """csrc/dot_probe.cu with the edits."""
    text = (cuda_build.CSRC / "dot_probe.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the edit {old!r} does not match dot_probe.cu once")
        text = text.replace(old, new)
    return text


def ptxas_report(log: str) -> list[str]:
    """The registers, stack, spills and warnings ptxas reports for the probe
    kernels."""
    out, kernel = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1] if "dot_probe_kernel" in ln else None
        elif kernel and ("registers" in ln or "spill" in ln or "stack" in ln):
            out.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
        elif "warning" in ln.lower() or "C7515" in ln:
            out.append(ln.strip())
    return out


def build_variants(out: Path, variants: dict) -> dict:
    """{name: the built library of each variant}, compiled in parallel."""
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        (d / "dot_probe.cu").write_text(edited_source(edits))
        procs[name] = (cuda_build.start_nvcc(d / "dot_probe.cu", d / "libdot_probe.so"),
                       d / "libdot_probe.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


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
        if not us:
            continue
        name = next((n for key, n in KERNELS if key in ev.key), "other")
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def run(dev: torch.device, real_only: bool = False) -> dict:
    """{variant: [(ms of each form), ...]}, the real kernel under "real"."""
    real = cuda_build.load_library("dot_probe")
    inputs = tprobe.make_inputs(tprobe.B, tprobe.D, tprobe.T, tprobe.NT, seed=0, dev=dev)
    calls = [lambda k=k: tprobe.probe_dot(k, *inputs[k]) for k in tprobe.KINDS]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **({} if real_only else build_variants(Path(tmp), VARIANTS))}
        order = [n for n in libs if n != "real"]
        try:
            for name in ["real", *order, "real", *reversed(order)]:
                cuda_build._LOADED["dot_probe"] = libs[name]
                times = tuple(time_ms(fn, dev) for fn in calls)
                out.setdefault(name, []).append(times)
                print(f"  {name}: "
                      + ", ".join(f"{k} {t:.4f}" for k, t in zip(tprobe.KINDS, times)), flush=True)
        finally:
            cuda_build._LOADED["dot_probe"] = real
    for kind, fn in zip(tprobe.KINDS, calls):
        dev_ms = device_ms(fn)
        print(f"  real, device time of one call ({kind}): {sum(dev_ms.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--real", action="store_true",
                        help="time the kernel as it is, no edited copies")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_variants times CUDA kernels and needs a card")
    dev = torch.device("cuda")
    print(card_line(dev))
    for name, log in cuda_build.build_all(["dot_probe"]).items():
        print(f"  {name}.cu: " + "; ".join(ptxas_report(log)))
    times = run(dev, args.real)
    mean = {k: [sum(v[i] for v in t) / len(t) for i in range(len(tprobe.KINDS))]
            for k, t in times.items()}
    for name, ms in mean.items():
        print(f"{name}: " + ", ".join(
            f"{k} {t:.4f} ms ({t - r:+.4f})" for k, t, r in zip(tprobe.KINDS, ms, mean["real"])))


if __name__ == "__main__":
    main()
