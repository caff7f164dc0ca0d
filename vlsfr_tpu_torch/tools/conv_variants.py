"""The 3×3 conv's redesigned kernels (``csrc/conv3x3.cu``: the streamed bf16
kernel on ``wgmma``, the f32 kernel on the FMA units, the bf16 stem) against
edited copies of their source, timed in turns on one card: where the time
goes, read as what a kernel saves when one phase is left out (its products,
its staging copies, the f32 kernel's shared-memory operand loads, the stem's
K-vector build, its y stores, the statistics epilogue), and the f32 kernel
at an 8 x 16 micro-tile. A copy that leaves a phase out computes wrong
outputs and is only timed.
Beside the times, each case's device time by kernel (torch.profiler: the
conv, the statistics merge, the rest).

    python -m vlsfr_tpu_torch.tools.conv_variants [--real]

``--real`` times the kernels as they are and builds no copy: run from a
checkout of an earlier commit (01496fd: the streamed and f32 kernels before
their redesign; 1511855: the stem on the padded resident kernel) with this
file copied into its ``vlsfr_tpu_torch/tools/``, it times that commit's
kernels (the wrapper's signature is the same), so that the parent's and
this tree's conv can be timed in turns in one call.

Cases (taps9; x ~ N(0, 1), w ~ 0.045 N(0, 1), as the bench): bf16 [128,
56, 56, 64] -> 64 at strip 28 (the resident kernel, which no edit touches:
the control), bf16 [128, 14, 14, 256] -> 256 and [128, 14, 14, 512] -> 512
at strip 14 (the streamed kernel; ir50's stage-3 and stage-4 widths), f32
[128, 56, 56, 64] -> 64 at strip 28 without and with statistics, bf16 [128,
112, 112, 3] -> 64 at strip 28 (ir50's stem) without and with statistics.
Each copy
is built with nvcc beside the real library, all at once; the times run
real, the copies, real, the copies backwards.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import torch

from vlsfr_tpu_torch.ops import conv3x3 as tconv
from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.tools import card_line, time_ms

# (name, dtype, x shape, Cout, strip, with statistics)
CASES = (("bf16 56^2 C64 (resident)", torch.bfloat16, (128, 56, 56, 64), 64, 28, False),
         ("bf16 14^2 C256", torch.bfloat16, (128, 14, 14, 256), 256, 14, False),
         ("bf16 14^2 C512", torch.bfloat16, (128, 14, 14, 512), 512, 14, False),
         ("f32 56^2 C64", torch.float32, (128, 56, 56, 64), 64, 28, False),
         ("f32 56^2 C64 + stats", torch.float32, (128, 56, 56, 64), 64, 28, True),
         ("bf16 112^2 C3 (stem)", torch.bfloat16, (128, 112, 112, 3), 64, 28, False),
         ("bf16 112^2 C3 (stem) + stats", torch.bfloat16, (128, 112, 112, 3), 64, 28, True))

# source edits of csrc/conv3x3.cu: {name: [(old, new)]}, each old text once
VARIANTS = {
    # the streamed kernel's wgmma products (its A fragments still loaded)
    "stream: no product": [
        ("        wgmma_m64n128k16(acc, a, sw128_desc(wsa + (tap * CCH + 16 * cb) * 128, HALF, "
         "1024),\n                         st > 0);\n", "")],
    # the streamed kernel's TMA copies (the stages' barriers expect no bytes)
    "stream: no staging copies": [
        ("mbar_expect_tx(&full[s], W_BYTES + n_vr * (W + 2) * CCH * 2);",
         "mbar_expect_tx(&full[s], 0);"),
        ("        tma_load_3d(Ws, &tmw, co0, c0, 0, &full[s]);  // the weight rows, each half\n"
         "        tma_load_3d(Ws + HALF, &tmw, co0 + 64, c0, 0, &full[s]);\n", ""),
        ("tma_load_4d(Xs + r * WP * CCH * 2, &tmx, c0, -1, hh, n, &full[s]);", "")],
    # the streamed kernel's y stores (behind a test that never holds)
    "stream: no stores": [
        ("for (int q = tid & 127; q < 64 * (S_BN / 8); q += 128) {",
         "for (int q = tid & 127; q < 64 * (S_BN / 8) * (Cout < 0); q += 128) {")],
    # the f32 kernel's products (the chunks still staged)
    "f32: no product": [("for (int st = 0; st < 9 * F_CCH / 4; ++st) {",
                         "for (int st = 0; st < 0; ++st) {")],
    # the f32 kernel's operand loads from shared memory (the FMAs on
    # register values)
    "f32: no operand loads": [
        ("a[ii] = *reinterpret_cast<const float4*>(Xs + (hp[ii] + toff) * F_CCH + 4 * c4);",
         "a[ii] = make_float4(hp[ii], toff, c4, 1.f);"),
        ("const float4 b = *reinterpret_cast<const float4*>(wr + 4 * F_TX * j);",
         "const float4 b = make_float4(tx, q, j, 1.f);")],
    # the f32 kernel's TMA copies (the stages' barriers expect no bytes)
    "f32: no staging copies": [
        ("mbar_expect_tx(&full[i % nst], (9 * F_CCH * F_BN + n_vr * (W + 2) * F_CCH) * 4);",
         "mbar_expect_tx(&full[i % nst], 0);"),
        ("    tma_load_3d(Ws, &tmw, co0, c0, 0, &full[i % nst]);  // the weight rows\n", ""),
        ("tma_load_4d(Xs + r * WP * F_CCH, &tmx, c0, -1, hh, n, &full[i % nst]);", "")],
    # the f32 kernel's y stores (kept in the code behind a test that never
    # holds, so that the products stay live)
    "f32: no stores": [("for (int j4 = 0; j4 < F_TJ / 4; ++j4) {",
                        "for (int j4 = 0; j4 < F_TJ / 4 * (Cout < 0); ++j4) {")],
    # the f32 kernel at an 8 x 16 micro-tile over 512-pixel tiles (0.75 byte
    # of shared memory per FMA; half the partials the wrapper allocates)
    "f32: 8 x 16 tile": [
        ("constexpr int F_TI = 8, F_TJ = 8;", "constexpr int F_TI = 8, F_TJ = 16;")],
    # the stem kernel's products (its A tile still built)
    "stem: no product": [("for (int ks = 0; ks < KS; ++ks) {  // the k16 steps in order",
                          "for (int ks = 0; ks < 0; ++ks) {  // the k16 steps in order")],
    # the stem kernel's K-vector build (the A tile keeps what it held)
    "stem: no K build": [("for (int ch = lane >> 4; ch < 2 * KS; ch += 2) {",
                          "for (int ch = lane >> 4; ch < 0; ch += 2) {")],
    # the stem kernel's halo copies (every tile reads a stage never filled)
    "stem: no halo copies": [("if (tile + 1 < t_hi) stage(tile + 1, buf ^ 1);", ""),
                             ("  if (t_lo < t_hi) stage(t_lo, 0);\n", "")],
    # the stem kernel's y stores (behind a test that never holds)
    "stem: no stores": [
        ("for (int q = lane; q < 16 * (ST_BN / 8); q += 32) {",
         "for (int q = lane; q < 16 * (ST_BN / 8) * (Cout < 0); q += 32) {")],
    # the kernels' statistics epilogues (the merge launch still runs)
    "no statistics epilogue": [
        ("with_stats ? launch_mode<true>(g, mode,", "with_stats ? launch_mode<false>(g, mode,")],
}
# the launches of a conv call, by a piece of their name
KERNELS = (("stream_kernel", "streamed"), ("f32_kernel", "f32"), ("bf16_kernel", "resident"),
           ("stem_kernel", "stem"), ("stats_merge", "merge"))


def edited_source(edits) -> str:
    """csrc/conv3x3.cu with the edits."""
    text = (cuda_build.CSRC / "conv3x3.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the edit {old!r} does not match conv3x3.cu once")
        text = text.replace(old, new)
    return text


def ptxas_report(log: str) -> list[str]:
    """The registers, stack and spills ptxas reports for the streamed, f32
    and stem kernels."""
    out, kernel = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1] if any(
                k in ln for k in ("stream_kernel", "f32_kernel", "stem_kernel")) else None
        elif kernel and ("registers" in ln or "spill" in ln or "stack" in ln or "warn" in ln):
            out.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
        elif "warning" in ln.lower():
            out.append(ln.strip())
    return out


def build_variants(out: Path, variants: dict) -> dict:
    """{name: the built library of each variant}, compiled in parallel."""
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        (d / "conv3x3.cu").write_text(edited_source(edits))
        procs[name] = (cuda_build.start_nvcc(d / "conv3x3.cu", d / "libconv3x3.so"),
                       d / "libconv3x3.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def make_cases(dev: torch.device) -> list:
    """The CASES' calls, inputs drawn on the card from one seed."""
    gen = torch.Generator(device=dev).manual_seed(5)
    calls = []
    for _, dtype, shape, cout, strip, stats in CASES:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        w = (torch.randn((3, 3, shape[-1], cout), generator=gen, device=dev) * 0.045).to(dtype)
        calls.append(lambda x=x, w=w, s=strip, st=stats: tconv.conv3x3(x, w, strip=s,
                                                                        with_stats=st))
    return calls


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
    """{variant: [(ms of each of CASES), ...]}, the real kernels under "real"."""
    real = cuda_build.load_library("conv3x3")
    cases = make_cases(dev)
    names = [c[0] for c in CASES]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **({} if real_only else build_variants(Path(tmp), VARIANTS))}
        order = [n for n in libs if n != "real"]
        try:
            for name in ["real", *order, "real", *reversed(order)]:
                cuda_build._LOADED["conv3x3"] = libs[name]
                times = tuple(time_ms(fn, dev) for fn in cases)
                out.setdefault(name, []).append(times)
                print(f"  {name}: " + ", ".join(f"{c} {t:.4f}" for c, t in zip(names, times)),
                      flush=True)
        finally:
            cuda_build._LOADED["conv3x3"] = real
    for case, fn in zip(names, cases):
        dev_ms = device_ms(fn)
        print(f"  real, device time of one call ({case}): {sum(dev_ms.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--real", action="store_true",
                        help="time the kernels as they are, no edited copies")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants times CUDA kernels and needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(dev))
    for name, log in cuda_build.build_all(["conv3x3"]).items():
        print(f"  {name}.cu: " + "; ".join(ptxas_report(log)))
    times = run(dev, args.real)
    names = [c[0] for c in CASES]
    mean = {k: [sum(v[i] for v in t) / len(t) for i in range(len(CASES))]
            for k, t in times.items()}
    for name, ms in mean.items():
        print(f"{name}: " + ", ".join(
            f"{c} {t:.4f} ms ({t - r:+.4f})" for c, t, r in zip(names, ms, mean["real"])))


if __name__ == "__main__":
    main()
