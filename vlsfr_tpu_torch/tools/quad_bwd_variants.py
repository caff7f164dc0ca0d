"""The quad backward's kernels (``csrc/quad_margin.cu``: the f32 form's
``quad_bwd_f32_kernel``, the other forms' ``quad_bwd_tc_kernel``) against
edited copies of their source, timed in turns on one card: where the time
goes, read as what the kernel saves when one phase is left out, and what 16
warps a block do (the tensor-core kernel). A copy that leaves a phase out
computes a wrong d_emb and is only timed; the copies that compute the same
function (16 warps; the f32 written cosines formed in the tile loop) are
also held to the plain version (``parity.quad_checks``). Each form is also
timed on the same inputs with the step's write columns and labels set to
-1: what the written columns and the targets cost.

    python -m vlsfr_tpu_torch.tools.quad_bwd_variants [--forms f32,int8c,int8,bf16]

Cases: R = 256 probe rows (b = 128 a direction), D = 512, k = 10, Arc, a
queue drawn as the trainer draws it (``core.ffc.init_queue``) and a random
write plan of b slots a direction with a duplicate slot; f32 at Q = 2^20
slots (ffc_q1m_f32), the int8 forms at 10,485,760 (capacity_10m_int8c),
bf16 at 4,194,304; the backward at the tile its step requests (2048
columns; an f32 queue rounds nothing). Each variant is built with nvcc
beside the real library, all at once; the times run real, the variants,
real, the variants backwards.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from vlsfr_tpu_torch.core.ffc import init_queue
from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.tools import card_line, time_ms
from vlsfr_tpu_torch.utils import parity

Q = {"f32": 1 << 20, "int8c": 10 << 20, "int8": 10 << 20, "bf16": 4 << 20}
B, D, K, TILE = 128, 512, 10, 2048
DTYPES = {"f32": torch.float32, "int8c": torch.int8, "int8": torch.int8,
          "bf16": torch.bfloat16}

# source edits of csrc/quad_margin.cu: (old, new) pairs, each old text once;
# the tensor-core kernel's
VARIANTS = {
    "16 warps": [("constexpr int BB_NW = 8,", "constexpr int BB_NW = 16,")],
    "no recompute": [("    tile_cos<FORM>(a, Es, S, Q, sq, r_base, m1, n1, acc1);\n",
                      "    for (int ni = 0; ni < BB_NI; ++ni)\n"
                      "      for (int e = 0; e < 4; ++e) acc1[0][ni][e] = 0.f;\n")],
    "no d_cos routing": [("                                             dg, dv, i0, ib);\n"
                          "            put(lr, c, dq, dq2);",
                          "                                             dg, dv, i0, ib);\n"
                          "            put(lr, c, 1e-3f, 0.f);")],
    "no d_cos arithmetic": [("      d = expf(z - rc.ref) * rc.c12;\n"
                             "      if (z >= rc.zthr[0]) d += rc.dn[0];\n"
                             "      if (z >= rc.zthr[1]) d += rc.dn[1];",
                             "      d = z * rc.c12;")],
    "no d_emb product": [("for (int p = 0; p < (two ? 2 : 1); ++p) {",
                          "for (int p = 0; p < 0; ++p) {")],
    "no widening": [("    if constexpr (FORM == FORM_INT8) {\n      widen_tile(Qb, S, D);\n",
                     "    if constexpr (FORM == FORM_INT8) {\n"),
                    ("    if constexpr (FORM == FORM_INT8C) widen_tile(Qb, S, D);", "")],
}
# ... the f32 kernel's (quad_bwd_f32_kernel)
PREFETCH_AT = "    // demb += d_cos . the q0 tile, column by column in order\n"
PREFETCH = ("    if (t0 + BF_TC < c_end) {\n"
            "      const char* nq = static_cast<const char*>(a.q0) + 4 * (t0 + BF_TC) * D;\n"
            "      const long long nb = 4 * min((long long)BF_TC, c_end - t0 - BF_TC) * D;\n"
            "      for (long long o = 128LL * tid; o < nb; o += 128LL * BF_THREADS)\n"
            "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(nq + o));\n"
            "    }\n")
F32_VARIANTS = {
    # the q0 tile staged whole, no cosine product
    "f32: no recompute": [(
        "    float acc[BF_TI][BF_TJ];\n    bf_dots(acc, stg, Qt, a, r_base, nr, t0, n, ax, by);\n",
        "    float acc[BF_TI][BF_TJ] = {};\n"
        "    stage_f32<BF_THREADS>(Qt, ldq, static_cast<const float*>(a.q0), t0, n, BF_TC, D,\n"
        "                          0, D);\n"
        "    cp_async_commit();\n    cp_async_wait<0>();\n    __syncthreads();\n")],
    "f32: no d_cos arithmetic": [(
        "Dq[c * BF_DLD + lr] = live ? bf_clean_dcos(a, rc, acc[i][j]) : 0.f;",
        "Dq[c * BF_DLD + lr] = acc[i][j] * 1e-3f;")],
    "f32: no d_emb product": [("    for (int c = 0; c < n; ++c) {\n      const float4 dlo",
                               "    for (int c = 0; c < 0; ++c) {\n      const float4 dlo")],
    # the written columns' cosines by row_dot in the tile loop (the same bits)
    "f32: written cosines in the tile loop": [(
        "  if (i0 >= 0) c1 = wcos[wrow + i0];\n"
        "  const float c2 = ib >= 0 ? wcos[wrow + a.BP + ib] : c1;",
        "  const float* e_row = a.E + (long long)gr * a.D;\n"
        "  if (i0 >= 0) c1 = row_dot(e_row, a.G + (long long)(rc.dir * a.BP + i0) * a.D, a.D);\n"
        "  const float c2 =\n"
        "      ib >= 0 ? row_dot(e_row, a.V + (long long)(rc.dir * a.BP + ib) * a.D, a.D) : c1;")],
    # staging: E's stages and the chunk width
    "f32: three E stages": [("constexpr int BF_NST = 2, BF_FK = 64;",
                             "constexpr int BF_NST = 3, BF_FK = 64;")],
    "f32: 32-feature chunks": [("constexpr int BF_NST = 2, BF_FK = 64;",
                                "constexpr int BF_NST = 2, BF_FK = 32;")],
    # (D = 512 only: 128 features a chunk do not divide D = 64 or 192)
    "f32: 128-feature chunks": [("constexpr int BF_NST = 2, BF_FK = 64;",
                                 "constexpr int BF_NST = 2, BF_FK = 128;")],
    # the per-tile write plan (mark_writes) left out
    "f32: no write plan": [(
        "    mark_writes<BF_TC>(a, t0, last0, lastb, written);  // its barriers publish rcs too\n",
        "    if (tid < 4) written[tid] = 0;\n    __syncthreads();\n")],
    # the written route inlined into every unrolled element of d_cos, as
    # the clean one is (one element at a time in the kernel)
    "f32: written route unrolled": [("#pragma unroll 1\n        for (int j = 0; j < BF_TJ; ++j) {",
                                     "#pragma unroll\n        for (int j = 0; j < BF_TJ; ++j) {")],
    # the next q0 tile prefetched into L2 under the d_emb product
    "f32: L2 prefetch": [(PREFETCH_AT, PREFETCH + PREFETCH_AT)],
    "f32: d_emb loop unrolled by 2": [("#pragma unroll 4\n    for (int c = 0; c < n; ++c) {",
                                       "#pragma unroll 2\n    for (int c = 0; c < n; ++c) {")],
    # the cosines 8 rows x 2 columns a thread, a warp's 32 threads on 32
    # columns of the same 8 rows: every E load a broadcast to the whole warp
    "f32: 8 x 2 cosine micro-tile": [
        ("constexpr int BF_TI = 4, BF_TJ = 4, BF_SA = 16, BF_SB = 16;",
         "constexpr int BF_TI = 8, BF_TJ = 2, BF_SA = 8, BF_SB = 32;"),
        ("  ax = 4 * (warp >> 1) + (lane >> 3);\n  by = 8 * (warp & 1) + (lane & 7);",
         "  ax = warp;\n  by = lane;")],
}
# the copy of each kernel that computes the same function, held to the plain version
CHECKED = {"f32": "f32: written cosines in the tile loop", "int8c": "16 warps", "int8": "16 warps",
           "bf16": "16 warps"}


def make_case(form: str, q: int, seed: int, dev: torch.device):
    """The packed kernel inputs, the form's keywords and masked cotangents."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    queue, scales = init_queue(q, D, device=dev, generator=gen, dtype=DTYPES[form])

    def unit(n):
        x = torch.randn((n, D), generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    dirs = []
    for _ in range(2):
        rows = torch.randint(0, 2, (B,), generator=gen, device=dev, dtype=torch.int32)
        cols = torch.randint(0, q, (B,), generator=gen, device=dev, dtype=torch.int32)
        rows[1], cols[1] = rows[0], cols[0]  # a duplicate slot
        seen = (torch.rand(B, generator=gen, device=dev) < 0.5).float()
        labels = torch.where(torch.rand(B, generator=gen, device=dev) < 0.3, -1, cols)
        dirs.append((unit(B), unit(B), rows, cols, seen, labels.to(torch.int32)))
    (pa, ga, ra, ca, sa, la), (pb, gb, rb, cb, sb, lb) = dirs
    packed = ttm.pack_dirs(pa, pb, ttm.dir_inputs(queue, ga, ra, ca, sa, scales),
                           ttm.dir_inputs(queue, gb, rb, cb, sb, scales), la, lb,
                           ttm.compute_twin_gt(pa, queue, ga, ra, ca, sa, la, scales),
                           ttm.compute_twin_gt(pb, queue, gb, rb, cb, sb, lb, scales))
    kw = dict(b=B, loss_type="Arc", margin=0.5, scale=32.0, k=K, mask_svfc=1.2,
              qscales=None if scales is None else scales[0],
              e8=quantize_rows(packed[0]) if form == "int8c" else None)
    cot = torch.randn((4, 2 * B), generator=gen, device=dev) / B
    pos = (packed[6] >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    return queue, packed, kw, dce, dneg


def build_variants(out: Path, variants: dict) -> dict:
    """{name: the built library of each variant}, compiled in parallel."""
    src = (cuda_build.CSRC / "quad_margin.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its edit does not match the source once")
            text = text.replace(old, new)
        d = out / f"v{i}"
        d.mkdir(parents=True)
        (d / "quad_margin.cu").write_text(text)
        procs[name] = (cuda_build.start_nvcc(d / "quad_margin.cu", d / "libquad_margin.so"),
                       d / "libquad_margin.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def clocks_under(fn, dev: torch.device, seconds: float = 2.0) -> str:
    """The SM clock and power draw that nvidia-smi samples every 100 ms
    while ``fn`` runs back to back for about ``seconds``: min / median /
    max of each."""
    ms = time_ms(fn, dev)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(max(1, int(seconds * 1e3 / ms))):
            fn()
        torch.cuda.synchronize(dev)
    finally:
        smi.terminate()
    out, _ = smi.communicate(timeout=30)
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    rows = rows[len(rows) // 5:] or rows  # the first samples may precede the load
    desc = []
    for k, (name, unit) in enumerate((("SM clock", "MHz"), ("power", "W"))):
        v = sorted(r[k] for r in rows)
        desc.append(f"{name} {v[0]:g} / {v[len(v) // 2]:g} / {v[-1]:g} {unit}")
    return f"{len(rows)} samples: " + ", ".join(desc) + " (min / median / max)"


def run(forms, dev: torch.device) -> dict:
    """{form: {variant: [ms, ms]}}, the real kernel under "real" and on the
    inputs without writes and targets under "no writes or targets"."""
    real = cuda_build.load_library("quad_margin")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        chosen = {**(F32_VARIANTS if "f32" in forms else {}),
                  **(VARIANTS if set(forms) - {"f32"} else {})}
        libs = {"real": real, **build_variants(Path(tmp), chosen)}
        try:
            for form in forms:
                order = [n for n in (F32_VARIANTS if form == "f32" else VARIANTS)]
                queue, packed, kw, dce, dneg = make_case(form, Q[form], 11, dev)
                E, rest = packed[0], packed[1:]
                G, V, rows, cols, blend, labels, gt = rest
                bare = (G, V, rows, torch.full_like(cols, -1), blend, torch.full_like(labels, -1),
                        gt)
                cuda_build._LOADED["quad_margin"] = real
                _, _, logz, topk = ttm.quad_fwd(E, queue, *rest, **kw)
                kth = topk[:, :, -1].contiguous()
                print(f"  {form} quad_bwd, real, under load: " + clocks_under(
                    lambda: ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, tile=TILE, **kw),
                    dev), flush=True)
                times = out.setdefault(form, {})
                for name in ["real", *order, "no writes or targets", "real", *reversed(order),
                             "no writes or targets"]:
                    cuda_build._LOADED["quad_margin"] = libs.get(name, real)
                    args = bare if name == "no writes or targets" else rest
                    ms = time_ms(lambda: ttm.quad_bwd(E, queue, *args, logz, kth, dce, dneg,
                                                      tile=TILE, **kw), dev)
                    times.setdefault(name, []).append(ms)
                    print(f"  {form} quad_bwd, {name}: {ms:.3f} ms", flush=True)
                cuda_build._LOADED["quad_margin"] = libs[CHECKED[form]]
                checks, _ = parity.quad_checks(queue, packed, kw, dce, dneg, tile=TILE)
                bad = parity.failures(checks)
                print(f"  {form}, {CHECKED[form]}, against the plain version: "
                      + ("every check within its limit" if not bad
                         else "; ".join(map(parity.describe, bad))), flush=True)
                del queue, packed, E, rest
                torch.cuda.empty_cache()
        finally:
            cuda_build._LOADED["quad_margin"] = real
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--forms", default="f32,int8c,int8,bf16")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("quad_bwd_variants times CUDA kernels and needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev))
    for form, times in run(args.forms.split(","), dev).items():
        base = sum(times["real"]) / len(times["real"])
        for name, ms in times.items():
            mean = sum(ms) / len(ms)
            print(f"{form}: {name}: {' / '.join(f'{m:.3f}' for m in ms)} ms "
                  f"({mean - base:+.3f} ms against real)")


if __name__ == "__main__":
    main()
