"""The tensor-core quad backward (``csrc/quad_margin.cu:
quad_bwd_tc_kernel``) against edited copies of its source, timed in turns
on one card: where its time goes, read as what the kernel saves when one
phase is left out, and what 16 warps a block do. A copy that leaves a
phase out computes a wrong d_emb and is only timed; the 16-warp copy is
also held to the plain version (``parity.quad_checks``).

    python -m vlsfr_tpu_torch.tools.quad_bwd_variants [--forms int8c,int8,bf16]

Cases: R = 256 probe rows (b = 128 a direction), D = 512, k = 10, Arc, a
queue drawn as the trainer draws it (``core.ffc.init_queue``) and a random
write plan of b slots a direction with a duplicate slot; the int8 forms at
Q = 10,485,760 slots (capacity_10m_int8c), bf16 at 4,194,304; the backward
at the tile its step requests (2048 columns). Each variant is built with
nvcc beside the real library, all at once; the times run real, the
variants, real, the variants backwards.
"""

from __future__ import annotations

import argparse
import ctypes
import tempfile
from pathlib import Path

import torch

from vlsfr_tpu_torch.core.ffc import init_queue
from vlsfr_tpu_torch.ops import cuda_build
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.tools import card_line, time_ms
from vlsfr_tpu_torch.utils import parity

Q = {"int8c": 10 << 20, "int8": 10 << 20, "bf16": 4 << 20}
B, D, K, TILE = 128, 512, 10, 2048
DTYPES = {"int8c": torch.int8, "int8": torch.int8, "bf16": torch.bfloat16}

# source edits of csrc/quad_margin.cu: (old, new) pairs, each old text once
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


def build_variants(out: Path) -> dict:
    """{name: the built library of each variant}, compiled in parallel."""
    src = (cuda_build.CSRC / "quad_margin.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
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


def run(forms, dev: torch.device) -> dict:
    """{form: {variant: [ms, ms]}}, the real kernel under "real"."""
    real = cuda_build.load_library("quad_margin")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **build_variants(Path(tmp))}
        order = [n for n in libs if n != "real"]
        try:
            for form in forms:
                queue, packed, kw, dce, dneg = make_case(form, Q[form], 11, dev)
                E, rest = packed[0], packed[1:]
                cuda_build._LOADED["quad_margin"] = real
                _, _, logz, topk = ttm.quad_fwd(E, queue, *rest, **kw)
                kth = topk[:, :, -1].contiguous()
                times = out.setdefault(form, {})
                for name in ["real", *order, "real", *reversed(order)]:
                    cuda_build._LOADED["quad_margin"] = libs[name]
                    ms = time_ms(lambda: ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg,
                                                      tile=TILE, **kw), dev)
                    times.setdefault(name, []).append(ms)
                    print(f"  {form} quad_bwd, {name}: {ms:.3f} ms", flush=True)
                cuda_build._LOADED["quad_margin"] = libs["16 warps"]
                checks, _ = parity.quad_checks(queue, packed, kw, dce, dneg, tile=TILE)
                bad = parity.failures(checks)
                print(f"  {form}, 16 warps against the plain version: "
                      + ("every check within its limit" if not bad
                         else "; ".join(map(parity.describe, bad))), flush=True)
                del queue, packed, E, rest
                torch.cuda.empty_cache()
        finally:
            cuda_build._LOADED["quad_margin"] = real
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--forms", default="int8c,int8,bf16")
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
