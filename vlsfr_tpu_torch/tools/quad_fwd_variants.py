"""The quad and twin forward's kernel (``csrc/quad_margin.cu``:
``quad_fwd_kernel``, every form of ``quad_fwd``, ``quad_partial_fwd``,
``twin_fwd`` and ``twin_partial_fwd``) against edited copies of its source,
timed in turns on one card: where the time goes, read as what the kernel
saves when one phase is left out (the row pass, the product's multiplies,
its staging copies, the per-tile write plan). A copy that leaves a phase
out computes wrong statistics and is only timed; the copy that streams a
row's columns through one (m, s) chain a view, not two, computes the same
function up to the order of a sum and is also held to the real kernel's
outputs.
Each case is also timed on the same inputs with the step's write columns
and labels set to -1: what the written columns and the targets cost.

    python -m vlsfr_tpu_torch.tools.quad_fwd_variants [--cases quad_f32,twin_bf16_2^18,...]
    python -m vlsfr_tpu_torch.tools.quad_fwd_variants --before   # in a checkout of fe3ba36
    python -m vlsfr_tpu_torch.tools.quad_fwd_variants --cases quad_int8c --rows 512

``--rows`` sets b, the probe rows (and writes) per direction (128 by
default; 512 is the shipped 10M config's batch, R = 1024: each tile's
write plan then scans 2 x 512 writes).

``--before`` times the forward as it stood before its redesign (commit
fe3ba36: 256 threads, one thread a probe row, the written columns' cosines
by ``row_dot`` in the tile loop, the f32 and int8c products staged by
plain loads): run it from a checkout of that commit with this file copied
into its ``vlsfr_tpu_torch/tools/``; the wrappers' signatures are the same.

Cases: the quad at R = 256 probe rows (b = 128 a direction), the twin at b
= 128, D = 512, k = 10, Arc, a queue drawn as the trainer draws it
(``core.ffc.init_queue``) and the write plan the port's DCP planner makes
(consecutive slots from 2: each direction's b writes in one run, the
first two entries on one slot); the quad's f32 queue at 2^20 slots
(ffc_q1m_f32), bf16 at 4,194,304, the int8 forms at 10,485,760
(capacity_10m_int8c); the twin at 2^20 (twin_fwd) and over one 2^18 block
of it (twin_partial_fwd, a 4-card shard). Each variant is built with nvcc
beside the real library, all at once; the times run real, the variants,
real, the variants backwards.
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

B, D, K = 128, 512, 10
DTYPES = {"f32": torch.float32, "int8c": torch.int8, "int8": torch.int8,
          "bf16": torch.bfloat16}
# name: (head, form, queue slots, columns streamed: the whole queue or its
# first block)
CASES = {
    "quad_f32": ("quad", "f32", 1 << 20, 1 << 20),
    "quad_bf16": ("quad", "bf16", 4 << 20, 4 << 20),
    "quad_int8": ("quad", "int8", 10 << 20, 10 << 20),
    "quad_int8c": ("quad", "int8c", 10 << 20, 10 << 20),
    "twin_f32": ("twin", "f32", 1 << 20, 1 << 20),
    "twin_bf16": ("twin", "bf16", 1 << 20, 1 << 20),
    "twin_f32_2^18": ("twin", "f32", 1 << 20, 1 << 18),
    "twin_bf16_2^18": ("twin", "bf16", 1 << 20, 1 << 18),
}

# source edits of csrc/quad_margin.cu: (old, new) pairs, each old text once
CHAINS = ("      stream4(a, rp.zs, c1[h], ok[h], rp.gt0, ln.m[0][h], ln.s[0][h]);\n"
          "      stream4(a, rp.zs, c2[h], ok[h], rp.gt1, ln.m[1][h], ln.s[1][h]);\n")
VARIANTS = {
    # the row pass left out
    "no row pass": [("    if (ti > 0 && row_ok)\n      row_pass<L>(",
                     "    if (false)\n      row_pass<L>(")],
    # the cosine product's multiplies (the chunks still staged; Cs then 0)
    "no multiply": [("    fwd_chunk<FORM, ROWS>(a, stg + (kc % NST) * f_stage_bytes<FORM, ROWS>(), Es, kc, "
                     "acc);\n", "")],
    # the feature chunks' copies (the product multiplies what the stages
    # hold; the tensor-core forms' resident E rows still loaded once)
    "no staging": [("    if (more) v = fwd_load<FORM, ROWS>(", "    if (false) v = fwd_load<FORM, ROWS>("),
                   ("    if (s < n_kc) v[s] = fwd_load<FORM, ROWS>(",
                    "    if (false) v[s] = fwd_load<FORM, ROWS>(")],
    # the per-tile write plan (every tile clean)
    "no write plan": [("    mark_writes<F_TC>(a, t0, plan, plan + 2 * F_TC, plan + 4 * F_TC);\n",
                       "    if (tid < 4) plan[4 * F_TC + tid] = 0;\n    __syncthreads();\n")],
    # both quads of a pair into one (m, s) chain a view: the same function up
    # to the order of the sum, held to the real kernel's outputs
    "one chain a view": [(CHAINS, CHAINS.replace("][h]", "][0]"))],
}
CHECKED = "one chain a view"
# ... of the forward before its redesign (``--before``)
BEFORE_VARIANTS = {
    "no row pass": [("    if (row_ok) {\n      const bool any_w = written[dir] != 0;",
                     "    if (false) {\n      const bool any_w = written[dir] != 0;")],
    # the cosines left at 0 (TC forms: the tile's first two feature chunks
    # still staged, by the prologue under the row pass)
    "no product": [
        ("      fwd_cos_tc<FORM, ROWS, NI>(a, stg, t0, c_end, wr, wc, acc);\n",
         "      for (int mi = 0; mi < 2; ++mi)\n"
         "        for (int ni = 0; ni < NI; ++ni)\n"
         "          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;\n"
         "      cp_async_wait<0>();\n"),
        ("      cos_tile<FORM, ROWS, F_TC, F_DK, F_THREADS, ALD, F_BLD, TI, 8, 32, 8>(a, acc, As, Bs,"
         " 0, t0,\n",
         "      for (int i = 0; i < TI; ++i)\n"
         "        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;\n"
         "      if (false) cos_tile<FORM, ROWS, F_TC, F_DK, F_THREADS, ALD, F_BLD, TI, 8, 32, 8>("
         "a, acc, As, Bs, 0, t0,\n")],
    "no write plan": [("    mark_writes<F_TC>(a, t0, last0, lastb, written);\n\n",
                       "    if (tid < 4) written[tid] = 0;\n    __syncthreads();\n\n")],
}


def gathered_plan(q: int, direction: int, gen: torch.Generator, dev: torch.device):
    """One direction's write plan as the DCP planner lays it out: b
    consecutive slots from 2 + direction * b, entries 0 and 1 on one slot
    at parity 0; labels on the written slots, 30 % outliers."""
    cols = (2 + direction * B + torch.arange(B, device=dev)).to(torch.int32)
    rows = torch.randint(0, 2, (B,), generator=gen, device=dev, dtype=torch.int32)
    cols[1], rows[0], rows[1] = cols[0], 0, 0
    seen = (torch.rand(B, generator=gen, device=dev) < 0.5).float()
    labels = torch.where(torch.rand(B, generator=gen, device=dev) < 0.3, -1, cols)
    return rows, cols % q, seen, labels.to(torch.int32)


def make_case(name: str, dev: torch.device):
    """(forward function, its positional inputs, keywords) of one case; the
    same inputs with the write columns and labels at -1."""
    head, form, q, n = CASES[name]
    gen = torch.Generator(device=dev).manual_seed(11)
    queue, scales = init_queue(q, D, device=dev, generator=gen, dtype=DTYPES[form])

    def unit(m):
        x = torch.randn((m, D), generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=K, mask_svfc=1.2)
    if head == "quad":
        dirs = [(unit(B), unit(B), *gathered_plan(q, d, gen, dev)) for d in range(2)]
        (pa, ga, ra, ca, sa, la), (pb, gb, rb, cb, sb, lb) = dirs
        packed = ttm.pack_dirs(pa, pb, ttm.dir_inputs(queue, ga, ra, ca, sa, scales),
                               ttm.dir_inputs(queue, gb, rb, cb, sb, scales), la, lb,
                               ttm.compute_twin_gt(pa, queue, ga, ra, ca, sa, la, scales),
                               ttm.compute_twin_gt(pb, queue, gb, rb, cb, sb, lb, scales))
        kw.update(b=B, qscales=None if scales is None else scales[0],
                  e8=quantize_rows(packed[0]) if form == "int8c" else None)
        return ttm.quad_fwd, (packed[0], queue, *packed[1:]), kw
    p, g = unit(B), unit(B)
    rows, cols, seen, labels = gathered_plan(q, 0, gen, dev)
    g32, rows_i, cols_i, v, blend = ttm.dir_inputs(queue, g, rows, cols, seen)
    gt = torch.stack(ttm.compute_twin_gt(p, queue, g, rows, cols, seen, labels))
    inputs = [x.contiguous() for x in (g32, v, rows_i, cols_i, blend.to(torch.int32), labels, gt)]
    if n == q:
        return ttm.twin_fwd, (p, queue, *inputs), kw
    return ttm.twin_partial_fwd, (p, queue[0, :n], *inputs), kw


def without_writes(args):
    """The inputs with every write column and label set to -1."""
    E, q, G, V, rows, cols, blend, labels, gt = args
    return (E, q, G, V, rows, torch.full_like(cols, -1), blend, torch.full_like(labels, -1), gt)


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


def run(cases, variants: dict, dev: torch.device, checked: str | None = None) -> dict:
    """{case: {variant: [ms, ms]}}, the real kernel under "real" and on the
    inputs without writes and targets under "no writes or targets"; the
    variant ``checked`` (the same function) also against the real kernel's
    outputs."""
    real = cuda_build.load_library("quad_margin")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"real": real, **build_variants(Path(tmp), variants)}
        try:
            for case in cases:
                fn, args, kw = make_case(case, dev)
                bare = without_writes(args)
                times = out.setdefault(case, {})
                order = list(variants)
                for name in ["real", *order, "no writes or targets", "real", *reversed(order),
                             "no writes or targets"]:
                    cuda_build._LOADED["quad_margin"] = libs.get(name, real)
                    a = bare if name == "no writes or targets" else args
                    ms = time_ms(lambda: fn(*a, **kw), dev)
                    times.setdefault(name, []).append(ms)
                    print(f"  {case}, {name}: {ms:.3f} ms", flush=True)
                if checked in libs:  # the same function as the real kernel's
                    cuda_build._LOADED["quad_margin"] = real
                    want = fn(*args, **kw)
                    cuda_build._LOADED["quad_margin"] = libs[checked]
                    got = fn(*args, **kw)
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                    print(f"  {case}, {checked}: max |outputs - real's| {err:.3e}", flush=True)
                del args, bare
                torch.cuda.empty_cache()
        finally:
            cuda_build._LOADED["quad_margin"] = real
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cases", default=",".join(CASES))
    parser.add_argument("--before", action="store_true",
                        help="the variants of the forward before its redesign (commit fe3ba36)")
    parser.add_argument("--rows", type=int, default=B, help="probe rows per direction")
    args = parser.parse_args()
    globals()["B"] = args.rows
    if not torch.cuda.is_available():
        raise SystemExit("quad_fwd_variants times CUDA kernels and needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev))
    variants = BEFORE_VARIANTS if args.before else VARIANTS
    checked = None if args.before else CHECKED
    for case, times in run(args.cases.split(","), variants, dev, checked).items():
        base = sum(times["real"]) / len(times["real"])
        for name, ms in times.items():
            mean = sum(ms) / len(ms)
            print(f"{case}: {name}: {' / '.join(f'{m:.3f}' for m in ms)} ms "
                  f"({mean - base:+.3f} ms against real)")


if __name__ == "__main__":
    main()
