#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``vlsfr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device — the card's name and power limit (nvidia-smi), TF32 off for
   both cuDNN and cuBLAS (the f32 paths must be IEEE f32);
2. build — the CUDA kernels from ``vlsfr_tpu_torch/csrc`` with nvcc, one
   process per source, printing the ``-Xptxas -v`` report;
3. parity — each kernel against its plain PyTorch version at the slice's
   full width (b = 128 rows per direction, D = 512, Q = 2^20, k = 10, Arc,
   scale 32, margin 0.5, a write plan from the port's DCP planner with a
   duplicate slot), then AM and SV at Q = 4096. Tolerances: ce / neg / logz
   1e-4 absolute and top-k 1e-5 (f32 sums in another order over 2^20
   columns); d_emb 1e-4 × max|d_emb|; d_gt 1e-5;
4. timing — CUDA events over repeated launches: each kernel, its plain
   version, and a PyTorch composition of the forward's function
   (matmul + logsumexp + topk) as a yardstick; the bound is the larger of
   FLOP / 67 TFLOP/s (f32, no tensor cores) and bytes / 3.35 TB/s;
5. training — the port's ``Trainer`` on the slice config (ir50, 512-d,
   batch 128, 2^20-slot f32 queue, Arc, fuse_forward, bf16 compute) over a
   raw-pixel synthetic store, a few steps, with the launch counters set to
   0 just before and read just after: each quad kernel must launch once
   per step;
6. profile — two more (warm) steps under torch.profiler: the device's
   busy and idle share of the wall time, time by kernel family, top kernels;
7. the ``kernels`` JSON line, then the device JSON line last.

The script imports nothing of JAX. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
SLICE = dict(b=128, d=512, q=1 << 20, k=10)
TRAIN_STEPS = 4


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def make_case(q: int, b: int, d: int, k: int, loss_type: str, seed: int):
    """Packed kernel inputs from a realistic write plan: the port's DCP
    planner after a few warm-up steps (pool hits, seen flags, in-pool probe
    labels), with one label three times in each gallery half so two writes
    land on the same (row, slot)."""
    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import init_queue
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    queue = init_queue(q, d, device=dev, generator=gen)
    rng = np.random.default_rng(seed)
    dcp = DCPManager(q)
    n_ids = 4 * b
    for _ in range(3):
        dcp.plan_step(rng.integers(0, n_ids, b), rng.integers(0, n_ids, b))
    xl, yl = rng.integers(0, n_ids, b), rng.integers(0, n_ids, b)
    xl[:3], yl[:3] = xl[0], yl[0]
    plan = dcp.plan_step(xl, yl)
    for side in (plan.a, plan.b):
        key = side.rows.astype(np.int64) * q + side.cols
        assert len(np.unique(key)) < b, "the plan must hold a duplicate (row, slot)"

    def unit(n):
        x = torch.randn((n, d), generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    p_x, p_y, g_a, g_b = unit(b), unit(b), unit(b), unit(b)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    pa = (t(plan.a.rows), t(plan.a.cols), t(plan.a.seen))
    pb = (t(plan.b.rows), t(plan.b.cols), t(plan.b.seen))
    la, lb = t(plan.a.fake_labels), t(plan.b.fake_labels)
    packed = ttm.pack_dirs(p_x, p_y, ttm.dir_inputs(queue, g_a, *pa),
                           ttm.dir_inputs(queue, g_b, *pb), la, lb,
                           ttm.compute_twin_gt(p_x, queue, g_a, *pa, la),
                           ttm.compute_twin_gt(p_y, queue, g_b, *pb, lb))
    kw = dict(b=b, loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    cot = torch.randn((4, 2 * b), generator=gen, device=dev) / b
    pos = (packed[6] >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    n_pos = int(pos.sum())
    print(f"  case Q={q} {loss_type}: {n_pos}/{2 * b} in-pool probe rows, "
          f"{int(packed[5].sum())} blend writes")
    return queue, packed, kw, dce, dneg


def check_pair(queue, packed, kw, dce, dneg):
    """Kernel vs plain on one case; raises above tolerance. Returns the
    forward outputs (plain) and the max errors."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = packed[0], packed[1:]
    got = ttm.quad_fwd(E, queue, *rest, **kw)
    want = ttm.quad_fwd_plain(E, queue, *rest, **kw)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w, tol in zip(("ce", "neg", "logz", "topk"), got, want,
                               (1e-4, 1e-4, 1e-4, 1e-5)):
        err = float((g - w).abs().max())
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"quad_fwd {name} disagrees: max |err| {err:.3e} > {tol}")
        errs[name] = err
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    d_k, g_k = ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw)
    d_p, g_p = ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 * float(d_p.abs().max())
    errs["d_emb"] = float((d_k - d_p).abs().max())
    errs["d_gt"] = float((g_k - g_p).abs().max())
    if not errs["d_emb"] <= tol:
        raise RuntimeError(f"quad_bwd d_emb disagrees: max |err| {errs['d_emb']:.3e} > {tol:.3e}")
    if not errs["d_gt"] <= 1e-5:
        raise RuntimeError(f"quad_bwd d_gt disagrees: max |err| {errs['d_gt']:.3e}")
    print("  max |kernel - plain|: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    return want, errs


def timing(queue, packed, kw, dce, dneg, fwd_plain):
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = packed[0], packed[1:]
    r_, d = E.shape
    q = queue.shape[1]
    logz, kth = fwd_plain[2], fwd_plain[3][:, :, -1].contiguous()
    out = {}
    out["quad_fwd"] = dict(
        ms=cuda_ms(lambda: ttm.quad_fwd(E, queue, *rest, **kw), 10),
        plain_ms=cuda_ms(lambda: ttm.quad_fwd_plain(E, queue, *rest, **kw), 3, 1))
    out["quad_bwd"] = dict(
        ms=cuda_ms(lambda: ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw), 10),
        plain_ms=cuda_ms(lambda: ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg,
                                                    **kw), 3, 1))
    q0 = queue[0]

    def library_fwd():  # yardstick only: the port never calls this
        cos = torch.matmul(E, q0.T)
        torch.logsumexp(kw["scale"] * cos, dim=1)
        torch.topk(cos, kw["k"], dim=1)

    out["quad_fwd"]["library_ms"] = cuda_ms(library_fwd, 5, 1)
    out["quad_bwd"]["library_ms"] = None
    vec_bytes = 4 * (3 * r_ * d + 6 * r_)  # E, G, V + the [R] / [2, R] row vectors
    q0_bytes = 4 * q * d
    fwd_flop = 2.0 * r_ * d * q
    fwd_bytes = q0_bytes + vec_bytes + 4 * 2 * r_ * (3 + kw["k"])
    bwd_flop = 4.0 * r_ * d * q
    bwd_bytes = q0_bytes + vec_bytes + 4 * 8 * r_ + 4 * (r_ * d + 2 * r_)
    for name, flop, nbytes in (("quad_fwd", fwd_flop, fwd_bytes),
                               ("quad_bwd", bwd_flop, bwd_bytes)):
        t_ops, t_bytes = flop / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        out[name]["bound_ms"] = max(t_ops, t_bytes)
        out[name]["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        out[name]["flop"] = flop
        out[name]["bytes"] = nbytes
    for name, v in out.items():
        lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.3f}"
        print(f"  {name}: ms={v['ms']:.3f} bound_ms={v['bound_ms']:.3f} ({v['bound_by']}: "
              f"{v['flop']:.3e} FLOP, {v['bytes']:.3e} B) plain_ms={v['plain_ms']:.3f} "
              f"library_ms={lib}")
    return out


def kernel_family(name: str) -> str:
    low = name.lower()
    if "quad_" in low:
        return "quad kernels"
    if any(s in low for s in ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad")):
        return "convolution / GEMM"
    if any(s in low for s in ("elementwise", "reduce", "batch_norm", "softmax")):
        return "elementwise / reduce"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def profile_steps(trainer, n: int = 2) -> None:
    """Device activity of ``n`` warm training steps (torch.profiler): the
    busy time as the union of the card's kernel and copy intervals, its
    share of the wall time, the time by kernel family and the top kernels.
    The batches are decoded before the window, so the window holds the
    step itself (in training a prefetch thread decodes them meanwhile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [trainer.pipeline.make_batch(0, s) for s in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            idx = trainer.dcp.plan_step(b.x_label, b.y_label)
            m = trainer.train_step(trainer.state, b.x, b.y, idx, trainer.plateau.scale)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, families = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms = (e.time_range.end - e.time_range.start) / 1e3
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + ms, cnt + 1)
        fam = kernel_family(e.name)
        families[fam] = families.get(fam, 0.0) + ms
    if not spans:
        raise RuntimeError("the profiler recorded no device activity in the training steps")
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):  # union of intervals: overlapping streams count once
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy = busy_us / 1e3
    print(f"  {n} steps: wall {wall_ms:.1f} ms under the profiler ({wall_ms / n:.1f} ms/step); "
          f"device busy {busy:.1f} ms, idle {100 * (1 - busy / wall_ms):.1f} % of wall")
    print("  device time by family (ms over the window): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(families.items(), key=lambda x: -x[1])))
    for name, (ms, count) in sorted(by_name.items(), key=lambda x: -x[1][0])[:12]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {name[:110]}")


def train_phase(card: str):
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides([
        "model.net_type=ir50", "model.feat_dim=512", "model.dtype=bfloat16",
        "data.batch_size=128", "data.image_size=112", f"pool.queue_size={1 << 20}",
        "pool.queue_dtype=float32", "loss.loss_type=Arc", "loss.margin=0.5", "loss.scale=32",
        "pool.fuse_forward=true", "data.synthetic_ids=200", "data.synthetic_images_per_id=3",
        "data.num_workers=4", "train.print_freq=1", "optim.lr=0.1"])
    cfg.data.synthetic = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg.train.saved_dir = tmp
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg)  # the normal entry point; runs on cuda
        try:
            if trainer.steps_per_epoch < TRAIN_STEPS:
                raise RuntimeError(f"the store holds {trainer.steps_per_epoch} steps, "
                                   f"fewer than {TRAIN_STEPS}")
            ttm.reset_launch_counts()
            t0 = time.perf_counter()
            out = trainer.train(max_steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ttm.LAUNCH_COUNTS)
            peak = torch.cuda.max_memory_allocated()
            print(f"  {TRAIN_STEPS} steps: {json.dumps(out)}")
            print(f"  quad launches in the training run: {launches}")
            check_training(trainer, out, launches)
            step_ms = 2 * 128 / out["images_per_sec"] * 1e3
            print(f"  step time {step_ms:.1f} ms (last window, {card}); {TRAIN_STEPS} steps "
                  f"{wall:.2f} s wall incl. first-step warm-up; peak memory "
                  f"{peak / 2**30:.2f} GiB ({card})")
            print("== phase 6: profile of two more training steps")
            profile_steps(trainer)
        finally:
            trainer.close()
    return launches


def check_training(trainer, out: dict, launches: dict) -> None:
    """Finite loss, one launch of each quad kernel per step, unit rows in
    the queue, and probe embeddings that agree with the same net on the CPU."""
    if not all(n == TRAIN_STEPS for n in launches.values()):
        raise RuntimeError(f"each quad kernel must launch once per step: {launches}")
    if not (math.isfinite(out["loss"]) and out["loss"] > 0 and out["final_step"] == TRAIN_STEPS):
        raise RuntimeError(f"training did not produce a finite loss: {out}")
    state = trainer.state
    norms = torch.linalg.vector_norm(state.queue[0, :1024], dim=-1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-4):
        raise RuntimeError("queue rows are not unit vectors after training")
    x = torch.from_numpy(trainer.pipeline.make_batch(0, 0).x[:4]).cuda()
    probe_cpu = copy.deepcopy(state.probe).cpu().eval()
    state.probe.eval()
    with torch.no_grad():
        emb = state.probe(x)
        emb_cpu = probe_cpu(x.cpu())
    if emb.shape != (4, 512) or not torch.isfinite(emb).all():
        raise RuntimeError(f"bad embeddings: {emb.shape}")
    agree = float((emb.cpu() * emb_cpu).sum(-1).min())
    if agree < 0.99:
        raise RuntimeError(f"card and CPU embeddings disagree: min cosine {agree:.4f}")
    print(f"  queue rows unit; card/CPU embedding cosine >= {agree:.5f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vlsfr_tpu_torch.ops.cuda_build import build_all

    print("== phase 1: device")
    card = smi_line()
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    print("== phase 2: build")
    t0 = time.perf_counter()
    for name, log in build_all(["quad_margin"]).items():
        print(f"  {name}.cu ptxas report:")
        print("\n".join("    " + ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln or "entry function" in ln))
    print(f"  build {time.perf_counter() - t0:.1f} s")

    print("== phase 3: parity at full width")
    full = make_case(SLICE["q"], SLICE["b"], SLICE["d"], SLICE["k"], "Arc", seed=0)
    fwd_plain, errs = check_pair(*full)
    for loss_type in ("AM", "SV"):
        check_pair(*make_case(4096, SLICE["b"], SLICE["d"], SLICE["k"], loss_type, seed=1))

    print("== phase 4: timing (full width)")
    times = timing(*full, fwd_plain)
    del full, fwd_plain
    torch.cuda.empty_cache()

    print("== phase 5: training through the Trainer")
    launches = train_phase(card)

    src = "vlsfr_tpu_torch/csrc/quad_margin.cu"
    fwd_err = max(errs["ce"], errs["neg"], errs["logz"], errs["topk"])
    kernels = []
    for name, replaces, err in (
            ("quad_fwd", "vlsfr_tpu/ops/twin_margin.py:1840", fwd_err),
            ("quad_bwd", "vlsfr_tpu/ops/twin_margin.py:1891", errs["d_emb"])):
        t = times[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
