"""Probe: int8 × int8 → int32 against bf16 × bf16 → f32 on the matrix unit,
which on an NVIDIA H100 is the tensor cores.

The port of ``tools/probe_int8_mxu.py`` (the name is kept so that a reader
finds the counterpart). The JAX probe asked whether the TPU's compiler
lowers int8 dots onto its matrix unit and at what rate against bf16; here
the three kernel bodies are one CUDA kernel (``csrc/dot_probe.cu``:
``wgmma`` s8 m64n256k32 and bf16 m64n256k16 over a resident in shared
memory and a TMA-staged ring of w, or bf16 m64n128k16 over w widened in
registers for the int8-stored form; the launch ``probe_geometry`` gives) in
three forms, each computing

    o[b, t] = Σ_{i < NT} Σ_d a[b, d] · w[i, t, d]

at the ir50 head's shapes: int8 (``_kernel_int8``: int32 sums, wrapping mod
2^32), bf16 (``_kernel_bf16``: f32 sums) and int8-stored w widened to bf16
(``_kernel_i8st_bf16dot``, the int8 queue's path; exact for −127..127).

At these shapes each byte of w feeds 2·B = 256 operations, under the H100's
ridge point (about 590 operations per byte in int8, 295 in bf16), so all
three forms are bound by reading w, and the int8 / bf16 ratio the probe
reads is mostly the ratio of their bytes.

    python -m vlsfr_tpu_torch.tools.probe_int8_mxu
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vlsfr_tpu_torch.tools import card_line, time_ms
from vlsfr_tpu_torch.utils.device import resolve_device

B, D, T, NT = 128, 512, 1024, 512  # ir50 head shapes, 512 tiles = q512k (probe_int8_mxu.py:30)
KINDS = ("int8", "bf16", "i8st_bf16dot")
# (a's dtype, w's dtype, o's dtype) per kind
DTYPES = {"int8": (torch.int8, torch.int8, torch.int32),
          "bf16": (torch.bfloat16, torch.bfloat16, torch.float32),
          "i8st_bf16dot": (torch.bfloat16, torch.int8, torch.float32)}
_FORM_CODE = {"int8": 0, "bf16": 1, "i8st_bf16dot": 2}
# csrc/dot_probe.cu's constants
_BN, _ROWB, _MROWS = 256, 128, 128  # columns of T a block; bytes of a staged row; rows of a
_MAX_SMEM, _MAX_NST = 232448, 8
_TAIL = 1024 + 2 * _MAX_NST * 8  # alignment, the ring's barriers
H100_SMS = 132
LAUNCH_COUNTS = {f"probe_{k}": 0 for k in KINDS}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor of exact sums as int32 accumulates them: mod 2^32."""
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def _check(kind: str, a: torch.Tensor, w: torch.Tensor) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    da, dw, _ = DTYPES[kind]
    if a.dtype != da or w.dtype != dw or a.dim() != 2 or w.dim() != 3 or \
            w.shape[2] != a.shape[1]:
        raise ValueError(f"{kind}: a must be {da} [B, D] and w {dw} [NT, T, D]; got "
                         f"{a.dtype} {tuple(a.shape)} and {w.dtype} {tuple(w.shape)}")
    if w.device != a.device:
        raise ValueError(f"w is on {w.device}, a on {a.device}")


def probe_dot_plain(kind: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The probe's function tile by tile: int8 as f64 products and sums
    (exact: every partial sum is an integer below 2^53), wrapped to int32;
    the bf16 forms as f32 matmuls over operands widened to f32 (bf16 and
    int8 products are exact there), the tiles summed in order."""
    _check(kind, a, w)
    if kind == "int8":
        acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float64, device=a.device)
        a64 = a.double()
        for i in range(w.shape[0]):
            acc += a64 @ w[i].double().T
        return wrap_int32(acc.to(torch.int64))
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    af = a.float()
    for i in range(w.shape[0]):
        acc += af @ w[i].float().T
    return acc


def exact_int8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int8 probe's exact result by another route: a · (Σ_i w_i)ᵀ in f64
    (integers below 2^53), wrapped to int32."""
    return wrap_int32((a.double() @ w.sum(0, dtype=torch.int64).double().T).to(torch.int64))


class ProbeGeometry(NamedTuple):
    """One launch of ``csrc/dot_probe.cu``: its grid (column tiles of 256,
    splits of the K axis), k values a chunk (128 bytes of a w row), the
    ring's stages (256 rows of w; 128 in i8st, whose blocks walk their
    columns in two halves) and the dynamic shared memory (bytes)."""
    grid: tuple[int, int]
    kc: int
    nst: int
    smem: int


def split_range(n_q: int, splits: int, s: int) -> tuple[int, int]:
    """The chunks [lo, hi) of the K axis that split ``s`` sums (the
    kernel's ``q_lo`` and its end): consecutive, one chunk apart at most."""
    return n_q * s // splits, n_q * (s + 1) // splits


@functools.lru_cache(maxsize=64)
def probe_geometry(kind: str, b: int, d: int, t: int, nt: int,
                   n_sm: int = H100_SMS) -> ProbeGeometry:
    """The launch ``probe_dot`` makes on ``n_sm`` SMs, the twin of
    ``dot_probe.cu: probe_geometry``: blocks of 256 columns of T (the last
    masked) times splits of the K axis, NT tiles × D in chunks of 128 bytes
    of a w row (64 bf16 or 128 int8 k), as many splits as fill the SMs
    (4 × 33 = 132 blocks at the probe's shapes); a resident (128 rows) and
    as many 32 KB stages of w as fit beside it. Raises outside the kernel's
    contract: B ≤ 128, T a multiple of 64, D a multiple of 128 up to 512."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if not (1 <= b <= _MROWS and t >= 64 and t % 64 == 0 and d >= 128 and d % 128 == 0
            and d <= 512 and nt >= 1):
        raise ValueError(f"the probe kernel takes B <= 128, T a multiple of 64, D a multiple of "
                         f"128 up to 512; got B={b}, T={t}, D={d}, NT={nt}")
    a_item = 1 if kind == "int8" else 2
    kc = _ROWB // (2 if kind == "bf16" else 1)
    n_col = -(-t // _BN)
    n_q = nt * (d // kc)
    splits = max(1, min(n_q, n_sm // n_col))
    a_bytes = _MROWS * d * a_item
    stage = (_BN // 2 if kind == "i8st_bf16dot" else _BN) * _ROWB  # w rows a stage: 256, i8st 128
    nst = min(_MAX_NST, (_MAX_SMEM - _TAIL - a_bytes) // stage)
    return ProbeGeometry((n_col, splits), kc, nst, a_bytes + nst * stage + _TAIL)


def _lib():
    from vlsfr_tpu_torch.ops.cuda_build import load_library

    lib = load_library("dot_probe")
    if not getattr(lib, "_vlsfr_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dot_probe_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.dot_probe_launch.restype = i
        lib.dot_probe_error_string.argtypes = [i]
        lib.dot_probe_error_string.restype = ctypes.c_char_p
        lib.dot_probe_geometry.argtypes = [i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.dot_probe_geometry.restype = i
        lib._vlsfr_typed = True
    return lib


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def probe_dot(kind: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o ``[B, T]`` = Σ_i a · w[i]ᵀ in the form ``kind`` (int32 for int8,
    else f32). On CPU tensors the plain version; on CUDA tensors the kernel
    (B ≤ 128, T a multiple of 64, D a multiple of 128 up to 512) or an
    error. The kernel splits the K axis over enough blocks to fill the card
    (``probe_geometry``) and sums the splits in order."""
    _check(kind, a, w)
    if not a.is_cuda:
        return probe_dot_plain(kind, a, w)
    b, d = a.shape
    nt, t, _ = w.shape
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("a and w must start on 16-byte boundaries (w is read by TMA)")
    n_sm = _sm_count(a.device.index if a.device.index is not None else
                     torch.cuda.current_device())
    geo = probe_geometry(kind, b, d, t, nt, n_sm)
    o_dtype = DTYPES[kind][2]
    part = torch.empty((geo.grid[1], b, t), dtype=o_dtype, device=a.device)
    o = torch.empty((b, t), dtype=o_dtype, device=a.device)
    lib = _lib()
    err = lib.dot_probe_launch(a.data_ptr(), w.data_ptr(), part.data_ptr(), o.data_ptr(),
                               _FORM_CODE[kind], b, d, t, nt, n_sm,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dot_probe kernel launch failed: "
                           f"{lib.dot_probe_error_string(err).decode()} (cudaError {err})")
    LAUNCH_COUNTS[f"probe_{kind}"] += 1
    return o


def library_dot(kind: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One PyTorch call over all tiles as the yardstick (``torch._int_mm``,
    or a bf16 matmul after widening an int8 w), then a sum over tiles; the
    port never calls it."""
    nt, t, d = w.shape
    flat = w.view(nt * t, d)
    if kind == "int8":
        o = torch._int_mm(a, flat.T)
    else:
        o = torch.matmul(a, (flat if kind == "bf16" else flat.to(torch.bfloat16)).T)
    return o.view(a.shape[0], nt, t).sum(1)


def make_inputs(b: int, d: int, t: int, nt: int, seed: int, dev: torch.device) -> dict:
    """JAX's inputs (probe_int8_mxu.py:110-114), drawn on the device: int8
    uniform in −127..127, bf16 N(0, 1); per kind its (a, w)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a8 = torch.randint(-127, 128, (b, d), generator=gen, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (nt, t, d), generator=gen, device=dev, dtype=torch.int8)
    abf = torch.randn((b, d), generator=gen, device=dev).bfloat16()
    wbf = torch.randn((nt, t, d), generator=gen, device=dev).bfloat16()
    return {"int8": (a8, w8), "bf16": (abf, wbf), "i8st_bf16dot": (abf, w8)}


def run(device=None, *, b: int = B, d: int = D, t: int = T, nt: int = NT,
        seed: int = 0) -> list[dict]:
    """The int8 probe checked bit for bit against the exact result (raises
    if it differs, as JAX's main does), then one record per kind: kernel
    ms, library ms and TOP/s on the card (None on the CPU, where the plain
    version runs and nothing is timed)."""
    dev = resolve_device(device)
    inputs = make_inputs(b, d, t, nt, seed, dev)
    a8, w8 = inputs["int8"]
    got = probe_dot("int8", a8, w8)
    if not torch.equal(got, exact_int8(a8, w8)):
        raise RuntimeError("the int8 probe differs from the exact int32 sum")
    ops = 2.0 * b * d * t * nt
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records = []
    for kind in KINDS:
        a, w = inputs[kind]
        ms = time_ms(lambda: probe_dot(kind, a, w), dev)
        lib_ms = time_ms(lambda: library_dot(kind, a, w), dev) if a.is_cuda else None
        records.append({"kind": kind, "shape": [b, d, t, nt], "device": name, "ms": ms,
                        "library_ms": lib_ms, "tops": None if ms is None else ops / ms / 1e9})
    return records


def main() -> None:
    dev = resolve_device(None)
    print(card_line(dev), flush=True)
    records = run(dev)
    print("int8 kernel CORRECT (exact int32 accumulation)", flush=True)
    for r in records:
        print(f"{r['kind']}: {r['ms']:.3f} ms/pass {r['tops']:.1f} TOP/s "
              f"(library {r['library_ms']:.3f} ms)", flush=True)


if __name__ == "__main__":
    main()
