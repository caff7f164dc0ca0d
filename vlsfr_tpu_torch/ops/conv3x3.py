"""A 3×3 stride-1 SAME convolution over NHWC activations, with an optional
BatchNorm-statistics epilogue (the port of ``vlsfr_tpu/ops/conv_pallas.py``).

The JAX module is an experiment: can a hand conv match the library's, so
that fusing the BN statistics into its epilogue (one activation read less
per BatchNorm) is worth it? No trainer or model calls it, in JAX or here;
``vlsfr_tpu_torch/tools/bench_conv.py`` measures it. Three functions:

* ``conv3x3`` — the kernel's wrapper (``csrc/conv3x3.cu``), JAX's
  ``conv3x3_pallas`` contract: on CPU tensors it runs ``conv3x3_plain``; on
  CUDA tensors it launches the kernel or raises;
* ``conv3x3_plain`` — nine shifted f32 matmuls, the version the kernel is
  held to;
* ``conv3x3_library`` — ``F.conv2d`` (cuDNN on a card), the yardstick the
  bench times, counterpart of ``conv3x3_xla``; the port never calls it.

Weights are JAX's HWIO ``[3, 3, C, Cout]`` as they are (numpy arrays go
through ``torch.from_numpy``): the kernel indexes HWIO itself, so no
conversion exists.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MODES = ("taps9", "im2col")
DTYPES = (torch.float32, torch.bfloat16)
_MODE_CODE = {"taps9": 0, "im2col": 1}


def kernel_name(dtype: torch.dtype, with_stats: bool) -> str:
    """The launch counter of one form: ``conv3x3`` (bf16, the bench's),
    ``conv3x3[stats]``, ``conv3x3[f32]``, ``conv3x3[f32,stats]``."""
    tags = (["f32"] if dtype == torch.float32 else []) + (["stats"] if with_stats else [])
    return "conv3x3" + (f"[{','.join(tags)}]" if tags else "")


LAUNCH_COUNTS = {kernel_name(dt, s): 0 for dt in DTYPES for s in (False, True)}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _check_args(x: torch.Tensor, w: torch.Tensor, mode: str, strip: int) -> None:
    """JAX's asserts (``conv_pallas.py:101-107``) and the shapes both
    versions take."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"x must be [B, H, W, C] and w [3, 3, C, Cout]; got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.shape[1] % strip:
        raise ValueError(f"strip {strip} does not divide H = {x.shape[1]}")
    if strip % 2:
        raise ValueError(f"strip must be even (JAX's halo block index is in 2-row units), "
                         f"got {strip}")


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, *, with_stats: bool = False):
    """y = the nine taps ``x_pad[:, dy:dy+H, dx:dx+W, :] @ w[dy, dx]`` over
    operands widened to f32 (a bf16 product is exact there), summed in f32 in
    taps9's order, rounded once to x.dtype; with ``with_stats`` also
    ``(Σ, Σ²)`` per output channel of the f32 sum before rounding."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    acc = torch.zeros((b * h * wd, cout), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c) @ wf[dy, dx]
    y = acc.to(x.dtype).reshape(b, h, wd, cout)
    if not with_stats:
        return y
    return y, (acc.sum(0), acc.square().sum(0))


def conv3x3_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` on channels-last views of the same tensors (cuDNN on a
    card; TF32 as the caller set it): the yardstick, never the kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _lib():
    from vlsfr_tpu_torch.ops.cuda_build import load_library

    lib = load_library("conv3x3")
    if not getattr(lib, "_vlsfr_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.conv3x3_launch.restype = i
        lib.conv3x3_error_string.argtypes = [i]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
        lib._vlsfr_typed = True
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor, *, mode: str = "taps9", strip: int = 28,
            with_stats: bool = False):
    """3×3 stride-1 SAME conv, NHWC: x ``[B, H, W, C]`` (f32 or bf16), w
    ``[3, 3, C, Cout]`` (HWIO, cast to x.dtype). Returns y ``[B, H, W, Cout]``
    in x.dtype, plus ``(Σ, Σ²)`` ``[Cout]`` f32 over all B·H·W positions of
    the f32 accumulator before rounding when ``with_stats``.

    In the CUDA kernel ``strip`` is the number of output rows of one image a
    block owns (grid: B·H/strip blocks per 64 output channels; each block
    walks its strip·W pixels — on the bf16 form's tensor cores in groups of
    output rows whose halo it stages once, on the f32 form's FMA units in
    tiles of 64 — and with statistics writes one partial per block, summed
    in block order by a second launch); ``mode`` is the order of the 9·C
    products each output sums: tap-major for ``taps9`` (JAX's nine dots),
    channel-major for ``im2col`` (PyTorch's unfold order; on the bf16 form,
    the order of its k16 steps of one tap × 16 channels). Both compute the
    same sum; only the f32 summation order differs. ``strip`` must divide H
    and be even, as in JAX; any C is taken, as JAX's wrapper takes it. The
    bf16 kernel keeps its block's weight slice in shared memory where it
    fits beside a halo row (C <= 144 at W <= 112) and streams it with the
    halo in chunks of 64 (or 32, 16) channels where it does not (C = 256,
    512); it stages 16-byte pieces of a pixel's channels, so a C that is not
    a multiple of 8 (ir50's stem, C = 3) is padded here with zero channels,
    once, in x and w (they add nothing to any sum)."""
    _check_args(x, w, mode, strip)
    if not x.is_cuda:
        return conv3x3_plain(x, w, with_stats=with_stats)
    if x.dtype not in DTYPES:
        raise ValueError(f"the conv3x3 kernel takes f32 or bf16 activations, got {x.dtype}")
    if not x.is_contiguous() or w.device != x.device:
        raise ValueError("x must be contiguous and w on x's device")
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    wc = w.to(x.dtype)
    if x.dtype == torch.bfloat16 and c % 8:  # zero channels up to a multiple of 8
        x = F.pad(x, (0, 8 - c % 8))
        wc = F.pad(wc, (0, 0, 0, 8 - c % 8))
        c = x.shape[-1]
    wc = wc.contiguous()
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    part = stats = None
    if with_stats:
        part = torch.empty((b * (h // strip), 2, cout), dtype=torch.float32, device=x.device)
        stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.conv3x3_launch(
        x.data_ptr(), wc.data_ptr(), y.data_ptr(), None if part is None else part.data_ptr(),
        None if stats is None else stats.data_ptr(), int(x.dtype == torch.bfloat16),
        _MODE_CODE[mode], b, h, wd, c, cout, strip, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: "
                           f"{lib.conv3x3_error_string(err).decode()} (cudaError {err})")
    LAUNCH_COUNTS[kernel_name(x.dtype, with_stats)] += 1
    if not with_stats:
        return y
    return y, (stats[0], stats[1])
