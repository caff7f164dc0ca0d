"""A 3×3 stride-1 SAME convolution over NHWC activations, with an optional
BatchNorm-statistics epilogue (the port of ``vlsfr_tpu/ops/conv_pallas.py``).

The JAX module is an experiment: can a hand conv match the library's, so
that fusing the BN statistics into its epilogue (one activation read less
per BatchNorm) is worth it? No trainer or model calls it, in JAX or here;
``vlsfr_tpu_torch/tools/bench_conv.py`` measures it. Three functions:

* ``conv3x3`` — the kernels' wrapper (``csrc/conv3x3.cu``, the launch
  ``conv_geometry`` gives), JAX's ``conv3x3_pallas`` contract: on CPU
  tensors it runs ``conv3x3_plain``; on CUDA tensors it launches a kernel
  or raises;
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
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

MODES = ("taps9", "im2col")
DTYPES = (torch.float32, torch.bfloat16)
_MODE_CODE = {"taps9": 0, "im2col": 1}
KINDS = ("f32", "resident", "streamed", "stem")  # csrc/conv3x3.cu: KIND_F32 .. KIND_STEM


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


# csrc/conv3x3.cu's constants
_MAX_SMEM = 232448  # a block's dynamic shared memory on sm_90
_BN, _PASS_PX = 64, 384  # the resident kernel's channels a block, pixels a pass
_S_BM, _S_BN, _S_CW, _S_MAX_NST = 128, 128, 2, 4  # the streamed kernel's tile, consumer warpgroups
_S_TAIL = 1024 + 2 * 4 * _S_CW * _S_BN * 4 + 2 * _S_MAX_NST * 8  # alignment, reduction, barriers
_F_BM, _F_BN, _F_CCH, _F_MAX_NST = 256, 64, 8, 4  # the f32 kernel's tile, channels a chunk
_F_TAIL = 128 + 2 * 8 * 64 * 4 + 8 * _F_MAX_NST  # alignment, reduction, barriers
_ST_BM, _ST_BN, _ST_KP, _ST_BLOCKS = 128, 64, 64, 2 * 132  # the stem kernel's tile, persistent blocks
_ST_Y_LD = _ST_BN * 2 + 16  # a y row's bytes in its shared memory


class ConvGeometry(NamedTuple):
    """One launch of ``csrc/conv3x3.cu``: the kernel (``KINDS``), its grid
    (x over pixels, y over output channels), dynamic shared memory (bytes),
    the statistics partials it writes (``part`` rows, one a block), w's row
    stride (Cout, or Cout rounded up to 8 for the streamed and f32 kernels:
    the wrapper pads w with zero columns), and its plan: resident (tr
    output rows a halo stage, n_st stages), streamed (cch channels a chunk,
    nst stages, vr halo rows), f32 (nst stages, vr halo rows), stem (a halo
    stage's bytes)."""
    kind: str
    grid: tuple[int, int]
    smem: int
    n_parts: int
    wld: int
    plan: tuple[int, ...]


def halo_rows(h: int, w: int, px: int) -> int:
    """Virtual rows (each image's H + 2 padded rows in order) that the halo
    of ``px`` consecutive output pixels can span: the image rows they
    touch, two padded rows at each image boundary among them, and the rows
    above and below (``conv3x3.cu: halo_rows``)."""
    span = (px + 2 * w - 2) // w
    return span + 2 * ((span - 1 + h - 1) // h) + 2


def kernel_channels(dtype: torch.dtype, c: int) -> int:
    """C as ``conv3x3`` hands it to the kernels: bf16 C < 8 as it is (the
    stem kernel reads x at its own C), any other C padded with zero channels
    to a whole 16-byte piece of a pixel (8 bf16, 4 f32)."""
    if dtype == torch.bfloat16 and c < 8:
        return c
    piece = 8 if dtype == torch.bfloat16 else 4
    return -(-c // piece) * piece


def stem_halo_bytes(w: int, c: int) -> int:
    """A stem tile's halo stage: x's elements from pixel p0 - W - 1 to p0 +
    128 + W, in 16-byte pieces (``conv3x3.cu: stem_halo_bytes``)."""
    return ((_ST_BM + 2 * w + 2) * c + 15) // 8 * 16


def _bf16_smem(c: int, w: int, tr: int, n_st: int) -> int:
    c16 = (c + 15) // 16 * 16
    return 9 * c16 * _BN * 2 + n_st * (tr + 2) * (w + 2) * c16 * 2 + 2 * 4 * _BN * 4


def _fit_rows(w: int, strip: int, smem) -> int:
    tr = min(strip, max(1, _PASS_PX // w))
    while tr > 0 and smem(tr) > _MAX_SMEM:
        tr -= 1
    return tr


@functools.lru_cache(maxsize=256)
def conv_geometry(bf16: bool, b: int, h: int, w: int, c: int, cout: int,
                  strip: int) -> ConvGeometry:
    """The launch ``conv3x3`` makes for x [b, h, w, c] (c already padded:
    below 8 or a multiple of 8 in bf16, a multiple of 4 in f32) and
    ``cout`` output channels, the twin of ``conv3x3.cu: conv_geometry``.
    bf16 with c < 8: the stem kernel, 264 persistent blocks (two an SM)
    over 128-pixel tiles × 64 channels. Other bf16: the resident kernel
    where the weight slice fits beside a halo row (two stages where they
    hold 128 pixels, else one), else the streamed kernel (32-channel chunks
    where two stages fit, else 16; up to four stages). f32: the f32 kernel,
    up to four stages. Raises where no plan fits a block's shared memory.
    Cached: at C = 256 the kernel takes ~0.06 ms, near the host's time for
    a call."""
    npx = b * h * w
    wld = (cout + 7) // 8 * 8
    if bf16 and c < 8:
        gy = -(-cout // _ST_BN)
        gx = min(-(-npx // _ST_BM), max(1, _ST_BLOCKS // gy))
        hb = stem_halo_bytes(w, c)
        smem = (_ST_KP * _ST_BN * 2 + _ST_BM * _ST_KP * 2 + _ST_BM * _ST_Y_LD + 2 * hb
                + _ST_KP * 8 + 2 * 8 * _ST_BN * 4)
        if smem > _MAX_SMEM or npx >= 1 << 31:
            raise ValueError(f"x of {npx} pixels at W = {w} is too large for the stem conv3x3 "
                             "kernel (its halo stages, its 32-bit pixel indices)")
        return ConvGeometry("stem", (gx, gy), smem, gx, cout, (hb,))
    if not bf16:
        vr = halo_rows(h, w, _F_BM)
        stage = 4 * (9 * _F_CCH * _F_BN + vr * (-(-(w + 2) // 4) * 4) * _F_CCH)
        nst = next((n for n in (4, 3, 2) if n * stage + _F_TAIL <= _MAX_SMEM), None)
        if nst is None or w + 2 > 256:
            raise ValueError(f"W = {w} is too wide for the f32 conv3x3 kernel (a halo row is one "
                             "TMA box of at most 256 pixels, the stages within shared memory)")
        n_mt = -(-npx // _F_BM)
        return ConvGeometry("f32", (n_mt, -(-cout // _F_BN)), nst * stage + _F_TAIL, n_mt, wld,
                            (nst, vr))
    n_st = 2
    tr = _fit_rows(w, strip, lambda r: _bf16_smem(c, w, r, 2))
    if tr * w < 128:
        n_st = 1
        tr = _fit_rows(w, strip, lambda r: _bf16_smem(c, w, r, 1))
    if tr > 0:
        return ConvGeometry("resident", (b * (h // strip), -(-cout // _BN)),
                            _bf16_smem(c, w, tr, n_st), b * (h // strip), cout, (tr, n_st))
    vr = halo_rows(h, w, _S_BM)
    if w + 2 > 256:
        raise ValueError(f"W = {w} is too wide for the streamed conv3x3 kernel (a halo row is one "
                         "TMA box of at most 256 pixels)")
    wp = -(-(w + 2) // 8) * 8  # a halo row's pixels, padded
    for cch in (32, 16):
        stage = -(-(9 * cch * _S_BN * 2 + vr * wp * cch * 2) // 1024) * 1024
        nst = min(_S_MAX_NST, (_MAX_SMEM - _S_TAIL) // stage)
        if nst >= 2:
            n_mt = -(-npx // _S_BM)
            return ConvGeometry("streamed", (n_mt, -(-cout // _S_BN)), nst * stage + _S_TAIL,
                                n_mt, wld, (cch, nst, vr))
    raise ValueError(f"W = {w} is too wide for the streamed conv3x3 kernel's stages")


def _lib():
    from vlsfr_tpu_torch.ops.cuda_build import load_library

    lib = load_library("conv3x3")
    if not getattr(lib, "_vlsfr_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.conv3x3_launch.restype = i
        lib.conv3x3_error_string.argtypes = [i]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
        lib.conv3x3_geometry.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.conv3x3_geometry.restype = i
        lib._vlsfr_typed = True
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor, *, mode: str = "taps9", strip: int = 28,
            with_stats: bool = False):
    """3×3 stride-1 SAME conv, NHWC: x ``[B, H, W, C]`` (f32 or bf16), w
    ``[3, 3, C, Cout]`` (HWIO, cast to x.dtype). Returns y ``[B, H, W, Cout]``
    in x.dtype, plus ``(Σ, Σ²)`` ``[Cout]`` f32 over all B·H·W positions of
    the f32 accumulator before rounding when ``with_stats``.

    The CUDA launch is ``conv_geometry``'s. ``strip`` must divide H and be
    even, as in JAX, but only the resident bf16 kernel's grid follows it: a
    block owns ``strip`` output rows of one image (B·H/strip blocks per 64
    output channels) and walks them in groups of rows whose halo it stages
    once. The streamed bf16 kernel (the C whose weight slice does not fit
    beside a halo row: C = 200, 256, 512) and the f32 kernel tile all
    B·H·W output pixels in order, 128 (bf16) or 256 (f32) a block, a tile
    spanning images where it ends inside one. With statistics each block
    writes one partial, summed in block order by a second launch. ``mode``
    is the order of the 9·C products each output sums: tap-major for
    ``taps9`` (JAX's nine dots), channel-major for ``im2col`` (PyTorch's
    unfold order); the resident kernel walks k16 steps of one tap × 16
    channels, the streamed kernel the same within each chunk of 32 (or 16)
    channels, the chunks in order, and the f32 kernel steps of one tap × 4
    channels within chunks of 8. Both modes compute the same sum; only the
    f32 summation order differs. Any C is taken, as JAX's wrapper takes it.
    bf16 x with C < 8 (ir50's stem, C = 3) goes to the stem kernel, which
    reads x at its own C: persistent blocks over 128-pixel tiles in order,
    each pixel's 9·C products (in the mode's order, padded to whole k16
    steps) in one chain. The other kernels stage 16-byte pieces of a
    pixel's channels, so a C of 8 or more that is not a multiple of 8
    (bf16) or of 4 (f32) is padded here with zero channels, once, in x and
    w (they add nothing to any sum), and the streamed and f32 kernels' w
    gets zero output columns up to a multiple of 8."""
    _check_args(x, w, mode, strip)
    if not x.is_cuda:
        return conv3x3_plain(x, w, with_stats=with_stats)
    if x.dtype not in DTYPES:
        raise ValueError(f"the conv3x3 kernel takes f32 or bf16 activations, got {x.dtype}")
    if not x.is_contiguous() or w.device != x.device or x.data_ptr() % 16:
        raise ValueError("x must be contiguous, start on a 16-byte boundary, and w be on x's "
                         "device")
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    wc = w.to(x.dtype)
    kc = kernel_channels(x.dtype, c)
    if kc != c:  # zero channels up to a piece
        x = F.pad(x, (0, kc - c))
        wc = F.pad(wc, (0, 0, 0, kc - c))
        c = kc
    geo = conv_geometry(x.dtype == torch.bfloat16, b, h, wd, c, cout, strip)
    if geo.wld != cout:  # zero output columns up to w's row stride
        wc = F.pad(wc, (0, geo.wld - cout))
    wc = wc.contiguous()
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    part = stats = None
    if with_stats:
        part = torch.empty((geo.n_parts, 2, cout), dtype=torch.float32, device=x.device)
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
