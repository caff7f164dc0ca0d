"""Int8 conv inference for the serving forward and the EMA gallery forward
(port of ``vlsfr_tpu/ops/quant.py``).

The scheme is JAX's, rounding point for rounding point, in f32, with no
calibration state (every scale is recomputed each call):

* channel equalisation: ``ax`` = max|x| per input channel over N, H, W;
  ``aw_in`` = max|w| per input channel over the output channels and the
  taps; ``s = sqrt(max(ax, 1e-12) / max(aw_in, 1e-12))``, 1 where ``ax``
  or ``aw_in`` is 0 (``x / s`` and ``w · s`` are exact in f32);
* activations, per tensor: ``sx = max(max(ax / s), 1e-12) / 127`` and
  ``xq = clip(round(x / (s · sx)), ±127)``, the product ``s · sx`` formed
  first;
* weights, per output channel: ``wq, sw`` from
  ``quantize_weight_per_channel(w · s)``;
* ``y = f32(xq ⊛ wq) · (sx · sw) + bias``, int8 × int8 → int32 sums, cast
  to the layer's compute dtype.

Rounding is half to even (``torch.round``, as ``jnp.round``). Two
rounding points follow what XLA compiles rather than what the source
reads: a division by the constant 127 becomes a product with its f32
reciprocal (XLA's algebraic simplifier rewrites ``a / c`` to ``a · (1 /
c)`` under ``jit``, where JAX's Embedder and FFC step run), so the port
multiplies by that reciprocal on both devices; and XLA's f32 square root
is correctly rounded where PyTorch's on the CPU is not (``ops/qqueue.py``),
so the port takes it in f64 and rounds once to f32.

The int path (``int8_conv2d``, ``int_conv``): an im2col of ``xq`` in NHWC
order, one copy of a strided view of the zero-padded int8 input
(``F.unfold`` has no int8 kernel), times the weight matrix through
``torch._int_mm`` — cuBLASLt on the card, the same code on the CPU. K and
N are padded with zeros to multiples of 8 and the rows to more than 16
(cuBLASLt's rules; the ir50 / mobile stem's K = 27 becomes 32), which
changes no sum. Images go in chunks whose im2col stays within
``CHUNK_BYTES``. JAX runs this conv through XLA, outside any Pallas
kernel, so it is a library product here too, not a kernel port.
``int_conv_plain`` — an f64 conv of the int values, exact since every sum
is below 127² · K < 2^53 — is the plain version the tests and
chip_smoke.py hold the int path to; nothing on the main path calls it.
On a CUDA tensor the int path runs or raises: it never becomes a float
conv.

Mechanism: ``int8_conv_inference()`` sets a context variable that
``models/layers.Conv.forward`` reads. Inside it an eligible conv (groups 1,
dilation 1, as JAX's ``_eligible``) takes ``int8_conv2d``; a depthwise
conv (MobileFaceNet's ``dw`` and GDConv) keeps its float path bit for
bit. Parameters and buffers are untouched: ``state_dict()`` is the same
inside the context and out.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn.functional as F

_QMAX = 127.0
_INV_QMAX = float(np.float32(1.0) / np.float32(_QMAX))  # XLA's f32 1 / 127
_EPS = 1e-12
CHUNK_BYTES = 1 << 28  # the im2col of one chunk of images, at most (one image at least)
# convs taken on the int path (one a call of int8_conv2d, whatever its chunks)
LAUNCH_COUNTS = {"int8_conv": 0}

_ACTIVE = contextvars.ContextVar("int8_conv_inference", default=False)


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


@contextlib.contextmanager
def int8_conv_inference():
    """Within the ``with`` block every eligible ``models.layers.Conv`` runs
    on the int path; the previous state comes back on exit, also when the
    block raises."""
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def int8_active() -> bool:
    return _ACTIVE.get()


def eligible(conv: torch.nn.Conv2d) -> bool:
    """An ungrouped conv without dilation (JAX's ``_eligible``)."""
    return conv.groups == 1 and tuple(conv.dilation) == (1, 1)


def quantize_weight_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[cout, ...]`` float weight → (int8 weight, f32 scale ``[cout]``):
    symmetric per output channel, scale = max|w| / 127 over every axis
    but the first (JAX's HWIO kernel has its output channels last)."""
    w = w.float()
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = absmax.clamp(min=_EPS) * _INV_QMAX
    wq = torch.round(w / scale.reshape(-1, *[1] * (w.dim() - 1)))
    return wq.clamp(-_QMAX, _QMAX).to(torch.int8), scale


def quantize_act_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float activation → (int8 activation, f32 0-dim scale), dynamic
    symmetric per tensor."""
    x = x.float()
    scale = x.abs().amax().clamp(min=_EPS) * _INV_QMAX
    return torch.round(x / scale).clamp(-_QMAX, _QMAX).to(torch.int8), scale


def conv_scales(x: torch.Tensor, w: torch.Tensor):
    """The int path's operands for input ``x [N, C, H, W]`` and weight
    ``w [O, C, kh, kw]``: ``(d, sx, wq, sw)`` — ``d = s · sx [C]`` the
    input's divisor, ``sx`` the activation scale (0-dim), ``wq`` int8 ``[O,
    C, kh, kw]`` and ``sw [O]`` the weight's."""
    ax = x.abs().amax(dim=(0, 2, 3)).float()
    w32 = w.float()
    aw_in = w32.abs().amax(dim=(0, 2, 3))
    s = torch.sqrt((ax.clamp(min=_EPS) / aw_in.clamp(min=_EPS)).double()).float()
    s = torch.where((ax > 0) & (aw_in > 0), s, torch.ones_like(s))
    sx = (ax / s).amax().clamp(min=_EPS) * _INV_QMAX
    wq, sw = quantize_weight_per_channel(w32 * s[None, :, None, None])
    return s * sx, sx, wq, sw


def quantize_input(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / d[c]), ±127)`` as int8, same shape as ``x``."""
    return torch.round(x.float() / d[None, :, None, None]).clamp(-_QMAX, _QMAX).to(torch.int8)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """int8 ``[O, C, kh, kw]`` → ``[up8(O), up8(K)]``, K in (kh, kw, C)
    order (the im2col's), zero-padded."""
    o = wq.shape[0]
    m = wq.permute(0, 2, 3, 1).reshape(o, -1)
    k = m.shape[1]
    return F.pad(m, (0, _up8(k) - k, 0, _up8(o) - o)).contiguous()


def _out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


class _Geometry:
    """One conv's shapes: the padded NHWC input's taps, the output size."""

    def __init__(self, x_shape, w_shape, stride, padding):
        _, self.c, h, w = x_shape
        self.o, _, self.kh, self.kw = w_shape
        self.sh, self.sw = _pair(stride)
        self.ph, self.pw = _pair(padding)
        self.ho = _out_size(h, self.kh, self.sh, self.ph)
        self.wo = _out_size(w, self.kw, self.sw, self.pw)
        self.kp = _up8(self.kh * self.kw * self.c)

    def chunks(self, n: int):
        """Image ranges whose im2col stays within CHUNK_BYTES."""
        step = max(1, CHUNK_BYTES // (self.ho * self.wo * self.kp))
        return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def _cols(xq: torch.Tensor, g: _Geometry) -> torch.Tensor:
    """int8 NCHW ``xq`` → its im2col ``[n·ho·wo, kp]`` (K in (kh, kw, C)
    order, zero columns past K): one copy of a strided view of the
    zero-padded NHWC input."""
    n = xq.shape[0]
    x = F.pad(xq.permute(0, 2, 3, 1), (0, 0, g.pw, g.pw, g.ph, g.ph))
    taps = x.unfold(1, g.kh, g.sh).unfold(2, g.kw, g.sw).permute(0, 1, 2, 4, 5, 3)
    k = g.kh * g.kw * g.c
    if g.kp == k:
        return taps.reshape(n * g.ho * g.wo, k)
    cols = x.new_zeros((n, g.ho, g.wo, g.kp))
    cols[..., :k].view(n, g.ho, g.wo, g.kh, g.kw, g.c).copy_(taps)
    return cols.view(n * g.ho * g.wo, g.kp)


def _int_mm(a: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ wm[N, K]ᵀ`` int8 → int32 ``[M, N]``; M of 16 or fewer
    rows is padded with zero rows (cuBLASLt takes more than 16)."""
    rows = a.shape[0]
    if rows <= 16:
        a = torch.cat([a, a.new_zeros((32 - rows, a.shape[1]))])
    return torch._int_mm(a, wm.t())[:rows]


def _int_blocks(xq_of, n: int, wq: torch.Tensor, g: _Geometry):
    """The int path's product by chunks of images: for each ``(lo, hi)`` of
    ``g.chunks(n)``, ``(lo, hi, acc)`` with ``acc`` the int32 ``[(hi - lo)
    · ho · wo, O]`` product of ``xq_of(lo, hi)`` (int8 NCHW) and ``wq``."""
    wm = _weight_matrix(wq)
    for lo, hi in g.chunks(n):
        yield lo, hi, _int_mm(_cols(xq_of(lo, hi), g), wm)[:, :g.o]


def int_conv(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """The int path's product alone: int8 ``xq [N, C, H, W]`` ⊛ int8 ``wq
    [O, C, kh, kw]`` → int32 ``[N, O, ho, wo]`` (an NCHW view of NHWC
    memory)."""
    g = _Geometry(xq.shape, wq.shape, stride, padding)
    n = xq.shape[0]
    acc = torch.empty((n, g.ho, g.wo, g.o), dtype=torch.int32, device=xq.device)
    for lo, hi, block in _int_blocks(lambda lo, hi: xq[lo:hi], n, wq, g):
        acc[lo:hi] = block.view(hi - lo, g.ho, g.wo, g.o)
    return acc.permute(0, 3, 1, 2)


def int_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """The plain version of ``int_conv``: an f64 conv of the int values
    (exact: every sum is an integer below 2^53), as int32 NCHW."""
    return F.conv2d(xq.double(), wq.double(), None, stride, padding).to(torch.int32)


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, stride=1,
                padding=0, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 conv of float ``x [N, C, H, W]`` with float ``w [O, C, kh,
    kw]`` (JAX's ``_int8_conv_call``): ``[N, O, ho, wo]`` in ``out_dtype``
    (default ``x.dtype``), an NCHW view of NHWC memory."""
    g = _Geometry(x.shape, w.shape, stride, padding)
    d, sx, wq, sw = conv_scales(x, w)
    scale = sx * sw
    b32 = None if bias is None else bias.float()
    n = x.shape[0]
    out = torch.empty((n, g.ho, g.wo, g.o), dtype=out_dtype or x.dtype, device=x.device)
    for lo, hi, acc in _int_blocks(lambda lo, hi: quantize_input(x[lo:hi], d), n, wq, g):
        y = acc.float() * scale
        if b32 is not None:
            y = y + b32
        out[lo:hi] = y.view(hi - lo, g.ho, g.wo, g.o)
    LAUNCH_COUNTS["int8_conv"] += 1
    return out.permute(0, 3, 1, 2)
