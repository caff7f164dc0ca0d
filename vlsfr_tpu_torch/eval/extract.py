"""Embedding extraction, the inference surface (port of
``vlsfr_tpu/eval/extract.py``).

``Embedder(model, batch_size, flip_average, device)`` runs a backbone in
eval mode under ``torch.inference_mode`` over fixed-size batches: the tail
batch is padded with zeros and its padded rows dropped (JAX pads so that
one compilation serves any dataset size; here every call has one shape, so
cuDNN keeps one algorithm). With ``flip_average`` each embedding is
``l2_normalize(e + e_flip)``, e_flip the embedding of the image flipped
along W (test-time augmentation). With ``int8`` both forwards run under
``ops.quant.int8_conv_inference()``: every ungrouped conv int8 × int8 →
int32 with dynamic scales (``ops/quant.py``), the depthwise ones in float.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vlsfr_tpu_torch.models.layers import l2_normalize
from vlsfr_tpu_torch.ops.quant import int8_conv_inference
from vlsfr_tpu_torch.utils.device import resolve_device


class Embedder:
    def __init__(self, model: torch.nn.Module, batch_size: int = 64, flip_average: bool = True,
                 device=None, int8: bool = False):
        """``model`` is a port backbone (its weights loaded); it is moved to
        ``device`` (``cuda`` unless the caller asks for the CPU) and run in
        eval mode, its own mode restored after each call; ``int8`` serves it
        on int8 convs."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.batch_size = batch_size
        self.flip_average = flip_average
        self.int8 = int8

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with int8_conv_inference() if self.int8 else contextlib.nullcontext():
            emb = self.model(x)
            if self.flip_average:
                emb = l2_normalize(emb + self.model(torch.flip(x, dims=[2])))
        return emb

    def __call__(self, images) -> np.ndarray:
        """[N, H, W, 3] float32 normalised pixels (numpy or a tensor) →
        [N, D] f32 embeddings (numpy)."""
        n = images.shape[0]
        out = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for lo in range(0, n, self.batch_size):
                    chunk = torch.as_tensor(images[lo:lo + self.batch_size])
                    rows = chunk.shape[0]
                    if rows < self.batch_size:
                        chunk = torch.cat([chunk, chunk.new_zeros(
                            (self.batch_size - rows, *chunk.shape[1:]))])
                    emb = self._forward(chunk.to(self.device, non_blocking=True))
                    out.append(emb[:rows].float().cpu().numpy())
        finally:
            self.model.train(was_training)
        return np.concatenate(out) if out else np.zeros((0, 0), np.float32)

    def from_reader(self, reader, image_size: int, indices=None) -> np.ndarray:
        """Embeddings of records of a store (decoded, normalised, no flip)."""
        from vlsfr_tpu_torch.data.pipeline import decode_image, normalize

        idx = range(len(reader)) if indices is None else indices
        imgs = np.stack(
            [normalize(decode_image(reader.payload(int(i)), image_size), False) for i in idx])
        return self(imgs)
