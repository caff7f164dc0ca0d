"""Synthetic identity store in RAW pixels (port of
``vlsfr_tpu/data/synthetic.py``).

The JAX generator JPEG-encodes through ``cv2``; the port writes raw uint8
HWC payloads instead (``encode_raw``), so generating and reading a store
needs numpy only. Each identity gets a smooth random base pattern; each of
its images is the base plus noise and a brightness shift (``hard=True``:
identities are perturbations of a shared low-dimensional manifold).
Deterministic given (seed, num_ids, images_per_id, image_size).
"""

from __future__ import annotations

import numpy as np

from vlsfr_tpu_torch.data.records import FaceRecordWriter

RAW_MAGIC = b"VRAW"


def encode_raw(img: np.ndarray) -> bytes:
    """uint8 HWC image → payload: magic + u32 (h, w, c) + pixel bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    return RAW_MAGIC + np.asarray([h, w, c], dtype="<u4").tobytes() + img.tobytes()


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """float HWC → [size, size, C] float32, bilinear with half-pixel
    centres (the sampling rule of cv2.INTER_LINEAR)."""
    img = np.asarray(img, np.float32)

    def axis(n):
        src = np.clip((np.arange(size) + 0.5) * n / size - 0.5, 0, n - 1)
        i0 = np.floor(src).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        return i0, i1, (src - i0).astype(np.float32)

    r0, r1, wr = axis(img.shape[0])
    c0, c1, wc = axis(img.shape[1])
    rows = img[r0] * (1 - wr)[:, None, None] + img[r1] * wr[:, None, None]
    return rows[:, c0] * (1 - wc)[None, :, None] + rows[:, c1] * wc[None, :, None]


def generate_synthetic_store(
    directory: str,
    num_ids: int = 10,
    images_per_id: int = 4,
    image_size: int = 112,
    seed: int = 0,
    db_name: str = "syn",
    hard: bool = False,
) -> str:
    rng = np.random.default_rng(seed)
    if hard:
        k = 8  # shared basis patterns
        basis = rng.uniform(-1, 1, size=(k, 8, 8, 3)).astype(np.float32)
        mean_coef = rng.uniform(-1, 1, size=k).astype(np.float32)
        id_spread = 0.5

        def render(coef):
            low = np.tensordot(coef, basis, axes=1)
            low = 127.5 + 60.0 * low / max(np.abs(low).max(), 1e-6)
            return resize_bilinear(low, image_size)

    with FaceRecordWriter(directory) as w:
        for ident in range(num_ids):
            if hard:
                coef = mean_coef + id_spread * rng.standard_normal(k).astype(np.float32)
                base = render(coef)
            else:
                low = rng.uniform(0, 255, size=(8, 8, 3)).astype(np.float32)
                base = resize_bilinear(low, image_size)
            for j in range(images_per_id):
                if hard:
                    img = base * rng.uniform(0.9, 1.1) + rng.uniform(-12, 12)
                    img = img + rng.normal(0, 10, size=img.shape)
                else:
                    img = base + rng.normal(0, 12, size=base.shape) + rng.uniform(-20, 20)
                img = np.clip(img, 0, 255).astype(np.uint8)
                w.add(f"{db_name}_{ident}_{j}", ident, encode_raw(img))
    return directory
