"""Input pipelines: deterministic samplers, host decode, async prefetch
(port of ``vlsfr_tpu/data/pipeline.py``).

Per-step FFC batch composition (reference main.py:53-60):

    x = [pair_img1 ; instance_half1]   x_label = [pair_ids ; labels_half1]
    y = [pair_img2 ; instance_half2]   y_label = [pair_ids ; labels_half2]

The full-softmax head takes plain (image, label) batches from
``InstancePipeline``. ``InstanceStream`` and ``PairStream`` are the JAX
package's index plans, keyed on ``(seed, epoch, step)`` with the same
counter-based numpy RNG, so both packages draw identical records and flips
for a step (tests/test_torch_dcp_data.py). Decode reads the raw payloads written by
``data/synthetic.py``; a JPEG payload needs ``cv2`` and raises a clear
error without it. Batches are NHWC float32, normalised (x − 127.5)/128.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from vlsfr_tpu_torch.data.records import MultiSourceReader
from vlsfr_tpu_torch.data.synthetic import RAW_MAGIC, resize_bilinear


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(entropy=key))


def _decode_jpeg(payload: bytes) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "this record store holds JPEG payloads, which need cv2 to decode; "
            "cv2 is not installed — write the store with raw payloads "
            "(vlsfr_tpu_torch.data.synthetic.encode_raw)") from e
    img = cv2.imdecode(np.frombuffer(payload, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError("failed to decode JPEG payload")
    return img


def decode_image(payload: bytes, image_size: int) -> np.ndarray:
    """Payload → HWC uint8 (3 channels) at ``image_size``²."""
    if payload[:4] == RAW_MAGIC:
        h, w, c = (int(v) for v in np.frombuffer(payload[4:16], dtype="<u4"))
        img = np.frombuffer(payload[16:], dtype=np.uint8).reshape(h, w, c)
    else:
        img = _decode_jpeg(payload)
    if img.ndim == 2:  # grayscale → replicate
        img = np.stack([img] * 3, axis=-1)
    elif img.shape[-1] == 4:
        img = img[..., :3]
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[0] != image_size or img.shape[1] != image_size:
        img = np.clip(np.rint(resize_bilinear(img, image_size)), 0, 255).astype(np.uint8)
    return img


def normalize(img: np.ndarray, flip: bool) -> np.ndarray:
    """Flip + (x−127.5)/128 to float32, HWC."""
    if flip:
        img = img[:, ::-1, :]
    out = np.multiply(img, np.float32(0.0078125), dtype=np.float32)
    out -= np.float32(127.5 * 0.0078125)
    return out


class InstanceStream:
    """Uniformly shuffled single-image index stream, one permutation per
    epoch. ``record_limit`` keeps the store's tail out of training."""

    def __init__(self, reader: MultiSourceReader, batch_size: int, seed: int,
                 record_limit: int | None = None):
        self.reader = reader
        self.batch_size = batch_size
        self.seed = seed
        self.n_records = record_limit if record_limit else len(reader)
        self._perm_cache: tuple[int, np.ndarray] | None = None

    def steps_per_epoch(self) -> int:
        return self.n_records // self.batch_size

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self._perm_cache is None or self._perm_cache[0] != epoch:
            self._perm_cache = (epoch, _rng(self.seed, epoch, 0x1157).permutation(self.n_records))
        return self._perm_cache[1]

    def batch_indices(self, epoch: int, step: int) -> np.ndarray:
        perm = self.epoch_indices(epoch)
        lo = step * self.batch_size
        return perm[lo : lo + self.batch_size]


class PairStream:
    """Identity-pair stream: each element is an identity; two of its images
    are sampled (the same image twice when it has only one)."""

    def __init__(self, reader: MultiSourceReader, batch_size: int, seed: int,
                 record_limit: int | None = None):
        self.reader = reader
        self.batch_size = batch_size
        self.seed = seed
        by_id = reader.labels_by_identity()
        if record_limit:
            by_id = {i: [r for r in recs if r < record_limit] for i, recs in by_id.items()}
            by_id = {i: recs for i, recs in by_id.items() if recs}
        self.identities = np.asarray(list(by_id.keys()))
        self.id_records = [by_id[int(i)] for i in self.identities]
        self._perm_cache: tuple[tuple, np.ndarray] | None = None

    def steps_per_epoch(self) -> int:
        return max(len(self.identities) // self.batch_size, 1)

    def batch(self, epoch: int, step: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(labels[b], rec1[b], rec2[b]); wraps around within the epoch."""
        b = self.batch_size
        spe = self.steps_per_epoch()
        sub_epoch, sub_step = divmod(step, spe)
        key = (epoch, sub_epoch)
        if self._perm_cache is None or self._perm_cache[0] != key:
            self._perm_cache = (
                key, _rng(self.seed, epoch, sub_epoch, 0x9A12).permutation(len(self.identities))
            )
        perm = self._perm_cache[1]
        chosen = perm[sub_step * b : sub_step * b + b]
        if len(chosen) < b:  # wrap around, over as many passes as it takes
            chosen = np.concatenate([chosen, np.resize(perm, b - len(chosen))])
        labels = self.identities[chosen]
        rec1 = np.empty(b, dtype=np.int64)
        rec2 = np.empty(b, dtype=np.int64)
        r = _rng(self.seed, epoch, step, 0x77)
        for k, ident_idx in enumerate(chosen):
            recs = self.id_records[int(ident_idx)]
            n = len(recs)
            if n >= 2:
                i1 = int(r.integers(n))
                i2 = int(r.integers(n - 1))
                i2 += i2 >= i1  # distinct second pick
                rec1[k], rec2[k] = recs[i1], recs[i2]
            else:
                rec1[k] = rec2[k] = recs[0]
        return labels, rec1, rec2


@dataclass
class FFCBatch:
    """One composed FFC step batch (host numpy, NHWC)."""

    x: np.ndarray  # [B, H, W, 3] float32
    y: np.ndarray  # [B, H, W, 3] float32
    x_label: np.ndarray  # [B] int32
    y_label: np.ndarray  # [B] int32
    epoch: int
    step: int


class FFCPipeline:
    """Composes instance + pair streams into FFC batches; a producer thread
    keeps ``prefetch`` batches ready while the device runs."""

    def __init__(self, reader: MultiSourceReader, batch_size: int, image_size: int,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 record_limit: int | None = None):
        if batch_size % 2:
            raise ValueError("FFC batch composition needs an even batch")
        self.reader = reader
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.instance = InstanceStream(reader, batch_size, seed, record_limit=record_limit)
        self.pairs = PairStream(reader, batch_size // 2, seed, record_limit=record_limit)
        self.pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self.prefetch = prefetch

    def steps_per_epoch(self) -> int:
        return self.instance.steps_per_epoch()

    def _load_one(self, rec: int, flip: bool) -> np.ndarray:
        return normalize(decode_image(self.reader.payload(int(rec)), self.image_size), flip)

    def batch_plan(self, epoch: int, step: int):
        """(x_recs, y_recs, flips_x, flips_y, x_label, y_label) of a step."""
        b = self.batch_size
        half = b // 2
        ins = self.instance.batch_indices(epoch, step)
        ins_labels = np.asarray(self.reader.labels[ins])
        pair_labels, rec1, rec2 = self.pairs.batch(epoch, step)
        x_recs = np.concatenate([rec1, ins[:half]])
        y_recs = np.concatenate([rec2, ins[half:]])
        flips_x = _rng(self.seed, epoch, step, 0xF11).random(b) < 0.5
        flips_y = _rng(self.seed, epoch, step, 0xF13).random(b) < 0.5
        x_label = np.concatenate([pair_labels, ins_labels[:half]]).astype(np.int32)
        y_label = np.concatenate([pair_labels, ins_labels[half:]]).astype(np.int32)
        return x_recs, y_recs, flips_x, flips_y, x_label, y_label

    def make_batch(self, epoch: int, step: int) -> FFCBatch:
        x_recs, y_recs, flips_x, flips_y, x_label, y_label = self.batch_plan(epoch, step)
        imgs = list(self.pool.map(self._load_one, np.concatenate([x_recs, y_recs]),
                                  np.concatenate([flips_x, flips_y])))
        n = len(imgs) // 2
        return FFCBatch(x=np.stack(imgs[:n]), y=np.stack(imgs[n:]),
                        x_label=x_label, y_label=y_label, epoch=epoch, step=step)

    def epoch_iter(self, epoch: int, start_step: int = 0, stop_step: int | None = None):
        """Yield FFCBatch for steps [start_step, stop_step) of ``epoch``
        (default: to the end of the epoch) with background prefetch."""
        return _prefetch_iter(self, epoch, start_step, stop_step)

    def close(self):
        self.pool.shutdown(wait=True)


def _prefetch_iter(pipe, epoch: int, start_step: int, stop_step: int | None):
    """Batches ``pipe.make_batch(epoch, s)`` for s in [start_step, stop_step)
    (default: to the end of the epoch); a producer thread keeps
    ``pipe.prefetch`` of them ready while the device runs."""
    spe = pipe.steps_per_epoch()
    end = spe if stop_step is None else min(stop_step, spe)
    q: queue.Queue = queue.Queue(maxsize=max(pipe.prefetch, 1))
    stop = threading.Event()

    def producer():
        try:
            for s in range(start_step, end):
                if stop.is_set():
                    return
                q.put(pipe.make_batch(epoch, s))
            q.put(None)
        except BaseException as e:  # hand the failure to the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)


@dataclass
class InstanceBatch:
    """One full-softmax step batch (host numpy, NHWC)."""

    images: np.ndarray  # [B, H, W, 3] float32
    labels: np.ndarray  # [B] int32
    epoch: int
    step: int


class InstancePipeline:
    """Plain (image, label) batches for full-softmax training: the shuffled
    ``InstanceStream`` with a random flip per image."""

    def __init__(self, reader: MultiSourceReader, batch_size: int, image_size: int,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 record_limit: int | None = None):
        self.reader = reader
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.instance = InstanceStream(reader, batch_size, seed, record_limit=record_limit)
        self.pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self.prefetch = prefetch

    def steps_per_epoch(self) -> int:
        return self.instance.steps_per_epoch()

    def batch_plan(self, epoch: int, step: int):
        """(records, flips, labels) of a step."""
        idx = self.instance.batch_indices(epoch, step)
        labels = np.asarray(self.reader.labels[idx], dtype=np.int32)
        flips = _rng(self.seed, epoch, step, 0xF12).random(len(idx)) < 0.5
        return idx, flips, labels

    def make_batch(self, epoch: int, step: int) -> InstanceBatch:
        idx, flips, labels = self.batch_plan(epoch, step)
        imgs = list(self.pool.map(
            lambda rec, flip: normalize(decode_image(self.reader.payload(int(rec)),
                                                     self.image_size), flip), idx, flips))
        return InstanceBatch(images=np.stack(imgs), labels=labels, epoch=epoch, step=step)

    def epoch_iter(self, epoch: int, start_step: int = 0, stop_step: int | None = None):
        """Yield InstanceBatch for steps [start_step, stop_step) of ``epoch``."""
        return _prefetch_iter(self, epoch, start_step, stop_step)

    def close(self):
        self.pool.shutdown(wait=True)
