"""Face record store: append-only blob log + numpy index (port of
``vlsfr_tpu/data/records.py``, Python reader and writer only).

    <dir>/data.bin      concatenated image payloads
    <dir>/index.npz     offsets[u64], lengths[u32], labels[i64]
    <dir>/index.bin     flat binary twin of the index (native-reader format)
    <dir>/keys.txt      one record key per line (same order)
    <dir>/train_kv.txt  "key label" manifest, kept for reference-tool compat

The on-disk format is the JAX package's, so stores written by either
package open in both. ``MultiSourceReader`` re-bases labels across sources
with the reference loader's running-offset rule.
"""

from __future__ import annotations

import mmap
import os

import numpy as np


class FaceRecordWriter:
    """Streaming writer; call ``add`` per image then ``close``."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self._data = open(os.path.join(directory, "data.bin"), "wb")
        self._offsets: list[int] = []
        self._lengths: list[int] = []
        self._labels: list[int] = []
        self._keys: list[str] = []
        self._pos = 0

    def add(self, key: str, label: int, payload: bytes) -> None:
        self._data.write(payload)
        self._offsets.append(self._pos)
        self._lengths.append(len(payload))
        self._labels.append(int(label))
        self._keys.append(key)
        self._pos += len(payload)

    def close(self) -> None:
        self._data.close()
        offsets = np.asarray(self._offsets, dtype=np.uint64)
        lengths = np.asarray(self._lengths, dtype=np.uint32)
        labels = np.asarray(self._labels, dtype=np.int64)
        np.savez(os.path.join(self.dir, "index.npz"),
                 offsets=offsets, lengths=lengths, labels=labels)
        # header = magic "VLFR" + u32 version + u64 count, then the 3 arrays
        with open(os.path.join(self.dir, "index.bin"), "wb") as f:
            f.write(b"VLFR")
            f.write(np.uint32(1).tobytes())
            f.write(np.uint64(len(offsets)).tobytes())
            f.write(offsets.tobytes())
            f.write(lengths.tobytes())
            f.write(labels.tobytes())
        with open(os.path.join(self.dir, "keys.txt"), "w") as f:
            f.write("\n".join(self._keys) + ("\n" if self._keys else ""))
        with open(os.path.join(self.dir, "train_kv.txt"), "w") as f:
            for k, lab in zip(self._keys, self._labels):
                f.write(f"{k} {lab}\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FaceRecordReader:
    """mmap-backed random-access reader for one store."""

    def __init__(self, directory: str):
        self.dir = directory
        idx = np.load(os.path.join(directory, "index.npz"))
        self.offsets = idx["offsets"]
        self.lengths = idx["lengths"]
        self.labels = idx["labels"]
        self._file = open(os.path.join(directory, "data.bin"), "rb")
        size = os.path.getsize(os.path.join(directory, "data.bin"))
        self._mm = (
            mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ) if size else b""
        )

    def __len__(self) -> int:
        return len(self.offsets)

    def payload(self, i: int) -> bytes:
        o, n = int(self.offsets[i]), int(self.lengths[i])
        return bytes(self._mm[o : o + n])

    def close(self) -> None:
        if not isinstance(self._mm, bytes):
            self._mm.close()
        self._file.close()


class MultiSourceReader:
    """N stores presented as one dataset with re-based global labels: the
    labels of source k are shifted by the running ``last_label``; after
    each source, ``last_label = max_label + 1``."""

    def __init__(self, directories: list[str] | str):
        if isinstance(directories, str):
            directories = [directories]
        if not directories:
            raise ValueError("need at least one record-store source")
        self.sources: list[FaceRecordReader] = []
        last_label = 0
        max_label = 0
        counts = []
        all_labels = []
        for d in directories:
            r = FaceRecordReader(d)
            self.sources.append(r)
            if len(r):
                shifted = r.labels + last_label
                all_labels.append(shifted)
                max_label = max(max_label, int(shifted.max()))
            counts.append(len(r))
            if max_label != last_label or len(r):
                max_label += 1
                last_label = max_label
        self.num_class = last_label
        self._counts = np.asarray(counts)
        self._starts = np.concatenate([[0], np.cumsum(self._counts)])
        self.labels = (
            np.concatenate(all_labels) if all_labels else np.zeros(0, dtype=np.int64)
        )

    def __len__(self) -> int:
        return int(self._starts[-1])

    def payload(self, i: int) -> bytes:
        s = int(np.searchsorted(self._starts, i, side="right")) - 1
        return self.sources[s].payload(i - int(self._starts[s]))

    def labels_by_identity(self) -> dict[int, np.ndarray]:
        """identity -> record indices, in order of first appearance."""
        order: dict[int, list[int]] = {}
        for i, lab in enumerate(self.labels):
            order.setdefault(int(lab), []).append(i)
        return {k: np.asarray(v) for k, v in order.items()}

    def close(self) -> None:
        for r in self.sources:
            r.close()
