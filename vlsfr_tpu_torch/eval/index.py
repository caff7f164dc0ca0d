"""Gallery index for large-scale 1:N identification, the serving path
(port of ``vlsfr_tpu/eval/index.py``).

* **Streaming tiled search.** Cosine scores are formed one tile of gallery
  rows at a time with a running top-k, so the [Q, G] score matrix never
  exists: each tile takes an exact ``torch.topk``, then the carried and the
  new candidates are merged exactly (a stable sort of the 2k: a tie keeps
  the lower gallery row, as ``lax.top_k`` does). JAX's per-tile reduction
  is ``approx_max_k``, which on the CPU returns ``lax.top_k``'s values and
  indices; the tests hold the port to it index for index.
* **Padding.** Rows are padded to a multiple of the tile (times the mesh's
  ``model`` ranks); padding rows are masked by their global row id, and a
  masked candidate carries row -1, so rows and labels beyond the gallery
  come back as -1 whatever the ties among masked scores.
* **Int8 storage** (``int8=True``, or ``from_arrays`` with ``scales``):
  symmetric per-row int8 and an f32 scale. With a bf16 ``compute_dtype``
  a tile is dequantised as JAX rounds it, ``t.to(bf16) * scale.to(bf16)``
  rounded in bf16, and scored against bf16 queries with f32 sums.
* **Int8 compute** (``compute_dtype=torch.int8``, needs int8 storage): the
  queries are quantised as JAX does (scale max|q| / 127, round half to
  even, clip to ±127), scored int8 × int8 → int32 (``torch._int_mm``) and
  rescaled by ``qscale ⊗ row_scale`` in f32.
* **Sharding** (``mesh=``, ``parallel/mesh.py``): gallery rows are split
  over the ``model`` ranks, one contiguous block each; each rank streams
  its block into a local top-k, then one ``all_gather`` and a global top-k
  over the m·k candidates in rank order.

A float product's scores are f32 sums of bf16 (or f32) products: on the
card ``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS, bf16 operands,
f32 output), on the CPU an f32 product of the same bf16 values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vlsfr_tpu_torch.utils.device import resolve_device

MASKED = -1e30  # the score of a padding row and of an empty top-k slot


def _quantize_rows(g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[G, D] float rows → (int8 rows, f32 per-row scale)."""
    absmax = np.abs(g).max(axis=-1)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(g / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _float_scores(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[Q, D] × [T, D] → [Q, T] f32 sums of the operands' products."""
    if q.is_cuda:
        return torch.mm(q, w.t(), out_dtype=torch.float32)
    return torch.mm(q.float(), w.float().t())


def _int_scores(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[Q, D] × [T, D] int8 → [Q, T] int32 (cuBLAS takes more than 16
    rows: fewer are padded with zero rows on the card)."""
    rows = q.shape[0]
    if q.is_cuda and rows <= 16:
        q = torch.cat([q, q.new_zeros((32 - rows, q.shape[1]))])
    return torch._int_mm(q, t.t())[:rows]


def _top_k(vals: torch.Tensor, idx: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, ties to the earlier column."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return vals.gather(1, order), idx.gather(1, order)


class FaceIndex:
    """Append-then-search cosine index over L2-normalised embeddings.

    Args:
      feat_dim: embedding dimension.
      mesh: optional ``parallel.mesh.Mesh``; gallery rows split over its
        ``model`` ranks (each rank builds the same index and keeps its block).
      int8: store the gallery int8 + per-row scale.
      tile: gallery rows scored per step (the [Q, tile] score block).
      compute_dtype: ``torch.bfloat16`` (default) or ``torch.float32``
        operands; ``torch.int8`` (needs ``int8``) quantises the queries too.
      recall_target: JAX's per-tile recall target for ``approx_max_k``,
        kept as ``self.recall_target`` for API parity; it must be above 0.
        The port's per-tile ``torch.topk`` is exact, so it meets any
        target: a value below 1 selects no approximate pick here.
      device: ``cuda`` unless the caller asks for the CPU.
    """

    def __init__(self, feat_dim: int, mesh=None, int8: bool = False, tile: int = 65536,
                 compute_dtype: torch.dtype = torch.bfloat16, recall_target: float = 0.95,
                 device=None):
        if compute_dtype == torch.int8 and not int8:
            raise ValueError("compute_dtype=int8 requires int8=True "
                             "(the gallery must be stored quantized)")
        self.feat_dim = feat_dim
        self.mesh = mesh
        self.int8 = int8
        self.tile = tile
        self.compute_dtype = compute_dtype
        if not recall_target > 0:
            raise ValueError(f"recall_target must be above 0, got {recall_target}")
        self.recall_target = recall_target
        self.device = resolve_device(device)
        self._embs: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []
        self._gallery = None
        self._scales = None
        self._gallery_labels = np.zeros(0, np.int64)
        self._n_rows = 0
        self._tile = tile

    @property
    def _ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.model

    def _padding(self, g_rows: int) -> tuple[int, int]:
        """(the tile, the rows to pad): the whole gallery pads to a
        multiple of tile × ranks, the tile to whole 128-row blocks."""
        m = self._ranks
        tile = max(128, min(self.tile, -(-max(g_rows, 1) // (128 * m)) * 128))
        return tile, (-g_rows) % (tile * m)

    def _place(self, gallery, scales, g_rows: int) -> None:
        """Pad the whole gallery (scales of padding rows 1), keep this
        rank's block on the device."""
        m = self._ranks
        tile = self._padding(g_rows)[0]
        pad = (-gallery.shape[0]) % (tile * m)
        if pad:
            gallery = torch.cat([gallery, gallery.new_zeros((pad, gallery.shape[1]))])
            if scales is not None:
                scales = torch.cat([scales, scales.new_ones(pad)])
        if m > 1:
            n = gallery.shape[0] // m
            lo = self.mesh.rank * n
            gallery = gallery[lo:lo + n]
            scales = None if scales is None else scales[lo:lo + n]
        self._gallery = gallery.to(self.device).contiguous()
        self._scales = None if scales is None else scales.to(self.device, torch.float32)
        self._n_rows, self._tile = g_rows, tile

    @classmethod
    def from_arrays(cls, gallery, labels, scales=None, *, mesh=None, tile: int = 65536,
                    compute_dtype: torch.dtype = torch.bfloat16, recall_target: float = 0.95,
                    device=None) -> "FaceIndex":
        """Wrap a prebuilt gallery (quantised offline, restored, or already
        on the device) without ``add``'s concatenate and re-quantise.

        ``gallery`` [G, D] (numpy or a tensor): with ``scales`` [G] (row ≈
        scale · int8 row) int8 rows used as they are; without, float rows,
        assumed L2-normalised, stored as ``compute_dtype``. ``labels`` [G]
        integer identities."""
        int8 = scales is not None
        g_rows, d = gallery.shape
        self = cls(feat_dim=d, mesh=mesh, int8=int8, tile=tile, compute_dtype=compute_dtype,
                   recall_target=recall_target, device=device)
        gallery = torch.as_tensor(gallery)
        if int8 and gallery.dtype != torch.int8:
            raise ValueError(f"scales given but gallery dtype is {gallery.dtype}, expected int8")
        if not int8:
            gallery = gallery.to(compute_dtype)
        self._place(gallery, None if scales is None else torch.as_tensor(scales), g_rows)
        self._gallery_labels = np.asarray(labels, np.int64)
        return self

    @property
    def gallery(self) -> torch.Tensor:
        """The device gallery rows (this rank's block, padded)."""
        if self._gallery is None:
            self._build()
        return self._gallery

    @property
    def row_scales(self) -> torch.Tensor | None:
        """Per-row int8 dequant scales (None for float galleries)."""
        if self._gallery is None:
            self._build()
        return self._scales

    def add(self, embeddings: np.ndarray, labels: np.ndarray) -> None:
        if embeddings.shape[1] != self.feat_dim:
            raise ValueError(f"embeddings of width {embeddings.shape[1]}, index of {self.feat_dim}")
        e = embeddings / np.maximum(np.linalg.norm(embeddings, axis=-1, keepdims=True), 1e-12)
        self._embs.append(e.astype(np.float32))
        self._labels.append(np.asarray(labels, np.int64))
        self._gallery = None  # rebuilt at the next search

    def __len__(self) -> int:
        return sum(len(x) for x in self._labels)

    def nbytes(self) -> int:
        """Device bytes this rank's gallery block occupies."""
        if self._gallery is None:
            self._build()
        n = self._gallery.numel() * self._gallery.element_size()
        if self._scales is not None:
            n += self._scales.numel() * self._scales.element_size()
        return n

    def _build(self) -> None:
        g = (np.concatenate(self._embs) if self._embs
             else np.zeros((0, self.feat_dim), np.float32))
        self._gallery_labels = (np.concatenate(self._labels) if self._labels
                                else np.zeros(0, np.int64))
        n = g.shape[0]
        g = np.concatenate([g, np.zeros((self._padding(n)[1], self.feat_dim), np.float32)])
        if self.int8:  # padding rows quantised with the rest, as JAX does
            rows, scales = _quantize_rows(g)
            self._place(torch.from_numpy(rows), torch.from_numpy(scales), n)
        else:
            self._place(torch.from_numpy(g).to(self.compute_dtype), None, n)

    def _prep(self, queries: torch.Tensor):
        """→ (product-ready queries, per-row query scale | None)."""
        if self.compute_dtype != torch.int8:
            return queries.to(self.compute_dtype), None
        qs = torch.clamp(queries.abs().amax(-1), min=1e-12) / 127.0
        qi = torch.clamp(torch.round(queries / qs[:, None]), -127, 127).to(torch.int8)
        return qi, qs

    def _stream(self, q: torch.Tensor, qscale, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The running top-k over this rank's gallery block, as global rows
        (-1 for a masked candidate)."""
        g, s, tile = self._gallery, self._scales, self._tile
        row0 = 0 if self.mesh is None else self.mesh.rank * g.shape[0]
        vals = torch.full((q.shape[0], k), MASKED, device=q.device)
        idx = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
        for lo in range(0, g.shape[0], tile):
            t = g[lo:lo + tile]
            if qscale is not None:  # int8 × int8 → int32, rescaled in f32
                z = _int_scores(q, t).float() * qscale[:, None] * s[None, lo:lo + tile]
            else:
                w = t.to(self.compute_dtype)
                if s is not None:  # JAX's rounding: the scaled row in the compute dtype
                    w = w * s[lo:lo + tile, None].to(self.compute_dtype)
                z = _float_scores(q, w)
            gid = torch.arange(row0 + lo, row0 + lo + tile, device=q.device)
            gid = torch.where(gid < self._n_rows, gid, -1)
            z = torch.where(gid[None, :] >= 0, z, MASKED)
            if k < tile:
                tv, tp = torch.topk(z, k, dim=1)
            else:  # k >= tile rows: every column of the tile is a candidate
                tv, tp = z, torch.arange(tile, device=q.device).expand(z.shape)
            vals, idx = _top_k(torch.cat([vals, tv], 1), torch.cat([idx, gid[tp]], 1), k)
        return vals, idx

    def search(self, queries: np.ndarray, k: int = 1):
        """Returns (scores [Q, k], gallery row [Q, k], labels [Q, k]) as
        numpy; row and label are -1 (score -inf) for slots beyond the
        gallery size."""
        if self._gallery is None:
            self._build()
        q = queries / np.maximum(np.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
        if self._n_rows == 0:
            z = np.full((len(q), k), -1, np.int64)
            return np.full((len(q), k), -np.inf, np.float32), z, z
        with torch.inference_mode():
            qt, qscale = self._prep(torch.as_tensor(q, dtype=torch.float32).to(self.device))
            vals, idx = self._stream(qt, qscale, k)
            if self._ranks > 1:  # one gather, then the global top-k over m·k in rank order
                group, m = self.mesh.group, self.mesh.model
                all_v = [torch.empty_like(vals) for _ in range(m)]
                all_i = [torch.empty_like(idx) for _ in range(m)]
                dist.all_gather(all_v, vals, group=group)
                dist.all_gather(all_i, idx, group=group)
                vals, idx = _top_k(torch.cat(all_v, 1), torch.cat(all_i, 1), k)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        valid = idx >= 0
        labels = np.where(valid, self._gallery_labels[np.maximum(idx, 0)], -1)
        return np.where(valid, vals, -np.inf), np.where(valid, idx, -1), labels

    def identify(self, queries: np.ndarray, threshold: float = 0.0) -> np.ndarray:
        """Top-1 label per query, -1 when below the accept threshold."""
        vals, _, labels = self.search(queries, k=1)
        return np.where(vals[:, 0] >= threshold, labels[:, 0], -1)
