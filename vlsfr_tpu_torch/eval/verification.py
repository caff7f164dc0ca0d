"""Face verification (1:1) and identification (1:N) evaluation — the
port's own copy of ``vlsfr_tpu/eval/verification.py`` (numpy only; the
port imports nothing of the JAX package).

LFW-style protocol: cosine scores over labeled same/different pairs,
threshold selected per held-out fold (10-fold cross-validation), plus
TAR@FAR and rank-k identification. ``make_verification_pairs`` makes the
same numpy RNG calls as JAX's, so both packages draw the same pairs from a
seed; insightface ``.bin`` files decode through the port's
``data/pipeline.decode_image``.
"""

from __future__ import annotations

import numpy as np


def cosine_scores(e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity for paired embedding matrices [N, D]."""
    a = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-12)
    b = e2 / np.maximum(np.linalg.norm(e2, axis=-1, keepdims=True), 1e-12)
    return np.sum(a * b, axis=-1)


def _accuracy_at(scores, labels, thr) -> float:
    pred = scores >= thr
    return float(np.mean(pred == labels.astype(bool)))


def best_threshold(scores: np.ndarray, labels: np.ndarray, grid: int = 400) -> tuple[float, float]:
    """(threshold, accuracy) maximizing accuracy over a cosine grid."""
    thrs = np.linspace(-1.0, 1.0, grid)
    accs = [(_accuracy_at(scores, labels, t), t) for t in thrs]
    acc, thr = max(accs)
    return thr, acc


def kfold_verification_accuracy(
    scores: np.ndarray, labels: np.ndarray, folds: int = 10, seed: int = 0
) -> tuple[float, float]:
    """LFW protocol: per fold, pick the threshold on the other folds, report
    held-out accuracy. Returns (mean, std)."""
    n = len(scores)
    folds = max(2, min(folds, n))  # degenerate small sets: no empty folds
    order = np.random.default_rng(seed).permutation(n)
    splits = np.array_split(order, folds)
    accs = []
    for k in range(folds):
        test = splits[k]
        train = np.concatenate([splits[i] for i in range(folds) if i != k])
        thr, _ = best_threshold(scores[train], labels[train])
        accs.append(_accuracy_at(scores[test], labels[test], thr))
    return float(np.mean(accs)), float(np.std(accs))


def tar_at_far(scores: np.ndarray, labels: np.ndarray, far: float = 1e-3) -> float:
    """True-accept rate at the threshold giving the requested false-accept rate."""
    pos = scores[labels.astype(bool)]
    neg = scores[~labels.astype(bool)]
    if len(neg) == 0 or len(pos) == 0:
        return float("nan")
    thr = np.quantile(neg, 1.0 - far)
    return float(np.mean(pos >= thr))


def identification_topk(
    gallery_emb: np.ndarray,
    gallery_labels: np.ndarray,
    probe_emb: np.ndarray,
    probe_labels: np.ndarray,
    k: int = 1,
) -> float:
    """Rank-k identification accuracy (1:N closed set)."""
    g = gallery_emb / np.maximum(np.linalg.norm(gallery_emb, axis=-1, keepdims=True), 1e-12)
    p = probe_emb / np.maximum(np.linalg.norm(probe_emb, axis=-1, keepdims=True), 1e-12)
    sims = p @ g.T  # [P, G]
    topk = np.argsort(-sims, axis=-1)[:, :k]
    hits = (gallery_labels[topk] == probe_labels[:, None]).any(axis=-1)
    return float(np.mean(hits))


def load_insightface_bin(path: str, image_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Load an insightface-style verification ``.bin`` (lfw.bin, cfp_fp.bin,
    agedb_30.bin…): a pickle of (encoded_image_bins, issame_list) where
    consecutive image pairs share one issame flag.

    Returns (images [2N, H, W, 3] float32 normalized, issame [N] int32).
    The ecosystem-standard eval format — the reference has no eval at all.
    """
    import pickle

    from vlsfr_tpu_torch.data.pipeline import decode_image, normalize

    with open(path, "rb") as f:
        bins, issame = pickle.load(f, encoding="bytes")
    imgs = np.stack(
        [normalize(decode_image(bytes(b), image_size), False) for b in bins]
    )
    return imgs, np.asarray(issame, dtype=np.int32)


def save_insightface_bin(path: str, payloads: list[bytes], issame: np.ndarray) -> None:
    """Write an insightface-style verification ``.bin``: a pickle of
    (encoded_image_bins, issame_list). ``payloads`` are encoded (JPEG/PNG)
    image bytes, pair-interleaved: images 2i and 2i+1 form pair i with flag
    ``issame[i]``. Round-trips through :func:`load_insightface_bin` —
    lets any record store be exported as a standard verification set."""
    import pickle

    assert len(payloads) == 2 * len(issame), (len(payloads), len(issame))
    with open(path, "wb") as f:
        pickle.dump((list(payloads), [bool(s) for s in issame]), f)


def make_bin_from_store(
    store_dirs: list[str], out_path: str, num_pairs: int, seed: int = 0
) -> int:
    """Export balanced verification pairs from record store(s) into a ``.bin``
    (the ecosystem-standard eval format). Returns the number of pairs."""
    from vlsfr_tpu_torch.data.records import MultiSourceReader

    reader = MultiSourceReader(store_dirs)
    labels = np.asarray(reader.labels)
    i1, i2, issame = make_verification_pairs(labels, num_pairs, seed=seed)
    payloads = []
    for a, b in zip(i1, i2):
        payloads.append(reader.payload(int(a)))
        payloads.append(reader.payload(int(b)))
    save_insightface_bin(out_path, payloads, issame)
    reader.close()
    return len(issame)


def evaluate_bin(embedder, path: str, image_size: int) -> dict:
    """Run the full verification protocol on a .bin file with the given
    Embedder (flip-TTA included). Returns accuracy/TAR metrics."""
    imgs, issame = load_insightface_bin(path, image_size)
    emb = embedder(imgs)
    scores = cosine_scores(emb[0::2], emb[1::2])
    acc, std = kfold_verification_accuracy(scores, issame)
    return {
        "verification_acc": acc,
        "verification_std": std,
        "tar_at_far1e-3": tar_at_far(scores, issame, 1e-3),
        "num_pairs": int(len(issame)),
    }


def make_verification_pairs(
    labels: np.ndarray, num_pairs: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample balanced same/different record-index pairs from a label vector.

    Returns (idx1, idx2, issame) with num_pairs//2 positives + negatives.
    """
    rng = np.random.default_rng(seed)
    by_label: dict[int, list[int]] = {}
    for i, l in enumerate(labels):
        by_label.setdefault(int(l), []).append(i)
    multi = [l for l, v in by_label.items() if len(v) >= 2]
    all_labels = list(by_label.keys())
    assert len(multi) >= 1 and len(all_labels) >= 2, "need >=2 ids, one with >=2 images"
    half = num_pairs // 2
    i1, i2, same = [], [], []
    for _ in range(half):
        l = multi[rng.integers(len(multi))]
        a, b = rng.choice(by_label[l], size=2, replace=False)
        i1.append(a), i2.append(b), same.append(1)
    for _ in range(half):
        la, lb = rng.choice(all_labels, size=2, replace=False)
        i1.append(rng.choice(by_label[int(la)]))
        i2.append(rng.choice(by_label[int(lb)]))
        same.append(0)
    return np.asarray(i1), np.asarray(i2), np.asarray(same, dtype=np.int32)
