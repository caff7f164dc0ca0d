"""The port's eval and serving path (``vlsfr_tpu_torch/eval/``, the
trainer's ``evaluate``, ``tools/evaluate.py``) against the JAX package's,
on the same numpy inputs.

* Verification functions: the same values (bit for bit: the same numpy
  code), the same pairs from a seed, the same ``.bin`` round trip.
* ``Embedder``: a toy net with JAX's weights carried by ``from_jax``,
  against JAX's ``Embedder`` with tail padding, with and without flip;
  embeddings at ``EMB_ATOL`` (2e-5, f32 convolutions summed in other
  orders, as ``tests/test_torch_models.py``).
* ``FaceIndex``: at ``recall_target=0.95`` against JAX's exact pick
  (``recall_target=1.0``); against JAX's at its defaults (``approx_max_k`` per tile,
  which on the CPU returns ``lax.top_k``'s values and indices) in bf16,
  int8 storage, int8 compute, ``k`` beyond the gallery, ``k`` at or above
  the tile, ``from_arrays`` with float and int8 rows and padding: rows and
  labels equal, scores within ``SCORE_ATOL`` (1e-5: f32 sums of the same
  bf16 or int8-scaled products in another order); at 2 gloo ranks against
  the single-device index (rows equal, scores 1e-6).
* The trainer's in-training eval against JAX's ``Trainer.evaluate`` on one
  JPEG store with JAX's weights carried over: the same record indices and
  pairs, scores within ``COS_ATOL`` (1e-4: cosines of embeddings each
  within EMB_ATOL), ``eval_use_ema`` selecting the gallery net.

The spawned ranks import this module by name, so every JAX import sits
inside a test or a helper.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vlsfr_tpu_torch.eval import extract as textract
from vlsfr_tpu_torch.eval import verification as tver
from vlsfr_tpu_torch.eval.index import FaceIndex
from vlsfr_tpu_torch.parallel import distributed

EMB_ATOL = 2e-5
SCORE_ATOL = 1e-5
COS_ATOL = 1e-4


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ----------------------------------------------------------------------
# verification functions
# ----------------------------------------------------------------------


def test_verification_functions_match_jax(rng):
    from vlsfr_tpu.eval import verification as jver

    e1, e2 = rng.standard_normal((2, 300, 24)).astype(np.float32)
    labels = (rng.random(300) < 0.5).astype(np.int32)
    s_t, s_j = tver.cosine_scores(e1, e2), jver.cosine_scores(e1, e2)
    np.testing.assert_array_equal(s_t, s_j)
    assert tver.best_threshold(s_t, labels) == jver.best_threshold(s_j, labels)
    for folds, seed in ((10, 0), (5, 3)):
        assert tver.kfold_verification_accuracy(s_t, labels, folds, seed) == \
            jver.kfold_verification_accuracy(s_j, labels, folds, seed)
    for far in (1e-3, 0.1):
        assert tver.tar_at_far(s_t, labels, far) == jver.tar_at_far(s_j, labels, far)
    g, p = rng.standard_normal((2, 40, 24)).astype(np.float32)
    gl, pl = rng.integers(0, 10, 40), rng.integers(0, 10, 40)
    for k in (1, 5):
        assert tver.identification_topk(g, gl, p, pl, k) == jver.identification_topk(g, gl, p,
                                                                                    pl, k)
    ids = rng.integers(0, 30, 500)
    for got, want in zip(tver.make_verification_pairs(ids, 200, seed=7),
                         jver.make_verification_pairs(ids, 200, seed=7)):
        np.testing.assert_array_equal(got, want)


def _png(img):
    import cv2

    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def test_insightface_bin_round_trip_matches_jax(rng, tmp_path):
    """``save_insightface_bin`` → ``load_insightface_bin``: the port's and
    JAX's loaders give the same images (PNG payloads at the target size,
    decoded by cv2 in both) and flags; ``make_bin_from_store`` writes the
    pairs ``make_verification_pairs`` draws."""
    from vlsfr_tpu.eval import verification as jver

    imgs = rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    issame = np.asarray([1, 0, 1, 1])
    path = str(tmp_path / "pairs.bin")
    tver.save_insightface_bin(path, [_png(x) for x in imgs], issame)
    got, got_same = tver.load_insightface_bin(path, 16)
    want, want_same = jver.load_insightface_bin(path, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_same, want_same)

    from vlsfr_tpu_torch.data.records import FaceRecordWriter

    store = str(tmp_path / "store")
    with FaceRecordWriter(store) as w:
        for i, x in enumerate(imgs):
            w.add(f"k{i}", i // 2, _png(x))
    out = str(tmp_path / "store.bin")
    assert tver.make_bin_from_store([store], out, num_pairs=6, seed=1) == 6
    loaded, same = tver.load_insightface_bin(out, 16)
    i1, i2, want_same = tver.make_verification_pairs(np.arange(8) // 2, 6, seed=1)
    np.testing.assert_array_equal(same, want_same)
    np.testing.assert_array_equal(loaded[0::2], got[i1])  # got[i]: record i's image
    np.testing.assert_array_equal(loaded[1::2], got[i2])


# ----------------------------------------------------------------------
# Embedder
# ----------------------------------------------------------------------


def _toy_pair(feat_dim=16, size=16):
    """JAX's ToyNet, its variables, and the port's ToyNet holding them."""
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.models.toynet import ToyNet as JToyNet
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables
    from vlsfr_tpu_torch.models.toynet import ToyNet

    jm = JToyNet(feat_dim=feat_dim)
    v = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, size, size, 3)),
                               train=False))
    # running stats away from (0, 1), so eval mode is not the identity BN
    r = np.random.default_rng(11)
    stats = jax.tree.map(lambda a: (np.abs(r.standard_normal(a.shape)) * 0.5 + 0.5).astype(
        np.float32), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    tm = ToyNet(feat_dim=feat_dim)
    load_flax_variables(tm, v["params"], v["batch_stats"])
    return jm, v, tm


@pytest.mark.parametrize("flip", [True, False])
def test_embedder_matches_jax(flip, rng):
    from vlsfr_tpu.eval.extract import Embedder as JEmbedder

    jm, v, tm = _toy_pair()
    images = rng.standard_normal((11, 16, 16, 3)).astype(np.float32)  # 11 = 2 × 4 + a tail of 3
    want = JEmbedder(jm, v, batch_size=4, flip_average=flip)(images)
    tm.train()
    got = textract.Embedder(tm, batch_size=4, flip_average=flip, device="cpu")(images)
    assert tm.training  # the caller's mode is restored
    assert got.shape == want.shape == (11, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_embedder_runs_int8_and_needs_a_device_choice(rng):
    """``int8=True`` serves on int8 convs on the CPU (held to JAX's in
    tests/test_torch_quant.py): unit embeddings, not the float ones."""
    from vlsfr_tpu_torch.models.toynet import ToyNet

    net = ToyNet(feat_dim=8)
    images = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    got = textract.Embedder(net, batch_size=2, device="cpu", int8=True)(images)
    fp = textract.Embedder(net, batch_size=2, device="cpu")(images)
    assert got.shape == fp.shape == (3, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert not np.array_equal(got, fp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            textract.Embedder(ToyNet(feat_dim=8))


# ----------------------------------------------------------------------
# FaceIndex
# ----------------------------------------------------------------------

D = 32


def _index_cases(rng):
    """(name, builder(pkg) -> index, queries, k) over one gallery."""
    g = _unit(rng, 1000, D)
    labels = rng.integers(0, 500, 1000)
    queries = g[rng.integers(0, 1000, 20)] + 0.3 * rng.standard_normal((20, D)).astype(np.float32)
    queries = np.concatenate([queries, rng.standard_normal((5, D)).astype(np.float32)])
    g8 = rng.integers(-127, 128, (700, D), dtype=np.int8)
    s8 = (1.0 / np.linalg.norm(g8.astype(np.float32), axis=1)).astype(np.float32)
    small = _unit(rng, 7, D)

    def added(int8, cd):
        def build(pkg, **kw):
            idx = pkg.FaceIndex(D, int8=int8, tile=256, compute_dtype=cd(pkg), **kw)
            idx.add(g[:600] * 3.0, labels[:600])  # add() normalises
            idx.add(g[600:], labels[600:])
            return idx
        return build

    bf16 = lambda pkg: pkg.BF16  # noqa: E731
    i8 = lambda pkg: pkg.INT8  # noqa: E731
    return [
        ("bf16", added(False, bf16), queries, 5),
        ("int8_storage", added(True, bf16), queries, 5),
        ("int8_compute", added(True, i8), queries, 5),
        ("k_beyond_gallery", lambda pkg, **kw: _small(pkg, small, **kw), queries, 10),
        ("k_at_tile", lambda pkg, **kw: pkg.FaceIndex.from_arrays(
            g[:300], labels[:300], tile=128, compute_dtype=pkg.BF16, **kw), queries, 130),
        ("from_arrays_float", lambda pkg, **kw: pkg.FaceIndex.from_arrays(
            g, labels, tile=384, compute_dtype=pkg.BF16, **kw), queries, 4),
        ("from_arrays_int8", lambda pkg, **kw: pkg.FaceIndex.from_arrays(
            g8, labels[:700], s8, tile=256, compute_dtype=pkg.BF16, **kw), queries, 6),
        ("from_arrays_int8_compute", lambda pkg, **kw: pkg.FaceIndex.from_arrays(
            g8, labels[:700], s8, tile=256, compute_dtype=pkg.INT8, **kw), queries, 6),
    ]


def _small(pkg, small, **kw):
    idx = pkg.FaceIndex(D, compute_dtype=pkg.BF16, **kw)
    idx.add(small, np.arange(7) + 100)
    return idx


class _Torch:
    FaceIndex = FaceIndex
    BF16, INT8 = torch.bfloat16, torch.int8


def _jax_pkg():
    import jax.numpy as jnp

    from vlsfr_tpu.eval import index as jindex

    class _Jax:
        FaceIndex = jindex.FaceIndex
        BF16, INT8 = jnp.bfloat16, jnp.int8
    return _Jax


@pytest.fixture(scope="module")
def index_cases():
    return _index_cases(np.random.default_rng(21))


def test_face_index_matches_jax(index_cases):
    jpkg = _jax_pkg()
    for name, build, queries, k in index_cases:
        want = build(jpkg).search(queries, k)
        port = build(_Torch, device="cpu")
        got = port.search(queries, k)
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)  # gallery rows
        np.testing.assert_array_equal(got[2], want[2], err_msg=name)  # labels
        np.testing.assert_allclose(got[0], want[0], atol=SCORE_ATOL, err_msg=name)
        if name == "k_beyond_gallery":
            assert (got[1][:, 7:] == -1).all() and np.isneginf(got[0][:, 7:]).all()
        assert port.nbytes() == build(jpkg).nbytes(), name
    # identify: top-1 label above the threshold, -1 below
    name, build, queries, k = index_cases[0]
    thr = 0.5
    np.testing.assert_array_equal(build(_Torch, device="cpu").identify(queries, thr),
                                  build(jpkg).identify(queries, thr))


def test_face_index_recall_target_matches_jax_exact(index_cases):
    """``recall_target`` is taken and kept (0 or below refused); the
    port's per-tile top-k is exact whatever its value, so at JAX's default
    0.95 it returns the rows JAX's exact pick returns
    (``recall_target=1.0``, ``lax.top_k`` per tile): rows and labels
    equal, scores within SCORE_ATOL."""
    jpkg = _jax_pkg()
    for name, build, queries, k in index_cases:
        want = build(jpkg, recall_target=1.0).search(queries, k)
        port = build(_Torch, device="cpu", recall_target=0.95)
        assert port.recall_target == 0.95, name
        with pytest.raises(ValueError, match="recall_target"):
            build(_Torch, device="cpu", recall_target=0.0)
        got = port.search(queries, k)
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        np.testing.assert_array_equal(got[2], want[2], err_msg=name)
        np.testing.assert_allclose(got[0], want[0], atol=SCORE_ATOL, err_msg=name)


def test_face_index_storage_matches_jax(index_cases):
    """The stored rows and row scales themselves (int8 rows and scales bit
    for bit; bf16 rows bit for bit)."""
    jpkg = _jax_pkg()
    for name, build, _, _ in index_cases:
        if name not in ("bf16", "int8_storage"):
            continue
        port, jidx = build(_Torch, device="cpu"), build(jpkg)
        got = port.gallery
        want = np.asarray(jidx.gallery)
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
        if port.row_scales is not None:
            np.testing.assert_array_equal(port.row_scales.numpy(), np.asarray(jidx.row_scales))


def test_face_index_refuses_int8_compute_on_float_rows():
    with pytest.raises(ValueError, match="int8=True"):
        FaceIndex(D, compute_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="expected int8"):
        FaceIndex.from_arrays(np.zeros((4, D), np.float32), np.arange(4),
                              np.ones(4, np.float32), device="cpu")


def _index_rank(rank, world, store, out_dir):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        from vlsfr_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(1, world)
        out = {}
        for name, build, queries, k in _index_cases(np.random.default_rng(21)):
            idx = build(_Torch, device="cpu", mesh=mesh)
            v, r, lab = idx.search(queries, k)
            out.update({f"{name}/v": v, f"{name}/r": r, f"{name}/l": lab,
                        f"{name}/rows": np.asarray(idx.gallery.shape[0])})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


def test_sharded_face_index_matches_single_device(index_cases, tmp_path):
    """2 gloo ranks, each holding half of the padded gallery: the merged
    top-k equals the single-device index's on both ranks."""
    mp.spawn(_index_rank, args=(2, str(tmp_path / "filestore"), str(tmp_path)), nprocs=2,
             join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for name, build, queries, k in index_cases:
        single = build(_Torch, device="cpu")
        v, r, lab = single.search(queries, k)
        assert int(ranks[0][f"{name}/rows"]) * 2 >= single.gallery.shape[0] >= single._n_rows
        for out in ranks:
            np.testing.assert_array_equal(out[f"{name}/r"], r, err_msg=name)
            np.testing.assert_array_equal(out[f"{name}/l"], lab, err_msg=name)
            np.testing.assert_allclose(out[f"{name}/v"], v, atol=1e-6, err_msg=name)


# ----------------------------------------------------------------------
# the trainer's in-training eval and the evaluate tool
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jpeg_store(tmp_path_factory):
    pytest.importorskip("cv2")
    from vlsfr_tpu.data.synthetic import generate_synthetic_store

    d = tmp_path_factory.mktemp("eval_store")
    generate_synthetic_store(str(d), num_ids=12, images_per_id=6, image_size=16, seed=0)
    return str(d)


EVAL_OV = ["model.net_type=toy", "model.feat_dim=16", "model.dtype=float32", "data.batch_size=8",
           "data.image_size=16", "data.num_workers=1", "pool.queue_size=32", "optim.epochs=1",
           "train.eval_records=40", "train.eval_pairs=50", "train.print_freq=1"]


def _record_eval(monkeypatch, pkg):
    """Record what ``Trainer.evaluate`` embeds and scores: the record
    indices, the pairs and the scores."""
    seen = {}
    ver = __import__(f"{pkg}.eval.verification", fromlist=["x"])
    ext = __import__(f"{pkg}.eval.extract", fromlist=["x"])
    pairs, scores, reader = ver.make_verification_pairs, ver.cosine_scores, \
        ext.Embedder.from_reader

    def rec_pairs(*a, **kw):
        seen["pairs"] = pairs(*a, **kw)
        return seen["pairs"]

    def rec_scores(*a, **kw):
        seen["scores"] = scores(*a, **kw)
        return seen["scores"]

    def rec_reader(self, r, size, indices=None):
        seen["indices"] = np.asarray(indices)
        seen["emb"] = reader(self, r, size, indices=indices)
        return seen["emb"]

    monkeypatch.setattr(ver, "make_verification_pairs", rec_pairs)
    monkeypatch.setattr(ver, "cosine_scores", rec_scores)
    monkeypatch.setattr(ext.Embedder, "from_reader", rec_reader)
    return seen


@pytest.mark.parametrize("holdout,use_ema", [(30, True), (30, False), (0, False)])
def test_in_training_eval_matches_jax(holdout, use_ema, jpeg_store, tmp_path, monkeypatch):
    import jax

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.train.trainer import Trainer as JTrainer
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables
    from vlsfr_tpu_torch.train.trainer import Trainer

    ov = [*EVAL_OV, f"train.holdout_records={holdout}", f"train.eval_use_ema={use_ema}"]
    results = {}
    for pkg in ("jax", "torch"):
        cfg = (JConfig() if pkg == "jax" else Config()).apply_overrides(ov)
        cfg.data.sources = [jpeg_store]
        cfg.train.saved_dir = str(tmp_path / pkg)
        seen = _record_eval(monkeypatch, "vlsfr_tpu" if pkg == "jax" else "vlsfr_tpu_torch")
        if pkg == "jax":
            t = JTrainer(cfg)
            # a gallery net that is not the probe: eval_use_ema must pick it
            gallery = jax.tree.map(lambda a: a * 1.5, t.state.gallery_params)
            t.state = t.state.replace(gallery_params=gallery)
            nets = {"probe": (t.state.probe_params, t.state.probe_stats),
                    "gallery": (t.state.gallery_params, t.state.gallery_stats)}
            nets = {k: jax.device_get(v) for k, v in nets.items()}
        else:
            t = Trainer(cfg, device="cpu")
            for name, (params, stats) in nets.items():
                load_flax_variables(getattr(t.state, name), params, stats)
        try:
            res = t.evaluate()
        finally:
            t.close()
        results[pkg] = (res, seen)
    (jres, jseen), (tres, tseen) = results["jax"], results["torch"]
    src = "holdout" if holdout else "train"
    assert set(tres) == set(jres) == {f"verification_acc_{src}", "verification_std"}
    np.testing.assert_array_equal(tseen["indices"], jseen["indices"])
    assert len(tseen["indices"]) == (30 if holdout else 40)
    for got, want in zip(tseen["pairs"], jseen["pairs"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tseen["emb"], jseen["emb"], atol=EMB_ATOL)
    np.testing.assert_allclose(tseen["scores"], jseen["scores"], atol=COS_ATOL)
    # the metric itself, on the port's scores, is the JAX function's
    from vlsfr_tpu.eval.verification import kfold_verification_accuracy

    pairs_same = tseen["pairs"][2]
    assert tres[f"verification_acc_{src}"] == kfold_verification_accuracy(
        tseen["scores"], pairs_same)[0]


def test_eval_use_ema_selects_the_gallery_net(jpeg_store, tmp_path):
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    for use_ema, want in ((True, "gallery"), (False, "probe")):
        cfg = Config().apply_overrides([*EVAL_OV, f"train.eval_use_ema={use_ema}"])
        cfg.data.sources = [jpeg_store]
        cfg.train.saved_dir = str(tmp_path / str(use_ema))
        t = Trainer(cfg, device="cpu")
        try:
            assert t._eval_net() is getattr(t.state, want)
        finally:
            t.close()


def test_trainer_runs_eval_every_eval_freq(jpeg_store, tmp_path):
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides([*EVAL_OV, "train.eval_freq=2", "train.holdout_records=30"])
    cfg.data.sources = [jpeg_store]
    cfg.train.saved_dir = str(tmp_path)
    t = Trainer(cfg, device="cpu")
    try:
        t.train(max_steps=4)
    finally:
        t.close()
    rows = [json.loads(ln) for ln in open(tmp_path / "logs" / "metrics.jsonl")]
    evals = [r for r in rows if r["prefix"] == "eval"]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(0.0 <= r["verification_acc_holdout"] <= 1.0 for r in evals)


def test_evaluate_tool_on_a_toy_checkpoint(jpeg_store, tmp_path, capsys):
    """A toy run's checkpoint through ``python -m vlsfr_tpu_torch.tools.evaluate``:
    its report is the verification of the checkpoint's probe (or, with
    ``--ema``, gallery) net, computed here by the port's functions."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.data.records import MultiSourceReader
    from vlsfr_tpu_torch.tools.evaluate import main
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(EVAL_OV)
    cfg.data.sources = [jpeg_store]
    cfg.train.saved_dir = str(tmp_path)
    t = Trainer(cfg, device="cpu")
    try:
        t.train()
        nets = {"probe": t.state.probe, "gallery": t.state.gallery}
        step = t.state.step
        reader = MultiSourceReader([jpeg_store])
        for ema, name in ((False, "probe"), (True, "gallery")):
            report = main(["--ckpt", str(tmp_path), "--store", jpeg_store, "--net_type", "toy",
                           "--feat_dim", "16", "--image_size", "16", "--num_pairs", "60",
                           "--device", "cpu", *(["--ema"] if ema else [])])
            assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
            emb = textract.Embedder(nets[name], device="cpu").from_reader(reader, 16)
            i1, i2, same = tver.make_verification_pairs(reader.labels, 60)
            acc, _ = tver.kfold_verification_accuracy(tver.cosine_scores(emb[i1], emb[i2]), same)
            assert report["checkpoint_step"] == step and report["records"] == len(reader)
            assert report["verification_acc"] == round(acc, 4)
            assert 0.0 <= report["rank1_identification"] <= 1.0
        reader.close()
    finally:
        t.close()
