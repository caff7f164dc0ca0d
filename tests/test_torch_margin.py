"""The port's dense margin head (vlsfr_tpu_torch/ops/margin.py) against the
JAX package's (vlsfr_tpu/ops/margin.py): same numpy inputs, values and
gradients, all three loss types, batches mixing in-pool and outlier rows.

Tolerances: f32 on both sides with the same operation order up to the
logsumexp / top-k implementations — 1e-5 relative on losses (~1 ulp of a
loss of O(10) accumulated over a few reductions), 1e-6 absolute on the
unscaled logits, and 1e-5 relative + 1e-6 absolute on gradients (the
target entries reach O(scale / n_pos) ~ 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import margin as jm
from vlsfr_tpu_torch.ops import margin as tm


def make_cos(rng, b=10, q=40):
    cos = rng.uniform(-1, 1, (b, q)).astype(np.float32)
    labels = rng.integers(0, q, b).astype(np.int32)
    labels[rng.random(b) < 0.4] = -1
    labels[0], labels[1] = -1, 3  # both row kinds always present
    return cos, labels


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_margin_logits_match(loss_type, rng):
    cos, labels = make_cos(rng)
    want = jm.margin_logits(jnp.asarray(cos), jnp.asarray(labels), loss_type=loss_type,
                            margin=0.4, mask_svfc=1.2)
    got = tm.margin_logits(torch.from_numpy(cos), torch.from_numpy(labels),
                           loss_type=loss_type, margin=0.4, mask_svfc=1.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
@pytest.mark.parametrize("hard_neg", [3, 10])
def test_add_margin_value_and_grad_match(loss_type, hard_neg, rng):
    cos, labels = make_cos(rng)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, hard_neg=hard_neg, mask_svfc=1.2)
    want, want_g = jax.value_and_grad(
        lambda c: jm.add_margin(c, jnp.asarray(labels), **kw))(jnp.asarray(cos))
    c = torch.from_numpy(cos).requires_grad_(True)
    got = tm.add_margin(c, torch.from_numpy(labels), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_add_margin_all_outliers_and_all_positive(rng):
    cos, _ = make_cos(rng)
    for labels in (np.full(10, -1, np.int32), np.arange(10, dtype=np.int32)):
        want = jm.add_margin(jnp.asarray(cos), jnp.asarray(labels))
        got = tm.add_margin(torch.from_numpy(cos), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_tile_modified_matches_margin_pallas(loss_type, rng):
    """The streaming heads' per-tile logits: target column → φ(gt), SV's
    hard-column boost elsewhere, invalid columns → NEG_INF."""
    from vlsfr_tpu.ops import margin_pallas as jmp

    cos, labels = make_cos(rng)
    cols = np.arange(cos.shape[1])[None, :]
    gt = np.take_along_axis(cos, np.maximum(labels, 0)[:, None], axis=1)
    is_target = cols == labels[:, None]
    valid = cols < 33
    want = jmp._tile_modified(*(jnp.asarray(a) for a in (cos, is_target, gt, valid)),
                              loss_type, 0.5, 1.2)
    got = tm.tile_modified(*(torch.from_numpy(a) for a in (cos, is_target, gt, valid)),
                           loss_type, 0.5, 1.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_default_hard_neg_and_label_smooth(rng):
    for q in (1, 1000, 16384, 50000, 1 << 20):
        assert tm.default_hard_neg(q) == jm.default_hard_neg(q)
    logits = rng.standard_normal((6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 6).astype(np.int32)
    want = jm.cross_entropy_label_smooth(jnp.asarray(logits), jnp.asarray(labels))
    got = tm.cross_entropy_label_smooth(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
