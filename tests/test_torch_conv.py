"""The port's 3×3 conv (``vlsfr_tpu_torch/ops/conv3x3.py``) against JAX's
``conv3x3_pallas`` in interpret mode and ``conv3x3_xla``, on the same numpy
inputs made from a seed.

Tolerances: f32 y 2e-5 absolute (``tests/test_conv_pallas.py:19``: f32 sums
of 72 products in another order); the statistics rtol 1e-5, atol 1e-4
(``:28-32``); bf16 y within one bf16 spacing of JAX's everywhere (the two
f32 sums round to neighbouring bf16 values where they straddle a rounding
boundary), and such elements few. The kernel against this plain version on
a card: ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops.conv_pallas import conv3x3_pallas, conv3x3_xla
from vlsfr_tpu_torch.ops import conv3x3 as tconv
from vlsfr_tpu_torch.tools import bench_conv


def inputs(seed, shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], cout)) * 0.1).astype(np.float32)
    return x, w


def bf16_spacing(v: np.ndarray) -> np.ndarray:
    """One bf16 spacing at each value (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(v), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("mode", ["taps9", "im2col"])
@pytest.mark.parametrize("shape,cout,strip", [((2, 8, 8, 8), 8, 4),
                                              ((2, 8, 12, 8), 16, 4),
                                              ((1, 12, 6, 4), 8, 6),
                                              ((1, 8, 8, 3), 16, 4),
                                              ((1, 4, 4, 256), 64, 4)])
def test_plain_matches_pallas_and_xla_f32(mode, shape, cout, strip):
    x, w = inputs(0, shape, cout)
    want = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), mode=mode, strip=strip,
                                     interpret=True))
    got = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), mode=mode, strip=strip)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(conv3x3_xla(jnp.asarray(x),
                                                                   jnp.asarray(w))), atol=2e-5)


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 8), 8), ((2, 8, 12, 8), 16)])
def test_stats_epilogue_matches_pallas(shape, cout):
    x, w = inputs(1, shape, cout)
    y_j, (s1_j, s2_j) = conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), mode="taps9", strip=4,
                                       with_stats=True, interpret=True)
    y, (s1, s2) = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), strip=4,
                                with_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), rtol=1e-5, atol=1e-4)
    # the statistics are of the f32 sum, as the reference's conv gives it
    ref = np.asarray(conv3x3_xla(jnp.asarray(x), jnp.asarray(w))).reshape(-1, cout)
    np.testing.assert_allclose(s1.numpy(), ref.sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.square(ref).sum(0), rtol=1e-5, atol=1e-4)


def test_bf16_stats_are_of_the_sum_before_rounding():
    x, w = inputs(2, (2, 8, 8, 8), 8)
    xb = torch.from_numpy(x).bfloat16()
    y, (s1, _) = tconv.conv3x3(xb, torch.from_numpy(w), strip=4, with_stats=True)
    _, (s1_j, _) = conv3x3_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), strip=4,
                                  with_stats=True, interpret=True)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), rtol=1e-5, atol=1e-4)
    # the sum of the rounded y is another number
    assert float((y.float().reshape(-1, 8).sum(0) - s1).abs().max()) > 1e-4


@pytest.mark.parametrize("mode", ["taps9", "im2col"])
def test_bf16_within_one_spacing_of_pallas(mode):
    x, w = inputs(3, (2, 8, 8, 16), 16)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(conv3x3_pallas(xb, jnp.asarray(w), mode=mode, strip=4, interpret=True),
                      np.float32)
    got = tconv.conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), mode=mode,
                        strip=4)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= bf16_spacing(want)).all()
    assert int((diff > 0).sum()) <= diff.size // 100  # straddles only


@pytest.mark.parametrize("mode", ["taps9", "im2col"])
@pytest.mark.parametrize("shape,cout", [((1, 8, 8, 3), 16), ((1, 4, 4, 256), 64),
                                        ((1, 8, 8, 1), 16), ((2, 8, 12, 5), 20),
                                        ((1, 8, 8, 7), 72)])
def test_bf16_c3_and_c256_within_one_spacing_of_pallas(mode, shape, cout):
    """The channel counts the stem kernel takes at their own C (C = 1, 3:
    ir50's stem, 5, 7) and the bf16 kernel streams (C = 256): the plain
    version within one bf16 spacing of JAX's conv3x3_pallas, straddles
    few."""
    x, w = inputs(9, shape, cout)
    want = np.asarray(conv3x3_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), mode=mode,
                                     strip=4, interpret=True), np.float32)
    got = tconv.conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), mode=mode, strip=4)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= bf16_spacing(want)).all()
    assert int((diff > 0).sum()) <= max(diff.size // 100, 1)  # straddles only


@pytest.mark.parametrize("strip", [3, 5])
def test_bad_strips_raise_in_both_packages(strip):
    x, w = inputs(4, (1, 6, 6, 4), 4) if strip == 3 else inputs(4, (1, 8, 8, 4), 4)
    with pytest.raises(AssertionError):
        conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), strip=strip, interpret=True)
    with pytest.raises(ValueError):
        tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), strip=strip)


def test_cpu_tensors_never_launch():
    tconv.reset_launch_counts()
    x, w = inputs(5, (2, 8, 8, 8), 8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y, (s1, s2) = tconv.conv3x3(xt, wt, mode="im2col", strip=4, with_stats=True)
    y_p, (s1_p, s2_p) = tconv.conv3x3_plain(xt, wt, with_stats=True)
    assert torch.equal(y, y_p) and torch.equal(s1, s1_p) and torch.equal(s2, s2_p)
    assert not any(tconv.LAUNCH_COUNTS.values())


def test_library_conv_matches_xla():
    x, w = inputs(6, (2, 8, 12, 8), 16)
    got = tconv.conv3x3_library(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(conv3x3_xla(jnp.asarray(x),
                                                                   jnp.asarray(w))), atol=2e-5)


def test_bench_run_on_cpu_gives_one_record_per_case():
    tconv.reset_launch_counts()
    recs = bench_conv.run([(1, 8, 8, 8), (1, 4, 4, 8)], device="cpu", strips=(4, 8),
                          stats_strips=(4,))
    # per shape: cuDNN's conv, then 2 modes x the strips dividing H (2 at H = 8, 1 at H = 4);
    # then the first shape's conv + reductions and one stats strip
    assert [r["case"] for r in recs] == (["library"] + ["conv3x3"] * 4 + ["library"]
                                         + ["conv3x3"] * 2 + ["library+stats", "conv3x3+stats"])
    assert all(r["ms"] is None and r["device"] == "cpu" for r in recs)
    assert all(r["max_abs_diff_vs_library"] < 1e-1 for r in recs if r["case"] == "conv3x3")
    assert not any(tconv.LAUNCH_COUNTS.values())
