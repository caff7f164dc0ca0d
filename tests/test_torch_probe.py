"""The port's matrix-unit probe (``vlsfr_tpu_torch/tools/probe_int8_mxu.py``)
against JAX's ``tools/probe_int8_mxu.py`` kernels in interpret mode, on the
same numpy inputs made from a seed, at small shapes.

The JAX tool takes no ``interpret`` argument and reads its shapes from
module constants, so the test loads it with importlib, sets its B, D, T, NT
and makes ``pl.pallas_call`` interpret. Importing it sets JAX's compilation
cache directory, which the fixture puts back. Tolerances: int8 bit for bit
(int32 sums of int8 products are exact); the bf16 forms 1e-5 × Σ|a·w| per
output (f32 sums of exact products in another order). The kernel against
this plain version on a card: ``tests/test_torch_kernels.py``.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(B=16, D=64, T=128, NT=4)


@pytest.fixture(scope="module")
def jax_probe():
    """tools/probe_int8_mxu.py at SMALL shapes with interpret-mode Pallas;
    JAX's cache setting and sys.path restored afterwards."""
    cache = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("jax_probe_int8_mxu",
                                                  ROOT / "tools" / "probe_int8_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache)
    sys.path[:] = path
    for k, v in SMALL.items():
        setattr(mod, k, v)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield mod
    finally:
        pl.pallas_call = orig


def inputs(seed):
    rng = np.random.default_rng(seed)
    b, d, t, nt = SMALL["B"], SMALL["D"], SMALL["T"], SMALL["NT"]
    return {"a8": rng.integers(-127, 128, (b, d)).astype(np.int8),
            "w8": rng.integers(-127, 128, (nt, t, d)).astype(np.int8),
            "abf": rng.standard_normal((b, d)).astype(np.float32),
            "wbf": rng.standard_normal((nt, t, d)).astype(np.float32)}


def jax_out(mod, kind, a, w):
    body = {"int8": (jnp.int32, mod._kernel_int8), "bf16": (jnp.float32, mod._kernel_bf16),
            "i8st_bf16dot": (jnp.float32, mod._kernel_i8st_bf16dot)}[kind]
    return np.asarray(jax.jit(mod.make_call(None, *body))(a, w))


def test_int8_is_bit_equal_to_jax(jax_probe):
    x = inputs(0)
    want = jax_out(jax_probe, "int8", jnp.asarray(x["a8"]), jnp.asarray(x["w8"]))
    a, w = torch.from_numpy(x["a8"]), torch.from_numpy(x["w8"])
    got = tprobe.probe_dot("int8", a, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tprobe.exact_int8(a, w).numpy(), want)


def abs_sum(a, w):
    """Σ_i Σ_d |a[b, d] · w[i, t, d]| per output, in f64."""
    return np.abs(a.astype(np.float64)) @ np.abs(w.astype(np.float64)).sum(0).T


@pytest.mark.parametrize("kind", ["bf16", "i8st_bf16dot"])
def test_bf16_forms_match_jax(jax_probe, kind):
    x = inputs(1)
    a_bf = jnp.asarray(x["abf"], jnp.bfloat16)
    w_j = jnp.asarray(x["wbf"], jnp.bfloat16) if kind == "bf16" else jnp.asarray(x["w8"])
    want = jax_out(jax_probe, kind, a_bf, w_j)
    a = torch.from_numpy(x["abf"]).bfloat16()
    w = torch.from_numpy(x["wbf"]).bfloat16() if kind == "bf16" else torch.from_numpy(x["w8"])
    got = tprobe.probe_dot(kind, a, w)
    assert got.dtype == torch.float32
    tol = 1e-5 * abs_sum(a.float().numpy(), w.float().numpy())
    assert (np.abs(got.numpy() - want) <= tol).all()


def test_int8_wraps_as_int32():
    """Sums past 2^31 wrap mod 2^32 in both the plain version and the exact
    reference, as an int32 accumulator does."""
    a = torch.full((2, 128), 127, dtype=torch.int8)
    w = torch.full((1100, 64, 128), 127, dtype=torch.int8)  # 1100 · 128 · 127² > 2^31
    exact = 1100 * 128 * 127 * 127
    want = (exact + 2**31) % 2**32 - 2**31
    assert int(tprobe.probe_dot_plain("int8", a, w)[0, 0]) == want
    assert int(tprobe.exact_int8(a, w)[0, 0]) == want


def test_cpu_tensors_never_launch_and_run_checks_exactly():
    tprobe.reset_launch_counts()
    recs = tprobe.run("cpu", b=16, d=64, t=128, nt=4)
    assert [r["kind"] for r in recs] == list(tprobe.KINDS)
    assert all(r["ms"] is None and r["library_ms"] is None for r in recs)
    assert not any(tprobe.LAUNCH_COUNTS.values())


def test_bad_arguments_raise():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        tprobe.probe_dot("int8", a, torch.zeros((2, 8, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tprobe.probe_dot("int4", a, torch.zeros((2, 8, 8), dtype=torch.int8))
