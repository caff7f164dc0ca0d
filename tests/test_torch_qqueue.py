"""The port's int8 queue storage (``vlsfr_tpu_torch/ops/qqueue.py``, the
int8 write and the queue forms in ``core/ffc.py``) against the JAX
package's (``vlsfr_tpu/ops/qqueue.py``, ``vlsfr_tpu/core/ffc.py``).

Everything here is held bit for bit: the quantisation is the same f32
operations in the same order on both sides, and the write is an indexed
store with the same winner among duplicate slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import qqueue as jqq
from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core import ffc
from vlsfr_tpu_torch.ops import qqueue as tqq


def exact_ties(n: int) -> np.ndarray:
    """f32 values x in (0, 1) whose f32 product with 127 is exactly k + 0.5:
    quantised with absmax 1 (an exact division), they sit on a rounding
    tie."""
    out = []
    for k in range(1, 126):
        x = np.float32((k + 0.5) / 127)
        for cand in (x, np.nextafter(x, np.float32(0)), np.nextafter(x, np.float32(1))):
            if np.float32(cand) * np.float32(127.0) == np.float32(k + 0.5):
                out.append(cand)
                break
        if len(out) == n:
            break
    return np.array(out, np.float32)


@pytest.mark.parametrize("d", [16, 128, 512, 1024])
def test_quantize_rows_bit_equal_to_jax(d, rng):
    x = (rng.standard_normal((300, d)) * rng.uniform(0.01, 10.0, (300, 1))).astype(np.float32)
    x[0] = 0.0  # a zero row: scale 0
    ties = exact_ties(min(6, (d - 1) // 2))
    assert len(ties) >= 4
    x[1] = 0.0
    x[1, 0] = 1.0
    x[1, 1:1 + len(ties)] = ties
    x[1, 1 + len(ties):1 + 2 * len(ties)] = -ties
    q_j, s_j = jqq.quantize_rows(jnp.asarray(x))
    q_t, s_t = tqq.quantize_rows(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert float(s_t[0]) == 0.0 and not q_t[0].any()
    # ties round half to even on both sides
    k = (ties * np.float32(127.0) - 0.5).astype(np.int64)
    want = np.where(k % 2 == 0, k, k + 1)
    np.testing.assert_array_equal(q_t[1, 1:1 + len(ties)].numpy(), want)
    np.testing.assert_array_equal(tqq.dequant_rows(q_t, s_t).numpy(),
                                  np.asarray(jqq.dequant_rows(q_j, s_j)))


def test_int8_write_with_duplicates_matches_jax(rng):
    """``write_rows_`` on an int8 queue: quantize_rows(g) into the rows and
    the scales, the same winner among duplicate (row, slot) entries for
    both — JAX's ``.at[rows, cols].set`` (later entries win on the CPU)."""
    q, d, b = 12, 32, 7
    queue, scales = tqq.quantize_rows(torch.from_numpy(rng.standard_normal((2, q, d))
                                                      .astype(np.float32)))
    g = rng.standard_normal((b, d)).astype(np.float32)
    rows = np.array([0, 1, 0, 0, 1, 1, 0], np.int32)
    cols = np.array([3, 3, 3, 9, 3, 0, 9], np.int32)  # (0, 3) x2, (1, 3) x2, (0, 9) x2
    qj, sj = jqq.quantize_rows(jnp.asarray(g))
    want_q = jnp.asarray(queue.numpy()).at[rows, cols].set(qj)
    want_s = jnp.asarray(scales.numpy()).at[rows, cols].set(sj)
    ffc.write_rows_(queue, torch.from_numpy(g), torch.from_numpy(rows), torch.from_numpy(cols),
                    scales=scales)
    np.testing.assert_array_equal(queue.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    # the block form writes the same rows and scales
    whole_q, whole_s = queue.clone(), scales.clone()
    block_q, block_s = queue[:, 8:].clone(), scales[:, 8:].clone()
    ffc.write_rows_(whole_q, torch.from_numpy(g), torch.from_numpy(rows),
                    torch.from_numpy(cols), scales=whole_s)
    ffc.write_rows_(block_q, torch.from_numpy(g), torch.from_numpy(rows),
                    torch.from_numpy(cols), 8, block_s)
    assert torch.equal(block_q, whole_q[:, 8:]) and torch.equal(block_s, whole_s[:, 8:])


def test_bf16_write_stores_the_rounded_rows(rng):
    queue = torch.zeros(2, 5, 4, dtype=torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    ffc.write_rows_(queue, g, torch.tensor([1, 0]), torch.tensor([2, 4]))
    assert torch.equal(queue[1, 2], g[0].bfloat16()) and torch.equal(queue[0, 4], g[1].bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_init_queue_forms(dtype):
    """f32 / bf16 / int8 queues drawn in chunks: unit rows (dequantised for
    int8), and a block is the whole queue's slice bit for bit."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    n = ffc.INIT_CHUNK + 100  # two chunks
    queue, scales = ffc.init_queue(n, 16, device="cpu", generator=gen(), dtype=dtype)
    assert queue.dtype == dtype and queue.shape == (2, n, 16)
    rows = queue.float() if scales is None else tqq.dequant_rows(queue, scales)
    norms = torch.linalg.vector_norm(rows, dim=-1)
    atol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.int8: 1e-5}[dtype]
    assert torch.allclose(norms, torch.ones_like(norms), atol=atol)
    assert (scales is None) == (dtype != torch.int8)
    c0 = ffc.INIT_CHUNK - 50
    block, bscales = ffc.init_queue(n, 16, device="cpu", generator=gen(), dtype=dtype,
                                    block=(c0, 120))
    assert torch.equal(block, queue[:, c0:c0 + 120])
    if scales is not None:
        assert torch.equal(bscales, scales[:, c0:c0 + 120])


def test_state_from_jax_keeps_dtype_and_bits(rng):
    x = jnp.asarray(rng.standard_normal((2, 6, 8)).astype(np.float32))
    q, s = ffc.state_from_jax(np.asarray(x.astype(jnp.bfloat16)))
    assert q.dtype == torch.bfloat16 and s is None
    np.testing.assert_array_equal(q.float().numpy(), np.asarray(x.astype(jnp.bfloat16)
                                                                .astype(jnp.float32)))
    qj, sj = jqq.quantize_rows(x)
    q, s = ffc.state_from_jax(np.asarray(qj), np.asarray(sj))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("overrides,match", [
    (["pool.queue_dtype=int8", "pool.use_fused=off"], "requires the fused streaming head"),
    (["pool.queue_int8_compute=true"], "queue_int8_compute requires"),
    (["pool.use_fused=on", "pool.queue_size=4096", "pool.queue_tile=1000"], "must divide"),
])
def test_queue_config_errors_match_jax(overrides, match):
    """The configuration errors of JAX's ``make_ffc_loss_fn``, with its
    messages, from the port's step and state builders."""
    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.core.ffc import make_ffc_loss_fn
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu_torch.models import create_net

    with pytest.raises(ValueError, match=match) as jerr:
        make_ffc_loss_fn(j_create_net("toy", feat_dim=16), JConfig().apply_overrides(overrides))
    cfg = Config().apply_overrides(overrides)
    with pytest.raises(ValueError, match=match) as terr:
        ffc.make_train_step(cfg, lambda s: 0.1)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match=match):
        ffc.create_ffc_state(create_net("toy", feat_dim=16), cfg, device="cpu")
