"""The port's backbones against the JAX package's, with weights carried
over by ``vlsfr_tpu_torch.models.from_jax``.

Embeddings are compared in train mode over two calls (batch statistics,
the flax BN rule and the running-stat updates) and then in eval mode.
Tolerance: f32 convolutions in XLA's and PyTorch's CPU kernels sum in
different orders; over a few conv/BN layers the unit-norm embeddings agree
to ~1e-6, held at atol 2e-5 (running stats at 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vlsfr_tpu.models.iresnet import IResNet as JIResNet
from vlsfr_tpu.models.toynet import ToyNet as JToyNet
from vlsfr_tpu.models.torch_import import convert_torch_state_dict
from vlsfr_tpu_torch.models import create_net, native_image_size
from vlsfr_tpu_torch.models.from_jax import load_flax_variables, state_dict_from_flax
from vlsfr_tpu_torch.models.iresnet import IResNet
from vlsfr_tpu_torch.models.toynet import ToyNet

EMB_ATOL = 2e-5


def _run_both(jmodel, tmodel, size, rng):
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, size, size, 3)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    load_flax_variables(tmodel, jax.device_get(params), jax.device_get(stats))
    tmodel.train()
    for _ in range(2):
        x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
        want, mut = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                 train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EMB_ATOL)
    expect = state_dict_from_flax(tmodel, jax.device_get(params), jax.device_get(stats))
    for k, v in tmodel.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    x = rng.standard_normal((3, size, size, 3)).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EMB_ATOL)


def test_toynet_matches_jax(rng):
    _run_both(JToyNet(feat_dim=16), ToyNet(feat_dim=16), 16, rng)


def test_small_iresnet_matches_jax(rng):
    _run_both(JIResNet(layers=(1, 1, 1, 1), feat_dim=32), IResNet(layers=(1, 1, 1, 1),
                                                                   feat_dim=32, image_size=32),
              32, rng)


def test_bf16_compute_close_to_f32(rng):
    """bf16 activations (f32 params, f32 BN statistics and fc) stay within
    bf16 rounding of the f32 embeddings."""
    torch.manual_seed(0)
    m32 = IResNet(layers=(1, 1, 1, 1), feat_dim=32, image_size=32)
    m16 = IResNet(layers=(1, 1, 1, 1), feat_dim=32, image_size=32, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        e32, e16 = m32(x), m16(x)
    assert e16.dtype == torch.float32
    cos = (e32 * e16).sum(-1)
    assert float(cos.min()) > 0.99


def test_from_jax_round_trips_through_torch_import():
    """Port state_dict keys are the reference torch names: the JAX
    package's converter maps the carried weights back to the flax tree."""
    jmodel = JIResNet(layers=(2, 2, 2, 2), feat_dim=64)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3)), train=False))
    r = np.random.default_rng(5)
    flat = {k: r.standard_normal(v.shape).astype(np.float32)
            for k, v in traverse_util.flatten_dict(shapes).items()}
    tree = traverse_util.unflatten_dict(flat)
    tmodel = create_net("ir18", feat_dim=64)
    sd = state_dict_from_flax(tmodel, tree["params"], tree["batch_stats"])
    assert set(sd) == set(tmodel.state_dict())
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, "ir18", feat_dim=64)
    back_flat = traverse_util.flatten_dict(back)
    assert set(back_flat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back_flat[k]), v, err_msg=str(k))


def test_registry():
    assert native_image_size("ir50") == 112 and native_image_size("toy") == 32
    net = create_net("ir50", feat_dim=512, dtype="bfloat16")
    n_blocks = sum(len(getattr(net, f"layer{s}")) for s in range(1, 5))
    assert n_blocks == 24 and net.fc.in_features == 512 * 7 * 7
    for name in ("mobile", "r50"):
        with pytest.raises(NotImplementedError):
            create_net(name)
    with pytest.raises(ValueError):
        create_net("vgg")
    with pytest.raises(NotImplementedError):
        create_net("toy", bn_stats_rows=8)
