"""The port's ResNet and MobileFaceNet against the JAX package's, with
weights carried over by ``vlsfr_tpu_torch.models.from_jax``.

Each net runs through ``test_torch_models._run_both``: two train-mode
calls (batch statistics, the flax BN rule, the running-stat updates) and
one eval-mode call, running stats at 1e-4 relative (plus 1e-6 absolute,
5e-6 for ResNet, for the stats near 0). Embeddings: f32
convolutions sum in other orders in XLA's and PyTorch's CPU kernels.
MobileFaceNet is held at ``EMB_ATOL`` (2e-5) as IResNet is; ResNet at
``RESNET_ATOL`` (5e-5): its kaiming fan_out init keeps activations large
and its scaled head BN normalises over the batch's 4 rows, so the same
sum-order noise comes out larger (in an f64 evaluation of the bottleneck
net at these inputs, JAX's f32 embeddings were 1.2e-5 from it, the
port's 4.7e-6). The weight layout is checked bit for bit by a round trip
through the JAX package's reference-checkpoint converter at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests.test_torch_models import _run_both
from vlsfr_tpu.models import create_net as jcreate_net
from vlsfr_tpu.models.mobilefacenet import MobileFaceNet as JMobileFaceNet
from vlsfr_tpu.models.resnet import ResNet as JResNet
from vlsfr_tpu.models.torch_import import convert_torch_state_dict
from vlsfr_tpu_torch.models import NATIVE_IMAGE_SIZE, create_net, native_image_size
from vlsfr_tpu_torch.models.from_jax import _fc_weight, state_dict_from_flax
from vlsfr_tpu_torch.models.mobilefacenet import MobileFaceNet
from vlsfr_tpu_torch.models.resnet import ResNet

# three stride-2 stages from 56² to the 7×7 map linear7 needs, last width 128
SHORT_SETTING = ((2, 64, 1, 2), (2, 128, 1, 2), (2, 128, 2, 2))
RESNET_ATOL, RESNET_STATS_ATOL = 5e-5, 5e-6


@pytest.mark.parametrize("block,size", [("basic", 64), ("bottleneck", 64), ("basic", 48)])
def test_small_resnet_matches_jax(block, size, rng):
    """layers=(1, 1, 1, 1) at 64²: the last map is 2×2, so the fc's NHWC →
    NCHW permutation at C = 512·expansion is exercised; at 48² the map
    halves to 3 and then to 2 (ceil, as the CLI's default 112² gives r50 a
    4×4 map), the fc's width as flax infers it."""
    _run_both(JResNet(block=block, layers=(1, 1, 1, 1), feat_dim=32),
              ResNet(block=block, layers=(1, 1, 1, 1), feat_dim=32, image_size=size), size,
              rng, atol=RESNET_ATOL, stats_atol=RESNET_STATS_ATOL)


def test_small_mobilefacenet_matches_jax(rng):
    _run_both(JMobileFaceNet(feat_dim=32, setting=SHORT_SETTING),
              MobileFaceNet(feat_dim=32, setting=SHORT_SETTING), 112, rng, batch=2)


def test_mobilefacenet_needs_112():
    with pytest.raises(ValueError, match="112"):
        create_net("mobile", image_size=96)


def test_registry_and_native_sizes():
    """Every name the JAX registry builds, at the same native size (the
    nets built on the meta device: structure only)."""
    for name, size in NATIVE_IMAGE_SIZE.items():
        assert native_image_size(name) == size
    assert set(NATIVE_IMAGE_SIZE) == {"mobile", "toy", "ir18", "ir34", "ir50", "ir100", "ir200",
                                      "r18", "r34", "r50", "r101"}
    with torch.device("meta"):
        for name, (blocks, width) in {"r18": (8, 512), "r34": (16, 512), "r50": (16, 2048),
                                      "r101": (33, 2048)}.items():
            net = create_net(name, feat_dim=64)
            assert sum(len(getattr(net, f"layer{s}")) for s in range(1, 5)) == blocks
            assert net.out_channels == width and net.fc.in_features == width * 49
        assert len(create_net("mobile").blocks) == 15


def test_fc_weight_at_2048_channels():
    """r50's head: 7·7·2048 = 100,352 = 512·14²; the permutation must use
    the model's C, not infer a 14×14×512 map."""
    c, s, o = 2048, 7, 3
    k = np.random.default_rng(0).standard_normal((s * s * c, o)).astype(np.float32)
    got = _fc_weight(k, c)
    h, w, ch = np.meshgrid(np.arange(s), np.arange(s), np.arange(c), indexing="ij")
    nhwc = (h * s * c + w * c + ch).ravel()
    nchw = (ch * s * s + h * s + w).ravel()
    want = np.empty((o, s * s * c), np.float32)
    want[:, nchw] = k[nhwc].T
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(_fc_weight(k, 512), want)


@pytest.mark.parametrize("net_type", ["r50", "r18", "mobile"])
def test_from_jax_round_trips_through_torch_import(net_type):
    """Full-size random flax trees → port state_dict → the JAX package's
    reference-checkpoint converter → the same trees, bit for bit."""
    size = native_image_size(net_type)
    shapes = jax.eval_shape(lambda: jcreate_net(net_type, feat_dim=64).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    r = np.random.default_rng(5)
    flat = {k: r.standard_normal(v.shape).astype(np.float32)
            for k, v in traverse_util.flatten_dict(shapes).items()}
    tree = traverse_util.unflatten_dict(flat)
    tmodel = create_net(net_type, feat_dim=64)
    sd = state_dict_from_flax(tmodel, tree["params"], tree["batch_stats"])
    assert set(sd) == set(tmodel.state_dict())
    back = traverse_util.flatten_dict(convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, net_type, feat_dim=64))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=str(k))
