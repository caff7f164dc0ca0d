"""The port's int8 conv inference (``vlsfr_tpu_torch/ops/quant.py``), the
subset-row BN statistics (``bn_stats_rows``) and the paths that use them,
against the JAX package on the same seeded numpy inputs.

* Quantisers: ``quantize_weight_per_channel`` / ``quantize_act_per_tensor``
  bit for bit against JAX's, an all-zero channel included. JAX runs under
  ``jax.jit`` throughout, as its Embedder and FFC step do: XLA compiles
  the division by 127 as a product with its reciprocal (``ops/quant.py``),
  which an eager call does not.
* One conv (``models.layers.Conv`` under ``int8_conv_inference()``)
  against flax's under JAX's context, over k, stride, padding, C_in, bias
  and dtype, with an all-zero input channel: JAX's int8 operands (captured
  at its ``conv_general_dilated``) equal the port's bit for bit; the output
  within 1e-6 × max|y| in f32 (the same int32 sums and f32 dequantisation;
  XLA may fuse the multiply-add) and within one bf16 ulp in bf16.
* The int path (``_int_mm`` over an im2col) against its f64 plain
  version: int32 bit for bit, with padded K / N / rows and forced chunks.
* Depthwise convs fall through bit for bit; ``state_dict`` and the float
  path are unchanged by the context, which never leaks out of its block.
* ``Embedder(int8=True)``: a small IResNet and a small MobileFaceNet, JAX's
  weights carried by ``from_jax`` (BN statistics calibrated), against JAX's
  int8 forward. Every int8 conv of the net, on the input the port's forward
  gave it: JAX's operands bit for bit and its output within 1e-6 × max|y|.
  The embeddings: within JAX's own int8 fidelity band (cosine > 0.995,
  ``tests/test_quant.py``), of JAX's int8 ones and, not equal, of the port's
  float ones. The two int8 nets agree no closer than that: a conv input
  that differs in its last f32 bit (a depthwise conv's or a BN's rsqrt in
  another order) rounds an int8 value the other way, which can move a
  channel's max|x|, and with it every rounding of that channel in the next
  conv; the cosine read 0.9987-0.9998 here.
* ``pool.gallery_int8``: two FFC steps against JAX's step on the toy model
  of ``tests/test_quant.py``: losses 1e-5 relative, probe parameters and
  BN statistics 1e-5 relative + 2e-5 absolute (``test_torch_ffc_step.py``'s
  limits); the probe's embeddings identical with the flag and without. Its
  embeddings are not normalised and its gradients are large: at lr 0.05
  the float trajectory itself (the flag off on both sides) leaves these
  limits by 3e-5 at the second step, so the steps run at lr 0.01.
* ``bn_stats_rows``: a BN layer (outputs and running statistics 1e-6
  absolute) and a small IResNet (embeddings 1e-5 absolute: the same net
  with the flax-rule BN reads 1.8e-6, conv sums in other orders; running
  statistics 1e-4 relative + 1e-6 absolute, ``test_torch_models.py``'s)
  against JAX's ``_SubsetBN``, in train and eval mode; JAX's variables load
  through ``from_jax`` as they are.
* ``tools/evaluate.py --int8 --device cpu`` on a toy checkpoint.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from vlsfr_tpu.models import layers as jlayers
from vlsfr_tpu.ops import quant as jquant
from vlsfr_tpu_torch.models import layers as tlayers
from vlsfr_tpu_torch.models.from_jax import load_flax_variables, state_dict_from_flax
from vlsfr_tpu_torch.ops import quant

SHORT_SETTING = ((2, 64, 1, 2), (2, 128, 1, 2), (2, 128, 2, 2))  # test_torch_backbones.py's
F32_REL = 1e-6  # one conv's f32 output, relative to max|y|
FIDELITY_COS = 0.995  # int8 against float, and port int8 against JAX's (tests/test_quant.py)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5, 2e-5
BN_ATOL = 1e-6
NET_ATOL = 1e-5  # a small IResNet's embeddings: the flax-rule BN net reads 1.8e-6 here


def _t(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# ----------------------------------------------------------------------
# quantisers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("zero", [False, True])
def test_quantizers_match_jax_bit_for_bit(zero, rng):
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.1).astype(np.float32)  # HWIO
    x = (rng.standard_normal((4, 5, 6, 7)) * 3.0).astype(np.float32)
    if zero:  # an all-zero output channel; an all-zero activation
        w[..., 5] = 0.0
        x[:] = 0.0
    jwq, jsw = jax.jit(jquant.quantize_weight_per_channel)(jnp.asarray(w))
    wq, sw = quant.quantize_weight_per_channel(_t(w.transpose(3, 2, 0, 1)))  # OIHW
    assert wq.dtype == torch.int8 and sw.shape == (16,)
    np.testing.assert_array_equal(wq.numpy().transpose(2, 3, 1, 0), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    jxq, jsx = jax.jit(jquant.quantize_act_per_tensor)(jnp.asarray(x))
    xq, sx = quant.quantize_act_per_tensor(_t(x))
    assert xq.dtype == torch.int8 and sx.dim() == 0
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert sx.item() == float(jsx)


# ----------------------------------------------------------------------
# one conv
# ----------------------------------------------------------------------


def _jax_int8_conv(x_nhwc, kernel, bias, k, stride, pad, dtype):
    """flax ``layers.Conv`` under JAX's int8 context, jitted; returns (y
    NHWC f32, the int8 operands JAX's conv received)."""
    conv = jax.lax.conv_general_dilated
    m = jlayers.Conv(kernel.shape[-1], k, stride, pad, use_bias=bias is not None, dtype=dtype)

    def run(params, x):
        seen = []

        def capture(lhs, rhs, *a, **kw):
            if lhs.dtype == jnp.int8:
                seen.append((lhs, rhs))
            return conv(lhs, rhs, *a, **kw)

        jax.lax.conv_general_dilated = capture
        try:
            with jquant.int8_conv_inference():
                y = m.apply({"params": params}, x)
        finally:
            jax.lax.conv_general_dilated = conv
        assert len(seen) == 1 and y.dtype == dtype
        return y.astype(jnp.float32), seen[0]

    params = {"conv": {"kernel": jnp.asarray(kernel)}}
    if bias is not None:
        params["conv"]["bias"] = jnp.asarray(bias)
    y, (xq, wq) = jax.jit(run)(params, jnp.asarray(x_nhwc, dtype))
    return np.asarray(y), (np.asarray(xq), np.asarray(wq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cin", [3, 8, 16])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_one_conv_matches_jax(k, stride, pad, cin, bias, dtype):
    rng = np.random.default_rng(100 + 10 * k + 5 * stride + 3 * pad + cin)
    cout = 12
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    x[..., 1] = 0.0  # an all-zero input channel: s = 1 there
    x[..., 0] *= 20.0  # a loud one: the equalisation has work to do
    kernel = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want, (jxq, jwq) = _jax_int8_conv(x, kernel, b, k, stride, pad, jdt)

    conv = tlayers.Conv(cin, cout, k, stride, pad, bias=bias, dtype=tdt)
    with torch.no_grad():
        conv.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(_t(b))
    xt = _t(x.transpose(0, 3, 1, 2), tdt)
    d, sx, wq, sw = quant.conv_scales(xt, conv.weight)
    np.testing.assert_array_equal(quant.quantize_input(xt, d).numpy().transpose(0, 2, 3, 1), jxq)
    np.testing.assert_array_equal(wq.numpy().transpose(2, 3, 1, 0), jwq)
    quant.reset_launch_counts()
    with quant.int8_conv_inference(), torch.no_grad():
        got = conv(xt)
    assert quant.LAUNCH_COUNTS["int8_conv"] == 1 and got.dtype == tdt
    got = got.float().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * np.abs(want).max())
    else:  # one bf16 ulp of the larger magnitude
        big = np.maximum(np.abs(got), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


GEOMETRIES = [  # (n, c, h, w, o, k, stride, pad)
    (2, 3, 11, 9, 5, 3, 1, 1),  # K = 27 → 32, N = 5 → 8
    (1, 4, 3, 3, 8, 3, 1, 1),  # 9 rows: padded past 16
    (3, 16, 10, 10, 24, 3, 2, 1),
    (2, 16, 8, 8, 16, 1, 1, 0),  # the 1×1 path, no copy
    (2, 12, 9, 7, 16, 1, 2, 0),  # the strided 1×1 shortcut
    (2, 8, 7, 7, 16, 7, 1, 0),  # a 7×7 VALID conv over the whole map
]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_int_path_matches_f64_plain_version(geom, monkeypatch):
    n, c, h, w, o, k, stride, pad = geom
    gen = torch.Generator().manual_seed(sum(geom))
    xq = torch.randint(-127, 128, (n, c, h, w), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=gen, dtype=torch.int8)
    xq[0, 0] = 127  # sums at the int8 extremes
    wq[0] = 127
    want = quant.int_conv_plain(xq, wq, stride, pad)
    got = quant.int_conv(xq, wq, stride, pad)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    monkeypatch.setattr(quant, "CHUNK_BYTES", 1)  # one image a chunk
    assert torch.equal(quant.int_conv(xq, wq, stride, pad), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_int8_conv2d_matches_its_formula_in_chunks(geom, dtype, monkeypatch):
    """The whole wrapper, in one chunk and in one image a chunk, equals
    ``f32(plain int product) · (sx · sw) + bias`` cast to ``dtype`` bit for
    bit (the same elementwise f32 ops in the same order)."""
    n, c, h, w, o, k, stride, pad = geom
    gen = torch.Generator().manual_seed(sum(geom))
    x = torch.randn((n, c, h, w), generator=gen).to(dtype)
    wt = torch.randn((o, c, k, k), generator=gen)
    bias = torch.randn((o,), generator=gen)
    d, sx, wq, sw = quant.conv_scales(x, wt)
    prod = quant.int_conv_plain(quant.quantize_input(x, d), wq, stride, pad)
    want = (prod.float() * (sx * sw)[None, :, None, None] + bias[None, :, None, None]).to(dtype)
    for chunk in (quant.CHUNK_BYTES, 1):  # 1: one image a chunk
        monkeypatch.setattr(quant, "CHUNK_BYTES", chunk)
        got = quant.int8_conv2d(x, wt, bias, stride, pad, dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_depthwise_falls_through_bit_for_bit(rng):
    dw = tlayers.Conv(8, 8, 3, 1, 1, groups=8)
    dense = tlayers.Conv(8, 8, 3, 1, 1)
    x = _t(rng.standard_normal((2, 8, 6, 6)).astype(np.float32))
    with torch.no_grad():
        y0, z0 = dw(x), dense(x)
        quant.reset_launch_counts()
        with quant.int8_conv_inference():
            y1, z1 = dw(x), dense(x)
    assert torch.equal(y0, y1)
    assert quant.LAUNCH_COUNTS["int8_conv"] == 1  # the ungrouped conv alone
    assert not torch.equal(z0, z1)  # it quantised
    cos = torch.nn.functional.cosine_similarity(z0.flatten(1), z1.flatten(1))
    assert float(cos.min()) > FIDELITY_COS


def test_state_dict_and_float_path_unchanged(rng):
    from vlsfr_tpu_torch.models.mobilefacenet import MobileFaceNet

    torch.manual_seed(0)
    net = MobileFaceNet(feat_dim=32, setting=SHORT_SETTING).eval()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    x = _t(rng.standard_normal((2, 112, 112, 3)).astype(np.float32))
    with torch.no_grad():
        y0 = net(x)
        with quant.int8_conv_inference():
            assert quant.int8_active()
            y1 = net(x)
        assert not quant.int8_active()
        y2 = net(x)
    after = net.state_dict()
    assert list(after) == list(before)
    for k, v in after.items():
        assert v.shape == before[k].shape and torch.equal(v, before[k]), k
    assert torch.equal(y0, y2) and not torch.equal(y0, y1)
    with pytest.raises(RuntimeError, match="inside"):
        with quant.int8_conv_inference():
            raise RuntimeError("inside")
    assert not quant.int8_active()  # reset on the way out of a raising block


# ----------------------------------------------------------------------
# Embedder(int8=True)
# ----------------------------------------------------------------------


def _jax_int8_embed(jmodel, variables, images):
    """JAX's ``Embedder(int8=True)`` forward with flip (``vlsfr_tpu/eval/
    extract.py``), the variables passed as arguments: closed over, as the
    class does, XLA constant-folds every weight's quantisation (8 s here)."""
    from vlsfr_tpu.models.layers import l2_normalize

    def forward(v, x):
        with jquant.int8_conv_inference():
            emb = jmodel.apply(v, x, train=False)
            emb2 = jmodel.apply(v, x[:, :, ::-1, :], train=False)
        return l2_normalize(emb + emb2)
    return np.asarray(jax.jit(forward)(variables, jnp.asarray(images)))


def _calibrated(jmodel, variables, x):
    """``variables`` with every BN's running statistics set to those of the
    batch ``x`` (recovered from one train-mode step of flax's EMA): at the
    initial (0, 1) a random net's eval-mode activations grow block by
    block, and int8 roundings that the two frameworks' last-bit f32
    differences flip then compound."""
    _, mut = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x, jnp.float32))
    stats = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, mut["batch_stats"],
                         variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("net", ["iresnet", "mobile"])
def test_embedder_int8_matches_jax(net, rng):
    from vlsfr_tpu.models.iresnet import IResNet as JIResNet
    from vlsfr_tpu.models.mobilefacenet import MobileFaceNet as JMobileFaceNet
    from vlsfr_tpu_torch.eval.extract import Embedder
    from vlsfr_tpu_torch.models.iresnet import IResNet
    from vlsfr_tpu_torch.models.mobilefacenet import MobileFaceNet

    if net == "iresnet":
        size, jmodel = 32, JIResNet(layers=(1, 1, 1, 1), feat_dim=32)
        tmodel = IResNet(layers=(1, 1, 1, 1), feat_dim=32, image_size=32)
    else:
        size, jmodel = 112, JMobileFaceNet(feat_dim=32, setting=SHORT_SETTING)
        tmodel = MobileFaceNet(feat_dim=32, setting=SHORT_SETTING)
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, size, size, 3)))
    images = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    variables = _calibrated(jmodel, variables, rng.standard_normal((8, size, size, 3)))
    load_flax_variables(tmodel, jax.device_get(variables["params"]),
                        jax.device_get(variables["batch_stats"]))
    want = _jax_int8_embed(jmodel, variables, images)
    convs = [m for m in tmodel.modules() if isinstance(m, tlayers.Conv) and quant.eligible(m)]
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((m, i[0].clone(), o.clone())) if len(seen) < len(convs)
        else None) for m in convs]  # the first (unflipped) forward's
    quant.reset_launch_counts()
    got = Embedder(tmodel, batch_size=4, device="cpu", int8=True)(images)
    for h in hooks:
        h.remove()
    assert quant.LAUNCH_COUNTS["int8_conv"] == 2 * len(convs) == 2 * len(seen)
    for m, x, y in seen:  # each conv of the net on its own input: JAX's operands and output
        k, stride, pad = m.kernel_size[0], m.stride[0], m.padding[0]
        w = m.weight.detach()
        jy, (jxq, jwq) = _jax_int8_conv(x.permute(0, 2, 3, 1).numpy(),
                                        w.permute(2, 3, 1, 0).numpy(), None, k, stride, pad,
                                        jnp.float32)
        d, _, wq, _ = quant.conv_scales(x, w)
        np.testing.assert_array_equal(quant.quantize_input(x, d).permute(0, 2, 3, 1).numpy(),
                                      jxq)
        np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), jwq)
        np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), jy, rtol=0,
                                   atol=F32_REL * np.abs(jy).max())
    assert got.shape == want.shape == (4, 32)
    assert _cos(got, want).min() > FIDELITY_COS, _cos(got, want)
    fp = Embedder(tmodel, batch_size=4, device="cpu")(images)
    assert _cos(got, fp).min() > FIDELITY_COS and not np.array_equal(got, fp)


# ----------------------------------------------------------------------
# pool.gallery_int8
# ----------------------------------------------------------------------


class _JImgEmbed(nn.Module):
    """tests/test_quant.py's ``ImgEmbed``: conv, BN, mean, Dense."""

    feat_dim: int = 16

    @nn.compact
    def __call__(self, x, train=True):
        x = jlayers.Conv(8, 3, 2, 1, name="c1")(x)
        x = jlayers.BatchNorm(name="bn")(x, train)
        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(self.feat_dim, name="fc")(x)


class _ImgEmbed(torch.nn.Module):
    def __init__(self, feat_dim: int = 16):
        super().__init__()
        self.c1 = tlayers.Conv(3, 8, 3, 2, 1)
        self.bn = tlayers.BatchNorm(8)
        self.fc = torch.nn.Linear(8, feat_dim)

    def forward(self, x):
        x = self.bn(self.c1(x.permute(0, 3, 1, 2)))
        return self.fc(x.mean(dim=(2, 3)))

    def load_jax(self, params, stats):
        sd = {"c1.weight": params["c1"]["conv"]["kernel"].transpose(3, 2, 0, 1),
              "bn.weight": params["bn"]["bn"]["scale"], "bn.bias": params["bn"]["bn"]["bias"],
              "bn.running_mean": stats["bn"]["bn"]["mean"],
              "bn.running_var": stats["bn"]["bn"]["var"],
              "fc.weight": params["fc"]["kernel"].T, "fc.bias": params["fc"]["bias"]}
        self.load_state_dict({k: _t(np.asarray(v)) for k, v in sd.items()})
        return self


@pytest.mark.parametrize("fuse_forward", [True, False])
def test_gallery_int8_steps_match_jax(fuse_forward, rng):
    import copy

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.core.dcp import DCPManager as JDCP
    from vlsfr_tpu.core.ffc import create_ffc_state as j_create_state
    from vlsfr_tpu.core.ffc import make_train_step as j_make_step
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.optim import make_schedule as j_make_schedule
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import FFCState, make_train_step
    from vlsfr_tpu_torch.optim import make_optimizer, make_schedule

    b, q, d, size = 8, 64, 16, 12
    ov = ["model.feat_dim=16", f"pool.queue_size={q}", "model.dtype=float32",
          "pool.momentum=0.9", "optim.lr=0.01", "loss.scale=32", "pool.hard_neg=4",
          "pool.use_fused=off", f"pool.fuse_forward={fuse_forward}"]
    jcfg = JConfig().apply_overrides(ov + ["pool.gallery_int8=true"])
    jmodel, jopt = _JImgEmbed(), j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, size)
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 10)))
    params = jax.device_get(jstate.probe_params)
    stats = jax.device_get(jstate.probe_stats)

    def port_state():
        probe = _ImgEmbed().load_jax(params, stats)
        return FFCState(step=0, probe=probe, gallery=copy.deepcopy(probe).requires_grad_(False),
                        queue=torch.from_numpy(np.array(jstate.queue)),
                        optimizer=make_optimizer(Config().apply_overrides(ov).optim,
                                                 probe.parameters()))

    states, steps, probe_out = {}, {}, {}
    for flag in (True, False):
        cfg = Config().apply_overrides(ov + [f"pool.gallery_int8={flag}"])
        states[flag] = port_state()
        steps[flag] = make_train_step(cfg, make_schedule(cfg.optim, 10))
        probe_out[flag] = []
        states[flag].probe.register_forward_hook(
            lambda m, i, o, out=probe_out[flag]: out.append(o.detach().clone()))
    jdcp, dcp = JDCP(q), {flag: DCPManager(q) for flag in (True, False)}
    for s in range(2):
        labels = rng.integers(0, 20, b)
        x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
        y = rng.standard_normal((b, size, size, 3)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jdcp.plan_step(labels, labels),
                           1.0)
        quant.reset_launch_counts()
        m = steps[True](states[True], x, y, dcp[True].plan_step(labels, labels), 1.0)
        assert quant.LAUNCH_COUNTS["int8_conv"] == (1 if fuse_forward else 2)  # gallery only
        for k in ("loss", "loss_dir_a", "loss_dir_b"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                       err_msg=f"{k}@{s}")
        probe = states[True].probe
        want = {k: v.numpy() for k, v in _ImgEmbed().load_jax(
            jax.device_get(jstate.probe_params), jax.device_get(jstate.probe_stats)
        ).state_dict().items()}
        for k, v in probe.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{k}@{s}")
        if s == 0:  # the same state and batch without the flag
            mf = steps[False](states[False], x, y, dcp[False].plan_step(labels, labels), 1.0)
            assert quant.LAUNCH_COUNTS["int8_conv"] == (1 if fuse_forward else 2)
            assert len(probe_out[True]) == len(probe_out[False]) > 0
            for a, c in zip(probe_out[True], probe_out[False]):
                assert torch.equal(a, c)  # the probe's embeddings do not see the flag
            assert float(mf["loss"]) != float(m["loss"])  # the gallery's do


# ----------------------------------------------------------------------
# bn_stats_rows (_SubsetBN)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("rows,batch", [(2, 8), (3, 8), (4, 10)])  # 4 at 10: 5 rows
def test_subset_bn_layer_matches_jax(rows, batch, rng):
    c = 6
    jbn = jlayers.BatchNorm(bn_stats_rows=rows)
    x = (rng.standard_normal((batch, 5, 4, c)) * 2.0 + 0.5).astype(np.float32)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    p = {"bn": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.standard_normal(c).astype(np.float32)}}
    st = {"bn": {"mean": rng.standard_normal(c).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    assert jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(
        {"params": p, "batch_stats": st})  # the flax BatchNorm's layout
    tbn = tlayers.BatchNorm(c, bn_stats_rows=rows)
    tbn.load_state_dict({"weight": _t(p["bn"]["scale"]), "bias": _t(p["bn"]["bias"]),
                         "running_mean": _t(st["bn"]["mean"]),
                         "running_var": _t(st["bn"]["var"])})
    want, mut = jbn.apply({"params": p, "batch_stats": st}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    xt = _t(x.transpose(0, 3, 1, 2))
    got = tbn.train()(xt)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=BN_ATOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(), mut["batch_stats"]["bn"]["mean"],
                               atol=BN_ATOL)
    np.testing.assert_allclose(tbn.running_var.numpy(), mut["batch_stats"]["bn"]["var"],
                               atol=BN_ATOL)
    full = tlayers.BatchNorm(c)  # the subset statistics are not the whole batch's
    full.load_state_dict(tbn.state_dict())
    assert not torch.allclose(full.train()(xt), got)
    want = jbn.apply({"params": p, "batch_stats": mut["batch_stats"]}, jnp.asarray(x),
                     train=False)
    got = tbn.eval()(xt).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=BN_ATOL)


@pytest.mark.parametrize("rows", [2, 3])
def test_subset_bn_iresnet_matches_jax(rows, rng):
    from vlsfr_tpu.models.iresnet import IResNet as JIResNet
    from vlsfr_tpu_torch.models.iresnet import IResNet

    jmodel = JIResNet(layers=(1, 1, 1, 1), feat_dim=32, bn_stats_rows=rows)
    tmodel = IResNet(layers=(1, 1, 1, 1), feat_dim=32, image_size=32, bn_stats_rows=rows)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    load_flax_variables(tmodel, jax.device_get(params), jax.device_get(stats))  # as is
    tmodel.train()
    for _ in range(2):
        x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
        want, mut = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                 train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        with torch.no_grad():
            got = tmodel(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NET_ATOL)
    expect = state_dict_from_flax(tmodel, jax.device_get(params), jax.device_get(stats))
    for k, v in tmodel.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4, atol=BN_ATOL,
                                       err_msg=k)
    x = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmodel.eval()(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NET_ATOL)


# ----------------------------------------------------------------------
# tools/evaluate.py --int8
# ----------------------------------------------------------------------


def test_evaluate_tool_int8_on_a_toy_checkpoint(tmp_path, capsys):
    import json

    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.data.records import MultiSourceReader
    from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store
    from vlsfr_tpu_torch.eval import verification as tver
    from vlsfr_tpu_torch.eval.extract import Embedder
    from vlsfr_tpu_torch.tools.evaluate import main
    from vlsfr_tpu_torch.train.trainer import Trainer

    store = str(tmp_path / "store")
    generate_synthetic_store(store, num_ids=8, images_per_id=4, image_size=16, seed=0)
    cfg = Config().apply_overrides([
        "model.net_type=toy", "model.feat_dim=16", "model.dtype=float32", "data.batch_size=8",
        "data.image_size=16", "data.num_workers=1", "pool.queue_size=32", "optim.epochs=1",
        "train.eval_freq=0", "train.holdout_records=0"])
    cfg.data.sources = [store]
    cfg.train.saved_dir = str(tmp_path / "ckpt")
    t = Trainer(cfg, device="cpu")
    try:
        t.train()
        probe = t.state.probe
    finally:
        t.close()
    report = main(["--ckpt", cfg.train.saved_dir, "--store", store, "--net_type", "toy",
                   "--feat_dim", "16", "--image_size", "16", "--num_pairs", "40", "--int8",
                   "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    reader = MultiSourceReader([store])
    try:
        emb = Embedder(probe, device="cpu", int8=True).from_reader(reader, 16)
        i1, i2, same = tver.make_verification_pairs(reader.labels, 40)
    finally:
        reader.close()
    acc, _ = tver.kfold_verification_accuracy(tver.cosine_scores(emb[i1], emb[i2]), same)
    assert report["verification_acc"] == round(acc, 4) and report["records"] == 32
