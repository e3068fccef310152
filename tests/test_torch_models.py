"""Each of the port's networks against the JAX package's, on the CPU.

The JAX networks are initialized under ``jax.jit``; their weights go into
the port through ``load_module_variables`` (the per-module half of
``load_jax_variables``). Forward outputs are compared in eval mode and in
train mode, and the BatchNorm running statistics after the train-mode
forward. LiteMono runs at 64x96 with drop-path off on both sides. The last
test carries the port's state dict back through the JAX package's own
torch -> flax converter and recovers the original flax tree.

Both tests run each network at ``encoder_num_layers`` 18 (LiteMono depth,
ResNet-18 pose and motion encoders) and 50 (Monodepth2's ResNet-50
configuration: the bottleneck trunk in all three encoders, and the
Monodepth2 depth decoder, the pose squeeze and both motion decoders at its
widths, 4 scales).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.models.convert import load_module_variables
from dynamo_depth_torch.models.depth_decoder import DepthDecoder as TDepthDecoder
from dynamo_depth_torch.models.depth_decoder import LiteDepthDecoder as TLiteDepthDecoder
from dynamo_depth_torch.models.litemono import LiteMono as TLiteMono
from dynamo_depth_torch.models.motion_decoder import MotionDecoder as TMotionDecoder
from dynamo_depth_torch.models.pose_decoder import PoseDecoder as TPoseDecoder
from dynamo_depth_torch.models.resnet import ResnetEncoder as TResnetEncoder
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.models.depth_decoder import DepthDecoder
from dynamo_depth_tpu.models.depth_decoder import LiteDepthDecoder
from dynamo_depth_tpu.models.litemono import LiteMono
from dynamo_depth_tpu.models.motion_decoder import MotionDecoder
from dynamo_depth_tpu.models.pose_decoder import PoseDecoder
from dynamo_depth_tpu.models.resnet import ResnetEncoder

# The converters' view of each encoder depth: the depth network and the
# scales of the configuration that runs it.
CFGS = {18: types.SimpleNamespace(depth_model="litemono", scales=[0, 1, 2], encoder_num_layers=18),
        50: types.SimpleNamespace(depth_model="monodepthv2", scales=[0, 1, 2, 3], encoder_num_layers=50)}
B = 2
ENC_CH = {18: (64, 64, 128, 256, 512), 50: (64, 256, 512, 1024, 2048)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(module, *args, **kwargs):
    variables = jax.jit(lambda k: module.init(k, *args, **kwargs))(jax.random.PRNGKey(0))
    return _np(variables["params"]), _np(variables.get("batch_stats", {}))


def _pyramid(rng, channels):
    """A 5-level encoder pyramid of a 64x96 image, NHWC."""
    return [rng.randn(B, 64 // 2 ** (i + 1), 96 // 2 ** (i + 1), c).astype(np.float32) for i, c in enumerate(channels)]


def _inputs(name, rng, layers):
    """Random NHWC inputs of each network at its main-path shapes (cut to
    64x96)."""
    ch = ENC_CH[layers]
    if name in ("pose_enc", "motion_enc"):
        n = 2 if name == "pose_enc" else 3
        return [rng.rand(B, 64, 96, 3 * n).astype(np.float32)]
    if name == "depth_enc":
        return [rng.rand(B, 64, 96, 3).astype(np.float32)]
    if name == "depth_dec":
        if layers == 50:
            return [_pyramid(rng, ch)]
        return [[rng.randn(B, 64 // s, 96 // s, c).astype(np.float32) for s, c in ((4, 64), (8, 128), (16, 224))]]
    if name == "pose_dec":
        return [rng.randn(B, 2, 3, ch[-1]).astype(np.float32)]
    pyramid = [rng.rand(B, 64, 96, 9).astype(np.float32)] + _pyramid(rng, ch)
    return [pyramid, (rng.randn(B, 6) * 0.01).astype(np.float32)]


def _nets(layers):
    """name -> (jax module, port module factory, has BatchNorm, module name
    for the converters), at ``encoder_num_layers`` ``layers``."""
    ch, scales = ENC_CH[layers], tuple(CFGS[layers].scales)
    if layers == 50:
        depth = {
            "depth_enc": (ResnetEncoder(50, 1), lambda: TResnetEncoder(50, 1), True, "depth_enc"),
            "depth_dec": (DepthDecoder(num_ch_enc=ch, scales=scales), lambda: TDepthDecoder(ch, scales=scales), False,
                          "depth_dec"),
        }
    else:
        depth = {
            "depth_enc": (LiteMono(drop_path_rate=0.0), lambda: TLiteMono(drop_path_rate=0.0), True, "depth_enc"),
            "depth_dec": (LiteDepthDecoder(num_ch_enc=(64, 128, 224), scales=(0, 1, 2)),
                          lambda: TLiteDepthDecoder((64, 128, 224), scales=(0, 1, 2)), False, "depth_dec"),
        }
    return {
        "pose_enc": (ResnetEncoder(layers, 2), lambda: TResnetEncoder(layers, 2), True, "pose_enc"),
        "motion_enc": (ResnetEncoder(layers, 3), lambda: TResnetEncoder(layers, 3), True, "motion_enc"),
        **depth,
        "pose_dec": (PoseDecoder(2), lambda: TPoseDecoder(ch[-1], 2), False, "pose_dec"),
        "motion_dec": (MotionDecoder(num_ch_enc=ch, scales=scales, out_dim=3),
                       lambda: TMotionDecoder(ch, scales=scales, out_dim=3), False, "motion_dec"),
        "motion_mask": (MotionDecoder(num_ch_enc=ch, scales=scales, out_dim=1),
                        lambda: TMotionDecoder(ch, scales=scales, out_dim=1), False, "motion_mask"),
    }


NAMES = list(_nets(18))
# (encoder_num_layers, network); the ResNet-18 cases keep their plain names.
CASES = [pytest.param(layers, name, id=name if layers == 18 else f"r{layers}_{name}")
         for layers in (18, 50) for name in NAMES]


@pytest.fixture(scope="module")
def jax_vars():
    """(layers, name) -> the JAX network's (params, batch_stats), each
    initialised once, when first asked for."""
    cache = {}

    def get(layers, name):
        if (layers, name) not in cache:
            jmod, _, has_bn, _ = _nets(layers)[name]
            args = [jax.tree.map(jnp.asarray, a) for a in _inputs(name, np.random.RandomState(1), layers)]
            cache[layers, name] = _init(jmod, *args, **({"train": False} if has_bn else {}))
        return cache[layers, name]
    return get


def _load(layers, name, params, stats):
    """The port's network ``name`` holding the JAX network's variables."""
    _, make, _, conv_name = _nets(layers)[name]
    cfg = CFGS[layers]
    return load_module_variables(make(), conv_name, params, stats, scales=tuple(cfg.scales),
                                 depth_model=cfg.depth_model)


def _to_torch(x):
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    x = np.asarray(x)
    return torch.tensor(nhwc_to_nchw(x) if x.ndim == 4 else x)


def _flat(out):
    """Network output (dict, tuple or list) -> {key: NHWC numpy}, either package."""
    items = out.items() if isinstance(out, dict) else enumerate(out)
    return {k: _nhwc(v) for k, v in items}


def _nhwc(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().numpy()
        return nchw_to_nhwc(v) if v.ndim == 4 else v
    return np.asarray(v)


def _compare(a, b, rtol, scale_atol):
    """|a - b| <= scale_atol * max|b| + rtol * |b| for every output."""
    assert a.keys() == b.keys()
    for k in a:
        atol = scale_atol * float(np.max(np.abs(b[k]))) + 1e-7
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=str(k))


# Float32 convolution stacks on both sides (flax at Precision.HIGHEST),
# summed in another order. Train-mode BatchNorm divides by batch standard
# deviations taken over few samples at the coarse levels (flax's
# E[x^2] - E[x]^2 against torch's two-pass variance), which turns ~1e-6
# round-off into ~1e-5 of the tensor's scale near zero crossings. So: 2e-4
# relative, plus 2e-5 of each output's largest magnitude.
RTOL, SCALE_ATOL = 2e-4, 2e-5


# Train mode through a ResNet-50 encoder is compared in float64 on both
# sides. There BatchNorm normalises by statistics of as few as 12 values a
# channel (layer4 at 2x3, batch 2) through 16 bottlenecks, and float32
# round-off grows to 6.3e-4 of layer4's scale in the JAX package (against
# its own float64 forward) and 1.4e-4 in the port; in float64 the two agree
# to 1e-12. So float64 holds the equations at the tolerance above.
F64_LAYERS = 50


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("layers,name", CASES)
def test_network_matches_jax(jax_vars, layers, name, train):
    jmod, _, has_bn, conv_name = _nets(layers)[name]
    params, stats = jax_vars(layers, name)
    rng = np.random.RandomState(2)
    args = _inputs(name, rng, layers)
    f64 = train and has_bn and layers == F64_LAYERS

    port = _load(layers, name, params, stats)
    port.train(train)
    inputs = _to_torch(args)
    if f64:
        port, inputs = port.double(), [x.double() for x in inputs]
    with torch.no_grad():
        out = port(*inputs)

    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    with jax.enable_x64(f64):
        dtype = jnp.float64 if f64 else jnp.float32
        jmod = jmod.clone(dtype=dtype) if f64 else jmod
        variables = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        jargs = [jax.tree.map(lambda a: jnp.asarray(a, dtype), a) for a in args]
        if has_bn:
            ref, mut = jmod.apply(variables, *jargs, train=train, mutable=["batch_stats"])
        else:
            ref, mut = jmod.apply(variables, *jargs), {}
        ref, mut = _np(ref), _np(mut)
    _compare(_flat(out), _flat(ref), RTOL, SCALE_ATOL)

    if has_bn and train:
        # Running statistics after one train-mode forward: momentum 0.9 with
        # the biased batch variance, as flax updates them.
        _, s2 = convert_module(conv_name, {k: v.numpy() for k, v in port.state_dict().items()}, CFGS[layers])
        flat_ref = jax.tree_util.tree_leaves_with_path(_np(mut["batch_stats"]))
        flat_port = dict(jax.tree_util.tree_leaves_with_path(s2))
        assert len(flat_ref) == len(flat_port)
        _compare({p: flat_port[p] for p, _ in flat_ref}, dict(flat_ref), RTOL, SCALE_ATOL)


@pytest.mark.parametrize("layers,name", CASES)
def test_state_dict_roundtrip(jax_vars, layers, name):
    """port state_dict -> dynamo_depth_tpu convert_module -> the flax tree
    the weights came from, exactly (at ResNet-50: each bottleneck's
    ``conv3``, ``bn3`` and ``downsample`` keys too)."""
    _, _, _, conv_name = _nets(layers)[name]
    params, stats = jax_vars(layers, name)
    port = _load(layers, name, params, stats)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    p2, s2 = convert_module(conv_name, sd, CFGS[layers])
    for ref, got in ((params, p2), (stats, s2)):
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(ref_leaves) == len(got_leaves)
        for path, v in ref_leaves:
            np.testing.assert_array_equal(got_leaves[path], v, err_msg=str(path))
