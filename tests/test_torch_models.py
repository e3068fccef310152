"""Each of the port's networks against the JAX package's, on the CPU.

The JAX networks are initialized under ``jax.jit``; their weights go into
the port through ``load_module_variables`` (the per-module half of
``load_jax_variables``). Forward outputs are compared in eval mode and in
train mode, and the BatchNorm running statistics after the train-mode
forward. LiteMono runs at 64x96 with drop-path off on both sides. The last
test carries the port's state dict back through the JAX package's own
torch -> flax converter and recovers the original flax tree.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.models.convert import load_module_variables
from dynamo_depth_torch.models.depth_decoder import LiteDepthDecoder as TLiteDepthDecoder
from dynamo_depth_torch.models.litemono import LiteMono as TLiteMono
from dynamo_depth_torch.models.motion_decoder import MotionDecoder as TMotionDecoder
from dynamo_depth_torch.models.pose_decoder import PoseDecoder as TPoseDecoder
from dynamo_depth_torch.models.resnet import ResnetEncoder as TResnetEncoder
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.models.depth_decoder import LiteDepthDecoder
from dynamo_depth_tpu.models.litemono import LiteMono
from dynamo_depth_tpu.models.motion_decoder import MotionDecoder
from dynamo_depth_tpu.models.pose_decoder import PoseDecoder
from dynamo_depth_tpu.models.resnet import ResnetEncoder

CFG = types.SimpleNamespace(depth_model="litemono", scales=[0, 1, 2], encoder_num_layers=18)
B = 2
ENC_CH = (64, 64, 128, 256, 512)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(module, *args, **kwargs):
    variables = jax.jit(lambda k: module.init(k, *args, **kwargs))(jax.random.PRNGKey(0))
    return _np(variables["params"]), _np(variables.get("batch_stats", {}))


def _inputs(name, rng):
    """Random NHWC inputs of each network at its main-path shapes (cut to
    64x96)."""
    if name in ("pose_enc", "motion_enc"):
        n = 2 if name == "pose_enc" else 3
        return [rng.rand(B, 64, 96, 3 * n).astype(np.float32)]
    if name == "depth_enc":
        return [rng.rand(B, 64, 96, 3).astype(np.float32)]
    if name == "depth_dec":
        return [[rng.randn(B, 64 // s, 96 // s, c).astype(np.float32) for s, c in ((4, 64), (8, 128), (16, 224))]]
    if name == "pose_dec":
        return [rng.randn(B, 2, 3, 512).astype(np.float32)]
    pyramid = [rng.rand(B, 64, 96, 9).astype(np.float32)]
    pyramid += [rng.randn(B, 64 // 2 ** (i + 1), 96 // 2 ** (i + 1), c).astype(np.float32) for i, c in enumerate(ENC_CH)]
    return [pyramid, (rng.randn(B, 6) * 0.01).astype(np.float32)]


def _nets():
    """name -> (jax module, port module factory, has BatchNorm, module name
    for the converters)."""
    return {
        "pose_enc": (ResnetEncoder(18, 2), lambda: TResnetEncoder(18, 2), True, "pose_enc"),
        "motion_enc": (ResnetEncoder(18, 3), lambda: TResnetEncoder(18, 3), True, "motion_enc"),
        "depth_enc": (LiteMono(drop_path_rate=0.0), lambda: TLiteMono(drop_path_rate=0.0), True, "depth_enc"),
        "depth_dec": (LiteDepthDecoder(num_ch_enc=(64, 128, 224), scales=(0, 1, 2)),
                      lambda: TLiteDepthDecoder((64, 128, 224), scales=(0, 1, 2)), False, "depth_dec"),
        "pose_dec": (PoseDecoder(2), lambda: TPoseDecoder(512, 2), False, "pose_dec"),
        "motion_dec": (MotionDecoder(num_ch_enc=ENC_CH, scales=(0, 1, 2), out_dim=3),
                       lambda: TMotionDecoder(ENC_CH, scales=(0, 1, 2), out_dim=3), False, "motion_dec"),
        "motion_mask": (MotionDecoder(num_ch_enc=ENC_CH, scales=(0, 1, 2), out_dim=1),
                        lambda: TMotionDecoder(ENC_CH, scales=(0, 1, 2), out_dim=1), False, "motion_mask"),
    }


NAMES = list(_nets())


@pytest.fixture(scope="module")
def jax_vars():
    rng = np.random.RandomState(1)
    out = {}
    for name, (jmod, _, has_bn, _) in _nets().items():
        args = [jax.tree.map(jnp.asarray, a) for a in _inputs(name, rng)]
        kwargs = {"train": False} if has_bn else {}
        out[name] = _init(jmod, *args, **kwargs)
    return out


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


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(jax_vars, name, train):
    jmod, make, has_bn, conv_name = _nets()[name]
    params, stats = jax_vars[name]
    rng = np.random.RandomState(2)
    args = _inputs(name, rng)

    port = load_module_variables(make(), conv_name, params, stats)
    port.train(train)
    with torch.no_grad():
        out = port(*_to_torch(args))

    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    jargs = [jax.tree.map(jnp.asarray, a) for a in args]
    if has_bn:
        ref, mut = jmod.apply(variables, *jargs, train=train, mutable=["batch_stats"])
    else:
        ref, mut = jmod.apply(variables, *jargs), {}
    _compare(_flat(out), _flat(ref), RTOL, SCALE_ATOL)

    if has_bn and train:
        # Running statistics after one train-mode forward: momentum 0.9 with
        # the biased batch variance, as flax updates them.
        _, s2 = convert_module(conv_name, {k: v.numpy() for k, v in port.state_dict().items()}, CFG)
        flat_ref = jax.tree_util.tree_leaves_with_path(_np(mut["batch_stats"]))
        flat_port = dict(jax.tree_util.tree_leaves_with_path(s2))
        assert len(flat_ref) == len(flat_port)
        _compare({p: flat_port[p] for p, _ in flat_ref}, dict(flat_ref), RTOL, SCALE_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_roundtrip(jax_vars, name):
    """port state_dict -> dynamo_depth_tpu convert_module -> the flax tree
    the weights came from, exactly."""
    _, make, _, conv_name = _nets()[name]
    params, stats = jax_vars[name]
    port = load_module_variables(make(), conv_name, params, stats)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    p2, s2 = convert_module(conv_name, sd, CFG)
    for ref, got in ((params, p2), (stats, s2)):
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(ref_leaves) == len(got_leaves)
        for path, v in ref_leaves:
            np.testing.assert_array_equal(got_leaves[path], v, err_msg=str(path))
