"""The port's monodepthv2 depth network against the JAX package's, on the CPU.

ResNet-18 widths at 64x96, batch 2. The JAX weights come from a jitted init
and go into the port through ``load_module_variables`` / ``load_jax_variables``
(``depth_model="monodepthv2"``). Held against the JAX package: the nearest
resizes, the Monodepth2 ``DepthDecoder``, the whole ``DynamoModel`` forward
in eval mode and its outputs and backward in train mode, and one
``fine_tune`` step: its loss terms and BatchNorm statistics at the tolerances of
``test_torch_train_step.py``, its module gradients at the tolerance its
conditioning allows (``STEP_GRAD_TOL``). The state dict goes back through
the JAX package's ``convert_module``, and a ``.pth`` folder that a bfloat16
port run wrote loads into the JAX package's ``Trainer``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.convert import load_jax_variables, load_module_variables
from dynamo_depth_torch.models.depth_decoder import DepthDecoder as TDepthDecoder
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.models.model import DynamoModel as TDynamoModel
from dynamo_depth_torch.models.resnet import ResnetEncoder as TResnetEncoder
from dynamo_depth_torch.ops import warp as t_warp
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.models.depth_decoder import DepthDecoder
from dynamo_depth_tpu.models.model import DynamoModel
from dynamo_depth_tpu.ops import warp as j_warp
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from test_torch_models import RTOL, SCALE_ATOL, _compare
from test_torch_train_step import (  # noqa: F401
    _port_tree,
    init_variables,
    jax_model,
    run_step,
    test_batch_stats_match,
    test_cpu_step_launches_no_kernel,
    test_losses_match,
)
from torch_test_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 64, 96
KW = dict(dataset="kitti", depth_model="monodepthv2", encoder_num_layers=18, height=H, width=W, batch_size=B,
          weights_init="scratch")
CFG = types.SimpleNamespace(depth_model="monodepthv2", scales=[0, 1, 2, 3], encoder_num_layers=18)
ENC_CH = (64, 64, 128, 256, 512)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_tree_equal(ref, got):
    ref, got = _leaves(ref), _leaves(got)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=str(k))


def test_upsample2x_nearest_matches_jax():
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(j_warp.upsample2x_nearest(jnp.asarray(x)))
    got = nchw_to_nhwc(t_warp.upsample2x_nearest(torch.tensor(nhwc_to_nchw(x))).numpy())
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape_in,shape_out", [((7, 11), (12, 17)), ((12, 18), (5, 7)), ((6, 8), (12, 16)),
                                                ((64, 96), (375, 1242)), ((5, 9), (5, 9))])
def test_resize_nearest_matches_jax(shape_in, shape_out):
    x = np.random.RandomState(1).randn(2, *shape_in, 3).astype(np.float32)
    ref = np.asarray(j_warp.resize_nearest(jnp.asarray(x), shape_out))
    got = nchw_to_nhwc(t_warp.resize_nearest(torch.tensor(nhwc_to_nchw(x)), shape_out).numpy())
    np.testing.assert_array_equal(got, ref)


def _pyramid(rng):
    return [rng.randn(B, H // 2 ** (i + 1), W // 2 ** (i + 1), c).astype(np.float32) for i, c in enumerate(ENC_CH)]


@pytest.fixture(scope="module")
def decoder_params():
    feats = _pyramid(np.random.RandomState(3))
    module = DepthDecoder(num_ch_enc=ENC_CH, scales=(0, 1, 2, 3))
    variables = jax.jit(lambda k: module.init(k, [jnp.asarray(f) for f in feats]))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables["params"])


def test_depth_decoder_matches_jax(decoder_params):
    port = load_module_variables(TDepthDecoder(ENC_CH, scales=(0, 1, 2, 3)), "depth_dec", decoder_params, {},
                                 depth_model="monodepthv2")
    feats = _pyramid(np.random.RandomState(4))
    with torch.no_grad():
        out = port([torch.tensor(nhwc_to_nchw(f)) for f in feats])
    ref = DepthDecoder(num_ch_enc=ENC_CH, scales=(0, 1, 2, 3)).apply(
        {"params": decoder_params}, [jnp.asarray(f) for f in feats])
    assert {k: tuple(v.shape) for k, v in out.items()} == {("disp", s): (B, 1, H // 2 ** s, W // 2 ** s)
                                                           for s in range(4)}
    _compare({k: nchw_to_nhwc(v.numpy()) for k, v in out.items()}, {k: np.asarray(v) for k, v in ref.items()},
             RTOL, SCALE_ATOL)


def test_depth_decoder_keys_are_the_references(decoder_params):
    keys = set(TDepthDecoder(ENC_CH).state_dict())
    assert "upconv_4_0.conv.conv.weight" in keys and "dispconv_0.conv.weight" in keys and "dispconv_3.conv.bias" in keys
    assert len(keys) == 2 * (10 + 4)


def test_state_dict_roundtrip(decoder_params):
    """port state dict -> the JAX package's convert_module -> the flax tree it
    came from, exactly: the decoder, and the ResNet depth encoder."""
    port = load_module_variables(TDepthDecoder(ENC_CH), "depth_dec", decoder_params, {}, depth_model="monodepthv2")
    params, stats = convert_module("depth_dec", {k: v.numpy() for k, v in port.state_dict().items()}, CFG)
    _assert_tree_equal(decoder_params, params)
    assert not stats

    torch.manual_seed(0)
    enc = TResnetEncoder(18, 1)
    for m in enc.modules():  # running statistics that differ from their initial values
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_()
            m.running_var.uniform_(0.5, 2.0)
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    params, stats = convert_module("depth_enc", sd, CFG)
    back = load_module_variables(TResnetEncoder(18, 1), "depth_enc", params, stats, depth_model="monodepthv2")
    for k, v in back.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


@pytest.fixture(scope="module")
def model_variables():
    return init_variables(JConfig(**KW))


def _images():
    batch = synthetic_batch(TConfig(**KW), B, H, W)
    return {k: v for k, v in batch.items() if isinstance(k, tuple) and k[0] == "color_aug"}


def _port_model(variables, train):
    port = TDynamoModel(depth_model="monodepthv2", scales=CFG.scales)
    load_jax_variables(port, variables["params"], variables["batch_stats"], JConfig(**KW))
    return port.train(train)


def _nhwc_outputs(out):
    return {k: nchw_to_nhwc(v.detach().numpy()) if v.dim() == 4 else v.detach().numpy() for k, v in out.items()}


def test_model_forward_matches_jax(model_variables):
    """Eval mode, as ``Trainer.predict`` runs it."""
    images = _images()
    ref = jax.jit(lambda v, x: jax_model(JConfig(**KW)).apply(v, x, train=False))(
        model_variables, {k: jnp.asarray(v) for k, v in images.items()})
    with torch.no_grad():
        out = _port_model(model_variables, False)({k: torch.tensor(nhwc_to_nchw(v)) for k, v in images.items()})
    assert out.keys() == ref.keys()
    assert {k for k in out if k[0] == "disp"} == {("disp", f, s) for f in (0, -1, 1) for s in range(4)}
    _compare(_nhwc_outputs(out), {k: np.asarray(v) for k, v in ref.items()}, RTOL, SCALE_ATOL)


def test_model_backward_matches_jax(model_variables):
    """Train mode: the outputs, and every module's gradient for the same
    random cotangent on every output (the networks' backward, apart from
    the losses), against the JAX model run in float64. In float32 the JAX
    package's backward of the one-image ResNet depth encoder lies 3.6e-3 of
    its norm from its own float64 backward; the port's lies 2.8e-6 from its
    float64 backward."""
    images = _images()
    model = DynamoModel(depth_model="monodepthv2", scales=tuple(CFG.scales), dtype=jnp.float64)
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), model_variables)
        x = {k: jnp.asarray(v, jnp.float64) for k, v in images.items()}

        def forward(params):
            out, _ = model.apply({"params": params, "batch_stats": f64["batch_stats"]}, x, train=True,
                                 mutable=["batch_stats"])
            return out

        ref = jax.jit(forward)(f64["params"])
        rng = np.random.RandomState(5)
        cot = {k: jnp.asarray(rng.randn(*v.shape), v.dtype) for k, v in ref.items()}
        ref_grads = jax.tree.map(np.asarray, jax.jit(lambda p: jax.vjp(forward, p)[1](cot)[0])(f64["params"]))
        ref, cot = jax.tree.map(np.asarray, ref), jax.tree.map(np.asarray, cot)

    port = _port_model(model_variables, True)
    out = port({k: torch.tensor(nhwc_to_nchw(v)) for k, v in images.items()})
    _compare(_nhwc_outputs(out), ref, RTOL, SCALE_ATOL)
    torch.autograd.backward([out[k] for k in cot],
                            [torch.tensor(nhwc_to_nchw(c) if c.ndim == 4 else c).float() for c in cot.values()])
    for m in MODULE_NAMES:
        mod = getattr(port, m)
        sd = {k: v.numpy().copy() for k, v in mod.state_dict().items()}
        for k, p in mod.named_parameters():
            sd[k] = np.zeros_like(sd[k]) if p.grad is None else p.grad.numpy().copy()
        got, want = _leaves(convert_module(m, sd, CFG)[0]), _leaves(ref_grads[m])
        assert got.keys() == want.keys(), m
        diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
        norm = np.sqrt(sum(np.sum(want[k] ** 2) for k in want))
        # test_torch_train_step.py's tolerance for a module's whole gradient.
        assert norm > 0 and diff / norm < 1e-3, (m, diff / norm)


@pytest.fixture(scope="module")
def step_results():
    return run_step("fine_tune", **{k: v for k, v in KW.items() if k not in ("dataset", "weights_init")})


def test_step_supervises_four_scales(step_results):
    assert step_results.cfg.scales == [0, 1, 2, 3]
    assert {f"loss_term/{s}" for s in range(4)} <= set(step_results.losses)


# The whole step's gradient is ill-conditioned at random init: the minimum
# over source frames picks between near-equal errors, so a 1e-6 relative
# change of the networks' outputs moves the gradient with respect to the
# disparity by up to 1e-2 of its norm (in the port alone). The two packages'
# outputs differ by up to 1.4e-6 here (train-mode BatchNorm over the coarse
# ResNet levels); on the same outputs, the gradients of view synthesis and
# the losses agree to 1e-5 at scales 0 and 1 and to 7.3e-3 at scales 2 and
# 3, where near ties sit; the JAX package's float32 backward of the depth
# encoder adds 3.6e-3 of its own. The step's module gradients differ by
# 2.1e-3 to 7.6e-3 of their norms. The networks' backward is held at 1e-3
# in test_model_backward_matches_jax (found: 5e-6).
STEP_GRAD_TOL = 2e-2


@pytest.mark.parametrize("module_name", MODULE_NAMES)
def test_step_gradients_match(step_results, module_name):
    r = step_results
    port, _ = _port_tree(r.trainer, module_name, r.cfg, grads=True)
    ref, got = _leaves(r.jax[1][module_name]), _leaves(port)
    assert ref.keys() == got.keys()
    diff = np.sqrt(sum(np.sum((got[k] - ref[k]) ** 2) for k in ref))
    norm = np.sqrt(sum(np.sum(ref[k] ** 2) for k in ref))
    assert norm > 0 and diff / norm < STEP_GRAD_TOL, (module_name, diff / norm)


def test_the_jax_trainer_loads_a_bfloat16_run_of_the_port(tmp_path):
    """A bfloat16 monodepthv2 run's folder: its BatchNorm statistics are
    float32 buffers, and the JAX package's Trainer loads every module as the
    port's state dict converts."""
    kw = dict(KW, compute_dtype="bfloat16", log_dir=str(tmp_path), model_name="bf16", print_opt=False)
    trainer = Trainer(TConfig(**kw), device="cpu", drop_path_rate=0.0)
    losses = trainer.train_step(trainer.to_device(synthetic_batch(trainer.cfg, B, H, W)),
                                torch.Generator().manual_seed(0), 5)
    assert all(np.isfinite(float(v)) for v in losses.values())
    floats = {k: v.dtype for k, v in trainer.model.state_dict().items() if v.is_floating_point()}
    assert set(floats.values()) == {torch.float32}, floats
    trainer.save_model("fine_tune", 0)
    folder = tmp_path / "bf16" / "models" / "fine_tune_00"

    cfg = JConfig(**{**kw, "num_devices": 1, "load_ckpt": str(folder)})
    variables = JTrainer(cfg).variables
    for m in MODULE_NAMES:
        params, stats = convert_module(m, {k: v.numpy() for k, v in getattr(trainer.model, m).state_dict().items()},
                                       cfg)
        _assert_tree_equal(params, variables["params"][m])
        if stats:
            _assert_tree_equal(stats, variables["batch_stats"][m])
