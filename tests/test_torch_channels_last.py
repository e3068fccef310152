"""The networks' memory layout, at ResNet-18 and ResNet-50.

The rule (``models/model.py::lay_out``): on a CUDA card the ResNet encoders
run channels-last (NHWC) from the stem's output on, and the Monodepth2
decoders that consume their features (``DepthDecoder``, ``PoseDecoder``,
``MotionDecoder``) hold channels-last weights; the stem's conv1, LiteMono
and its decoder stay NCHW, and every network output leaves in NCHW. On the
CPU everything stays NCHW. The tests lay the networks out channels-last on
the CPU, and hold their values against the benchmark's frozen reference
networks, the NCHW copy of the same modules: encoders in float64 (their
BatchNorm magnifies float32 round-off at these sizes,
``test_torch_models.py``), decoders (no BatchNorm) in float32. The tests
marked ``cuda`` skip without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_channels_last.py -q
"""

import types

import pytest
import torch

from benchmark.reference import depth_decoder as ref_depth_decoder
from benchmark.reference import motion_decoder as ref_motion_decoder
from benchmark.reference import pose_decoder as ref_pose_decoder
from benchmark.reference import resnet as ref_resnet
from dynamo_depth_torch.models.convert import load_jax_variables, module_to_jax_variables
from dynamo_depth_torch.models.depth_decoder import DepthDecoder
from dynamo_depth_torch.models import model as model_module
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel, lay_out, memory_format_for
from dynamo_depth_torch.models.motion_decoder import MotionDecoder
from dynamo_depth_torch.models.pose_decoder import PoseDecoder
from dynamo_depth_torch.models.resnet import ResnetEncoder
from dynamo_depth_torch.training.checkpoint import load_model, save_model
from torch_test_threads import two_torch_threads  # noqa: F401

CL = torch.channels_last
LAYERS = (18, 50)
SCALES = {"monodepthv2": (0, 1, 2, 3), "litemono": (0, 1, 2)}
MD2 = SCALES["monodepthv2"]
H, W = 64, 96


def _strides(t, memory_format):
    return torch.empty(t.shape, device="meta", memory_format=memory_format).stride()


def _is_channels_last(t):
    return t.dim() == 4 and t.stride() == _strides(t, CL)


def _is_nchw(t):
    return t.stride() == _strides(t, torch.contiguous_format)


def _expected_nchw(name: str, depth_model: str) -> bool:
    """Where the rule keeps a 4-D weight NCHW: the encoders' stem and all of
    LiteMono's depth network."""
    module = name.split(".")[0]
    if module.endswith("_enc") and name.startswith(f"{module}.encoder.conv1."):
        return True
    return depth_model == "litemono" and module in ("depth_enc", "depth_dec")


def _weights(model):
    return [(n, p) for n, p in model.named_parameters() if p.dim() == 4]


@pytest.mark.parametrize("depth_model", ["monodepthv2", "litemono"])
@pytest.mark.parametrize("layers", LAYERS)
def test_every_weight_is_laid_out_by_the_rule(layers, depth_model):
    with torch.device("meta"):
        model = DynamoModel(depth_model=depth_model, encoder_num_layers=layers, scales=SCALES[depth_model])
    assert all(_is_nchw(p) for _, p in _weights(model))
    lay_out(model, CL)
    kinds = {"channels_last": 0, "nchw": 0}
    for name, p in _weights(model):
        nchw = _expected_nchw(name, depth_model)
        assert (_is_nchw(p) if nchw else _is_channels_last(p)), (name, p.shape, p.stride())
        kinds["nchw" if nchw else "channels_last"] += 1
    assert kinds["channels_last"] and kinds["nchw"], kinds
    lay_out(model, torch.contiguous_format)
    assert all(_is_nchw(p) for _, p in _weights(model))


def test_the_layout_is_channels_last_on_a_card_alone():
    assert memory_format_for(torch.device("cuda")) == CL
    assert memory_format_for(torch.device("cuda", 0)) == CL
    assert memory_format_for(torch.device("cpu")) == torch.contiguous_format
    assert memory_format_for(torch.device("meta")) == torch.contiguous_format


@pytest.mark.parametrize("move", ["to", "cpu", "float"])
def test_every_move_lays_the_model_out_for_its_device(monkeypatch, move):
    """``DynamoModel`` is built NCHW on the CPU; a move lays it out by
    ``memory_format_for`` of the device it lands on (channels-last stands in
    for the card's answer here), and a move back restores NCHW."""
    model = DynamoModel(depth_model="monodepthv2", scales=MD2, generator=torch.Generator().manual_seed(0))
    values = {k: v.clone() for k, v in model.state_dict().items()}
    assert all(_is_nchw(p) for _, p in _weights(model))
    moves = {"to": lambda m: m.to("cpu"), "cpu": lambda m: m.cpu(), "float": lambda m: m.float()}
    monkeypatch.setattr(model_module, "memory_format_for", lambda device: CL)
    assert moves[move](model) is model
    laid_out = [_is_channels_last(p) for n, p in _weights(model) if not _expected_nchw(n, "monodepthv2")]
    assert laid_out and all(laid_out)
    monkeypatch.undo()
    moves[move](model)
    assert all(_is_nchw(p) for _, p in _weights(model))
    assert all(torch.equal(v, values[k]) for k, v in model.state_dict().items())


@pytest.mark.cuda
def test_on_the_card_the_model_and_its_loaded_weights_are_channels_last():
    """As ``Trainer`` builds the model and the benchmark loads its weights:
    built on the CPU, moved to the card, then NCHW tensors through
    ``load_state_dict``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    model = DynamoModel(depth_model="monodepthv2", encoder_num_layers=50, scales=MD2,
                        generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    model.to("cuda")
    for name, p in _weights(model):
        assert (_is_nchw(p) if _expected_nchw(name, "monodepthv2") else _is_channels_last(p)), name
    model.load_state_dict(sd)
    assert all(_is_channels_last(p) for n, p in _weights(model) if not _expected_nchw(n, "monodepthv2"))
    assert all(torch.equal(v.cpu(), sd[k]) for k, v in model.state_dict().items())
    model.cpu()
    assert all(_is_nchw(p) for _, p in _weights(model))


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("num_input_images", [1, 2, 3])
@pytest.mark.parametrize("fmt", ["channels_last", "nchw"])
def test_the_encoder_returns_features_laid_out_as_its_trunk(layers, num_input_images, fmt):
    enc = ResnetEncoder(layers, num_input_images).eval()
    if fmt == "channels_last":
        lay_out(enc, CL)
    with torch.no_grad():
        features = enc(torch.rand(2, 3 * num_input_images, H, W))
    assert [f.shape[1] for f in features] == [int(c) for c in enc.num_ch_enc]
    if fmt == "channels_last":
        assert all(_is_channels_last(f) and not f.is_contiguous() for f in features)
    else:
        assert all(f.is_contiguous() for f in features)


@pytest.mark.parametrize("depth_model,layers", [("monodepthv2", 18), ("litemono", 18), ("monodepthv2", 50)])
def test_every_map_the_model_returns_leaves_in_nchw(depth_model, layers):
    """Disparities, complete flow, motion logits and masks at every scale,
    and the camera transforms, of a model laid out channels-last:
    contiguous, with NCHW's strides. (The pose vectors are slices of the pose
    decoder's output, as they always were.)"""
    model = DynamoModel(depth_model=depth_model, encoder_num_layers=layers, scales=SCALES[depth_model],
                        generator=torch.Generator().manual_seed(0))
    lay_out(model, CL)
    g = torch.Generator().manual_seed(1)
    inputs = {("color_aug", f, 0): torch.rand(1, 3, H, W, generator=g) for f in (0, -1, 1)}
    with torch.no_grad():
        outputs = model(inputs, generator=torch.Generator().manual_seed(2))
    maps = {k: v for k, v in outputs.items() if k[0] not in ("axisangle", "translation")}
    assert {k[0] for k in maps} == {"disp", "complete_flow", "motion_mask", "motion_prob", "cam_T_cam"}
    for key, v in maps.items():
        assert v.is_contiguous() and _is_nchw(v), (key, v.shape, v.stride())


# (network, its constructor arguments at ``layers``): the port's module, the
# reference's (NCHW) module, and the inputs the model hands it.
def _networks(layers):
    ch = (64, 64, 128, 256, 512) if layers == 18 else (64, 256, 512, 1024, 2048)
    return {
        "encoder": (lambda: ResnetEncoder(layers, 3), lambda: ref_resnet.ResnetEncoder(layers, 3)),
        "depth_dec": (lambda: DepthDecoder(ch, scales=MD2), lambda: ref_depth_decoder.DepthDecoder(ch, scales=MD2)),
        "pose_dec": (lambda: PoseDecoder(ch[-1], 2), lambda: ref_pose_decoder.PoseDecoder(ch[-1], 2)),
        "motion_dec": (lambda: MotionDecoder(ch, scales=(0, 1, 2), out_dim=3),
                       lambda: ref_motion_decoder.MotionDecoder(ch, scales=(0, 1, 2), out_dim=3)),
        "motion_mask": (lambda: MotionDecoder(ch, scales=(0, 1, 2), out_dim=1),
                        lambda: ref_motion_decoder.MotionDecoder(ch, scales=(0, 1, 2), out_dim=1)),
    }, ch


def _features(ch, g, dtype):
    """An encoder pyramid of a 64x96 image, batch 2, channels-last as the
    port's encoder returns it."""
    return [torch.randn(2, c, H // 2 ** (i + 1), W // 2 ** (i + 1), generator=g, dtype=dtype).contiguous(memory_format=CL)
            for i, c in enumerate(ch)]


def _inputs(network, ch, dtype):
    g = torch.Generator().manual_seed(3)
    if network == "encoder":
        return [torch.rand(2, 9, H, W, generator=g, dtype=dtype)]
    if network == "depth_dec":
        return [_features(ch, g, dtype)]
    if network == "pose_dec":
        return [torch.randn(2, ch[-1], 2, 3, generator=g, dtype=dtype).contiguous(memory_format=CL)]
    pyramid = [torch.rand(2, 9, H, W, generator=g, dtype=dtype)] + _features(ch, g, dtype)
    return [pyramid, torch.randn(2, 6, generator=g, dtype=dtype) * 0.01]


def _nchw(x):
    if isinstance(x, list):
        return [_nchw(v) for v in x]
    return x.contiguous()


def _tensors(out):
    items = out.items() if isinstance(out, dict) else enumerate(out)
    return {k: v for k, v in items}


def _run(module, inputs, train):
    """Outputs, and each parameter's gradient of a fixed random weighting of
    the outputs."""
    module.train(train)
    out = _tensors(module(*inputs))
    g = torch.Generator().manual_seed(4)
    loss = sum((v * torch.randn(v.shape, generator=g, dtype=v.dtype)).sum() for _, v in sorted(out.items(), key=str))
    loss.backward()
    return {k: v.detach() for k, v in out.items()}, {n: p.grad for n, p in module.named_parameters()}


# Encoders in float64, in train and in eval mode: the train mode's BatchNorm
# over a few values a channel, and the eval mode's initial statistics, which
# leave the trunk unnormalised, magnify float32 round-off to 4e-4 of the
# stem's gradient. Decoders, with no BatchNorm, in float32.
CASES = [pytest.param(layers, net, train, dtype, id=f"r{layers}-{net}-{'train' if train else 'eval'}-{str(dtype)[6:]}")
         for layers in LAYERS for net in ("encoder", "depth_dec", "pose_dec", "motion_dec", "motion_mask")
         for train, dtype in (((True, torch.float64), (False, torch.float64)) if net == "encoder"
                              else ((True, torch.float32),))]
# Against each output's and gradient's largest: float64 round-off alone
# (read at most 8.9e-13), float32 sums over up to 2048 x 9 products in
# another order (read at most 4.3e-6).
TOL = {torch.float64: 1e-10, torch.float32: 2e-5}
# BatchNorm takes its running statistics in float32 in either dtype.
STATS_TOL = 2e-5


@pytest.mark.parametrize("layers,network,train,dtype", CASES)
def test_outputs_and_gradients_equal_the_nchw_modules(layers, network, train, dtype):
    nets, ch = _networks(layers)
    make_port, make_ref = nets[network]
    port, ref = make_port().to(dtype), make_ref().to(dtype)
    lay_out(port, CL)
    ref.load_state_dict(port.state_dict())
    inputs = _inputs(network, ch, dtype)
    out_p, grad_p = _run(port, inputs, train)
    out_r, grad_r = _run(ref, _nchw(inputs), train)
    tol = TOL[dtype]
    assert out_p.keys() == out_r.keys()
    for k, r in out_r.items():
        assert float((out_p[k] - r).abs().max()) <= tol * float(r.abs().max()) + 1e-30, k
    assert grad_p.keys() == grad_r.keys()
    for k, r in grad_r.items():
        assert float((grad_p[k] - r).abs().max()) <= tol * float(r.abs().max()) + 1e-30, k
        assert grad_p[k].stride() == dict(port.named_parameters())[k].stride(), k
    if train and network == "encoder":
        stats = ref.state_dict()
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert float((v - stats[k]).abs().max()) <= STATS_TOL * float(stats[k].abs().max()), k


def _layouts(model):
    return {k: v.stride() for k, v in model.state_dict().items()}


def _model(seed):
    model = DynamoModel(depth_model="monodepthv2", scales=MD2, generator=torch.Generator().manual_seed(seed))
    lay_out(model, CL)
    return model


@pytest.fixture(scope="module")
def saved():
    """A monodepthv2 model at ResNet-18, laid out channels-last, whose
    weights the tests load into another."""
    return _model(0)


def test_a_checkpoint_round_trip_keeps_values_and_layout(saved, tmp_path):
    b = _model(1)
    layouts = _layouts(b)
    save_model(saved, str(tmp_path), height=H, width=W)
    load_model(b, str(tmp_path), verbose=False)
    sd = saved.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in b.state_dict().items())
    assert _layouts(b) == layouts


def test_a_jax_variables_load_keeps_values_and_layout(saved):
    b = _model(1)
    layouts = _layouts(b)
    params, stats = {}, {}
    for name in MODULE_NAMES:
        params[name], stats[name] = module_to_jax_variables(getattr(saved, name), name, "monodepthv2", MD2)
    load_jax_variables(b, params, stats, types.SimpleNamespace(scales=MD2, depth_model="monodepthv2"))
    sd = saved.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in b.state_dict().items())
    assert _layouts(b) == layouts


def test_an_nchw_state_dict_keeps_the_layout(saved):
    """As the benchmark loads its weights: NCHW tensors through
    ``load_state_dict``."""
    b = _model(1)
    layouts = _layouts(b)
    sd = saved.state_dict()
    b.load_state_dict({k: v.clone(memory_format=torch.contiguous_format) for k, v in sd.items()})
    assert all(torch.equal(v, sd[k]) for k, v in b.state_dict().items())
    assert _layouts(b) == layouts
    assert sum(_is_channels_last(p) and not _is_nchw(p) for p in b.parameters()) > 100
