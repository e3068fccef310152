"""The port's reader of the JAX package's ``.msgpack`` checkpoint folders, on
the CPU: ``utils/msgpack.py`` against ``flax.serialization``,
``module_to_jax_variables`` against the JAX package's converter, and
folders written by ``dynamo_depth_tpu/training/checkpoint.py`` loaded into
the port: the weights and ``Trainer.predict``, a partial folder, and
``adam.msgpack`` resumed into the port's Adam against optax's next update
from the same folder."""

import shutil
import types

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import flax.serialization as flax_serialization
from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.convert import flax_entries, module_to_jax_variables
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel
from dynamo_depth_torch.training import checkpoint as ckpt
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import PHASE_SPEC, Trainer
from dynamo_depth_torch.utils import msgpack
from dynamo_depth_torch.utils.layout import outputs_to_host
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.models.model import modules_for_networks
from dynamo_depth_tpu.training import checkpoint as jckpt
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from test_torch_train_vis import _carried_variables
from torch_test_threads import two_torch_threads  # noqa: F401

H, W = 32, 64
KW = dict(dataset="kitti", height=H, width=W, batch_size=2, weights_init="scratch")


def _assert_same_tree(got, ref, path=""):
    """Same structure, types and values, arrays bit for bit."""
    assert type(got) is type(ref), (path, type(got), type(ref))
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape and got.tobytes() == ref.tobytes(), path
    else:
        assert got == ref, path


def _port_model(seed=0):
    torch.manual_seed(seed)
    return DynamoModel(drop_path_rate=0.0)


@pytest.fixture(scope="module")
def jax_folder(tmp_path_factory):
    """A folder the JAX package's ``checkpoint.save_model`` wrote, from the
    JAX variables of a seed-1 port model (the JAX package's converter),
    with BatchNorm statistics that are not the initial ones."""
    model = _port_model(1)
    gen = torch.Generator().manual_seed(1)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    variables = _carried_variables(model, JConfig(**KW))
    folder = tmp_path_factory.mktemp("jax_ckpt") / "fine_tune_00"
    jckpt.save_model(variables, str(folder), height=H, width=W)
    yield types.SimpleNamespace(folder=folder, model=model, variables=variables)
    shutil.rmtree(folder, ignore_errors=True)  # ~170 MB


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, emptied afterwards: the folders written here hold
    ~170-520 MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _partial_copy(src, dst, changed):
    """``dst`` as a copy of the folder ``src`` whose files other than
    ``changed`` are links to ``src``'s."""
    dst.mkdir()
    for f in src.iterdir():
        if f.name in changed:
            shutil.copy(f, dst / f.name)
        else:
            (dst / f.name).symlink_to(f)


def test_the_decoder_is_bit_equal_to_flax_on_the_models_files(jax_folder):
    for m in MODULE_NAMES:
        data = (jax_folder.folder / f"{m}.msgpack").read_bytes()
        _assert_same_tree(msgpack.restore(data), serialization.msgpack_restore(data))


def test_every_form_flax_writes_decodes_bit_equal():
    rng = np.random.RandomState(0)
    params = {"conv": {"kernel": rng.rand(3, 3, 4, 8).astype(np.float32), "bias": np.zeros(8, np.float32)},
              "dense": {"kernel": rng.rand(5, 2).astype(np.float32)}}
    tx = optax.adam(lambda count: 1e-4 * 0.5 ** (count // 10))  # under a schedule, as the trainer builds it
    state = tx.init(params)
    _, state = tx.update(jax.tree.map(np.ones_like, params), state, params)
    trees = [
        jax.tree.map(np.asarray, state),  # {"0": {count, mu, nu}, "1": {count}}, 0-d int32 counts
        {"a": {"b": {"c": np.arange(6, dtype=np.int64).reshape(2, 3)}}, "s": np.float32(2.5), "i": np.int32(-7),
         "zero_d": np.array(1.5, np.float32), "u8": np.arange(300, dtype=np.uint8), "bool": np.array([True, False]),
         "f64": rng.rand(2), "f16": rng.rand(3).astype(np.float16), "n": None, "t": True, "x": 1.25,
         "ints": [0, 127, 128, -1, -33, 255, 65536, 2 ** 40, -2 ** 40], "name": "k" * 40, "raw": b"\x00" * 300,
         "big_map": {str(i): i for i in range(40)}},
    ]
    for tree in trees:
        data = serialization.to_bytes(tree)
        _assert_same_tree(msgpack.restore(data), serialization.msgpack_restore(data))
        # The port's encoder writes flax's bytes, which restore through flax.
        state_dict = serialization.to_state_dict(tree)
        assert msgpack.packb(state_dict) == serialization.msgpack_serialize(state_dict)
        _assert_same_tree(serialization.msgpack_restore(msgpack.packb(state_dict)), msgpack.restore(data))


def test_complex_numbers_chunks_and_unknown_dtypes_are_refused(monkeypatch):
    with pytest.raises(msgpack.MsgpackError, match="native_complex"):
        msgpack.restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    chunked = serialization.msgpack_serialize({"w": np.arange(100, dtype=np.float32)})
    with pytest.raises(msgpack.MsgpackError, match="chunked"):
        msgpack.restore(chunked)
    with pytest.raises(msgpack.MsgpackError, match="bfloat16"):
        msgpack.restore(serialization.msgpack_serialize({"w": jax.numpy.ones(3, jax.numpy.bfloat16)}))
    with pytest.raises(msgpack.MsgpackError, match="ext type 5"):
        msgpack.restore(b"\xd4\x05\x00")
    with pytest.raises(msgpack.MsgpackError, match="complex"):
        msgpack.packb({"c": 1j})


def _flax_keys(model):
    """The state-dict keys ("module.key") that flax keeps: not LiteMono's
    unused ``DilatedConv.norm``, nor BatchNorm's ``num_batches_tracked``."""
    return {f"{m}.{key}" for m in MODULE_NAMES
            for key, *_ in flax_entries(getattr(model, m), m, model.scales, model.depth_model)}


@pytest.mark.parametrize("depth_model", ["litemono", "monodepthv2"])
def test_module_to_jax_variables_inverts_the_loader_exactly(depth_model, scratch):
    scales = (0, 1, 2, 3) if depth_model == "monodepthv2" else (0, 1, 2)
    torch.manual_seed(0)
    model = DynamoModel(depth_model=depth_model, scales=scales, drop_path_rate=0.0)
    cfg = JConfig(**KW, depth_model=depth_model, scales=list(scales))
    for m in MODULE_NAMES:
        params, stats = module_to_jax_variables(getattr(model, m), m, depth_model, scales)
        sd = {k: v.numpy() for k, v in getattr(model, m).state_dict().items()}
        ref_params, ref_stats = convert_module(m, sd, cfg)  # the JAX package's torch -> flax converter
        _assert_same_tree(params, jax.tree.map(lambda x: np.asarray(x, np.float32), ref_params), m)
        _assert_same_tree(stats, jax.tree.map(lambda x: np.asarray(x, np.float32), dict(ref_stats)), m)
    # Written as a JAX folder and read back: every entry flax keeps, bit for bit.
    ckpt.save_jax_folder(model, str(scratch), height=H, width=W)
    other = DynamoModel(depth_model=depth_model, scales=scales, drop_path_rate=0.0)
    ckpt.load_model(other, str(scratch), verbose=False)
    got, ref = other.state_dict(), model.state_dict()
    keys = _flax_keys(model)
    assert keys and all(torch.equal(got[k], ref[k]) for k in keys)


def test_a_jax_folder_loads_into_the_port_and_predicts_as_the_jax_package(jax_folder, capsys):
    port = Trainer(TConfig(**KW, load_ckpt=str(jax_folder.folder)), device="cpu")
    out = capsys.readouterr().out
    assert all(f"|- Loading {m} weights...\n" in out for m in MODULE_NAMES) and "FAILED" not in out
    got_sd, ref_sd = port.model.state_dict(), jax_folder.model.state_dict()
    assert all(torch.equal(got_sd[k], ref_sd[k]) for k in _flax_keys(port.model))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_variables", lambda self: jax_folder.variables)  # a template: replaced by the folder
        jtrainer = JTrainer(JConfig(**KW, num_devices=1, load_ckpt=str(jax_folder.folder)))
    rng = np.random.RandomState(6)
    batch = {("color_aug", f, 0): rng.rand(2, H, W, 3).astype(np.float32) for f in (0, -1, 1)}
    got = outputs_to_host(port.predict(batch, True, True))
    ref = jax.tree.map(np.asarray, dict(jtrainer.predict(batch, True, True)))
    assert got.keys() == ref.keys()
    for k in ref:
        # test_torch_eval_ops.py's tolerance for predict.
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4 * scale, err_msg=str(k))


def test_a_partial_folder_gives_the_jax_packages_messages(jax_folder, tmp_path, capsys):
    folder = tmp_path / "partial"
    _partial_copy(jax_folder.folder, folder, {"motion_dec.msgpack", "meta.json"})
    (folder / "pose_dec.msgpack").unlink()
    raw = serialization.msgpack_restore((folder / "motion_dec.msgpack").read_bytes())
    convs = sorted(raw["params"])
    raw["params"][convs[0]]["kernel"] = np.zeros((1, 2, 3), np.float32)  # reshaped
    del raw["params"][convs[1]]["bias"]  # missing: the JAX loader then takes its partial path
    (folder / "motion_dec.msgpack").write_bytes(serialization.msgpack_serialize(raw))
    (folder / "meta.json").write_text('{"height": 64, "width": 64}')

    template = _carried_variables(_port_model(2), JConfig(**KW))
    jckpt.load_model(template, str(folder), height=H, width=W)
    ref_out = capsys.readouterr().out
    port = _port_model(2)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    ckpt.load_model(port, str(folder), height=H, width=W)
    out = capsys.readouterr().out
    assert out == ref_out
    n = sum(1 for _ in jax.tree_util.tree_leaves(raw["params"]))
    assert f"|- Loading motion_dec weights... PARTIAL :: {n - 1} matched, 1 skipped" in out
    assert "|- Loading pose_dec weights... FAILED :: Path" in out and "WARNING: opt (32,64) != loaded (64,64)" in out
    skipped = {f"motion_dec.{key}" for key, _, _, path, _ in flax_entries(port.motion_dec, "motion_dec")
               if path in ((convs[0], "kernel"), (convs[1], "bias"))}
    assert len(skipped) == 2
    loaded, ref = port.state_dict(), jax_folder.model.state_dict()
    for k in loaded:
        if k in _flax_keys(port) and k not in skipped and not k.startswith("pose_dec."):
            assert torch.equal(loaded[k], ref[k]), k
        else:  # kept: not in the folder, not of its shape, or not kept by flax
            assert torch.equal(loaded[k], before[k]), k


def test_a_reshaped_leaf_alone_is_loaded_partially(jax_folder, tmp_path, capsys):
    # The JAX package's loader takes a leaf of another shape as it is (flax's
    # from_bytes checks keys, not shapes); a port tensor cannot take it, so
    # the port skips that leaf and says so.
    folder = tmp_path / "reshaped"
    _partial_copy(jax_folder.folder, folder, {"pose_dec.msgpack"})
    raw = serialization.msgpack_restore((folder / "pose_dec.msgpack").read_bytes())
    raw["params"]["squeeze"]["kernel"] = np.zeros((2, 2), np.float32)
    (folder / "pose_dec.msgpack").write_bytes(serialization.msgpack_serialize(raw))
    port = _port_model(2)
    before = port.pose_dec.squeeze.weight.clone()
    ckpt.load_model(port, str(folder), height=H, width=W)
    n = sum(1 for _ in jax.tree_util.tree_leaves(raw))
    assert f"|- Loading pose_dec weights... PARTIAL :: {n - 1} matched, 1 skipped" in capsys.readouterr().out
    assert torch.equal(port.pose_dec.squeeze.weight, before)
    assert torch.equal(port.pose_dec.squeeze.bias, jax_folder.model.pose_dec.squeeze.bias)


def _jax_tx(phase, steps_per_epoch):
    cfg = JConfig(**KW)
    lr_factor = PHASE_SPEC[phase][3]
    return optax.adam(JTrainer._lr_schedule(types.SimpleNamespace(cfg=cfg), lr_factor, steps_per_epoch)), cfg


@pytest.mark.parametrize("phase", ["motion_init", "fine_tune"])
def test_adam_msgpack_resumes_as_the_jax_package(jax_folder, scratch, phase):
    """optax's state after two updates, saved by the JAX package with its
    weights; the port resumes it with --resume_optim and takes one step;
    optax's next update from the same folder, given the port's gradient,
    moves the weights as the port's Adam did."""
    spe = 4
    tx, jcfg = _jax_tx(phase, spe)
    trainable = modules_for_networks(PHASE_SPEC[phase][2])
    params = {m: jax_folder.variables["params"][m] for m in trainable}
    init, update = jax.jit(tx.init), jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    state = init(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x), dtype=np.float32), params)
        params, state = update(grads, state, params)
    variables = {"params": {**jax_folder.variables["params"], **jax.tree.map(np.asarray, params)},
                 "batch_stats": jax_folder.variables["batch_stats"]}
    folder = str(scratch / f"{phase}_00")
    jckpt.save_model(variables, folder, height=H, width=W)
    jckpt.save_opt_state(state, folder)

    port = Trainer(TConfig(**KW, load_ckpt=folder, resume_optim=True), device="cpu", phase=phase,
                   steps_per_epoch=spe, drop_path_rate=0.0)
    port.load_optimizer(folder)
    assert port.opt_steps == 2
    was = {m: module_to_jax_variables(getattr(port.model, m), m)[0] for m in trainable}
    port.train_step(port.to_device(synthetic_batch(port.cfg, 2, H, W)), torch.Generator().manual_seed(0), 2)

    # optax from the same folder, through the JAX package's own loaders.
    restored = jckpt.load_opt_state(init(params), folder)
    start = jckpt.load_model(variables, folder, verbose=False)["params"]
    start = {m: start[m] for m in trainable}
    grads = {}
    for m in trainable:
        sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
              for k, p in getattr(port.model, m).named_parameters()}
        sd.update({k: v.numpy() for k, v in getattr(port.model, m).state_dict().items() if k not in sd})
        grads[m] = convert_module(m, sd, jcfg)[0]
    new = jax.tree.map(np.asarray, update(grads, restored, start)[0])
    lr = port.lr_at(2)
    for m in trainable:
        got, _ = module_to_jax_variables(getattr(port.model, m), m)
        for (path, g), (_, r), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                             jax.tree_util.tree_leaves_with_path(new[m]),
                                             jax.tree_util.tree_leaves_with_path(was[m])):
            # Adam's two formulas in float32: the steps agree to ~1e-6 of lr,
            # read back through the weights' own spacing.
            tol = 1e-5 * lr + 2 * np.spacing(np.maximum(np.abs(w), np.abs(g)))
            assert np.all(np.abs((g - w) - (r - w)) <= tol), (m, path)
    # A state over another set of modules is refused, as a .pth state is.
    other = Trainer(TConfig(**KW), device="cpu", phase="disp_init", drop_path_rate=0.0)
    with pytest.raises(ValueError, match="modules"):
        other.load_optimizer(folder)
