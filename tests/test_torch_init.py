"""The port's random init (``models/init.py``) against the JAX package's, on
the CPU.

The two RNGs differ, so no value is compared: per tensor, the statistics of
the distribution. The JAX side is the JAX ``DynamoModel``'s own jitted
``init`` for LiteMono at 32x64, and for monodepthv2 the JAX ``ResnetEncoder``
and ``DepthDecoder`` that it adds, at 64x96; every port parameter is matched
to its flax leaf through ``flax_entries``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.convert import flax_entries
from dynamo_depth_torch.models.init import fan_in, init_like_jax, lecun_normal_
from dynamo_depth_torch.models import model as model_mod
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.models.depth_decoder import DepthDecoder as JDepthDecoder
from dynamo_depth_tpu.models.model import DynamoModel as JDynamoModel
from dynamo_depth_tpu.models.resnet import ResnetEncoder as JResnetEncoder
from torch_test_threads import two_torch_threads  # noqa: F401

SCALES = {"litemono": (0, 1, 2), "monodepthv2": (0, 1, 2, 3)}
TRUNCATED_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's initial ``params`` for each depth model (numpy)."""
    key = jax.random.PRNGKey(0)
    model = JDynamoModel(depth_model="litemono", scales=SCALES["litemono"], frame_ids=(0, -1, 1))
    dummy = {("color_aug", f, 0): jnp.zeros((1, 32, 64, 3)) for f in (0, -1, 1)}
    lite = jax.jit(lambda k: model.init({"params": k, "droppath": k}, dummy, train=False))(key)["params"]
    lite = jax.tree.map(np.asarray, dict(lite))
    enc = JResnetEncoder(num_layers=18, num_input_images=1)
    image = jnp.zeros((1, 64, 96, 3))
    features = [jnp.zeros((1, 64 // 2 ** (i + 1), 96 // 2 ** (i + 1), c))
                for i, c in enumerate((64, 64, 128, 256, 512))]
    md2 = dict(lite)
    md2["depth_enc"] = jax.tree.map(np.asarray, dict(jax.jit(lambda k: enc.init(k, image))(key)["params"]))
    dec = JDepthDecoder(num_ch_enc=(64, 64, 128, 256, 512), scales=SCALES["monodepthv2"])
    md2["depth_dec"] = jax.tree.map(np.asarray, dict(jax.jit(lambda k: dec.init(k, features))(key)["params"]))
    return {"litemono": lite, "monodepthv2": md2}


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _sampling_bound(n):
    """Six standard errors of a sample std of ``n`` draws of a normal
    truncated at 2 stds (kurtosis 2.36), relative to the std."""
    return 6 * math.sqrt((2.36 - 1) / (4 * n))


@pytest.mark.parametrize("depth_model", ["litemono", "monodepthv2"])
def test_every_parameter_is_drawn_as_the_jax_package_draws_it(depth_model, jax_params):
    model = DynamoModel(depth_model=depth_model, scales=SCALES[depth_model], generator=torch.Generator().manual_seed(0))
    assert init_like_jax(model, torch.Generator().manual_seed(1)) == []  # every parameter under one rule
    modules = dict(model.named_modules())
    kernels = seen = 0
    for m in MODULE_NAMES:
        module = getattr(model, m)
        for key, tensor, collection, path, _ in flax_entries(module, m, SCALES[depth_model], depth_model):
            if collection != "params":
                continue
            seen += 1
            got, ref = tensor.detach().numpy(), _leaf(jax_params[depth_model][m], path)
            assert got.size == ref.size, (m, key)
            owner = modules[f"{m}.{key.rsplit('.', 1)[0]}"]
            if path[-1] == "kernel":
                kernels += 1
                n = fan_in(owner)
                assert n == math.prod(ref.shape[:-1]), (m, key)  # flax's fan_in of the same leaf
                for side, w in (("port", got), ("jax", ref)):
                    ratio = float(w.std()) * math.sqrt(n)
                    assert abs(ratio - 1.0) <= _sampling_bound(w.size), (side, m, key, ratio)
                    assert float(np.abs(w).max()) <= 2 * math.sqrt(1 / n) / TRUNCATED_STD * (1 + 1e-6), (side, m, key)
                    assert abs(float(w.mean())) * math.sqrt(n) <= _sampling_bound(w.size), (side, m, key)
            else:  # biases, norms, layer scales, temperatures: constants, exact
                assert np.array_equal(got.reshape(ref.shape), ref), (m, key)
    assert kernels > 40 and seen > kernels
    # The unused LayerNorms of LiteMono's dilated-conv blocks (no flax leaf): ones and zeros.
    for name, p in model.named_parameters():
        if ".norm." in name and "stages" in name and name.split(".")[-2] == "norm":
            assert torch.all(p == (1.0 if name.endswith("weight") else 0.0)), name


def test_no_parameter_keeps_torchs_default():
    """Biases are torch's non-zero uniform draws and kernels have a third of
    the variance before the init; after it, none."""
    model = DynamoModel(generator=torch.Generator().manual_seed(0))
    ratios = [float(m.weight.detach().std()) * math.sqrt(fan_in(m)) for m in model.modules()
              if isinstance(m, (nn.Conv2d, nn.Linear))]
    assert min(ratios) > 0.75 and 0.98 < float(np.median(ratios)) < 1.02  # torch's default: 1/sqrt(3) = 0.577
    biases = [m.bias for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None]
    assert biases and all(not b.any() for b in biases)


def test_a_parameter_no_rule_covers_is_listed(monkeypatch):
    model = DynamoModel(generator=torch.Generator().manual_seed(0))
    model.pose_dec.extra = nn.Parameter(torch.zeros(3))
    assert init_like_jax(model) == ["pose_dec.extra"]
    # DynamoModel refuses to be built with such a parameter.
    monkeypatch.setattr(model_mod, "init_like_jax", lambda module, generator: ["pose_dec.extra"])
    with pytest.raises(RuntimeError, match="no initialisation rule covers"):
        DynamoModel()


def test_the_truncated_normal_has_the_variance_of_flaxs():
    w = torch.empty(1_000_000)
    lecun_normal_(w, 50, torch.Generator().manual_seed(0))
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (50, 20_000)))
    for x in (w.numpy(), ref):
        assert abs(float(x.std()) * math.sqrt(50) - 1.0) < 3e-3
        assert float(np.abs(x).max()) <= 2 / math.sqrt(50) / TRUNCATED_STD * (1 + 1e-6)
    # The same shape of tail: the share of draws beyond one std of the untruncated normal.
    edge = 1 / math.sqrt(50) / TRUNCATED_STD
    assert abs(float((np.abs(w.numpy()) > edge).mean()) - float((np.abs(ref) > edge).mean())) < 3e-3


def test_the_trainer_draws_the_same_weights_on_every_construction():
    cfg = dict(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch")
    a, b = (Trainer(TConfig(**cfg), device="cpu").model.state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = Trainer(TConfig(**cfg, seed=1), device="cpu").model.state_dict()
    assert not torch.equal(a["pose_enc.encoder.conv1.weight"], c["pose_enc.encoder.conv1.weight"])
    ref = DynamoModel(generator=torch.Generator().manual_seed(0), drop_path_rate=0.4).state_dict()
    assert all(torch.equal(a[k], ref[k]) for k in a)


def test_fresh_processes_draw_the_same_weights():
    """Processes started apart draw the same weights from one seed, as the
    ranks of a launch and the two sides of ``bench/grad_compare.py`` must.
    The first erfinv of a process is its draw of the first kernel; torch
    split it over the thread pool, where a worker's chunk could come out
    off by up to 5e-5 (``tests/first_erfinv_stress.py``). ``lecun_normal_``
    keeps erfinv on the calling thread and leaves the pool's size as it
    was."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_depth_torch.parallel.dist import state_fingerprint
    from torch_ddp_workers import init_fingerprints

    models = ("monodepthv2", "litemono")
    threads = torch.get_num_threads()
    ref = [state_fingerprint(DynamoModel(depth_model=d, generator=torch.Generator().manual_seed(0))).tolist()
           for d in models]
    assert torch.get_num_threads() == threads
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
        drawn = list(pool.map(init_fingerprints, [models] * 4))
    assert all(fp == ref for fp in drawn)
