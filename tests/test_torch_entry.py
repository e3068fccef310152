"""The port's entry points of ``dynamo_depth_torch/entry.py`` against
``__graft_entry__.py``.

- ``synthetic_batch(..., with_color=False)`` equals ``_synthetic_batch``'s
  bit for bit.
- ``entry(device="cpu")`` at 64x96: its three outputs against the JAX
  ``DynamoModel.apply`` with the same flags, on the JAX init's weights
  carried into the port (``load_jax_variables``); at its defaults, the
  example batch has the JAX ``entry()``'s keys and shapes (NCHW).
- ``Conv3x3`` pads an axis of one pixel as the JAX package's
  ``reflect_pad`` does (monodepthv2's bottom level is 1x2 at 32x64, the
  dry run's first arm).
- ``dryrun_multichip``'s control flow (a real flagship failure raises, a
  budget timeout is a skip, success reports both arms) with the flagship
  subprocess stubbed; NCCL with more ranks than cards is refused.
- One real first arm over two gloo ranks on the CPU.
"""

import math
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from dynamo_depth_torch import entry as tentry
from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.convert import load_jax_variables
from dynamo_depth_torch.models.layers import Conv3x3 as TConv3x3
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models.layers import Conv3x3 as JConv3x3
from dynamo_depth_tpu.models.model import DynamoModel as JModel
from test_torch_models import RTOL, SCALE_ATOL, _compare
from torch_test_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("with_color", [False, True])
@pytest.mark.parametrize("depth_model", ["litemono", "monodepthv2"])
def test_synthetic_batch_matches_the_jax_one(with_color, depth_model):
    kw = dict(dataset="kitti", depth_model=depth_model, height=32, width=64)
    ours = synthetic_batch(TConfig(**kw), 2, 32, 64, with_color=with_color)
    theirs = ge._synthetic_batch(JConfig(**kw), 2, 32, 64, with_color=with_color)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_entry_matches_the_jax_forward():
    h, w = 64, 96
    fn, (model, batch) = tentry.entry(device="cpu", height=h, width=w)
    jcfg = JConfig(dataset="kitti", no_train_vis=True, height=h, width=w)
    jmodel = JModel(depth_model=jcfg.depth_model, encoder_num_layers=jcfg.encoder_num_layers,
                    scales=tuple(jcfg.scales), frame_ids=tuple(jcfg.frame_ids))
    jbatch = {k: jnp.asarray(v) for k, v in ge._synthetic_batch(jcfg, 1, h, w, with_color=False).items()}
    variables = jax.jit(lambda k: jmodel.init({"params": k, "droppath": k}, jbatch, train=False))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, dict(variables))
    load_jax_variables(model, variables["params"], variables["batch_stats"], TConfig(height=h, width=w))

    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, bool_CmpFlow=True, bool_MotMask=True))(
        variables, jbatch)
    ours = fn(model, batch)
    assert not model.training and not any(t.requires_grad for t in ours)
    nhwc = lambda t: t.numpy().transpose(0, 2, 3, 1) if t.dim() == 4 else t.numpy()  # noqa: E731
    _compare({k: nhwc(t) for k, t in zip(tentry.ENTRY_OUTPUTS, ours)},
             {k: np.asarray(ref[k]) for k in tentry.ENTRY_OUTPUTS}, RTOL, SCALE_ATOL)


def test_entry_example_shapes_match_the_jax_entry():
    _, (model, batch) = tentry.entry(device="cpu")
    jcfg = JConfig(dataset="kitti", no_train_vis=True)
    theirs = ge._synthetic_batch(jcfg, 1, jcfg.height, jcfg.width, with_color=False)
    assert batch.keys() == theirs.keys()
    for k, v in theirs.items():
        b, hh, ww, c = v.shape
        assert tuple(batch[k].shape) == (b, c, hh, ww) and batch[k].dtype == torch.float32, k
    assert model.depth_model == jcfg.depth_model == "litemono"


@pytest.mark.parametrize("hw", [(1, 2), (1, 1), (3, 1), (4, 6)])
def test_conv3x3_pads_a_one_pixel_axis_as_the_jax_package(hw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *hw, 5).astype(np.float32)  # NHWC
    jconv = JConv3x3(4)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables["params"]["conv"]
    bias = rng.randn(4).astype(np.float32)
    ref = np.asarray(jconv.apply({"params": {"conv": {"kernel": params["kernel"], "bias": bias}}}, jnp.asarray(x)))
    conv = TConv3x3(5, 4)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(np.array(params["kernel"]).transpose(3, 2, 0, 1)))
        conv.conv.bias.copy_(torch.from_numpy(bias))
        out = conv(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


class _FakeProc:
    def __init__(self, rc):
        self.returncode = rc
        self.stdout = f"fake flagship arm output rc={rc}\n"


def _quick_first_arm(monkeypatch):
    monkeypatch.setattr(tentry, "_run_arm", lambda *a, **k: None)
    monkeypatch.setattr(tentry, "_check_devices", lambda *a: None)


def test_dryrun_propagates_real_flagship_failure(monkeypatch):
    _quick_first_arm(monkeypatch)
    monkeypatch.setattr(tentry, "_run_flagship_subprocess", lambda n, timeout, **kw: _FakeProc(1))
    with pytest.raises(RuntimeError, match="flagship arm FAILED"):
        tentry.dryrun_multichip(2)


def test_dryrun_budget_timeout_is_a_skip(monkeypatch, capsys):
    _quick_first_arm(monkeypatch)

    def raise_timeout(n, timeout, **kw):
        raise subprocess.TimeoutExpired(cmd=[sys.executable], timeout=timeout)

    monkeypatch.setattr(tentry, "_run_flagship_subprocess", raise_timeout)
    tentry.dryrun_multichip(2)  # returns normally
    out = capsys.readouterr().out
    assert "skipped" in out and "both arms completed" not in out


def test_dryrun_success_reports_both_arms(monkeypatch, capsys):
    _quick_first_arm(monkeypatch)
    monkeypatch.setattr(tentry, "_run_flagship_subprocess", lambda n, timeout, **kw: _FakeProc(0))
    tentry.dryrun_multichip(2)
    assert "both arms completed" in capsys.readouterr().out


def test_nccl_with_more_ranks_than_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"needs 2 cards, one per rank, and this machine has 1"):
        tentry._check_devices(2, None, None)
    tentry._check_devices(2, "gloo", None)  # gloo ranks share the card
    tentry._check_devices(1, None, None)


def test_dryrun_first_arm_on_two_gloo_ranks(monkeypatch, capfd):
    monkeypatch.setenv("DYNAMO_DRYRUN_QUICK", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank
    tentry.dryrun_multichip(2, backend="gloo", device="cpu")
    out = capfd.readouterr().out
    found = re.search(r"dryrun_multichip\(2\) \[monodepthv2 32x64\]: fine_tune step OK, loss=(\S+)", out)
    assert found and math.isfinite(float(found.group(1))), out
    assert "flagship arm skipped (DYNAMO_DRYRUN_QUICK=1)" in out
