"""The port's pretrained init and checkpoint-zoo names against the JAX
package's, on the CPU.

The ImageNet files are downloads that the repository does not hold, so the
tests write files of the same layout with random values under
``<tmp>/ckpt`` and run from ``<tmp>``, where both packages look:

- ``resnet18-f37072fd.pth``: a torchvision ResNet-18 state dict, ``fc.*``
  included;
- ``lite-mono-8m-pretrain.pth``: ``{"model": the Lite-Mono-8M classifier's
  state dict with its final ``norm.*`` and ``head.*``, "args": an
  argparse.Namespace}``, as ConvNeXt-style ImageNet scripts save it.

Every encoder the port loads is held bit for bit against the JAX
``load_pretrained_backbones`` through the weight bridge
(``module_to_jax_variables``), the widened conv1 included; the messages for
missing files are the JAX package's. The zoo names run both packages'
``_try_fetch_zoo_ckpt`` with ``gdown`` absent and with a stub ``gdown`` on
``PATH`` that zips a folder made here: no test reaches the network.
"""

import argparse
import contextlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.litemono import LiteMono
from dynamo_depth_torch.models.convert import module_to_jax_variables
from dynamo_depth_torch.models.pretrained import BACKBONE_FILES, MODEL_ZOO, widen_conv1
from dynamo_depth_torch.models.resnet import ResnetEncoder
from dynamo_depth_torch.training import checkpoint as ckpt
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models import convert as jconvert
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from test_torch_eval_common import save_checkpoint
from torch_ddp_workers import pretrained_rank, run_ranks
from torch_test_threads import two_torch_threads  # noqa: F401

SIZES = {"litemono": dict(height=32, width=64), "monodepthv2": dict(height=64, width=96, scales=[0, 1, 2, 3])}
ENCODERS = ("depth_enc", "pose_enc", "motion_enc")


def _random_state(module, rng):
    """``module``'s state-dict keys and shapes with random values (positive
    variances, counts of batches)."""
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(rng.randint(1, 1000), dtype=torch.int64)
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy(rng.rand(*v.shape).astype(np.float32) + 0.5)
        else:
            out[k] = torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1)
    return out


def write_backbone_files(ckpt_dir, which=("resnet18", "litemono"), seed=0):
    """Random files in the layouts of :data:`BACKBONE_FILES` under
    ``ckpt_dir``; returns their state dicts by name."""
    rng = np.random.RandomState(seed)
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    files = {}
    if "resnet18" in which:
        sd = _random_state(ResnetEncoder(18, 1).encoder, rng)
        sd["fc.weight"] = torch.from_numpy(rng.randn(1000, 512).astype(np.float32))
        sd["fc.bias"] = torch.from_numpy(rng.randn(1000).astype(np.float32))
        torch.save(sd, ckpt_dir / BACKBONE_FILES["resnet18"])
        files["resnet18"] = sd
    if "litemono" in which:
        sd = _random_state(LiteMono(), rng)
        for k, shape in (("norm.weight", (224,)), ("norm.bias", (224,)), ("head.weight", (1000, 224)),
                         ("head.bias", (1000,))):
            sd[k] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        args = argparse.Namespace(model="lite-mono-8m", drop_path=0.1, lr=6e-3, input_size=224)
        torch.save({"model": sd, "args": args, "epoch": 299}, ckpt_dir / BACKBONE_FILES["litemono"])
        files["litemono"] = sd
    return files


def _port_trainer(depth_model, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = Trainer(TConfig(dataset="kitti", batch_size=1, depth_model=depth_model, **SIZES[depth_model], **kw),
                          device="cpu")
    return trainer, out.getvalue().splitlines()


def _jax_load(depth_model):
    """The JAX package's ``load_pretrained_backbones`` into an empty tree,
    and what it printed."""
    cfg = JConfig(dataset="kitti", batch_size=1, depth_model=depth_model, **SIZES[depth_model])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        variables = jconvert.load_pretrained_backbones({"params": {}, "batch_stats": {}}, cfg, seed=cfg.seed)
    return variables, out.getvalue().splitlines()


def _assert_same_tree(got, ref, path):
    assert isinstance(ref, dict) == isinstance(got, dict), path
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    else:
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape and got.tobytes() == ref.tobytes(), path


def _pretrained_lines(lines):
    return [line for line in lines if "pretrained" in line or "not found" in line]


@pytest.mark.parametrize("depth_model", ["litemono", "monodepthv2"])
def test_every_loaded_encoder_equals_the_jax_packages(depth_model, tmp_path, monkeypatch):
    write_backbone_files(tmp_path / "ckpt")
    monkeypatch.chdir(tmp_path)
    trainer, printed = _port_trainer(depth_model)  # weights_init="pretrained", the default
    ref, ref_printed = _jax_load(depth_model)
    assert _pretrained_lines(printed) == ref_printed and ref_printed
    assert set(ref["params"]) == set(ENCODERS)
    for m in ENCODERS:
        params, stats = module_to_jax_variables(getattr(trainer.model, m), m, depth_model, tuple(trainer.cfg.scales))
        _assert_same_tree(params, ref["params"][m], f"{m}/params")  # conv1 widened bit for bit
        _assert_same_tree(stats, ref["batch_stats"][m], f"{m}/batch_stats")


def test_the_widened_conv1_holds_the_file_over_the_jax_filler(tmp_path, monkeypatch):
    files = write_backbone_files(tmp_path / "ckpt", which=("resnet18",))
    monkeypatch.chdir(tmp_path)
    trainer, _ = _port_trainer("litemono")
    conv1 = files["resnet18"]["conv1.weight"]
    rng = np.random.RandomState(trainer.cfg.seed)
    for m, n in (("pose_enc", 2), ("motion_enc", 3)):  # the JAX order: pose, then motion
        got = getattr(trainer.model, m).encoder.conv1.weight.detach()
        for i in range(n):
            assert torch.equal(got[:, 3 * i:3 * i + 3], conv1 / n), (m, i)
        assert torch.equal(got, widen_conv1(conv1, n, rng)), m
        # The rest of the trunk is the file's, fc dropped.
        sd = getattr(trainer.model, m).encoder.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in files["resnet18"].items() if k != "conv1.weight"
                   and not k.startswith("fc."))


@pytest.mark.parametrize("depth_model,present", [
    ("litemono", ()), ("litemono", ("resnet18",)), ("litemono", ("litemono",)), ("monodepthv2", ()),
])
def test_missing_files_keep_the_random_init_with_the_jax_packages_messages(depth_model, present, tmp_path,
                                                                          monkeypatch):
    write_backbone_files(tmp_path / "ckpt", which=present)
    monkeypatch.chdir(tmp_path)
    trainer, printed = _port_trainer(depth_model)
    _, ref_printed = _jax_load(depth_model)
    assert _pretrained_lines(printed) == ref_printed
    loaded = {"resnet18": ("pose_enc", "motion_enc"), "litemono": ("depth_enc",)}
    loaded = {m for f in present for m in loaded[f]}
    missing = ("resnet18" not in present) + (depth_model == "litemono" and "litemono" not in present)
    assert sum("keep random init" in line or "keeps random init" in line for line in printed) == missing
    scratch, _ = _port_trainer(depth_model, weights_init="scratch")
    got, ref = trainer.model.state_dict(), scratch.model.state_dict()
    assert all(torch.equal(got[k], ref[k]) == (k.split(".")[0] not in loaded) for k in got
               if k.endswith(("weight", "running_var")))


def test_a_checkpoint_replaces_the_pretrained_init(tmp_path, monkeypatch):
    write_backbone_files(tmp_path / "ckpt")
    folder = save_checkpoint(tmp_path / "run", seed=3)
    monkeypatch.chdir(tmp_path)
    trainer, printed = _port_trainer("litemono", load_ckpt=folder)
    assert not _pretrained_lines(printed)
    saved = torch.load(Path(folder) / "pose_enc.pth", map_location="cpu", weights_only=True)
    assert torch.equal(trainer.model.pose_enc.encoder.conv1.weight, saved["encoder.conv1.weight"])


def test_two_gloo_ranks_load_the_same_backbones(tmp_path):
    write_backbone_files(tmp_path / "ckpt")
    run_ranks(pretrained_rank, (str(tmp_path), str(tmp_path)))
    prints = [(tmp_path / f"pretrained_rank{r}.txt").read_text().splitlines() for r in (0, 1)]
    fingerprints = [(tmp_path / f"pretrained_rank{r}.fp").read_text() for r in (0, 1)]
    assert fingerprints[0] == fingerprints[1]  # check_replicated passed inside Trainer.__init__
    assert sum("pretrained" in line for line in prints[0]) == 3 and not _pretrained_lines(prints[1])


# ------------------------------------------------------------------ the zoo

class _Printer:
    """What ``_try_fetch_zoo_ckpt`` reads of its trainer in either package."""

    def __init__(self):
        self.lines = []

    def print(self, s=""):
        self.lines.append(s)


def _fetch(package, name):
    method = Trainer._try_fetch_zoo_ckpt if package == "port" else JTrainer._try_fetch_zoo_ckpt
    return method(_Printer(), name)


def _stub_gdown(bin_dir, folder):
    """A ``gdown`` on ``PATH`` that writes ``<name>.zip`` of ``folder``
    (whose name is the zoo folder's) into the working directory."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    stub = bin_dir / "gdown"
    stub.write_text(f"#!{sys.executable}\n"
                    "import shutil, sys\n"
                    f"shutil.make_archive({Path(folder).name!r}, 'zip', {str(Path(folder).parent)!r}, "
                    f"{Path(folder).name!r})\n"
                    f"open('gdown_args.txt', 'w').write(' '.join(sys.argv[1:]))\n")
    stub.chmod(0o755)


def test_the_zoo_names_are_the_jax_packages():
    assert MODEL_ZOO == jconvert.MODEL_ZOO and BACKBONE_FILES == jconvert.BACKBONE_FILES


@pytest.mark.parametrize("name", ["ckpt/W_Dynamo-Depth", "ckpt/W_Dynamo-Depth_MD2"])
def test_a_waymo_name_gives_the_licence_message(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for package in ("port", "jax"):
        with pytest.raises(FileNotFoundError, match="Waymo-licensed") as err:
            _fetch(package, name)
        assert name in str(err.value)
    assert not (tmp_path / "ckpt").exists() or not any((tmp_path / "ckpt").iterdir())


def test_without_gdown_the_error_names_the_id_and_the_folder(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    name = "ckpt/K_Dynamo-Depth"
    for package in ("port", "jax"):
        with pytest.raises(FileNotFoundError) as err:
            _fetch(package, name)
        assert MODEL_ZOO[name] in str(err.value) and f"unzip to {name}" in str(err.value), package
    # A name outside the zoo is returned as it is, for the caller's own error.
    assert _fetch("port", "ckpt/elsewhere") == "ckpt/elsewhere"
    cfg = TConfig(dataset="kitti", height=32, width=64, batch_size=1, load_ckpt=name)
    with pytest.raises(FileNotFoundError, match=MODEL_ZOO[name]):
        Trainer(cfg, device="cpu")


def test_a_stub_gdown_fetches_a_folder_that_loads(tmp_path, monkeypatch):
    source = Path(save_checkpoint(tmp_path / "made", seed=5))
    named = tmp_path / "zoo" / "K_Dynamo-Depth"
    named.parent.mkdir()
    source.rename(named)
    _stub_gdown(tmp_path / "bin", named)
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep + os.environ["PATH"])
    name = "ckpt/K_Dynamo-Depth"
    files = {}
    for package in ("port", "jax"):
        work = tmp_path / package
        work.mkdir()
        monkeypatch.chdir(work)
        assert _fetch(package, name) == name
        assert (work / "gdown_args.txt").read_text() == MODEL_ZOO[name]
        assert not (work / "K_Dynamo-Depth.zip").exists() and not (work / "K_Dynamo-Depth").exists()
        files[package] = {p.relative_to(work / name): p.read_bytes() for p in (work / name).rglob("*") if p.is_file()}
    assert files["port"] == files["jax"] and len(files["port"]) == 7
    # The fetched folder loads through load_model, as -l ckpt/K_Dynamo-Depth does.
    monkeypatch.chdir(tmp_path / "port")
    trainer, _ = _port_trainer("litemono", load_ckpt=name)
    reference = Trainer(TConfig(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch"),
                        device="cpu")
    ckpt.load_model(reference.model, str(named), verbose=False)
    got, ref = trainer.model.state_dict(), reference.model.state_dict()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
