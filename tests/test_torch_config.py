"""The port's DynamoConfig and command line against the JAX package's."""

import dataclasses
import json

import pytest

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.config import build_parser as t_build_parser
from dynamo_depth_torch.config import parse_config as t_parse
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.config import build_parser as j_build_parser
from dynamo_depth_tpu.config import parse_config as j_parse


def test_same_fields_and_defaults():
    t = {f.name: f for f in dataclasses.fields(TConfig)}
    j = {f.name: f for f in dataclasses.fields(JConfig)}
    assert list(t) == list(j)
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())


@pytest.mark.parametrize("dataset", ["kitti", "waymo", "nuscenes"])
@pytest.mark.parametrize("depth_model", ["litemono", "monodepthv2"])
def test_same_resolution(dataset, depth_model):
    kw = dict(dataset=dataset, depth_model=depth_model, width=None if dataset != "kitti" else 320)
    assert dataclasses.asdict(TConfig(**kw)) == dataclasses.asdict(JConfig(**kw))


@pytest.mark.parametrize("bad", [dict(height=100), dict(width=90), dict(frame_ids=[-1, 0, 1]), dict(epoch_schedules=[1, 1])])
def test_validate_rejects(bad):
    with pytest.raises(ValueError):
        TConfig(dataset="kitti", **bad).validate()
    TConfig(dataset="kitti").validate()


@pytest.mark.parametrize("argv", [
    [],
    ["-d", "kitti", "-n", "run", "-b", "2", "--epoch-size", "5", "--epoch_schedules", "1", "0", "2", "3"],
    ["--dataset", "nuscenes", "--depth_model", "monodepthv2", "--scales", "0", "1", "--height", "64", "--width", "96",
     "-l", "logs/x/models/fine_tune_00", "--resume_optim", "--no_train_vis", "-c", "a note", "--print_opt", ""],
    ["-d", "waymo", "--weights_init", "scratch", "--frame_ids", "0", "-2", "2", "--eval_img_bound", "0", "1", "0", "1",
     "--gp_score_mode", "reference", "--seed", "4", "--profile", "--num_devices", "1", "--compute_dtype", "bfloat16"],
])
def test_parse_config_equals_the_jax_packages(argv):
    assert dataclasses.asdict(t_parse(argv)) == dataclasses.asdict(j_parse(argv))


def test_same_command_line():
    def surface(parser):
        return sorted((a.dest, tuple(a.option_strings), repr(a.default), repr(a.choices), a.nargs, repr(a.type))
                      for a in parser._actions if a.dest != "help")

    assert surface(t_build_parser()) == surface(j_build_parser())


def test_opt_json_round_trip(tmp_path):
    cfg = t_parse(["-d", "kitti", "-n", "run", "--height", "64", "--width", "96"])
    cfg.save(str(tmp_path / "opt.json"))
    j_cfg = j_parse(["-d", "kitti", "-n", "run", "--height", "64", "--width", "96"])
    j_cfg.save(str(tmp_path / "opt_jax.json"))
    assert (tmp_path / "opt.json").read_text() == (tmp_path / "opt_jax.json").read_text()
    assert TConfig.from_dict(json.loads((tmp_path / "opt.json").read_text())) == cfg
