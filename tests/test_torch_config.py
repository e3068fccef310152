"""The port's DynamoConfig against the JAX package's, field by field."""

import dataclasses

import pytest

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_tpu.config import DynamoConfig as JConfig


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
