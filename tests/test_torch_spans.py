"""The port's spans (``dynamo_depth_torch/utils/spans.py``) on the CPU: how
they nest and what they record, that they enter nothing with neither sink
on, that a ``fine_tune`` step shows every span of its boundaries under
``torch.profiler`` and in a recording, and that recording them leaves the
step's numbers bit-equal."""

import gc
import time

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from dynamo_depth_torch.config import DynamoConfig
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils import spans
from torch_test_threads import two_torch_threads  # noqa: F401

STEP_SPANS = ("dynamo.train_step", "dynamo.pyramid", "dynamo.networks", "dynamo.view_synthesis", "dynamo.losses",
              "dynamo.ground_plane", "dynamo.backward", "dynamo.optimizer", "dynamo.batch_stats")


def test_spans_nest_with_parent_and_step():
    with spans.recording() as rec:
        with spans.span("root", 7):
            with spans.span("a"):
                with spans.span("a.inner"):
                    pass
            with spans.span("b"):
                pass
        with spans.span("root", 8):
            with spans.span("a"):
                pass
    assert [(s.name, s.parent, s.step) for s in rec] == [
        ("root", -1, 7), ("a", 0, 7), ("a.inner", 1, 7), ("b", 0, 7), ("root", -1, 8), ("a", 4, 8)]
    for s in rec:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = rec[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert rec[3].start_ns >= rec[1].end_ns


def test_a_recording_takes_only_the_spans_inside_it():
    with spans.span("before"):
        with spans.recording() as rec:
            with spans.span("inside"):
                pass
    with spans.span("after"):
        pass
    assert [(s.name, s.parent) for s in rec] == [("inside", -1)]
    with spans.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with spans.recording():
                pass


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_with_neither_sink_on_nothing_is_entered_or_recorded(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _refuse)
    assert not autograd_profiler._is_profiler_enabled
    with spans.span("dynamo.train_step", 0) as handle:
        with spans.span("dynamo.losses"):
            pass
    assert handle is None
    assert spans.span("x") is spans.span("y")  # one shared object, nothing made per span
    with spans.recording() as rec:  # the recorder alone does not enter record_function either
        with spans.span("dynamo.losses"):
            pass
    assert [s.name for s in rec] == ["dynamo.losses"]


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    with spans.recording() as rec:
        with pytest.raises(ValueError):
            with spans.span("root", 1):
                with spans.span("failing"):
                    raise ValueError
        with spans.span("next", 2):
            pass
    assert [(s.name, s.parent, s.step) for s in rec] == [("root", -1, 1), ("failing", 0, 1), ("next", -1, 2)]


def _trainer():
    cfg = DynamoConfig(dataset="kitti", height=32, width=64, batch_size=2, weights_init="scratch",
                       depth_model="monodepthv2", scales=[0, 1], seed=3)
    return Trainer(cfg, device="cpu", phase="fine_tune", steps_per_epoch=100, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def fine_tune():
    """A ``fine_tune`` trainer, its state before any step, and a device batch."""
    trainer = _trainer()
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    batch = trainer.to_device(synthetic_batch(trainer.cfg, 2, 32, 64, seed=5))
    return trainer, state, batch


def _step(trainer, state, batch, step=5):
    """One step from ``state`` with a fresh Adam; -> (losses, gradients)."""
    trainer.model.load_state_dict(state)
    trainer.setup_phase("fine_tune", 100)
    losses = trainer.train_step(batch, torch.Generator().manual_seed(11), step)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
    return losses, grads


def test_a_profiled_step_shows_every_span(fine_tune):
    trainer, state, batch = fine_tune
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _step(trainer, state, batch)
    names = {e.name for e in prof.events()}
    assert set(STEP_SPANS) <= names, set(STEP_SPANS) - names
    grounds = [e for e in prof.events() if e.name == "dynamo.ground_plane"]
    assert len(grounds) == len(trainer.cfg.scales)  # once per scale


def test_recorded_spans_of_a_step(fine_tune):
    trainer, state, batch = fine_tune
    trainer.model.load_state_dict(state)
    trainer.setup_phase("fine_tune", 100)
    gaps = []
    gc.disable()  # a collection between the clock and the span is not the span's to hold
    try:
        for step in (41, 42):
            generator = torch.Generator().manual_seed(11)
            with spans.recording() as rec:
                a = time.perf_counter_ns()
                trainer.train_step(batch, generator, step)
                b = time.perf_counter_ns()
            gaps.append(abs((b - a) - (rec[0].end_ns - rec[0].start_ns)))
    finally:
        gc.enable()
    assert min(gaps) < 1_000_000  # the root span is within 1 ms of the call, in one of two tries
    root = rec[0]
    assert root.name == "dynamo.train_step" and root.parent == -1
    assert {s.step for s in rec} == {42}
    parents = {s.name: rec[s.parent].name for s in rec if s.parent >= 0}
    assert parents == {"dynamo.pyramid": "dynamo.train_step", "dynamo.networks": "dynamo.train_step",
                       "dynamo.view_synthesis": "dynamo.train_step", "dynamo.losses": "dynamo.train_step",
                       "dynamo.ground_plane": "dynamo.losses", "dynamo.backward": "dynamo.train_step",
                       "dynamo.optimizer": "dynamo.train_step", "dynamo.batch_stats": "dynamo.train_step"}
    order = [s.name for s in rec if s.parent == 0]
    assert order == ["dynamo.pyramid", "dynamo.networks", "dynamo.view_synthesis", "dynamo.losses",
                     "dynamo.backward", "dynamo.optimizer", "dynamo.batch_stats"]


def test_spans_leave_the_step_bit_equal(fine_tune):
    trainer, state, batch = fine_tune
    plain_losses, plain_grads = _step(trainer, state, batch)
    plain_after = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with spans.recording() as rec, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        losses, grads = _step(trainer, state, batch)
    assert len(rec) == len(STEP_SPANS) + len(trainer.cfg.scales) - 1
    assert plain_losses.keys() == losses.keys()
    for k in losses:
        assert torch.equal(plain_losses[k], losses[k]), k
    assert plain_grads.keys() == grads.keys() and grads
    for k in grads:
        assert torch.equal(plain_grads[k], grads[k]), k
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(plain_after[k], v), k
