"""The port's throughput CLI (``dynamo_depth_torch/bench/throughput.py``)
against ``bench.py``'s stdout contract.

- The six cases of ``tests/test_bench_contract.py`` on the port's module:
  batch 7 first and the best leg wins, a skipped leg still emits, zero
  legs give an explicit error, an exhausted budget skips every leg,
  SIGTERM emits, ``emit_contract`` is idempotent.
- Both packages' ``emit_contract`` print byte-identical lines for the same
  results.
- Without a card ``main([])`` exits 1 with the error contract and measures
  nothing (no fallback to the CPU).
- One real ``measure(..., device="cpu")`` at 32x64, monodepthv2: a finite
  examples/s and a launches entry for each of K1-K4, 0 on the CPU (the
  counters count launches of the kernels, never of their plain versions).
"""

import json
import math
import signal

import pytest
import torch

import bench
from dynamo_depth_torch.bench import throughput
from torch_test_threads import two_torch_threads  # noqa: F401

KERNELS = ("warp_fwd", "warp_bwd", "warp_fwd_bf16", "warp_bwd_bf16", "photometric_fwd", "photometric_bwd")


@pytest.fixture(autouse=True)
def _reset_emit(monkeypatch):
    monkeypatch.setattr(throughput, "_emitted", False)
    monkeypatch.setattr(bench, "_emitted", False)


def _no_backend_probe(monkeypatch):
    monkeypatch.setattr(throughput, "wait_for_backend", lambda **kw: 1)


def _run_main(monkeypatch, capsys, leg_results, argv=(), budget="540"):
    """Drive ``throughput.main`` with ``run_leg`` stubbed to pop from
    ``leg_results``."""
    _no_backend_probe(monkeypatch)
    calls = []

    def fake_leg(args, batch_size, timeout_s):
        calls.append((batch_size, timeout_s))
        return leg_results.pop(0)

    monkeypatch.setattr(throughput, "run_leg", fake_leg)
    monkeypatch.setenv("DYNAMO_BENCH_BUDGET", budget)
    rc = 0
    try:
        throughput.main(list(argv))
    except SystemExit as e:
        rc = e.code or 0
    out = capsys.readouterr().out
    contract = json.loads(out.strip().splitlines()[-1])
    return rc, contract, calls


def test_headline_leg_runs_first_and_best_wins(monkeypatch, capsys):
    legs = [
        {"batch_size": 7, "examples_per_sec": 40.2, "ms_per_step": 174.2},
        {"batch_size": 8, "examples_per_sec": 39.3, "ms_per_step": 203.4},
        {"batch_size": 3, "examples_per_sec": 31.9, "ms_per_step": 93.9},
    ]
    rc, contract, calls = _run_main(monkeypatch, capsys, legs)
    assert rc == 0
    assert [b for b, _ in calls] == [7, 8, 3]
    # The first leg's slice keeps 150 s back for each later leg.
    assert calls[0][1] <= 540 - 2 * 150 + 1
    assert calls[-1][1] > calls[0][1] - 60  # later legs get the leftovers
    assert contract["value"] == 40.2
    assert contract["metric"] == "kitti_litemono_fine_tune_train_throughput_bfloat16_b7"
    assert contract["vs_baseline"] == pytest.approx(40.2 / 20.0, abs=1e-3)


def test_skipped_leg_still_emits_completed_leg(monkeypatch, capsys):
    legs = [
        {"batch_size": 7, "examples_per_sec": 40.2, "ms_per_step": 174.2},
        None,
        None,
    ]
    rc, contract, _ = _run_main(monkeypatch, capsys, legs)
    assert rc == 0
    assert contract["value"] == 40.2 and "error" not in contract


def test_zero_completed_legs_is_explicit_error(monkeypatch, capsys):
    rc, contract, _ = _run_main(monkeypatch, capsys, [None, None, None])
    assert rc == 1
    assert contract["value"] is None and "error" in contract


def test_exhausted_budget_skips_later_legs(monkeypatch, capsys):
    _no_backend_probe(monkeypatch)
    called = []
    monkeypatch.setattr(throughput, "run_leg", lambda *a, **k: called.append(a) or None)
    monkeypatch.setenv("DYNAMO_BENCH_BUDGET", "1")
    with pytest.raises(SystemExit):
        throughput.main([])
    assert not called
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["value"] is None
    assert "skipped" in err


def test_sigterm_handler_emits_contract(monkeypatch, capsys):
    # A caller's timeout lands during batch 8, after batch 7 completed: the
    # handler prints the contract line and exits 0.
    _no_backend_probe(monkeypatch)
    exits = []
    monkeypatch.setattr(throughput.os, "_exit", lambda code: exits.append(code))

    def leg_then_term(args, batch_size, timeout_s):
        if batch_size == 7:
            return {"batch_size": 7, "examples_per_sec": 40.2, "ms_per_step": 174.2}
        signal.raise_signal(signal.SIGTERM)
        return None

    monkeypatch.setattr(throughput, "run_leg", leg_then_term)
    monkeypatch.setenv("DYNAMO_BENCH_BUDGET", "540")
    try:
        throughput.main([])
    except SystemExit:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert exits and all(e == 0 for e in exits)
    contract = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert contract["value"] == 40.2


def test_emit_contract_is_idempotent(capsys):
    class A:
        compute_dtype = "bfloat16"

    res = [{"batch_size": 8, "examples_per_sec": 40.0, "ms_per_step": 200.0}]
    throughput.emit_contract(A, res)
    throughput.emit_contract(A, res)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("results", [
    [{"batch_size": 7, "examples_per_sec": 51.234567, "ms_per_step": 136.6},
     {"batch_size": 3, "examples_per_sec": 24.98765, "ms_per_step": 120.1}],
    [{"batch_size": 3, "examples_per_sec": 20.0049999, "ms_per_step": 149.9}],
    [],
], ids=["two_legs", "one_leg", "no_leg"])
def test_both_packages_emit_the_same_line(capsys, dtype, results):
    class A:
        compute_dtype = dtype

    bench.emit_contract(A, [dict(r) for r in results], error="e")
    jax_line = capsys.readouterr().out
    throughput.emit_contract(A, [dict(r) for r in results], error="e")
    assert capsys.readouterr().out == jax_line


def test_no_card_exits_1_with_the_error_contract(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe finds it")
    measured = []
    monkeypatch.setattr(throughput, "run_leg", lambda *a, **k: measured.append(a))
    monkeypatch.setattr(throughput, "measure", lambda *a, **k: measured.append(a))
    with pytest.raises(SystemExit) as e:
        throughput.main(["--probe_window", "0"])
    assert e.value.code == 1 and not measured
    out, err = capsys.readouterr()
    contract = json.loads(out.strip().splitlines()[-1])
    assert contract["value"] is None and "no usable CUDA device" in contract["error"]
    assert "device_count() is 0" in err


def test_measure_on_the_cpu(monkeypatch):
    monkeypatch.setattr(throughput, "N_WARMUP", 1)
    monkeypatch.setattr(throughput, "N_TIMED", 2)
    args = throughput.parse_args(["--height", "32", "--width", "64", "--depth_model", "monodepthv2",
                                  "--compute_dtype", "float32"])
    r = throughput.measure(args, 1, device="cpu")
    assert r["batch_size"] == 1
    assert math.isfinite(r["examples_per_sec"]) and r["examples_per_sec"] > 0
    assert r["ms_per_step"] == pytest.approx(1e3 / r["examples_per_sec"])
    assert r["launches_per_step"] == {k: 0 for k in KERNELS}
    assert r["flops_per_step"] > 0
