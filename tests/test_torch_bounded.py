"""``dynamo_depth_torch/utils/bounded.py``: a child bounded by a timeout,
and a caller's SIGTERM, stop every process the child started; the
throughput CLI stops its running leg when it is sent SIGTERM."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from dynamo_depth_torch.bench import throughput
from dynamo_depth_torch.utils import bounded

ROOT = Path(__file__).resolve().parents[1]

# A child that starts a grandchild in its own process group, prints both
# pids and sleeps.
PARENT_OF_SLEEPER = """
import os, subprocess, sys, time
grandchild = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
print(os.getpid(), grandchild.pid, flush=True)
time.sleep(120)
"""


def _alive(pid):
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return False
    return state != "Z"


def _gone(pids, within=15.0):
    deadline = time.monotonic() + within
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    return not any(_alive(p) for p in pids)


def test_a_timeout_stops_the_child_and_what_it_started():
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired) as e:
        bounded.run([sys.executable, "-c", PARENT_OF_SLEEPER], 3, stdout=subprocess.PIPE, text=True)
    pids = [int(p) for p in e.value.output.split()]
    assert len(pids) == 2 and _gone(pids)
    assert time.monotonic() - t0 < 3 + bounded.GRACE_S
    assert not bounded._running


def test_a_finished_child_hands_back_its_output_and_code():
    done = bounded.run([sys.executable, "-c", "print('out'); raise SystemExit(3)"], 60, stdout=subprocess.PIPE,
                       text=True)
    assert done.returncode == 3 and done.stdout == "out\n"


def test_a_sigterm_to_the_caller_stops_its_children():
    """The caller installs ``exit_on_sigterm`` and waits on a child in a
    group of its own: SIGTERM to the caller stops that group, and the
    caller's ``finally`` runs."""
    caller = f"""
import subprocess, sys
from dynamo_depth_torch.utils import bounded
bounded.exit_on_sigterm()
try:
    bounded.run([sys.executable, "-c", {PARENT_OF_SLEEPER!r}], 120)
finally:
    print("finally", flush=True)
"""
    proc = subprocess.Popen([sys.executable, "-c", caller], cwd=str(ROOT), stdout=subprocess.PIPE, text=True)
    pids = [int(p) for p in proc.stdout.readline().split()]  # the child prints through the inherited pipe
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 128 + signal.SIGTERM and "finally" in out
    assert len(pids) == 2 and _gone(pids)


def test_the_bench_stops_its_running_leg_on_sigterm(monkeypatch, capsys):
    """SIGTERM while a leg runs: the leg's group is stopped before the
    contract line is printed from the completed legs."""
    monkeypatch.setattr(throughput, "_emitted", False)
    monkeypatch.setattr(throughput, "wait_for_backend", lambda **kw: 1)
    exits, pids, waited = [], [], []
    monkeypatch.setattr(throughput.os, "_exit", lambda code: exits.append(code))

    def leg(args, batch_size, timeout_s):
        if batch_size == 7:
            return {"batch_size": 7, "examples_per_sec": 40.2, "ms_per_step": 174.2}
        if batch_size == 3:  # reached because os._exit is stubbed
            return None
        threading.Timer(2.0, os.kill, (os.getpid(), signal.SIGTERM)).start()
        t0 = time.monotonic()
        done = bounded.run([sys.executable, "-c", PARENT_OF_SLEEPER], timeout_s, stdout=subprocess.PIPE, text=True)
        waited.append(time.monotonic() - t0)
        pids.extend(int(p) for p in done.stdout.split())
        return None

    monkeypatch.setattr(throughput, "run_leg", leg)
    try:
        throughput.main([])
    except SystemExit:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert exits == [0] and waited[0] < 30 and len(pids) == 2 and _gone(pids)  # the sleepers would take 120 s
    contract = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert contract["value"] == 40.2
