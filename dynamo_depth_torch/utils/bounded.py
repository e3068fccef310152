"""Child processes bounded by a wall-clock timeout, stopped together with
every process they started.

:func:`run` starts each child in a process group of its own. At its
timeout the whole group is sent SIGTERM, and SIGKILL ``GRACE_S`` later: a
child that runs children of its own through :func:`run` stops them in its
SIGTERM handler (:func:`stop_children`, which :func:`exit_on_sigterm`
installs), since those sit in groups of their own. A caller that is itself
sent SIGTERM stops its running children the same way, so that no leg of a
benchmark or rank of a dry run outlives the command that started it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import List, Optional, Set

GRACE_S = 10.0  # between SIGTERM and SIGKILL of a child's group at its timeout

_running: Set[subprocess.Popen] = set()


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    """``sig`` to the child's group. Only while the child is not reaped: its
    pid, the group's id, cannot be taken by another process until then."""
    if proc.returncode is None:
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:  # the group has no member left
            pass


def _exited(proc: subprocess.Popen) -> bool:
    """Whether the child has exited, without reaping it."""
    try:
        return os.waitid(os.P_PID, proc.pid, os.WEXITED | os.WNOHANG | os.WNOWAIT) is not None
    except ChildProcessError:
        return True


def _stop(proc: subprocess.Popen) -> None:
    """SIGTERM to the child's group, then SIGKILL to the group once the
    child has exited or ``GRACE_S`` have passed; then the child is reaped."""
    _signal_group(proc, signal.SIGTERM)
    deadline = time.monotonic() + GRACE_S
    while not _exited(proc) and time.monotonic() < deadline:
        time.sleep(0.1)
    _signal_group(proc, signal.SIGKILL)
    proc.wait()


def run(cmd: List[str], timeout: Optional[float], **popen_kw) -> subprocess.CompletedProcess:
    """Run ``cmd`` (``subprocess.Popen``'s keywords) in a new process group
    and wait for it at most ``timeout`` seconds. Past the timeout the group
    is stopped and ``subprocess.TimeoutExpired`` raised with what the child
    printed to a pipe. If the wait is interrupted (a signal, an exception),
    the group is stopped before the exception goes on."""
    proc = subprocess.Popen(cmd, start_new_session=True, **popen_kw)
    _running.add(proc)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop(proc)
        out, err = proc.communicate()
        raise subprocess.TimeoutExpired(cmd, timeout, output=out, stderr=err)
    finally:
        _running.discard(proc)
        if proc.returncode is None:  # the wait was interrupted
            _stop(proc)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def stop_children() -> None:
    """SIGKILL the groups of the children of :func:`run` still running (from
    a signal handler: nothing here waits)."""
    for proc in list(_running):
        _signal_group(proc, signal.SIGKILL)


def exit_on_sigterm() -> None:
    """On SIGTERM, stop the running children, then raise ``SystemExit(143)``
    so that the caller's ``finally`` blocks run."""

    def handler(signum, frame):
        stop_children()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)
