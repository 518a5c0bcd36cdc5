"""Multi-host training path: 2-process fake-DCN over localhost CPU.

The reference has no distributed backend (SURVEY §2.6); the
multi-host story is `jax.distributed` + a global env mesh.  This test runs
the REAL `harness.train` entry point in two coordinated processes (gloo
collectives over localhost) and checks both complete with identical,
finite metrics — the replicated-learner invariant.
"""
import json
import math
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_train(tmp_path):
    # NOTE: no @pytest.mark.timeout — pytest-timeout is not installed and
    # the mark is silently ignored (round-4 advisor).  The watchdog is
    # hand-rolled: communicate() bounds each wait and the finally block
    # kills the EXACT child PIDs so a hung worker can never outlive the
    # test or block the suite.
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=str(REPO),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    rows = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("METRICS ")]
        assert lines, f"no metrics line:\n{out[-2000:]}"
        rows.append(json.loads(lines[-1][len("METRICS "):]))
    for row in rows:
        assert math.isfinite(row["policy_loss"])
        assert math.isfinite(row["value_loss"])
    # replicated learner: both processes observe the same losses
    assert abs(rows[0]["policy_loss"] - rows[1]["policy_loss"]) < 1e-5
    assert abs(rows[0]["value_loss"] - rows[1]["value_loss"]) < 1e-5
