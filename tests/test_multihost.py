"""Multi-host runtime test: two REAL processes over a localhost
coordinator (jax.distributed + Gloo CPU collectives), 2 virtual devices
each -> a 2x2 scenario-x-cluster hybrid mesh.  See multihost_worker.py
for the assertions (measurement exchange + sharded-vs-local step
equality).  The same mesh/step code paths run across GPU hosts once
``multihost.initialize()`` has its coordinator (SURVEY §2.3).
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cpu_launch():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "PALLAS_"))}
    env["PYTHONPATH"] = _REPO
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"OK pid={pid}" in out, out[-4000:]
