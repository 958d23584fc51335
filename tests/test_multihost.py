"""Multi-host distributed test without a cluster (SURVEY.md section 4).

Spawns two jax.distributed processes (2 virtual CPU devices each) that
form one 4-device global mesh and run ShardedCodec with cross-process
collectives — the code path of a multi-host cluster
(parallel/mesh.init_multihost), verified bit-exact vs golden.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_encode_bit_exact():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # workers set their own device count
    env.pop("JAX_PLATFORMS", None)
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
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert "MULTIHOST-OK" in out, f"worker {pid} no OK:\n{out[-3000:]}"
