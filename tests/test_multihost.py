"""Two-process ``jax.distributed`` integration test.

The reference is single-node (its only concurrency is OS processes over
independent clips, ``src/render.ts:21-22``); the framework's scaling
story beyond one host is ``jax.distributed`` + global meshes. No
multi-host hardware exists in this environment, so this test forms a REAL
two-process JAX cluster on CPU (4 virtual devices per process, one
8-device global mesh) and runs the temporal-parallel collectives whose
halos/gathers cross the process boundary — the honest stand-in for DCN.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_cluster():
    port = _free_port()
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # Workers pin their own platform/device count via jax.config.
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(i), "2"],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIHOST OK pid={i}" in out, out
