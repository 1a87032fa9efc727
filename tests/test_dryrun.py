"""The driver entry (`__graft_entry__.dryrun_multichip`) stays green.

Runs the fast-shapes variant in a subprocess (the dryrun mutates jax
device config, so it cannot share this process's backend). The full-size
variant (1280x960, radius 30) is what the driver executes; DRYRUN_FAST
shrinks frames/radius but exercises every code path: all three mesh
factorizations, oracle equality, non-identity corrections, and the
batched YUV warp's DP encode path in both tap variants.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_fast():
    env = dict(os.environ)
    env.update(
        DRYRUN_FAST="1",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        DRYRUN_DEVICES="8",
    )
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "__graft_entry__.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    assert p.returncode == 0, p.stderr[-3000:]
    assert "dryrun_multichip OK" in p.stdout, p.stdout[-2000:]
    # All three mesh factorizations ran and matched the oracle.
    for tag in ("(8,1,1)", "(2,2,2)", "(1,8,1)", "dp-rotation[bilinear]",
                "dp-rotation[bicubic]", "dp-similarity", "dp-deshake",
                "non-identity"):
        assert tag in p.stdout, (tag, p.stdout[-2000:])
