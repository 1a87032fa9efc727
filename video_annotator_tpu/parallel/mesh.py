"""Device-mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def _factor(n: int, k: int) -> Tuple[int, ...]:
    """Split n devices into k axes, largest axis first."""
    dims = [1] * k
    i = 0
    rem = n
    # greedy: peel factors of 2 (device counts are usually powers of
    # two), then the rest
    f = 2
    while rem > 1:
        while rem % f == 0:
            dims[i % k] *= f
            rem //= f
            i += 1
        f += 1
    return tuple(sorted(dims, reverse=True))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "time", "space"),
) -> Mesh:
    """A mesh over the first ``n_devices`` devices.

    Axis sizes are factored automatically: 8 devices -> (2, 2, 2);
    4 -> (2, 2, 1); 1 -> (1, 1, 1).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    dims = _factor(len(devs), len(axis_names))
    arr = np.asarray(devs).reshape(dims)
    return Mesh(arr, axis_names=tuple(axis_names))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join a multi-host jax cluster.

    The reference is strictly single-node; this is the scaling story
    beyond one host (SURVEY.md section 5's distributed-comm equivalent):
    call on every host before ``make_mesh`` and the mesh spans all hosts'
    devices — shardings over it place DP/SP axes across hosts
    automatically. Arguments default to the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.
    Returns True when a multi-process runtime was initialized, False for
    the single-host no-op (nothing configured). Tested with CPU
    processes only (``tests/test_multihost.py``).
    """
    import os

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else os.environ.get(
        "JAX_NUM_PROCESSES"
    )
    if addr is None and nproc is None:
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(nproc) if nproc is not None else None,
        process_id=int(process_id) if process_id is not None
        else (int(os.environ["JAX_PROCESS_ID"])
              if "JAX_PROCESS_ID" in os.environ else None),
    )
    return True
