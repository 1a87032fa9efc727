"""Worker process for the two-process jax.distributed test.

Launched by ``test_multihost.py`` as ``python _multihost_worker.py <port>
<process_id> <num_processes>``. Each process owns 4 virtual CPU devices;
together they form one 8-device cluster — the CPU stand-in for two
accelerator hosts (SURVEY.md section 5's distributed-communication equivalent;
the reference is strictly single-node, ``src/render.ts:21-22`` process
queues being its only concurrency).

Exercises, over the GLOBAL (cross-process) mesh:
  - ``parallel.mesh.initialize_multihost`` (jax.distributed bring-up)
  - ``parallel.temporal.smooth_rotations_sharded`` (ppermute halos that
    cross the process boundary)
  - ``parallel.temporal.distributed_accumulate_rotations`` (all_gather
    prefix product spanning both processes)

Each process checks its addressable output shards against a locally
computed single-device oracle and exits non-zero on any mismatch.
"""

import sys

import numpy as np


def main() -> None:
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    # Platform must be pinned before any backend use (same as
    # tests/conftest.py).
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    from video_annotator_tpu.parallel.mesh import initialize_multihost

    assert initialize_multihost(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == nproc * 4, len(jax.devices())
    assert len(jax.local_devices()) == 4

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from video_annotator_tpu import so3
    from video_annotator_tpu.parallel.temporal import (
        distributed_accumulate_rotations,
        smooth_rotations_sharded,
    )
    from video_annotator_tpu.smoothing.savgol import smooth_rotations

    t, radius = 64, 5
    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("time",))

    # Identical trajectory in both processes (seeded), sharded over time.
    rng = np.random.default_rng(7)
    deltas_np = np.stack(
        [
            np.asarray(so3.exp(jnp.asarray(w, jnp.float32)))
            for w in rng.normal(size=(t, 3)) * 0.05
        ]
    ).astype(np.float32)

    sharding = NamedSharding(mesh, P("time"))
    deltas = jax.make_array_from_process_local_data(
        sharding, deltas_np[pid * (t // nproc) : (pid + 1) * (t // nproc)]
    )

    # --- distributed prefix product across both processes ---
    accum = jax.jit(
        lambda d: distributed_accumulate_rotations(d, mesh),
        out_shardings=sharding,
    )(deltas)

    oracle_accum = np.empty_like(deltas_np)
    r = np.eye(3, dtype=np.float32)
    for i in range(t):
        r = deltas_np[i] @ r
        oracle_accum[i] = r

    for shard in accum.addressable_shards:
        got = np.asarray(shard.data)
        want = oracle_accum[shard.index]
        np.testing.assert_allclose(got, want, atol=5e-5)

    # --- halo-exchange SG smoothing across the process boundary ---
    accum_global = jax.make_array_from_process_local_data(
        sharding, oracle_accum[pid * (t // nproc) : (pid + 1) * (t // nproc)]
    )
    smoothed = jax.jit(
        lambda x: smooth_rotations_sharded(x, radius, mesh),
        out_shardings=sharding,
    )(accum_global)

    oracle_smooth = np.asarray(
        smooth_rotations(jnp.asarray(oracle_accum), radius)
    )
    for shard in smoothed.addressable_shards:
        got = np.asarray(shard.data)
        want = oracle_smooth[shard.index]
        np.testing.assert_allclose(got, want, atol=5e-5)

    print(f"MULTIHOST OK pid={pid} devices={len(jax.devices())}")


if __name__ == "__main__":
    main()
