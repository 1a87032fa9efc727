"""Temporal-axis (sequence) parallelism for trajectory processing.

The reference's "long context" is the frame-time axis with a sliding
``smooth_radius`` lookahead window (``opencv/FrameSourceWarp.cpp:452-464``).
Sharding that axis across devices needs two collective patterns, both
between mesh neighbors:

- :func:`distributed_accumulate_rotations` — the accumulated product
  ``R_t = dR_t . R_{t-1}`` (``opencv/FrameSourceWarp.cpp:441``) as a
  distributed prefix "sum" on SO(3): local scan, all-gather of block
  totals, prefix-multiply — a matrix-product Blelloch scan.
- :func:`smooth_rotations_sharded` — SG smoothing where each time shard
  exchanges ``radius`` halo frames with its neighbors via ``ppermute``
  (ring neighbor exchange), then filters locally; identical output to the
  global filter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from video_annotator_tpu import so3
from video_annotator_tpu.smoothing.savgol import savgol_weights, sg_conv as _sg_conv


def smooth_rotations_sharded(
    rotations: jax.Array,  # (T, 3, 3), T divisible by the time-axis size
    radius: int,
    mesh: Mesh,
    axis: str = "time",
    order: int = 2,
) -> jax.Array:
    """SG-smooth a time-sharded trajectory with halo exchange.

    Matches the unsharded :func:`smoothing.savgol.smooth_rotations` exactly
    (same replicate-padding at the global ends) as long as each local block
    is at least ``radius`` frames long.
    """
    w = jnp.asarray(savgol_weights(radius, order))
    n_shards = mesh.shape[axis]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
    )
    def smooth_block(flat):  # (T/n, 9)
        idx = jax.lax.axis_index(axis)
        # Neighbor halos via ring permute: my *last* `radius` rows
        # go right; my *first* `radius` rows go left.
        right_halo = jax.lax.ppermute(
            flat[-radius:], axis, [(i, (i + 1) % n_shards) for i in range(n_shards)]
        )
        left_halo = jax.lax.ppermute(
            flat[:radius], axis, [(i, (i - 1) % n_shards) for i in range(n_shards)]
        )
        # Global ends: replicate the terminal frame (reference EOF semantics).
        first_rep = jnp.broadcast_to(flat[:1], (radius, 9))
        last_rep = jnp.broadcast_to(flat[-1:], (radius, 9))
        left = jnp.where(idx == 0, first_rep, right_halo)
        right = jnp.where(idx == n_shards - 1, last_rep, left_halo)
        return _sg_conv(jnp.concatenate([left, flat, right], axis=0), w)

    t = rotations.shape[0]
    flat = rotations.reshape(t, 9).astype(jnp.float32)
    return so3.project(smooth_block(flat).reshape(t, 3, 3))


def distributed_accumulate_rotations(
    deltas: jax.Array,  # (T, 3, 3) per-frame rotations dR_t
    mesh: Mesh,
    axis: str = "time",
) -> jax.Array:
    """Distributed prefix product: out[t] = dR_t . dR_{t-1} ... dR_0.

    Local associative scan per shard, all-gather of shard totals, then each
    shard pre-multiplies by the product of all earlier shards. This is how
    the inherently-sequential accumulation at
    ``opencv/FrameSourceWarp.cpp:441-442`` scales across the time axis.
    """
    n_shards = mesh.shape[axis]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
    )
    def scan_block(block):  # (T/n, 3, 3)
        # Associative local prefix product (matmul composes left-to-right:
        # combine(next, prev) = next @ prev).
        def combine(a, b):
            # jax.lax.associative_scan applies combine(carry_left, elem_right)
            return so3.matmul(b, a)

        local = jax.lax.associative_scan(combine, block, axis=0)
        total = local[-1]  # (3, 3) product of this shard's deltas
        totals = jax.lax.all_gather(total, axis)  # (n, 3, 3)
        idx = jax.lax.axis_index(axis)

        # prefix[i] = product of totals[0..i-1] (earlier shards), built by a
        # small unrolled loop over the (static) shard count.
        prefix = jnp.eye(3, dtype=block.dtype)
        for i in range(n_shards):
            prefix = jnp.where(i < idx, so3.matmul(totals[i], prefix), prefix)
        return so3.matmul(local, prefix[None])

    return scan_block(deltas)
