"""Gravity-referenced horizon lock (roll leveling).

The reference's dead GPMF code walked both the ``GYRO`` and ``ACCL``
streams (``opencv/gpmf.cpp:82-105``) but used neither; the gyro side is
live in :mod:`smoothing.gyro`, and this module completes the pair: the
accelerometer gives an absolute gravity reference, which pins the *roll*
degree of freedom that pure stabilization leaves floating (smoothing
preserves whatever slow roll drift the trajectory has — a leveled horizon
is the one thing a gravity sensor can provide that vision cannot).

Conventions (matching ``pipeline/render.py``): the measured trajectory
``M_t`` maps frame-0 camera rays to frame-t camera rays; camera axes are
x right, y down, z forward (image "up" is ``-y``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu import so3

GRAVITY = 9.80665  # m/s^2


def estimate_up_direction(
    omega,  # (S, 3) gyro rad/s, camera frame
    omega_ts,  # (S,)
    accl,  # (A, 3) accelerometer m/s^2, camera frame
    accl_ts,  # (A,)
    t0: float,
    sigma: float = 2.0,
) -> np.ndarray:
    """World "up" as a unit vector in FRAME-0 camera coordinates.

    Each accelerometer sample (which at rest reads +g opposite gravity,
    i.e. "up" in the sensor frame) is rotated into frame-0 coordinates
    using the gyro-integrated orientation at its timestamp, then samples
    are averaged with weights that discount high-dynamics readings
    (|a| far from g — shakes/impacts where specific force is not gravity).
    """
    from video_annotator_tpu.smoothing.gyro import integrate_gyro

    omega = jnp.asarray(omega, jnp.float32)
    omega_ts = jnp.asarray(omega_ts, jnp.float32)
    accl = jnp.asarray(accl, jnp.float32)
    accl_ts = jnp.asarray(accl_ts, jnp.float32)

    # integrate_gyro rebases its output so the FIRST resample time is the
    # identity; prepend t0 (the first video frame's timestamp) so frame 0
    # is the reference, then R[1:] maps frame-t -> frame-0 rays (it is the
    # inverse of the measured trajectory, cf. analyse_gyro's rebase).
    times = jnp.concatenate([jnp.asarray([t0], jnp.float32), accl_ts])
    R = integrate_gyro(omega, omega_ts, times)
    a0 = jnp.einsum("tij,tj->ti", R[1:], accl,
                    precision=jax.lax.Precision.HIGHEST)

    mag = jnp.linalg.norm(accl, axis=1)
    w = jnp.exp(-(((mag - GRAVITY) / sigma) ** 2))
    g0 = jnp.sum(a0 * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1e-6)
    n = jnp.linalg.norm(g0)
    up = np.asarray(jnp.where(n > 1e-6, g0 / n, jnp.asarray([0.0, -1.0, 0.0])))
    return up.astype(np.float64)


@jax.jit
def level_horizon(virtual: jax.Array, up0: jax.Array) -> jax.Array:
    """Roll-lock a virtual-camera trajectory against gravity.

    ``virtual`` (T, 3, 3) maps frame-0 rays to virtual-camera rays (the
    smoothed trajectory; identity rows for ``--stabilise fixed``). Each
    orientation is post-rolled about its optical axis so the world up
    vector projects onto the image's up direction (-y): the horizon stays
    level regardless of residual roll drift. Degenerate poses (optical
    axis within ~0 of vertical, where "horizon" is undefined) keep their
    roll.
    """
    u = jnp.einsum("tij,j->ti", virtual, jnp.asarray(up0, virtual.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    # Roll angle of world-up away from image-up, about +z.
    theta = jnp.arctan2(u[:, 0], -u[:, 1])
    r = jnp.hypot(u[:, 0], u[:, 1])
    theta = jnp.where(r > 1e-6, theta, 0.0)
    c, s = jnp.cos(-theta), jnp.sin(-theta)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    rz = jnp.stack(
        [
            jnp.stack([c, -s, z], axis=-1),
            jnp.stack([s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )
    return so3.matmul(rz, virtual)
