"""Kalman trajectory smoothing as a ``lax.scan``.

The reference ships a constant-velocity Kalman filter twice — an unused
pipeline hook (``init_filter``, ``opencv/FrameSourceWarp.cpp:167-175``: 2
states, process noise 1e-5, measurement noise 1e-1, identity transition with
``F[0,1] = 1``) and a standalone demo (``opencv/kalman/kalman.cpp:34-99``).
Here it is wired in as a real smoothing mode: each rotation-vector component
of the camera trajectory runs through an (angle, angular-velocity) filter;
an optional backward Rauch-Tung-Striebel pass gives the offline (two-phase
analyse/encode) smoother zero phase lag.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from video_annotator_tpu import so3


@functools.partial(jax.jit, static_argnames=("rts",))
def kalman_filter_1d(
    z: jax.Array,  # (T,) measurements
    process_noise: float = 1e-5,
    measurement_noise: float = 1e-1,
    rts: bool = True,
) -> jax.Array:
    """Constant-velocity Kalman filter (optionally RTS-smoothed), (T,) -> (T,).

    State x = (value, velocity); F = [[1, 1], [0, 1]]; H = [1, 0];
    parameters default to the reference's (``FrameSourceWarp.cpp:169-174``).
    """
    F = jnp.array([[1.0, 1.0], [0.0, 1.0]])
    H = jnp.array([[1.0, 0.0]])
    Q = jnp.eye(2) * process_noise
    R = jnp.array([[measurement_noise]])

    def mm(*ms):
        # Full float32 products: a TF32 product (the GPU default) would
        # perturb the covariance recursion.
        return functools.reduce(
            lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST),
            ms)

    def step(carry, zt):
        x, P = carry
        # predict
        xp = mm(F, x)
        Pp = mm(F, P, F.T) + Q
        # update
        S = mm(H, Pp, H.T) + R
        K = mm(Pp, H.T) / S[0, 0]
        xn = xp + K[:, 0] * (zt - mm(H, xp)[0])
        Pn = mm(jnp.eye(2) - mm(K, H), Pp)
        return (xn, Pn), (xn, Pn, xp, Pp)

    x0 = jnp.array([z[0], 0.0])
    P0 = jnp.eye(2)
    (_, _), (xs, Ps, xps, Pps) = jax.lax.scan(step, (x0, P0), z)
    if not rts:
        return xs[:, 0]

    # Backward RTS pass for the offline smoother.
    def back(carry, inp):
        xs_next = carry
        x_f, P_f, xp_next, Pp_next = inp
        C = mm(P_f, F.T, jnp.linalg.inv(Pp_next))
        x_s = x_f + mm(C, xs_next - xp_next)
        return x_s, x_s

    # iterate from T-2 down to 0; element t uses prediction at t+1
    inits = xs[-1]
    inps = (xs[:-1], Ps[:-1], xps[1:], Pps[1:])
    _, sm = jax.lax.scan(back, inits, inps, reverse=True)
    out = jnp.concatenate([sm[:, 0], xs[-1:, 0]], axis=0)
    return out


def _unwrap_rotvecs(w: jax.Array) -> jax.Array:
    """Lift (T, 3) log-map vectors onto one continuous branch.

    so3.log returns angles in [0, pi] with axis flips at the boundary; a
    trajectory whose accumulated angle crosses pi therefore JUMPS by ~2*pi
    in the raw components, and filtering across the jump produces virtual
    rotations far from the measured pose. Every representation of the same
    rotation is w + 2*pi*k*axis; pick, per frame, the candidate closest to
    the previous (already-continuous) frame. k is centered on the previous
    frame's projection onto the axis (NOT a fixed range: a camera that
    keeps spinning accumulates unboundedly many turns, and a fixed k
    window breaks after ~2.5 revolutions).
    """
    rel_ks = jnp.arange(-1.0, 2.0)[:, None]  # (3, 1) around the estimate

    def step(prev, wt):
        theta = jnp.linalg.norm(wt)
        axis = jnp.where(
            theta > 1e-6,
            wt / jnp.maximum(theta, 1e-6),
            prev / jnp.maximum(jnp.linalg.norm(prev), 1e-6),
        )
        # Continuous angle along `axis` should land near prev's
        # projection onto it: theta + 2*pi*k ~= <prev, axis>.
        k0 = jnp.round((jnp.dot(prev, axis) - theta) / (2.0 * jnp.pi))
        ks = k0 + rel_ks
        cands = wt[None, :] + 2.0 * jnp.pi * ks * axis[None, :]  # (3, 3)
        d = jnp.sum((cands - prev[None, :]) ** 2, axis=1)
        best = cands[jnp.argmin(d)]
        return best, best

    _, out = jax.lax.scan(step, w[0], w)
    return out


def smooth_rotations_kalman(
    rotations: jax.Array,  # (T, 3, 3)
    process_noise: float = 1e-5,
    measurement_noise: float = 1e-1,
    rts: bool = True,
) -> jax.Array:
    """Kalman-smoothed rotation trajectory.

    Works in the Lie algebra relative to the trajectory start: log-map each
    accumulated rotation, lift onto a continuous branch (the pi-crossing
    wrap would otherwise corrupt the filter), filter the 3 components
    independently, exp back.
    """
    w = _unwrap_rotvecs(so3.log(rotations))  # (T, 3)
    sm = jnp.stack(
        [
            kalman_filter_1d(w[:, i], process_noise, measurement_noise, rts=rts)
            for i in range(3)
        ],
        axis=-1,
    )
    return so3.exp(sm)
