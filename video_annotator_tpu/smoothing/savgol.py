"""Savitzky-Golay smoothing of rotation trajectories.

The reference smooths the accumulated camera rotation with
``gram_sg::RotationFilter(SavitzkyGolayFilterConfig(radius, 0, 2, 0))`` — a
centered window of ``2*radius + 1`` rotations, polynomial order 2, evaluated
at the center (``opencv/FrameSourceWarp.cpp:212,444,471``); the correction
applied per frame is ``(R_smooth * R_measured^-1)^-1``
(``opencv/FrameSourceWarp.cpp:468-475``).

Device shape: instead of a streaming deque, the whole trajectory (or a
sharded block of it with halo — see ``parallel/temporal.py``) is smoothed at
once: the 9 matrix entries are convolved with the SG kernel (one small
matmul over the time axis) and the results are projected back onto SO(3)
with a batched polar projection — the chordal-metric weighted rotation mean.
Endpoints replicate the terminal rotations, matching the reference's EOF
behavior of replaying the last rotation into the filter
(``opencv/FrameSourceWarp.cpp:457-460``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import math

import numpy as np

from video_annotator_tpu import so3


def savgol_weights(radius: int, order: int = 2, pos: int = 0, deriv: int = 0):
    """SG kernel over window [-radius, radius], evaluated at ``pos``.

    Least-squares polynomial fit weights (the Gram-polynomial construction
    used by gram_sg reduces to the same projection). Returns (2*radius+1,)
    float32, index 0 = t-radius.
    """
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    A = np.stack([t**k for k in range(order + 1)], axis=1)  # (w, order+1)
    # value (or s-th derivative) of the fitted polynomial at pos:
    # f^(s)(pos) = sum_k c_k * k!/(k-s)! * pos^(k-s)
    e = np.zeros(order + 1)
    for k in range(deriv, order + 1):
        e[k] = (math.factorial(k) / math.factorial(k - deriv)) * (
            float(pos) ** (k - deriv)
        )
    w = e @ np.linalg.pinv(A)  # (window,)
    return w.astype(np.float32)


def sg_conv(padded: jax.Array, w: jax.Array) -> jax.Array:
    """Entrywise 1D convolution of an already replicate-padded
    (T + 2r, K) block with SG weights (2r + 1,) -> (T, K).

    THE smoothing primitive, shared by every trajectory path (offline
    savgol, the streaming window core, the temporal-sharded halo
    smoother, and the 2D families) so the numerics cannot drift apart.
    HIGHEST precision: the entries are rotation-matrix components, and a
    TF32 convolution (the GPU default for f32) would move the trajectory.
    """
    return jax.lax.conv_general_dilated(
        padded.T[:, None, :],
        w[None, None, :],
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )[:, 0, :].T


@functools.partial(jax.jit, static_argnames=("radius", "order"))
def smooth_rotations(
    rotations: jax.Array,  # (T, 3, 3)
    radius: int,
    order: int = 2,
) -> jax.Array:
    """Smooth a rotation trajectory; returns (T, 3, 3).

    Replicate-pads both ends by ``radius`` (the reference's lookahead
    warm-up/EOF semantics), convolves entrywise with the SG kernel, and
    projects each result back to SO(3).
    """
    w = jnp.asarray(savgol_weights(radius, order))
    t = rotations.shape[0]
    flat = rotations.reshape(t, 9)
    padded = jnp.concatenate(
        [
            jnp.broadcast_to(flat[:1], (radius, 9)),
            flat,
            jnp.broadcast_to(flat[-1:], (radius, 9)),
        ],
        axis=0,
    )
    return so3.project(sg_conv(padded, w).reshape(t, 3, 3))


# The per-mode corrections math (none/fixed/smooth -> warp rotations)
# lives in ONE place: pipeline/render.py's make_window_corrections /
# _lock_and_attitude — shared by the two-phase, streaming, and compare
# paths. A parallel copy here once let tests pass while asserting
# nothing about the shipped path; test the renderer's own function.
