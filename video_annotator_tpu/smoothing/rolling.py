"""Rolling-shutter correction: per-scanline warp rotations.

CMOS action cameras read sensor rows out sequentially over a large
fraction of the frame period, so fast rotation skews every frame
("jello"). The reference has no answer to this (its dewobble/vidstab
stages warp whole frames with one transform); the warp computes its map
per output pixel anyway, so giving each 8-row output band its OWN
rotation is nearly free (one gathered 3x3 per row) — per-scanline
correction quantized to 8 rows (~0.3% of the readout window at 4K).

Model: frame ``t``'s rows are captured over
``[frame_time_t, frame_time_t + readout / fps)`` where ``readout`` is
the CLI's ``--rolling-shutter`` fraction (GoPro HERO-era sensors measure
~0.75). The measured trajectory ``M_t`` is referenced to scanline 0; the
camera pose at scan fraction ``f`` is approximated with the frame-rate
angular velocity ``w_t = log(M_{t+1} M_t^T)``:

    M(t, f) ~= exp(f * readout * w_t) . M_t

so the warp rotation for an output tile row at fraction ``f`` becomes
``exp(f * readout * w_t) . corr_t`` — valid for both visual and gyro
trajectories (both provide per-frame measured rotations).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from video_annotator_tpu import so3


def scan_fractions(out_camera, in_camera, ny: int) -> jax.Array:
    """(ny,) SOURCE scan fraction at each output tile-row center.

    Output rows are not source rows: a cropped/zoomed output camera's row
    0 maps well inside the sensor, so using the output-row fraction
    mis-times every scanline (measured: ~30% residual jello on a
    crop-borders camera). The identity-correction map gives the source
    row each output tile center samples; the per-frame correction
    perturbs it by at most the stabilization amplitude (second order).
    """
    ys = jnp.arange(ny, dtype=jnp.float32) * 8.0 + 4.0
    xs = jnp.full((ny,), float(out_camera.cx), jnp.float32)
    rays = out_camera.unproject(jnp.stack([xs, ys], axis=-1))
    src = in_camera.project(rays)
    return jnp.clip(src[:, 1] / float(in_camera.height), 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("readout_s",))
def rs_row_rotations_gyro(
    corrections: jax.Array,  # (T, 3, 3) per-frame warp rotations
    omega: jax.Array,  # (S, 3) gyro rad/s, camera frame
    ts: jax.Array,  # (S,) gyro sample times
    frame_ts: jax.Array,  # (T,) frame timestamps (trimmed range)
    readout_s: float,  # readout time in SECONDS
    fractions: jax.Array,  # (ny,) source scan fraction per output tile row
) -> jax.Array:
    """(T, ny, 3, 3) per-tile-row warp rotations, EXACT from telemetry.

    Where :func:`rs_row_rotations` extrapolates each frame's pose with
    its frame-rate angular velocity (first-order), this integrates the
    ~400 Hz gyro stream at every scanline time — intra-frame
    acceleration (whip pans, impacts) is captured exactly.
    """
    from video_annotator_tpu.smoothing.gyro import integrate_gyro

    t = corrections.shape[0]
    ny = fractions.shape[0]
    times = (
        frame_ts[:, None] + fractions[None, :].astype(frame_ts.dtype)
        * readout_s
    ).reshape(-1)
    # One integration pass over frame starts + every scanline time, all
    # rebased at the first frame (the trajectory's reference).
    all_times = jnp.concatenate([frame_ts, times])
    R = integrate_gyro(omega, ts, all_times)
    M = jnp.swapaxes(R, -1, -2)  # measured convention (cf. analyse_gyro)
    m_frames = M[:t]
    m_rows = M[t:].reshape(t, ny, 3, 3)
    delta = so3.matmul(m_rows, jnp.swapaxes(m_frames, -1, -2)[:, None])
    return so3.matmul(delta, corrections.astype(jnp.float32)[:, None])


@functools.partial(jax.jit, static_argnames=("readout",))
def rs_row_rotations(
    corrections: jax.Array,  # (T, 3, 3) per-frame warp rotations
    measured: jax.Array,  # (T, 3, 3) measured camera trajectory
    readout: float,  # rolling-shutter readout as a fraction of 1/fps
    fractions: jax.Array,  # (ny,) source scan fraction per output tile row
) -> jax.Array:
    """(T, ny, 3, 3) per-tile-row warp rotations."""
    t = corrections.shape[0]
    ny = fractions.shape[0]
    if t < 2:
        return jnp.broadcast_to(corrections[:, None], (t, ny, 3, 3))
    m = measured.astype(jnp.float32)
    # Frame-rate angular velocity; the last frame reuses its predecessor's.
    w = so3.log(so3.matmul(m[1:], jnp.swapaxes(m[:-1], -1, -2)))  # (T-1, 3)
    w = jnp.concatenate([w, w[-1:]], axis=0)  # (T, 3)
    f = fractions.astype(jnp.float32)
    ang = f[None, :, None] * float(readout) * w[:, None, :]  # (T, ny, 3)
    delta = so3.exp(ang.reshape(-1, 3)).reshape(t, ny, 3, 3)
    return so3.matmul(delta, corrections.astype(jnp.float32)[:, None])
