"""SG/Kalman/gyro smoothing tests: polynomial reproduction, jitter removal."""

import numpy as np
import pytest

import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.smoothing.savgol import (
    savgol_weights,
    smooth_rotations,
)
from video_annotator_tpu.smoothing.kalman import (
    kalman_filter_1d,
    smooth_rotations_kalman,
)
from video_annotator_tpu.smoothing.gyro import integrate_gyro


def _shaky_trajectory(t=200, seed=0):
    """Smooth pan + high-frequency jitter, as rotation matrices."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t)
    smooth = np.stack(
        [
            0.001 * ts,  # slow pan
            0.0005 * np.sin(ts / 40.0),
            np.zeros(t),
        ],
        axis=-1,
    )
    jitter = rng.normal(size=(t, 3)) * 0.004
    return smooth.astype(np.float32), (smooth + jitter).astype(np.float32)


def test_savgol_weights_sum_to_one():
    w = savgol_weights(30, 2)
    assert w.shape == (61,)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-5)


def test_savgol_reproduces_quadratic():
    # Order-2 SG must pass quadratics through unchanged.
    w = savgol_weights(10, 2).astype(np.float64)
    t = np.arange(-10, 11, dtype=np.float64)
    for poly in (np.ones_like(t), t, t**2):
        # weights are float32; quadratic reproduction holds to f32 rounding
        np.testing.assert_allclose((w * poly).sum(), poly[10], atol=1e-5)


def test_savgol_matches_scipy():
    from scipy.signal import savgol_coeffs

    w = savgol_weights(15, 2)
    ref = savgol_coeffs(31, 2, pos=15)[::-1]
    np.testing.assert_allclose(w, ref, atol=1e-5)


def test_smooth_rotations_removes_jitter():
    smooth_w, noisy_w = _shaky_trajectory()
    noisy_R = so3.exp(jnp.asarray(noisy_w))
    out = smooth_rotations(noisy_R, radius=30)
    out_w = np.asarray(so3.log(out))
    # Residual vs the true smooth trajectory shrinks a lot (interior only).
    err_in = np.linalg.norm(noisy_w[40:-40] - smooth_w[40:-40], axis=-1).mean()
    err_out = np.linalg.norm(out_w[40:-40] - smooth_w[40:-40], axis=-1).mean()
    assert err_out < err_in * 0.35, (err_in, err_out)
    # Outputs are valid rotations.
    R = np.asarray(out)
    np.testing.assert_allclose(
        R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape), atol=1e-5
    )


def _corrections(R, mode, radius=0):
    """Corrections via the PRODUCTION path (make_window_corrections —
    the function every render path ships with), replicate-padded like
    the two-phase renderer does."""
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        make_window_corrections,
    )

    fn = make_window_corrections(radius, RenderOptions(stabilise=mode), None)
    flat = jnp.asarray(R)
    if radius:
        flat = jnp.concatenate(
            [jnp.broadcast_to(flat[:1], (radius, 3, 3)), flat,
             jnp.broadcast_to(flat[-1:], (radius, 3, 3))], axis=0)
    return fn(flat)


def test_stabilization_modes():
    """Mode semantics of the reference (--stabilise none|fixed|smooth,
    src/cli.ts:80-85; libdewobble stab none|fixed|sg,
    src/render.ts:669-678), asserted on the renderer's own corrections
    function."""
    _, noisy_w = _shaky_trajectory(t=100)
    R = so3.exp(jnp.asarray(noisy_w))
    none = _corrections(R, "none")
    np.testing.assert_allclose(
        np.asarray(none), np.broadcast_to(np.eye(3), (100, 3, 3)), atol=1e-6
    )
    fixed = _corrections(R, "fixed")
    np.testing.assert_allclose(np.asarray(fixed), np.asarray(R), atol=1e-6)
    sm = _corrections(R, "smooth", radius=20)
    # Warp rotations should be small (they only cancel the jitter).
    angles = np.linalg.norm(np.asarray(so3.log(sm)), axis=-1)
    assert angles.max() < 0.05


def test_kalman_tracks_ramp():
    t = np.arange(200, dtype=np.float32)
    z = 0.01 * t + np.random.default_rng(1).normal(size=200).astype(np.float32) * 0.05
    out = np.asarray(kalman_filter_1d(jnp.asarray(z)))
    # Steady-state tracking of the ramp with reduced noise.
    resid = out[50:] - 0.01 * t[50:]
    assert np.abs(resid).mean() < 0.03


def test_kalman_rotations_shape_and_validity():
    _, noisy_w = _shaky_trajectory(t=120)
    out = smooth_rotations_kalman(so3.exp(jnp.asarray(noisy_w)))
    R = np.asarray(out)
    assert R.shape == (120, 3, 3)
    np.testing.assert_allclose(
        R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape), atol=1e-4
    )


def test_kalman_survives_many_revolutions():
    """The rotation-vector unwrap must track an UNBOUNDED accumulated
    angle (a camera that keeps panning): a fixed candidate range broke
    after ~2.5 turns, and the filter then smoothed across a 2*pi jump —
    a ~180-degree wrong virtual pose mid-clip."""
    t = 800
    ang = np.linspace(0.0, 8.0 * np.pi, t).astype(np.float32)  # 4 turns
    w = np.stack([np.zeros(t), ang, np.zeros(t)], axis=-1)
    R = so3.exp(jnp.asarray(w))
    out = np.asarray(smooth_rotations_kalman(R))
    # The smoothed pose of a perfectly smooth pan stays ON the pan.
    err = np.abs(out - np.asarray(R)).max()
    assert err < 0.05, err


def test_wahba_180_degree_sum_zero_quaternion():
    """rotation_from_correlation must recover rotations whose quaternion
    has w+x+y+z == 0 (e.g. 180 degrees about (1,-1,0)/sqrt(2)) — a fixed
    all-ones power-iteration start is exactly orthogonal to that optimum
    and silently returned a wrong (but valid) rotation."""
    axis = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    R = np.asarray(so3.exp(jnp.asarray(np.pi * axis, jnp.float32)))
    got = np.asarray(so3.rotation_from_correlation(jnp.asarray(R)))
    np.testing.assert_allclose(got, R, atol=1e-3)


def test_integrate_gyro_constant_rate():
    # Constant angular rate about y: after 1s the camera rotated by w rad.
    s = 1000
    ts = np.linspace(0.0, 1.0, s).astype(np.float32)
    omega = np.tile(np.array([0.0, 0.4, 0.0], np.float32), (s, 1))
    frame_ts = np.linspace(0.0, 1.0, 31).astype(np.float32)
    R = integrate_gyro(jnp.asarray(omega), jnp.asarray(ts), jnp.asarray(frame_ts))
    w_frames = np.asarray(so3.log(R))
    expected = np.outer(frame_ts, [0.0, 0.4, 0.0])
    np.testing.assert_allclose(w_frames, expected, atol=2e-3)


def test_kalman_survives_pi_crossing():
    """Accumulated rotations crossing 180 deg: the log-map wraps, and an
    unwrapped per-component filter would interpolate across a ~2*pi jump
    (regression test for the branch-lift in smoothing/kalman.py)."""
    import numpy as np
    import jax.numpy as jnp

    from video_annotator_tpu import so3
    from video_annotator_tpu.smoothing.kalman import smooth_rotations_kalman

    t = 120
    angles = np.linspace(0.0, 4.0, t)  # crosses pi at frame ~94
    w = np.stack([np.zeros(t), np.zeros(t), angles], axis=1)
    measured = so3.exp(jnp.asarray(w, jnp.float32))
    sm = smooth_rotations_kalman(measured)
    # The smoothed trajectory must stay within a few degrees of the
    # measured one everywhere (it is a slow, smooth signal).
    err = np.asarray(so3.log(so3.matmul(
        measured, jnp.swapaxes(sm, -1, -2)
    )))
    err_deg = np.degrees(np.linalg.norm(err, axis=1))
    assert err_deg.max() < 10.0, err_deg.max()


@pytest.mark.parametrize("radius,order", [(3, 2), (15, 2), (30, 3)])
def test_sg_conv_matches_scipy_savgol_filter(radius, order):
    """``sg_conv`` over a replicate-padded block IS scipy's savgol_filter
    with ``mode="nearest"`` — pinned at 1e-6 so a reduced-precision
    (TF32) convolution on an accelerator would fail it."""
    from scipy.signal import savgol_filter

    from video_annotator_tpu.smoothing.savgol import sg_conv

    rng = np.random.default_rng(radius)
    x = rng.uniform(-1.0, 1.0, (200, 9)).astype(np.float32)
    padded = np.concatenate(
        [np.repeat(x[:1], radius, 0), x, np.repeat(x[-1:], radius, 0)])
    got = np.asarray(sg_conv(jnp.asarray(padded),
                             jnp.asarray(savgol_weights(radius, order))))
    want = savgol_filter(x.astype(np.float64), 2 * radius + 1, order,
                         axis=0, mode="nearest")
    np.testing.assert_allclose(got, want, atol=1e-6)
