"""Rolling-shutter correction: per-tile-row rotation math, kernel parity,
and end-to-end jello removal on synthetic RS footage."""

import numpy as np
import pytest

import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.camera import (
    CameraModel,
    camera_from_dfov,
    get_output_camera,
)
from video_annotator_tpu.smoothing.rolling import rs_row_rotations


def test_rs_row_rotations_constant_velocity():
    """Constant angular velocity: row rotations interpolate exactly."""
    t, ny = 6, 12
    w = np.asarray([0.02, -0.01, 0.05])
    readout = 0.8
    measured = so3.exp(jnp.asarray(
        -np.outer(np.arange(t), w), jnp.float32))  # M_t = exp(-w t)
    corr = measured  # fixed-mode corrections
    f = jnp.asarray((np.arange(ny) * 8.0 + 4.0) / (ny * 8.0), jnp.float32)
    rows = np.asarray(rs_row_rotations(corr, measured, readout, f))
    assert rows.shape == (t, ny, 3, 3)
    for j in (0, 5, 11):
        fj = (j * 8.0 + 4.0) / (ny * 8.0)
        want = np.asarray(so3.exp(jnp.asarray(
            -w * (2 + fj * readout), jnp.float32)))
        np.testing.assert_allclose(rows[2, j], want, atol=1e-5)
    # Single-frame trajectories degrade to the per-frame correction.
    one = np.asarray(rs_row_rotations(corr[:1], measured[:1], readout, f))
    np.testing.assert_allclose(
        one, np.broadcast_to(np.asarray(corr[:1])[:, None], (1, ny, 3, 3)),
        atol=1e-7,
    )


def test_rs_kernel_matches_oracle():
    """Per-band rotation stacks through the batched uint8 warp
    (``FrameWarper``) == the float XLA oracle, luma and full YUV."""
    from video_annotator_tpu.ops.warp_xla import (
        RS_BAND_ROWS,
        _scaled_camera,
        chroma_row_rotations,
        warp_image_xla,
    )
    from video_annotator_tpu.pipeline.render import FrameWarper

    rng = np.random.default_rng(0)
    in_cam = camera_from_dfov(130.0, (256, 192), CameraModel.FISHEYE)
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)
    oh, ow = warper.out_h, warper.out_w
    ny = -(-oh // RS_BAND_ROWS)
    rots = jnp.asarray(np.stack([
        np.asarray(so3.exp(jnp.asarray(
            [0.01 * i / ny, -0.02 * i / ny, 0.03 * i / ny], jnp.float32)))
        for i in range(ny)
    ]))
    frame = rng.integers(0, 255, (192, 256)).astype(np.uint8)
    u = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    v = rng.integers(0, 255, (96, 128)).astype(np.uint8)

    wy, wu, wv = warper.warp_yuv(
        jnp.asarray(frame), jnp.asarray(u), jnp.asarray(v), rots)
    want = np.asarray(warp_image_xla(
        jnp.asarray(frame, jnp.float32), out_cam, in_cam, rots, (oh, ow)))
    np.testing.assert_allclose(
        np.asarray(wy).astype(np.float32), np.clip(np.round(want), 0, 255),
        atol=1.0,
    )
    # The stack really bends the map: rows differ from a one-rotation warp.
    flat = np.asarray(warp_image_xla(
        jnp.asarray(frame, jnp.float32), out_cam, in_cam, rots[-1], (oh, ow)))
    assert np.abs(want[:8] - flat[:8]).mean() > 1.0

    # Chroma quantizes to 16-row luma granularity, neutral border.
    rot_c = chroma_row_rotations(rots, -(-(oh // 2) // RS_BAND_ROWS))
    want_u = np.asarray(warp_image_xla(
        jnp.asarray(u, jnp.float32) - 128.0, _scaled_camera(out_cam, 0.5),
        _scaled_camera(in_cam, 0.5), rot_c, (oh // 2, ow // 2))) + 128.0
    assert wu.shape == (oh // 2, ow // 2) and wv.shape == wu.shape
    np.testing.assert_allclose(
        np.asarray(wu).astype(np.float32), np.clip(np.round(want_u), 0, 255),
        atol=1.0,
    )


def test_rs_render_removes_jello(tmp_path):
    """End-to-end: oscillating rotation + sequential readout produces
    jello; --rolling-shutter with the known trajectory removes it."""
    from fractions import Fraction

    from video_annotator_tpu.camera import CameraPreset, get_preset_camera
    from video_annotator_tpu.io.synthetic import render_frame
    from video_annotator_tpu.io.video import VideoMeta, open_reader, open_writer
    from video_annotator_tpu.pipeline.render import RenderOptions, render
    from video_annotator_tpu.pipeline.trajectory import (
        Trajectory,
        trajectory_path,
    )

    W, H, N = 192, 144, 10
    readout = 1.0
    cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (W, H))

    def omega_t(t):  # oscillating roll rate, ~0.05 rad amplitude
        return np.asarray([0.0, 0.0, 0.05 * np.sin(2 * np.pi * t / 10.0)])

    # Integrate the ray-rotation R(t) ONCE at fine steps (re-integrating
    # per query is eagerly-dispatched jax and dominated this test's
    # runtime); band j of frame t is captured at time t + f_j * readout.
    steps = 64
    poses = [np.eye(3)]
    for k in range(N * steps + steps):
        poses.append(np.asarray(so3.exp(jnp.asarray(
            omega_t(k / steps) / steps, jnp.float32))) @ poses[-1])

    def R_at(time):
        return poses[int(round(time * steps))]

    src = str(tmp_path / "jello_src.y4m")
    wtr = open_writer(src, VideoMeta(W, H, Fraction(30, 1)))
    rotvecs = []
    for t in range(N):
        bands = []
        for j in range(H // 8):
            f = (j * 8.0 + 4.0) / H
            rot = jnp.asarray(R_at(t + f * readout), jnp.float32)
            y, u, v = render_frame(cam, rot)
            bands.append((np.asarray(y, np.uint8)[j * 8:(j + 1) * 8],
                          np.asarray(u, np.uint8)[j * 4:(j + 1) * 4],
                          np.asarray(v, np.uint8)[j * 4:(j + 1) * 4]))
        wtr.write((np.concatenate([b[0] for b in bands]),
                   np.concatenate([b[1] for b in bands]),
                   np.concatenate([b[2] for b in bands])))
        # Measured trajectory at scanline 0: M_t = R(t)^T.
        rotvecs.append(np.asarray(so3.log(jnp.asarray(R_at(float(t)).T))))
    wtr.close()

    opts = dict(preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED,
                stabilise="fixed", encode_only=True)
    scores = {}
    for name, rs in (("plain", 0.0), ("rs", readout)):
        out = str(tmp_path / f"{name}.y4m")
        Trajectory(params=np.stack(rotvecs), kind="so3",
                   fps=Fraction(30, 1)).save(trajectory_path(out))
        render(src, out, RenderOptions(rolling_shutter=rs, **opts))
        r = open_reader(out)
        fs = [y.astype(np.float64) for y, _, _ in r]
        r.close()
        assert len(fs) == N
        h, w = fs[0].shape
        c = (slice(h // 4, -h // 4), slice(w // 4, -w // 4))
        # Fixed stabilization of a static world: frames should be
        # identical; residual inter-frame motion is the jello.
        scores[name] = np.mean([
            np.abs(f[c] - fs[0][c]).mean() for f in fs[1:]
        ])
    # The frame-rate velocity model is first-order: expect a strong
    # (not total) jello reduction; bilinear/codec blur floors both.
    assert scores["rs"] < scores["plain"] * 0.6, scores


def test_rs_rejects_wrong_modes(tmp_path):
    from video_annotator_tpu.pipeline.render import RenderOptions, render

    with pytest.raises(ValueError, match="rotation family"):
        render("synthetic://shaky?w=64&h=48&n=4", str(tmp_path / "o.y4m"),
               RenderOptions(filter="vidstab", rolling_shutter=0.7))
    with pytest.raises(ValueError, match="two-phase"):
        render("synthetic://shaky?w=64&h=48&n=4", str(tmp_path / "o.y4m"),
               RenderOptions(rolling_shutter=0.7, streaming=True,
                             stabilise="smooth"))


def test_rs_row_rotations_gyro_exact():
    """Telemetry-exact scanline poses: constant rate matches the velocity
    model; non-constant rate matches the true integral where the
    velocity model cannot."""
    from video_annotator_tpu.smoothing.rolling import rs_row_rotations_gyro

    t, ny = 4, 8
    fps = 30.0
    readout_s = 1.0 / fps
    frame_ts = jnp.asarray(np.arange(t) / fps, jnp.float32)
    f = jnp.asarray((np.arange(ny) * 8.0 + 4.0) / (ny * 8.0), jnp.float32)

    # Accelerating roll rate: w(t) = a * t (rad/s).
    a = 3.0
    s = 2000
    ts = np.arange(s) / (s / (t / fps + 0.1))  # dense grid over the clip
    omega = np.stack([np.zeros(s), np.zeros(s), a * ts], axis=1)

    def angle_at(time):  # integral of a*t
        return 0.5 * a * time * time

    corr = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (t, 3, 3))
    rows = np.asarray(rs_row_rotations_gyro(
        corr, jnp.asarray(omega, jnp.float32), jnp.asarray(ts, jnp.float32),
        frame_ts, readout_s, f,
    ))
    for ti in (1, 3):
        for j in (0, 7):
            tf = ti / fps + float(f[j]) * readout_s
            # rows = M(t,f) M_t^T: rotation between scanline and frame start.
            want_angle = -(angle_at(tf) - angle_at(ti / fps))
            got = rows[ti, j]
            got_angle = np.arctan2(got[1, 0], got[0, 0])
            assert abs(got_angle - want_angle) < 2e-3, (ti, j, got_angle,
                                                        want_angle)
