"""Camera model tests against the OpenCV fisheye oracle.

The reference delegates this math to ``cv::fisheye`` — so cv2 is the ground
truth for project/unproject and for the output-camera auto-fit
(``opencv/FrameSourceWarp.cpp:88-165``).
"""

import math

import numpy as np
import pytest

import cv2
import jax.numpy as jnp

from video_annotator_tpu.camera import (
    Camera,
    CameraModel,
    CameraPreset,
    camera_from_dfov,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu import so3


def _cv_K(cam):
    return np.array(
        [[float(cam.fx), 0, float(cam.cx)], [0, float(cam.fy), float(cam.cy)], [0, 0, 1]]
    )


@pytest.fixture
def fisheye_cam():
    return get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (1920, 1440))


def test_preset_matches_reference_values(fisheye_cam):
    # opencv/FrameSourceWarp.cpp:50-56 at native 1920x1440.
    assert float(fisheye_cam.cx) == pytest.approx(967.37)
    assert float(fisheye_cam.cy) == pytest.approx(711.07)
    assert float(fisheye_cam.fx) == pytest.approx(942.96)
    assert float(fisheye_cam.fy) == pytest.approx(942.53)
    assert fisheye_cam.model == CameraModel.FISHEYE


def test_preset_scales_with_resolution():
    cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (960, 720))
    assert float(cam.fx) == pytest.approx(942.96 / 2)
    assert float(cam.cx) == pytest.approx(967.37 / 2)


def test_fisheye_project_matches_cv2(fisheye_cam):
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(64, 3)).astype(np.float64)
    rays[:, 2] = np.abs(rays[:, 2]) + 0.5  # in front of camera
    dist = np.array([0.02, -0.01, 0.004, -0.001])
    cam = Camera.make(
        fisheye_cam.fx, fisheye_cam.fy, fisheye_cam.cx, fisheye_cam.cy,
        1920, 1440, CameraModel.FISHEYE, dist=dist,
    )
    ours = np.asarray(cam.project(jnp.asarray(rays, jnp.float32)))
    cv_pts, _ = cv2.fisheye.projectPoints(
        rays.reshape(1, -1, 3), np.zeros(3), np.zeros(3), _cv_K(cam), dist
    )
    np.testing.assert_allclose(ours, cv_pts.reshape(-1, 2), atol=0.1)


def test_fisheye_unproject_matches_cv2(fisheye_cam):
    rng = np.random.default_rng(1)
    pts = rng.uniform([100, 100], [1800, 1300], size=(64, 2))
    dist = np.array([0.02, -0.01, 0.004, -0.001])
    cam = Camera.make(
        fisheye_cam.fx, fisheye_cam.fy, fisheye_cam.cx, fisheye_cam.cy,
        1920, 1440, CameraModel.FISHEYE, dist=dist,
    )
    ours = np.asarray(cam.unproject(jnp.asarray(pts, jnp.float32)))
    cv_und = cv2.fisheye.undistortPoints(
        pts.reshape(1, -1, 2).astype(np.float64), _cv_K(cam), dist
    ).reshape(-1, 2)
    np.testing.assert_allclose(ours[:, :2], cv_und, atol=2e-3)
    np.testing.assert_allclose(ours[:, 2], 1.0)


def test_project_unproject_roundtrip(fisheye_cam):
    rng = np.random.default_rng(2)
    pts = rng.uniform([50, 50], [1870, 1390], size=(128, 2)).astype(np.float32)
    rays = fisheye_cam.unproject(jnp.asarray(pts))
    back = np.asarray(fisheye_cam.project(rays))
    np.testing.assert_allclose(back, pts, atol=0.02)


def test_rectilinear_roundtrip():
    cam = camera_from_dfov(90.0, (1280, 720), CameraModel.RECTILINEAR)
    rng = np.random.default_rng(3)
    pts = rng.uniform([0, 0], [1279, 719], size=(32, 2)).astype(np.float32)
    back = np.asarray(cam.project(cam.unproject(jnp.asarray(pts))))
    np.testing.assert_allclose(back, pts, atol=1e-2)


def test_output_camera_autofit(fisheye_cam):
    # Mirror the reference algorithm with cv2 as the undistort oracle
    # (opencv/FrameSourceWarp.cpp:88-165).
    out = get_output_camera(fisheye_cam, scale=1.0, crop_borders=False, zoom=1.0)
    w, h = 1920, 1440
    cx, cy = float(fisheye_cam.cx), float(fisheye_cam.cy)
    pts = np.array(
        [
            [0, 0], [0, h - 1], [w - 1, 0], [w - 1, h - 1],
            [cx, 0], [w - 1, cy], [cx, h - 1], [0, cy],
        ],
        np.float64,
    )
    und = cv2.fisheye.undistortPoints(
        pts.reshape(1, -1, 2), _cv_K(fisheye_cam), np.zeros(4)
    ).reshape(-1, 2)
    min_x, max_x = und[:, 0].min(), und[:, 0].max()
    min_y, max_y = und[:, 1].min(), und[:, 1].max()
    in_diag = math.hypot(w - 1, h - 1)
    out_diag = math.hypot(und[3, 0] - und[0, 0], und[3, 1] - und[0, 1])
    scale = in_diag / out_diag
    assert float(out.fx) == pytest.approx(scale, rel=1e-3)
    assert float(out.cx) == pytest.approx(scale * -min_x, rel=1e-3)
    assert out.width == pytest.approx(int(scale * (max_x - min_x)), abs=2)
    assert out.height == pytest.approx(int(scale * (max_y - min_y)), abs=2)
    assert out.model == CameraModel.RECTILINEAR


def test_output_camera_crop_borders_smaller(fisheye_cam):
    full = get_output_camera(fisheye_cam, crop_borders=False)
    crop = get_output_camera(fisheye_cam, crop_borders=True)
    assert crop.width < full.width
    assert crop.height < full.height


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(32, 3)).astype(np.float32)
    R = so3.exp(jnp.asarray(w))
    w2 = np.asarray(so3.log(R))
    # exp/log roundtrip up to 2*pi wrapping — keep norms < pi.
    w_small = w * (0.9 * np.pi / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-6))
    w_small = np.where(np.linalg.norm(w, axis=-1, keepdims=True) < 0.9 * np.pi, w, w_small)
    R = so3.exp(jnp.asarray(w_small))
    w2 = np.asarray(so3.log(R))
    np.testing.assert_allclose(w2, w_small, atol=1e-4)


def test_so3_exp_matches_cv2_rodrigues():
    rng = np.random.default_rng(5)
    for _ in range(8):
        w = rng.normal(size=3) * 0.5
        ours = np.asarray(so3.exp(jnp.asarray(w, jnp.float32)))
        cv_R, _ = cv2.Rodrigues(w)
        np.testing.assert_allclose(ours, cv_R, atol=1e-5)


def test_so3_project_recovers_rotation():
    rng = np.random.default_rng(6)
    w = rng.normal(size=3).astype(np.float32)
    R = np.asarray(so3.exp(jnp.asarray(w)))
    noisy = R + rng.normal(size=(3, 3)).astype(np.float32) * 1e-3
    fixed = np.asarray(so3.project(jnp.asarray(noisy)))
    np.testing.assert_allclose(fixed @ fixed.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(fixed, R, atol=5e-3)


def test_equirect_project_unproject_roundtrip():
    from video_annotator_tpu.camera import camera_from_dfov

    cam = camera_from_dfov(180.0, (720, 360), CameraModel.EQUIRECT)
    rng = np.random.default_rng(9)
    pts = rng.uniform([10, 10], [709, 349], size=(64, 2)).astype(np.float32)
    dirs = cam.unproject(jnp.asarray(pts))
    # directions are unit-norm over the full sphere
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(dirs), axis=-1), 1.0, atol=1e-5
    )
    back = np.asarray(cam.project(dirs))
    np.testing.assert_allclose(back, pts, atol=0.05)


# --- v360 panoramic projection family --------------------------------------
# The reference forwards --projection verbatim to the v360 filter
# (src/cli.ts:117-121; `output: projection`, src/render.ts:523), so the
# closed-form v360 output projections are part of the capability surface.

_PANO_MODELS = [
    CameraModel.STEREOGRAPHIC,
    CameraModel.MERCATOR,
    CameraModel.BALL,
    CameraModel.HAMMER,
    CameraModel.SINUSOIDAL,
    CameraModel.CYLINDRICAL,
    CameraModel.PANNINI,
]


@pytest.mark.parametrize("model", _PANO_MODELS, ids=lambda m: m.value)
def test_panoramic_project_unproject_roundtrip(model):
    """unproject gives unit directions; project inverts it (interior px)."""
    from video_annotator_tpu.camera import camera_from_dfov

    # Stay inside each chart's valid region: moderate dfov, interior pixels.
    cam = camera_from_dfov(160.0, (640, 480), model)
    rng = np.random.default_rng(11)
    pts = rng.uniform([120, 120], [519, 359], size=(128, 2)).astype(np.float32)
    dirs = cam.unproject(jnp.asarray(pts))
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(dirs), axis=-1), 1.0, atol=1e-5
    )
    back = np.asarray(cam.project(dirs))
    np.testing.assert_allclose(back, pts, atol=0.08)


@pytest.mark.parametrize("model", _PANO_MODELS, ids=lambda m: m.value)
def test_panoramic_numpy_twin_matches_jax(model):
    """camera.unproject_np (the warp reference's host twin) must stay in
    lock-step with Camera.unproject for every model."""
    from video_annotator_tpu.camera import camera_from_dfov, unproject_np

    cam = camera_from_dfov(200.0, (320, 240), model)
    ys, xs = np.mgrid[0:240:7, 0:320:9].astype(np.float64)
    ref = unproject_np(cam, ys, xs)
    pts = jnp.asarray(np.stack([xs, ys], axis=-1), jnp.float32)
    ours = np.asarray(cam.unproject(pts))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_panoramic_invalid_regions_point_backward():
    """Pixels outside hammer's ellipse / ball's disk / sinusoidal's wings
    unproject to (0,0,-1) so the warp renders border there."""
    from video_annotator_tpu.camera import camera_from_dfov

    for model in (CameraModel.HAMMER, CameraModel.SINUSOIDAL):
        cam = camera_from_dfov(360.0, (400, 400), model)
        corner = jnp.asarray([[1.0, 1.0], [399.0, 1.0]], jnp.float32)
        dirs = np.asarray(cam.unproject(corner))
        np.testing.assert_allclose(dirs, [[0, 0, -1]] * 2, atol=1e-6)
    # Ball's dfov-360 disk circumscribes the canvas (focal is
    # diagonal-derived), so probe a point beyond one disk radius.
    cam = camera_from_dfov(360.0, (400, 400), CameraModel.BALL)
    outside = jnp.asarray(
        [[float(cam.cx) + 1.2 * float(cam.fx), float(cam.cy)]], jnp.float32
    )
    dirs = np.asarray(cam.unproject(outside))
    np.testing.assert_allclose(dirs, [[0, 0, -1]], atol=1e-6)


def test_panoramic_known_angles():
    """Spot-check chart geometry: the point one focal length right of the
    principal point is at the model's characteristic longitude."""
    from video_annotator_tpu.camera import camera_from_dfov

    # Equirect/mercator/cylindrical: x displacement == longitude (radians).
    for model in (CameraModel.EQUIRECT, CameraModel.MERCATOR,
                  CameraModel.CYLINDRICAL):
        cam = camera_from_dfov(180.0, (720, 720), model)
        p = jnp.asarray([float(cam.cx) + float(cam.fx) * 1.0, float(cam.cy)])
        d = np.asarray(cam.unproject(p))
        lon = math.atan2(d[0], d[2])
        assert abs(lon - 1.0) < 1e-5, (model, lon)
        assert abs(d[1]) < 1e-6
    # Stereographic: r = 2 tan(theta/2) -> r = 2 at theta = 90 deg.
    cam = camera_from_dfov(180.0, (720, 720), CameraModel.STEREOGRAPHIC)
    p = jnp.asarray([float(cam.cx) + float(cam.fx) * 2.0, float(cam.cy)])
    d = np.asarray(cam.unproject(p))
    assert abs(d[2]) < 1e-5 and d[0] > 0.999
    # Ball: r = sin(theta/2) -> r = 1 is the backward pole.
    cam = camera_from_dfov(360.0, (720, 720), CameraModel.BALL)
    p = jnp.asarray([float(cam.cx) + float(cam.fx) * 1.0, float(cam.cy)])
    d = np.asarray(cam.unproject(p))
    np.testing.assert_allclose(d, [0, 0, -1], atol=1e-4)


def test_projection_cli_choices_match_models():
    """cli.py hardcodes the --projection choices (so --help stays jax-free);
    they must equal pipeline.render.PROJECTION_MODELS' keys."""
    from video_annotator_tpu.cli import build_parser
    from video_annotator_tpu.pipeline.render import PROJECTION_MODELS

    p = build_parser()
    sub = dict(p._subparsers._group_actions[0].choices.items())["render"]  # noqa: SLF001
    for a in sub._actions:  # noqa: SLF001
        if "--projection" in getattr(a, "option_strings", ()):
            assert set(a.choices) == set(PROJECTION_MODELS)
            break
    else:
        raise AssertionError("--projection not found")


def test_build_cameras_applies_projection_without_explicit_dfov():
    """--projection must take effect even without -w/-h/--output-dfov (the
    reference's v360 path applies it unconditionally, src/render.ts:523)."""
    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import RenderOptions, build_cameras

    meta = VideoMeta(width=640, height=480, fps=30.0, num_frames=10)
    for name, model in (("equirect", CameraModel.EQUIRECT),
                        ("sg", CameraModel.STEREOGRAPHIC),
                        ("mercator", CameraModel.MERCATOR)):
        o = RenderOptions(projection=name)
        _, out_cam = build_cameras(meta, o)
        assert out_cam.model == model, name
        assert out_cam.width > 0 and out_cam.height > 0
    # Default rect path unchanged: auto-fit rectilinear.
    _, out_cam = build_cameras(meta, RenderOptions())
    assert out_cam.model == CameraModel.RECTILINEAR
