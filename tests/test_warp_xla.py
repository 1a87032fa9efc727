"""XLA warp vs cv2.remap oracle — the BASELINE fidelity gate (PSNR >= 45 dB)."""

import numpy as np
import pytest

import cv2
import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.camera import (
    CameraModel,
    CameraPreset,
    camera_from_dfov,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu.ops.warp_xla import (
    bilinear_sample,
    compute_warp_map,
    warp_image_xla,
    warp_yuv420_xla,
)


def psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def _test_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        128
        + 80 * np.sin(xx / 17.0)
        + 40 * np.cos(yy / 11.0)
        + rng.normal(size=(h, w)) * 10
    )
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def cameras():
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (640, 480))
    out_cam = get_output_camera(in_cam, scale=0.5)
    return in_cam, out_cam


def test_map_matches_cv2_fisheye_init_undistort_rectify(cameras):
    """Identity rotation: our map == cv2.fisheye.initUndistortRectifyMap."""
    in_cam, out_cam = cameras
    rotation = jnp.eye(3)
    ours = np.asarray(compute_warp_map(out_cam, in_cam, rotation))
    K = np.array(
        [[float(in_cam.fx), 0, float(in_cam.cx)],
         [0, float(in_cam.fy), float(in_cam.cy)], [0, 0, 1]]
    )
    P = np.array(
        [[float(out_cam.fx), 0, float(out_cam.cx)],
         [0, float(out_cam.fy), float(out_cam.cy)], [0, 0, 1]]
    )
    map_x, map_y = cv2.fisheye.initUndistortRectifyMap(
        K, np.zeros(4), np.eye(3), P, (out_cam.width, out_cam.height), cv2.CV_32FC1
    )
    np.testing.assert_allclose(ours[..., 0], map_x, atol=0.05)
    np.testing.assert_allclose(ours[..., 1], map_y, atol=0.05)


def test_bilinear_sample_matches_cv2_remap(cameras):
    in_cam, out_cam = cameras
    img = _test_image(480, 640)
    rotation = so3.exp(jnp.array([0.02, -0.03, 0.01]))
    coords = compute_warp_map(out_cam, in_cam, rotation)
    ours = np.asarray(bilinear_sample(jnp.asarray(img), coords))
    cmap = np.asarray(coords)
    ref = cv2.remap(
        img, cmap[..., 0], cmap[..., 1], cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT,
    )
    assert psnr(np.clip(ours, 0, 255), ref) > 45.0


def test_warp_image_full_pipeline_psnr(cameras):
    """End-to-end warp (map+remap fused) vs all-OpenCV reference >= 45 dB."""
    in_cam, out_cam = cameras
    img = _test_image(480, 640, seed=1)
    w = np.array([0.05, 0.02, -0.04], np.float32)
    rotation = so3.exp(jnp.asarray(w))
    ours = np.asarray(warp_image_xla(jnp.asarray(img), out_cam, in_cam, rotation))

    # All-OpenCV reference: createMap math via initUndistortRectifyMap with R.
    K = np.array(
        [[float(in_cam.fx), 0, float(in_cam.cx)],
         [0, float(in_cam.fy), float(in_cam.cy)], [0, 0, 1]]
    )
    P = np.array(
        [[float(out_cam.fx), 0, float(out_cam.cx)],
         [0, float(out_cam.fy), float(out_cam.cy)], [0, 0, 1]]
    )
    # cv2's R maps undistorted coords: map = project(R^-1 @ P^-1 p); our
    # rotation rotates output rays before projecting, so R_cv = rotation^-1.
    R_cv, _ = cv2.Rodrigues(-w.astype(np.float64))
    map_x, map_y = cv2.fisheye.initUndistortRectifyMap(
        K, np.zeros(4), R_cv, P, (out_cam.width, out_cam.height), cv2.CV_32FC1
    )
    ref = cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
    assert psnr(np.clip(ours, 0, 255), ref) > 45.0


def test_warp_yuv420_shapes(cameras):
    in_cam, out_cam = cameras
    y = jnp.asarray(_test_image(480, 640))
    u = jnp.asarray(_test_image(240, 320, seed=2))
    v = jnp.asarray(_test_image(240, 320, seed=3))
    rotation = jnp.eye(3)
    oh = out_cam.height - out_cam.height % 2
    ow = out_cam.width - out_cam.width % 2
    y_o, u_o, v_o = warp_yuv420_xla(y, u, v, out_cam, in_cam, rotation, (oh, ow))
    assert y_o.shape == (oh, ow)
    assert u_o.shape == (oh // 2, ow // 2)
    assert v_o.shape == (oh // 2, ow // 2)


def test_identity_camera_identity_rotation_is_noop():
    """Rectilinear -> rectilinear with same intrinsics is (near) identity."""
    cam = camera_from_dfov(90.0, (256, 192), CameraModel.RECTILINEAR)
    img = _test_image(192, 256, seed=4)
    out = np.asarray(warp_image_xla(jnp.asarray(img), cam, cam, jnp.eye(3)))
    assert psnr(np.clip(out, 0, 255), img) > 50.0


def test_bicubic_sample_matches_cv2_remap(cameras):
    """--interp bicubic == cv2.remap INTER_CUBIC (Keys a=-0.75), the
    higher-order resampler the reference requests from vidstab
    (interpol=bicubic, src/render.ts:571)."""
    from video_annotator_tpu.ops.warp_xla import bicubic_sample

    in_cam, out_cam = cameras
    img = _test_image(480, 640)
    rotation = so3.exp(jnp.array([0.02, -0.03, 0.01]))
    coords = compute_warp_map(out_cam, in_cam, rotation)
    ours = np.asarray(bicubic_sample(jnp.asarray(img), coords))
    cmap = np.asarray(coords)
    ref = cv2.remap(
        img, cmap[..., 0], cmap[..., 1], cv2.INTER_CUBIC,
        borderMode=cv2.BORDER_CONSTANT,
    )
    # cv2 clips INTER_CUBIC overshoot to uint8 before we compare.
    assert psnr(np.clip(ours, 0, 255), ref) > 45.0
    # ...and bicubic must actually differ from (be sharper than) bilinear.
    bil = np.asarray(bilinear_sample(jnp.asarray(img), coords))
    assert np.abs(ours - bil).max() > 1.0


def test_frame_warper_bicubic(tmp_path):
    """FrameWarper(interp='bicubic') produces a valid uint8,
    bilinear-differing warp."""
    from video_annotator_tpu.pipeline.render import FrameWarper

    in_cam = get_preset_camera(
        CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240)
    )
    out_cam = get_output_camera(in_cam, scale=0.5, crop_borders=True)
    wb = FrameWarper(in_cam, out_cam)
    wc = FrameWarper(in_cam, out_cam, interp="bicubic")
    y = jnp.asarray(_test_image(240, 320))
    u = jnp.asarray(_test_image(120, 160, seed=2))
    v = jnp.asarray(_test_image(120, 160, seed=3))
    rot = so3.exp(jnp.array([0.01, 0.02, -0.01]))
    yb, _, _ = wb.warp_yuv(y, u, v, rot)
    yc, uc, vc = wc.warp_yuv(y, u, v, rot)
    assert yc.shape == yb.shape and yc.dtype == jnp.uint8
    d = np.abs(np.asarray(yc).astype(int) - np.asarray(yb).astype(int))
    assert d.max() >= 1 and d.mean() < 4.0  # differs, but same image

    with pytest.raises(ValueError):
        FrameWarper(in_cam, out_cam, interp="lanczos9000")


def test_lanczos4_matches_cv2_remap(cameras):
    """lanczos_sample(a=4) == cv2.remap INTER_LANCZOS4 — external oracle
    for the windowed-sinc kernel + separable normalization."""
    from video_annotator_tpu.ops.warp_xla import lanczos_sample

    in_cam, out_cam = cameras
    img = _test_image(480, 640)
    rotation = so3.exp(jnp.array([0.02, -0.03, 0.01]))
    coords = compute_warp_map(out_cam, in_cam, rotation)
    ours = np.asarray(lanczos_sample(jnp.asarray(img), coords, a=4))
    cmap = np.asarray(coords)
    ref = cv2.remap(
        img, cmap[..., 0], cmap[..., 1], cv2.INTER_LANCZOS4,
        borderMode=cv2.BORDER_CONSTANT,
    )
    # Compare only where the full 8x8 stencil is in-frame: cv2's border
    # handling for LANCZOS4 renormalizes differently near edges.
    x0 = np.floor(cmap[..., 0]).astype(int)
    y0 = np.floor(cmap[..., 1]).astype(int)
    interior = (
        (x0 >= 4) & (x0 < 640 - 4) & (y0 >= 4) & (y0 < 480 - 4)
    )
    assert interior.mean() > 0.3
    a = np.clip(ours, 0, 255)[interior]
    b = ref[interior]
    assert psnr(a, b) > 45.0


def test_lanczos_integer_exact_and_sharper():
    """The a=2 kernel (v360's interp=lanczos, src/render.ts:533) is exact
    at integer coordinates and differs from bilinear at subpixel shifts."""
    from video_annotator_tpu.ops.warp_xla import lanczos_sample

    img = _test_image(64, 96, seed=5)
    yy, xx = np.mgrid[4:60, 4:92]
    coords = jnp.asarray(
        np.stack([xx, yy], axis=-1).astype(np.float32)
    )
    out = np.asarray(lanczos_sample(jnp.asarray(img), coords))
    np.testing.assert_allclose(out, img[4:60, 4:92].astype(np.float32),
                               atol=1e-3)
    # Half-pixel shift: windowed sinc must differ from the bilinear tent.
    shifted = coords + 0.5
    lz = np.asarray(lanczos_sample(jnp.asarray(img), shifted))
    bl = np.asarray(bilinear_sample(jnp.asarray(img), shifted))
    assert np.abs(lz - bl).max() > 1.0


def test_frame_warper_lanczos():
    """FrameWarper(interp='lanczos') produces a valid uint8,
    bilinear-differing warp (the v360 reprojection stage's resampler)."""
    from video_annotator_tpu.pipeline.render import FrameWarper

    in_cam = get_preset_camera(
        CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240)
    )
    out_cam = get_output_camera(in_cam, scale=0.5, crop_borders=True)
    wb = FrameWarper(in_cam, out_cam)
    wl = FrameWarper(in_cam, out_cam, interp="lanczos")
    y = jnp.asarray(_test_image(240, 320))
    u = jnp.asarray(_test_image(120, 160, seed=2))
    v = jnp.asarray(_test_image(120, 160, seed=3))
    rot = so3.exp(jnp.array([0.01, 0.02, -0.01]))
    yb, _, _ = wb.warp_yuv(y, u, v, rot)
    yl, ul, vl = wl.warp_yuv(y, u, v, rot)
    assert yl.shape == yb.shape and yl.dtype == jnp.uint8
    d = np.abs(np.asarray(yl).astype(int) - np.asarray(yb).astype(int))
    assert d.max() >= 1 and d.mean() < 4.0
