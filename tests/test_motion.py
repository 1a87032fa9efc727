"""Corner detection / LK flow / rotation RANSAC vs cv2 and synthetic truth."""

import numpy as np
import pytest

import cv2
import jax
import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.camera import CameraPreset, get_preset_camera
from video_annotator_tpu.ops.corners import detect_corners, shi_tomasi_response
from video_annotator_tpu.ops.lk import build_pyramid, pyramidal_lk
from video_annotator_tpu.ops.ransac import (
    estimate_rotation,
    rotation_with_fallback,
    RotationEstimate,
)


def _textured_image(h, w, seed=0):
    """Smooth random texture with good gradients everywhere."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h // 8, w // 8)).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.float32)


# --- corners ---------------------------------------------------------------


def test_shi_tomasi_response_peaks_on_corner():
    img = np.zeros((64, 64), np.float32)
    img[28:, 28:] = 255.0  # a single corner at (28, 28)
    resp = np.asarray(shi_tomasi_response(jnp.asarray(img)))
    py, px = np.unravel_index(resp.argmax(), resp.shape)
    assert abs(py - 28) <= 2 and abs(px - 28) <= 2


def test_detect_corners_finds_grid_dots():
    img = np.zeros((240, 320), np.float32)
    truth = []
    for y in range(40, 240, 50):
        for x in range(40, 320, 60):
            cv2.rectangle(img, (x - 4, y - 4), (x + 4, y + 4), 255, -1)
            truth.append((x, y))
    pts, valid = detect_corners(jnp.asarray(img), max_corners=64, min_distance=20)
    pts = np.asarray(pts)[np.asarray(valid)]
    # Every true blob must have a detection within 8 px.
    for tx, ty in truth:
        d = np.sqrt(((pts - [tx, ty]) ** 2).sum(-1)).min()
        assert d < 8, (tx, ty, d)


def test_detect_corners_respects_min_distance():
    img = _textured_image(240, 320)
    pts, valid = detect_corners(jnp.asarray(img), max_corners=128, min_distance=30)
    pts = np.asarray(pts)[np.asarray(valid)]
    assert len(pts) > 20
    d = np.sqrt(((pts[None] - pts[:, None]) ** 2).sum(-1))
    np.fill_diagonal(d, 1e9)
    # Cell-based suppression guarantees no two corners share a cell; the
    # minimum pairwise distance can be slightly under min_distance across
    # cell borders but not collapse to adjacency.
    assert d.min() > 8


# --- LK flow ---------------------------------------------------------------


def test_lk_recovers_pure_translation():
    img = _textured_image(240, 320, seed=1)
    shift = (7.3, -4.6)  # (dx, dy)
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    img2 = cv2.warpAffine(img, M, (320, 240))
    pts, valid = detect_corners(jnp.asarray(img), max_corners=64, min_distance=25)
    new_pts, status = pyramidal_lk(
        jnp.asarray(img), jnp.asarray(img2), pts, valid
    )
    new_pts = np.asarray(new_pts)
    status = np.asarray(status)
    pts = np.asarray(pts)
    # Only judge interior points (warp border effects kill edges).
    interior = (
        (pts[:, 0] > 30) & (pts[:, 0] < 280) & (pts[:, 1] > 30) & (pts[:, 1] < 205)
        & status
    )
    assert interior.sum() > 10
    flow = (new_pts - pts)[interior]
    err = np.abs(flow - np.asarray(shift))
    assert np.median(err[:, 0]) < 0.25, np.median(err, axis=0)
    assert np.median(err[:, 1]) < 0.25, np.median(err, axis=0)


def test_lk_matches_cv2_on_rotation_warp():
    img = _textured_image(480, 640, seed=2)
    M = cv2.getRotationMatrix2D((320, 240), 1.5, 1.0)  # degrees
    img2 = cv2.warpAffine(img, M, (640, 480))
    pts, valid = detect_corners(jnp.asarray(img), max_corners=128, min_distance=30)
    ours_pts, ours_st = pyramidal_lk(jnp.asarray(img), jnp.asarray(img2), pts, valid)

    cv_pts, cv_st, _ = cv2.calcOpticalFlowPyrLK(
        img.astype(np.uint8), img2.astype(np.uint8),
        np.asarray(pts).reshape(-1, 1, 2).astype(np.float32), None
    )
    both = np.asarray(ours_st) & (cv_st.reshape(-1) == 1) & np.asarray(valid)
    assert both.sum() > 30
    diff = np.abs(np.asarray(ours_pts)[both] - cv_pts.reshape(-1, 2)[both])
    assert np.median(diff) < 0.3, np.median(diff)


# --- rotation RANSAC -------------------------------------------------------


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 1.0
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_estimate_rotation_exact():
    p = _random_rays(200, 3)
    w_true = np.array([0.02, -0.015, 0.03], np.float32)
    R_true = np.asarray(so3.exp(jnp.asarray(w_true)))
    q = p @ R_true.T
    est = estimate_rotation(
        jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.ones(200, bool), jax.random.PRNGKey(0),
    )
    assert int(est.num_inliers) > 190
    np.testing.assert_allclose(np.asarray(est.rotation), R_true, atol=1e-4)


def test_estimate_rotation_with_outliers():
    rng = np.random.default_rng(4)
    p = _random_rays(200, 5)
    R_true = np.asarray(so3.exp(jnp.asarray([0.01, 0.025, -0.02], jnp.float32)))
    q = p @ R_true.T
    # 30% gross outliers + small noise on inliers
    out = rng.random(200) < 0.3
    q[out] = _random_rays(int(out.sum()), 6)
    q += rng.normal(size=q.shape) * 5e-4
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    est = estimate_rotation(
        jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.ones(200, bool), jax.random.PRNGKey(1), threshold_rad=0.005,
    )
    assert int(est.num_inliers) > 100
    err = np.asarray(so3.log(jnp.asarray(np.asarray(est.rotation) @ R_true.T)))
    assert np.linalg.norm(err) < 2e-3


def test_rotation_fallback_gate():
    prev = np.asarray(so3.exp(jnp.asarray([0.01, 0.0, 0.0], jnp.float32)))
    weak = RotationEstimate(
        rotation=jnp.eye(3), num_inliers=jnp.int32(10), inliers=jnp.zeros(5, bool)
    )
    strong = RotationEstimate(
        rotation=jnp.eye(3), num_inliers=jnp.int32(80), inliers=jnp.zeros(5, bool)
    )
    np.testing.assert_allclose(
        np.asarray(rotation_with_fallback(weak, jnp.asarray(prev))), prev
    )
    np.testing.assert_allclose(
        np.asarray(rotation_with_fallback(strong, jnp.asarray(prev))), np.eye(3)
    )


def test_rotation_from_projected_corners_end_to_end():
    """Full chain: project points with fisheye camera, rotate camera,
    estimate the rotation back from pixel pairs (the consume_frame flow,
    opencv/FrameSourceWarp.cpp:397-447)."""
    cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (640, 480))
    rng = np.random.default_rng(7)
    pix_prev = rng.uniform([60, 60], [580, 420], size=(150, 2)).astype(np.float32)
    rays_prev = np.asarray(cam.unproject_unit(jnp.asarray(pix_prev)))
    R_cam = np.asarray(so3.exp(jnp.asarray([0.008, -0.012, 0.01], jnp.float32)))
    # Camera rotates by R_cam => observed ray directions rotate by R_cam^T.
    rays_curr = rays_prev @ R_cam  # == (R_cam^T @ rays^T)^T
    pix_curr = np.asarray(cam.project(jnp.asarray(rays_curr, jnp.float32)))
    inside = (
        (pix_curr[:, 0] > 0) & (pix_curr[:, 0] < 639)
        & (pix_curr[:, 1] > 0) & (pix_curr[:, 1] < 479)
    )
    est = estimate_rotation(
        cam.unproject_unit(jnp.asarray(pix_prev)),
        cam.unproject_unit(jnp.asarray(pix_curr)),
        jnp.asarray(inside),
        jax.random.PRNGKey(2),
        threshold_rad=8.0 / float(cam.fx),  # reference's 8 px gate
    )
    err = np.asarray(so3.log(jnp.asarray(np.asarray(est.rotation) @ R_cam)))
    # est.rotation ~= R_cam^T
    assert np.linalg.norm(err) < 1e-3, err


def test_detect_corners_large_min_distance_hierarchical_nms():
    """min_distance > 32 uses the two-stage cell reduction; winners must
    still honor the spacing."""
    import numpy as np
    import jax.numpy as jnp
    from video_annotator_tpu.ops.corners import detect_corners

    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    pts, valid = detect_corners(jnp.asarray(img), max_corners=64,
                                min_distance=60)
    p = np.asarray(pts)[np.asarray(valid)]
    assert len(p) >= 8
    d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    assert d.min() >= 60 - 1e-3, d.min()


def test_analysis_level_validation():
    import pytest
    from video_annotator_tpu.pipeline.render import RenderOptions, analysis_level

    assert analysis_level(RenderOptions()) == 0
    assert analysis_level(RenderOptions(analysis_scale=0.25)) == 2
    with pytest.raises(ValueError):
        analysis_level(RenderOptions(analysis_scale=0.75))


def test_rotation_accumulation_drift_over_long_sequences():
    """SURVEY hard-part: R_t = dR.R_{t-1} accumulated in f32 for thousands
    of frames (opencv/FrameSourceWarp.cpp:441) must stay orthonormal —
    the per-step so3.project re-orthonormalization bounds the drift."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3

    rng = np.random.default_rng(0)
    steps = jnp.asarray(
        so3.exp(jnp.asarray(rng.normal(size=(5000, 3)) * 0.02, jnp.float32))
    )

    def step(r, dr):
        # The accumulation exactly as analyse()'s track_step does it.
        r_new = so3.project(
            jnp.matmul(dr, r, precision=jax.lax.Precision.HIGHEST)
        )
        return r_new, r_new

    _, rs = jax.lax.scan(step, jnp.eye(3, dtype=jnp.float32), steps)
    last = np.asarray(rs[-1], np.float64)
    # Orthonormality after 5000 steps.
    np.testing.assert_allclose(last @ last.T, np.eye(3), atol=2e-6)
    assert abs(np.linalg.det(last) - 1.0) < 2e-6
    # And accuracy: compare against a float64 accumulation.
    acc = np.eye(3)
    for d in np.asarray(steps, np.float64):
        acc = d @ acc
    err = np.degrees(np.linalg.norm(
        np.asarray(so3.log(jnp.asarray((last @ acc.T), jnp.float32)))
    ))
    assert err < 0.05, err  # < 0.05 deg of drift over 5000 frames


def test_box_filter_block_size():
    """shi_tomasi_response(block_size=b) must box-filter over b x b, not
    merely rescale the 3x3 result."""
    import numpy as np
    import jax.numpy as jnp

    from video_annotator_tpu.ops.corners import _box

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.normal(size=(24, 31)).astype(np.float32))
    for b in (3, 5, 7):
        got = np.asarray(_box(img, b))
        pad = np.pad(np.asarray(img), b // 2)
        want = np.zeros_like(np.asarray(img))
        for dy in range(b):
            for dx in range(b):
                want += pad[dy : dy + 24, dx : dx + 31]
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_detect_corners_exact_position_on_large_image():
    """Winner decoding stays exact past float32's 24-bit mantissa
    (images > 16.7M px — the old global flat index corrupted these)."""
    import numpy as np
    import jax.numpy as jnp

    from video_annotator_tpu.ops.corners import detect_corners

    h, w = 4200, 4200  # 17.6M px > 2^24
    img = np.zeros((h, w), np.float32)
    # Strong checkerboard corners at known, odd positions near the far end.
    for cy, cx in ((4091, 4117), (101, 4081), (4153, 97)):
        img[cy - 6 : cy + 6, cx - 6 : cx + 6] = 30.0
        img[cy - 6 : cy, cx - 6 : cx] = 225.0
        img[cy : cy + 6, cx : cx + 6] = 225.0
    pts, valid = detect_corners(jnp.asarray(img), max_corners=8,
                                min_distance=30)
    pts = np.asarray(pts)[np.asarray(valid)]
    assert len(pts) >= 3, pts
    for cy, cx in ((4091, 4117), (101, 4081), (4153, 97)):
        d = np.abs(pts - np.asarray([cx, cy])).sum(axis=1).min()
        assert d <= 2.0, (cy, cx, pts)


def test_lk_recovers_large_coherent_pan():
    """A global pan beyond a once-fetched window's drift padding: the
    XLA path re-fetches the sample window around the current estimate
    each iteration (cv2 semantics), so large coherent motion is
    recovered instead of saturating at the window edge with status
    still True (which RANSAC cannot reject — every point agrees on the
    same wrong answer)."""
    import cv2

    rng = np.random.default_rng(7)
    # Coarse features (~40 px) so a 15 px offset at pyramid level 2 is
    # inside the Newton convergence basin — the basin is a fundamental
    # LK limit shared with cv2; the fix under test removes the
    # window-clamp ceiling, not the basin.
    img = rng.normal(size=(18, 32)).astype(np.float32)
    img = cv2.resize(img, (1280, 720), interpolation=cv2.INTER_CUBIC)
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(
        np.float32)
    shift = (60, 8)  # (dx, dy) px — far beyond the old ~49 px ceiling
    img2 = np.roll(img, (shift[1], shift[0]), axis=(0, 1)).astype(np.float32)

    from video_annotator_tpu.ops.corners import detect_corners
    from video_annotator_tpu.ops.lk import pyramidal_lk

    pts, valid = detect_corners(jnp.asarray(img), max_corners=64,
                                min_distance=40, border=100)
    new_pts, status = pyramidal_lk(jnp.asarray(img), jnp.asarray(img2),
                                   pts, valid)
    ok = np.asarray(status) & np.asarray(valid)
    assert ok.sum() > 20
    d = (np.asarray(new_pts) - np.asarray(pts))[ok]
    med = np.median(d, axis=0)
    np.testing.assert_allclose(med, shift, atol=0.5)


def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h // 8 + 1, w // 16 + 1)).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)


def test_lk_edge_points_fail_cleanly():
    """Points within the window margin of an edge at some pyramid level
    come back status=False (cv2-style), never as plausible-looking
    garbage flow; every status=True point tracks the true shift."""
    img = _textured(480, 640, seed=2)
    img2 = np.roll(img, (2, 3), axis=(0, 1)).astype(np.float32)
    ys = np.asarray([9.0, 12.0, 30.0, 60.0, 240.0, 470.0, 474.0])
    pts = jnp.asarray(np.stack([np.full_like(ys, 320.0), ys], axis=1),
                      jnp.float32)
    valid = jnp.ones((len(ys),), bool)
    new_pts, status = pyramidal_lk(jnp.asarray(img), jnp.asarray(img2),
                                   pts, valid)
    status = np.asarray(status)
    new_pts = np.asarray(new_pts)
    assert status[4]
    np.testing.assert_allclose(new_pts[4], [323.0, 242.0], atol=0.35)
    for i in np.nonzero(status)[0]:
        np.testing.assert_allclose(
            new_pts[i] - np.asarray(pts)[i], [3.0, 2.0], atol=0.5)
    assert not status[0] and not status[-1]


def test_lk_tracks_last_strip():
    """Points near the right/bottom edges whose windows still fit at
    every pyramid level track normally (no whole-strip status kill)."""
    img = _textured(720, 1280, seed=3)
    img2 = np.roll(img, (2, 3), axis=(0, 1)).astype(np.float32)
    xy = [(1080.0, 360.0), (1150.0, 300.0), (1200.0, 400.0),
          (640.0, 600.0), (700.0, 640.0), (1100.0, 620.0),
          (640.0, 360.0), (200.0, 200.0)]
    pts = jnp.asarray(np.asarray(xy, np.float32))
    valid = jnp.ones((len(xy),), bool)
    new_pts, status = pyramidal_lk(jnp.asarray(img), jnp.asarray(img2),
                                   pts, valid)
    assert np.asarray(status).all(), status
    np.testing.assert_allclose(
        np.asarray(new_pts) - np.asarray(xy),
        np.tile([3.0, 2.0], (len(xy), 1)), atol=0.5)


def test_lk_vmapped_pairs_match_per_pair_calls():
    """The paired analyse tracks all adjacent pairs with ``jax.vmap`` of
    ``pyramidal_lk``; each pair equals its own unbatched call."""
    frames = np.stack([np.roll(_textured(192, 256, seed=4), (i, 2 * i),
                               axis=(0, 1)) for i in range(4)])
    pts, valid = detect_corners(jnp.asarray(frames[0]), max_corners=32,
                                min_distance=12)
    pts_b = jnp.broadcast_to(pts, (3,) + pts.shape)
    valid_b = jnp.broadcast_to(valid, (3,) + valid.shape)
    got_p, got_s = jax.vmap(pyramidal_lk)(
        jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), pts_b, valid_b)
    for i in range(3):
        want_p, want_s = pyramidal_lk(jnp.asarray(frames[i]),
                                      jnp.asarray(frames[i + 1]), pts, valid)
        np.testing.assert_array_equal(np.asarray(got_s[i]), np.asarray(want_s))
        ok = np.asarray(want_s)
        np.testing.assert_allclose(np.asarray(got_p[i])[ok],
                                   np.asarray(want_p)[ok], atol=1e-3)
    assert np.asarray(got_s).sum() > 20
