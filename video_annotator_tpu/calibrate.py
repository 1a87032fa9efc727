"""Camera intrinsic calibration by differentiable bundle adjustment.

Replaces the reference's OpenCV-sample calibration tool
(``opencv/camera_calibration/camera_calibration.cpp``: chessboard views ->
``fisheye::calibrate`` at ``:574`` / ``calibrateCameraRO`` at ``:587-589``,
reporting RMS reprojection error at ``:488,600-606``). Approach here:
the projection model is already differentiable JAX code (``camera.py``), so
calibration is plain gradient-based nonlinear least squares over
(fx, fy, cx, cy, k1..k4, per-view pose) — no bespoke solver, and the same
code path that runs in the pipeline is the one being calibrated.

Input: a video to detect a chessboard in (the reference tool's workflow —
its settings point ``Input`` at GoPro footage of a 9x6 board,
``opencv/camera_calibration/in_VID5.xml``; detection + subpixel refinement
as in ``camera_calibration.cpp:379-390``), or an ``.npz`` with
``object_points`` (N, 3) board coordinates and ``image_points`` (V, N, 2)
pre-extracted detections per view.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import sys
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu import so3
from video_annotator_tpu.camera import Camera, CameraModel


class PatternType(enum.Enum):
    """Calibration target families the reference tool supports
    (``camera_calibration.cpp:22``, detection switch ``:356-363``)."""

    CHESSBOARD = "CHESSBOARD"
    CIRCLES_GRID = "CIRCLES_GRID"
    ASYMMETRIC_CIRCLES_GRID = "ASYMMETRIC_CIRCLES_GRID"


def _project(params, obj_pts, model: CameraModel, aspect_ratio=None):
    """Project board points through pose + intrinsics.

    ``aspect_ratio``: when set, fx is tied to ``aspect_ratio * fy`` (the
    reference's CALIB_FIX_ASPECT_RATIO semantics,
    ``camera_calibration.cpp:137-138``) and ``params["fx"]`` is unused.
    """
    fx, fy, cx, cy = params["fx"], params["fy"], params["cx"], params["cy"]
    if aspect_ratio is not None:
        fx = aspect_ratio * fy
    dist = params["dist"]
    rvecs, tvecs = params["rvec"], params["tvec"]  # (V, 3)

    R = so3.exp(rvecs)  # (V, 3, 3)
    cam_pts = (
        jnp.einsum("vij,nj->vni", R, obj_pts, precision=jax.lax.Precision.HIGHEST)
        + tvecs[:, None, :]
    )
    # Clamp the depth: an optimizer iterate that momentarily pushes a
    # board point to z <= 0 must produce a large finite residual, not a
    # NaN that permanently poisons every parameter (close boards, z well
    # under one board diagonal, hit this; far boards never do).
    z = jnp.maximum(cam_pts[..., 2], 1e-2)
    x = cam_pts[..., 0] / z
    y = cam_pts[..., 1] / z
    if model == CameraModel.FISHEYE:
        # Double-where: a board point exactly on the optical axis (r = 0,
        # e.g. a corner-origin board facing the camera) must not leak NaN
        # through sqrt'(0)/x/0 into the AUTODIFF gradients — jnp.where
        # alone evaluates both branches' cotangents.
        r2 = x * x + y * y
        on_axis = r2 < 1e-18
        r = jnp.sqrt(jnp.where(on_axis, 1.0, r2))
        theta = jnp.arctan(r)
        t2 = theta * theta
        theta_d = theta * (
            1.0 + t2 * (dist[0] + t2 * (dist[1] + t2 * (dist[2] + t2 * dist[3])))
        )
        s = jnp.where(on_axis, 1.0, theta_d / r)
        x, y = x * s, y * s
    else:
        # The reference's standard (non-fisheye) model fits Brown radial
        # distortion k1..k3 (camera_calibration.cpp:587-589 with
        # AssumeZeroTangentialDistortion, the in_VID5.xml default);
        # dist[:3] holds (k1, k2, k3), dist[3] stays unused/fixed.
        r2 = x * x + y * y
        radial = 1.0 + r2 * (dist[0] + r2 * (dist[1] + r2 * dist[2]))
        x, y = x * radial, y * radial
    u = fx * x + cx
    v = fy * y + cy
    return jnp.stack([u, v], axis=-1)  # (V, N, 2)


def calibrate(
    object_points: np.ndarray,  # (N, 3)
    image_points: np.ndarray,  # (V, N, 2)
    image_size: Tuple[int, int],
    model: CameraModel = CameraModel.FISHEYE,
    steps: int = 4000,
    fix_aspect_ratio: Optional[float] = None,
    fix_principal_point: bool = False,
    fix_k: Sequence[bool] = (False, False, False, False),
    full_output: bool = False,
):
    """Fit intrinsics + per-view poses; returns (camera, rms_error_px),
    plus the per-view extrinsics (V, 6) [rvec | tvec] when
    ``full_output`` (the reference's saveCameraParams writes them,
    ``camera_calibration.cpp:640-668``).

    The ``fix_*`` knobs mirror the reference's calibration flags
    (``camera_calibration.cpp:130-147``): CALIB_FIX_ASPECT_RATIO pins
    fx = ratio * fy, CALIB_FIX_PRINCIPAL_POINT pins (cx, cy) at the image
    center, and CALIB_FIX_K1..K4 pin individual distortion coefficients at
    zero. Fixing is exact (masked out of both optimizers), not penalized.
    """
    v = image_points.shape[0]
    w, h = image_size
    obj = jnp.asarray(object_points, jnp.float32)
    img = jnp.asarray(image_points, jnp.float32)

    # Initialization: principal point at center, focal from a 90-degree
    # dfov guess, boards roughly 1 board-diagonal in front of the camera.
    diag = float(np.linalg.norm(object_points.max(0) - object_points.min(0)))
    fx0 = fy0 = 0.8 * w
    rvec0 = np.zeros((v, 3), np.float32)
    tvec0 = np.tile(np.asarray([0.0, 0.0, max(diag, 1.0)], np.float32),
                    (v, 1))
    if model == CameraModel.RECTILINEAR:
        # The pinhole model's X/z ray geometry is unbounded, and gradient
        # descent from a generic guess reliably diverges (the fisheye
        # theta parameterization is bounded and does not need this).
        # Seed focal + per-view poses the way calibrateCameraRO does:
        # planar-homography intrinsics, then PnP per view.
        try:
            import cv2

            objs = [object_points.astype(np.float32)] * v
            imgs = [image_points[i].astype(np.float32).reshape(-1, 1, 2)
                    for i in range(v)]
            K0 = cv2.initCameraMatrix2D(objs, imgs, (w, h))
            fx0, fy0 = float(K0[0, 0]), float(K0[1, 1])
            for i in range(v):
                ok, rv, tv = cv2.solvePnP(
                    objs[i], imgs[i], K0, None,
                    flags=cv2.SOLVEPNP_ITERATIVE)
                if ok:
                    rvec0[i] = rv.ravel()
                    tvec0[i] = tv.ravel()
        except Exception:
            pass  # fall back to the generic init
    params = {
        "fx": jnp.asarray(fx0, jnp.float32),
        "fy": jnp.asarray(fy0, jnp.float32),
        "cx": jnp.asarray((w - 1) / 2.0, jnp.float32),
        "cy": jnp.asarray((h - 1) / 2.0, jnp.float32),
        "dist": jnp.zeros(4, jnp.float32),
        "rvec": jnp.asarray(rvec0, jnp.float32),
        "tvec": jnp.asarray(tvec0, jnp.float32),
    }

    # 0/1 mask with the params' structure: fixed entries never move (the
    # LM refiner zeroes the matching Jacobian columns with the same mask).
    mask = {
        "fx": jnp.asarray(0.0 if fix_aspect_ratio is not None else 1.0),
        "fy": jnp.asarray(1.0),
        "cx": jnp.asarray(0.0 if fix_principal_point else 1.0),
        "cy": jnp.asarray(0.0 if fix_principal_point else 1.0),
        "dist": jnp.asarray(
            [0.0 if f else 1.0 for f in fix_k], jnp.float32
        ),
        "rvec": jnp.ones((v, 3), jnp.float32),
        "tvec": jnp.ones((v, 3), jnp.float32),
    }
    ar = None if fix_aspect_ratio is None else float(fix_aspect_ratio)

    def loss(p):
        pred = _project(p, obj, model, aspect_ratio=ar)
        return jnp.mean(jnp.sum((pred - img) ** 2, axis=-1))

    import optax

    # Two-stage schedule: poses+focal first converge fast, distortion after.
    opt = optax.adam(learning_rate=optax.exponential_decay(0.05, 1000, 0.5))
    state = opt.init(params)

    import functools as _ft

    @_ft.partial(jax.jit, static_argnames=("freeze_dist",))
    def step(p, s, freeze_dist):
        g = jax.grad(loss)(p)
        updates, s = opt.update(g, s)
        # Scale pixel-unit params up (adam is scale-free, but keep cx/cy and
        # focals moving at pixel scale).
        for k in ("fx", "fy", "cx", "cy"):
            updates[k] = updates[k] * 100.0
        updates = jax.tree_util.tree_map(lambda u, m: u * m, updates, mask)
        if freeze_dist:
            updates = dict(updates, dist=updates["dist"] * 0.0)
        p = optax.apply_updates(p, updates)
        return p, s

    # Staged: distortion frozen while poses/focal find the basin — a free
    # distortion polynomial in r^2 (rectilinear: r^6 terms on rays past
    # r = 1) otherwise feeds back on wrong poses and diverges; the
    # reference's calibrateCameraRO does the same implicitly via its
    # intrinsic guess.
    for i in range(steps):
        params, state = step(params, state, freeze_dist=i < steps // 2)

    params = _lm_refine(params, obj, img, model, mask=mask, aspect_ratio=ar)
    rms = float(jnp.sqrt(loss(params)))
    fx = params["fx"] if ar is None else ar * params["fy"]
    cam = Camera.make(
        fx, params["fy"], params["cx"], params["cy"], w, h, model,
        dist=params["dist"],
    )
    if full_output:
        extr = np.concatenate(
            [np.asarray(params["rvec"]), np.asarray(params["tvec"])], axis=1
        ).astype(np.float64)
        return cam, rms, extr
    return cam, rms


def _lm_refine(params, obj, img, model: CameraModel, iters: int = 40,
               mask=None, aspect_ratio=None):
    """Levenberg-Marquardt polish of the adam solution.

    Adam finds the basin but crawls on calibration's ill-conditioned
    focal/distortion/depth trade-off (hundreds of px RMS per 1000 steps
    near the optimum); LM on the same jax-differentiated residuals
    converges it to the noise floor in a few dozen normal-equation
    solves (the problem is tiny: ~8 + 6V parameters).
    """
    from jax.flatten_util import ravel_pytree

    p0, unravel = ravel_pytree(params)
    flat_mask = (
        np.asarray(ravel_pytree(mask)[0], np.float64)
        if mask is not None else np.ones(p0.shape[0])
    )

    def resid(p):
        return (
            _project(unravel(p), obj, model, aspect_ratio=aspect_ratio) - img
        ).ravel()

    res_j = jax.jit(resid)
    jac_j = jax.jit(jax.jacfwd(resid))

    p = np.asarray(p0, np.float64)
    r = np.asarray(res_j(jnp.asarray(p, jnp.float32)), np.float64)
    cost = float(r @ r)
    lam = 1e-3
    for _ in range(iters):
        J = np.asarray(jac_j(jnp.asarray(p, jnp.float32)), np.float64)
        J *= flat_mask  # fixed params: zero column -> zero gradient/step
        jtj = J.T @ J
        g = J.T @ r
        scale = np.diag(np.maximum(np.diag(jtj), 1e-8))
        improved = False
        for _ in range(8):
            try:
                delta = np.linalg.solve(jtj + lam * scale, -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            p_new = p + delta
            r_new = np.asarray(
                res_j(jnp.asarray(p_new, jnp.float32)), np.float64
            )
            c_new = float(r_new @ r_new)
            if c_new < cost:
                p, r, cost = p_new, r_new, c_new
                lam = max(lam * 0.3, 1e-10)
                improved = True
                break
            lam *= 10.0
        if not improved:
            break
    return unravel(jnp.asarray(p, jnp.float32))


def board_object_points(cols: int, rows: int, square_size: float = 1.0,
                        pattern: PatternType = PatternType.CHESSBOARD):
    """(cols*rows, 3) board feature coordinates (z = 0).

    Chessboard/symmetric circles share the regular grid; the asymmetric
    circles grid staggers odd rows by one square
    (``camera_calibration.cpp:527-540`` ``calcBoardCornerPositions``).
    """
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    if pattern == PatternType.ASYMMETRIC_CIRCLES_GRID:
        xs = 2 * xs + ys % 2
    return np.stack(
        [xs.ravel(), ys.ravel(), np.zeros(cols * rows)], axis=1
    ).astype(np.float64) * float(square_size)


def detect_pattern(gray, pattern: Tuple[int, int],
                   pattern_type: PatternType = PatternType.CHESSBOARD):
    """Find one calibration target in a grayscale image.

    The reference's detection switch (``camera_calibration.cpp:354-368``):
    chessboard corners (adaptive threshold + normalize, subpixel-refined)
    or ``findCirclesGrid`` in symmetric/asymmetric mode. Returns (N, 2)
    float32 points or ``None``.
    """
    import cv2

    cols, rows = pattern
    if pattern_type == PatternType.CHESSBOARD:
        flags = cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE
        found, pts = cv2.findChessboardCorners(gray, (cols, rows), flags)
        if not found:
            return None
        crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 0.01)
        pts = cv2.cornerSubPix(gray, pts, (11, 11), (-1, -1), crit)
    else:
        flags = (
            cv2.CALIB_CB_ASYMMETRIC_GRID
            if pattern_type == PatternType.ASYMMETRIC_CIRCLES_GRID
            else cv2.CALIB_CB_SYMMETRIC_GRID
        )
        found, pts = cv2.findCirclesGrid(gray, (cols, rows), flags=flags)
        if not found:
            return None
    return pts.reshape(-1, 2).astype(np.float32)


# Live-capture safety bound: ~5 minutes at 30 fps (the reference's
# interactive loop has no bound; a headless CLI needs one).
_LIVE_CAPTURE_MAX_FRAMES = 9000


def _iter_gray_frames(source: str):
    """Yield grayscale frames + (w, h) from a video or an image-list file.

    Mirrors the reference's input switch (``camera_calibration.cpp:96-121``):
    a ``.xml``/``.yaml``/``.yml`` path is a FileStorage string list of image
    files (``readStringList``, ``:246-262``); a numeric string opens that
    live capture device (``cv2.VideoCapture(int)``, the reference's
    ``cameraID`` branch at ``:108-113``), raising a clean error when no
    such device exists (headless boxes); anything else decodes as video
    through this framework's readers (luma plane only — detection is
    grayscale).
    """
    import cv2

    if source.split(".")[-1].lower() in ("xml", "yaml", "yml"):
        fs = cv2.FileStorage(source, cv2.FILE_STORAGE_READ)
        try:
            node = fs.getNode("images")
            if node.empty():
                node = fs.root().at(0) if fs.root().size() else node
            files = [node.at(i).string() for i in range(node.size())]
        finally:
            fs.release()
        base = os.path.dirname(os.path.abspath(source))
        for f in files:
            path = f if os.path.isabs(f) else os.path.join(base, f)
            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise FileNotFoundError(f"image list entry not readable: {f}")
            yield img, (img.shape[1], img.shape[0]), None
        return
    if source.isdigit():
        # Live-camera capture, exactly the reference's numeric-ID input
        # switch (camera_calibration.cpp:96-121). The view-sampling
        # cadence upstream (interval_s) plays the role of the
        # reference's inter-capture delay (:340-352).
        cap = cv2.VideoCapture(int(source))
        if not cap.isOpened():
            cap.release()
            raise ValueError(
                f"live-camera calibration input: no capture device "
                f"/dev/video{source} is present/openable on this host; "
                "record a clip (or an image-list .xml) instead"
            )
        try:
            fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
            # Bounded, unlike the reference's interactive loop: a
            # headless CLI must not spin forever when no board ever
            # appears. ~5 minutes of capture at 30 fps.
            for _ in range(_LIVE_CAPTURE_MAX_FRAMES):
                ok, frame = cap.read()
                if not ok:
                    return
                gray = (frame if frame.ndim == 2
                        else cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
                yield gray, (gray.shape[1], gray.shape[0]), (
                    float(fps) if fps > 0 else None)
        finally:
            cap.release()
        # Exhausting the bounded capture ends the input; without this
        # return the numeric ID would fall through to the file reader.
        return

    from video_annotator_tpu.io.video import open_reader

    reader = open_reader(source)
    meta = reader.meta
    try:
        for y, _, _ in iter(reader):
            yield y, (meta.width, meta.height), float(meta.fps)
    finally:
        reader.close()


def detect_board_views(
    source: str,
    pattern: Tuple[int, int] = (9, 6),
    square_size: float = 1.0,
    max_views: int = 25,
    interval_s: float = 0.25,
    pattern_type: PatternType = PatternType.CHESSBOARD,
    flip_vertical: bool = False,
):
    """Detect calibration-target views across a video's frames.

    The reference tool's capture loop (``camera_calibration.cpp:340-390``):
    optional flip around the horizontal axis, pattern detection per
    ``pattern_type``, subpixel refinement for chessboards, sampling views at
    least ``interval_s`` apart until ``max_views`` are collected.

    Returns ``(object_points (N, 3), image_points (V, N, 2), (w, h))``.
    """
    import cv2

    cols, rows = pattern
    views = []
    size = None
    stride = None
    for i, (gray, wh, fps) in enumerate(_iter_gray_frames(source)):
        size = wh
        if stride is None:
            # Image lists (fps None) examine every entry; video samples
            # views at least interval_s apart.
            stride = (1 if fps is None
                      else max(1, int(round(interval_s * fps))))
        if i % stride:
            continue
        if flip_vertical:
            gray = cv2.flip(gray, 0)
        pts = detect_pattern(gray, (cols, rows), pattern_type)
        if pts is None:
            continue
        views.append(pts)
        if len(views) >= max_views:
            break
    if len(views) < 3:
        raise ValueError(
            f"found a {cols}x{rows} {pattern_type.value} in only "
            f"{len(views)} frames of {source}; calibration needs at least "
            f"3 views"
        )
    obj = board_object_points(cols, rows, square_size, pattern_type)
    return obj, np.stack(views), size


@dataclasses.dataclass
class CalibrationSettings:
    """The reference calibrator's settings file, field for field
    (``Settings::read/write``, ``camera_calibration.cpp:25-75``; example
    ``in_VID5.xml``). Read/write via cv2.FileStorage so the reference's own
    XML settings files load unchanged (YAML works too, by extension).

    GUI-only fields (``Show_UndistortedImage``, ``Input_Delay`` for live
    cameras) are parsed and preserved but inert in this headless build.
    """

    board_width: int = 9
    board_height: int = 6
    square_size: float = 1.0
    pattern: PatternType = PatternType.CHESSBOARD
    input: str = ""
    flip_vertical: bool = False
    delay_ms: int = 100
    nr_frames: int = 25
    fix_aspect_ratio: float = 0.0  # 0 = free; >0 pins fx/fy to this ratio
    zero_tangent_dist: bool = True  # inert: the fisheye model has none
    fix_principal_point: bool = False
    output_file: str = "out_camera_data.xml"
    write_points: bool = False
    write_extrinsics: bool = False
    write_grid: bool = False
    show_undistorted: bool = False
    use_fisheye: bool = True
    fix_k: Tuple[bool, bool, bool, bool, bool] = (
        False, False, False, False, False)

    @staticmethod
    def read(path: str) -> "CalibrationSettings":
        import cv2

        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        if not fs.isOpened():
            raise FileNotFoundError(f"cannot open settings file {path}")
        try:
            node = fs.getNode("Settings")
            if node.empty():
                node = fs.root()

            def _i(name, default):
                n = node.getNode(name)
                return default if n.empty() else int(n.real())

            def _f(name, default):
                n = node.getNode(name)
                return default if n.empty() else float(n.real())

            def _s(name, default):
                n = node.getNode(name)
                # The reference's files quote strings inside the element
                # ("CHESSBOARD"); FileStorage keeps the quotes — strip.
                return default if n.empty() else n.string().strip('"')

            pat = _s("Calibrate_Pattern", "CHESSBOARD").upper()
            try:
                pattern = PatternType(pat)
            except ValueError:
                raise ValueError(
                    f"Camera calibration mode does not exist: {pat}")
            return CalibrationSettings(
                board_width=_i("BoardSize_Width", 9),
                board_height=_i("BoardSize_Height", 6),
                square_size=_f("Square_Size", 1.0),
                pattern=pattern,
                input=_s("Input", ""),
                flip_vertical=bool(_i("Input_FlipAroundHorizontalAxis", 0)),
                delay_ms=_i("Input_Delay", 100),
                nr_frames=_i("Calibrate_NrOfFrameToUse", 25),
                fix_aspect_ratio=_f("Calibrate_FixAspectRatio", 0.0),
                zero_tangent_dist=bool(
                    _i("Calibrate_AssumeZeroTangentialDistortion", 1)),
                fix_principal_point=bool(
                    _i("Calibrate_FixPrincipalPointAtTheCenter", 0)),
                output_file=_s("Write_outputFileName", "out_camera_data.xml"),
                write_points=bool(_i("Write_DetectedFeaturePoints", 0)),
                write_extrinsics=bool(_i("Write_extrinsicParameters", 0)),
                write_grid=bool(_i("Write_gridPoints", 0)),
                show_undistorted=bool(_i("Show_UndistortedImage", 0)),
                use_fisheye=bool(_i("Calibrate_UseFisheyeModel", 1)),
                fix_k=tuple(
                    bool(_i(f"Fix_K{i}", 0)) for i in range(1, 6)),
            )
        finally:
            fs.release()

    def write(self, path: str) -> None:
        import cv2

        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        try:
            fs.startWriteStruct("Settings", cv2.FileNode_MAP)
            fs.write("BoardSize_Width", self.board_width)
            fs.write("BoardSize_Height", self.board_height)
            fs.write("Square_Size", self.square_size)
            fs.write("Calibrate_Pattern", self.pattern.value)
            fs.write("Calibrate_NrOfFrameToUse", self.nr_frames)
            fs.write("Calibrate_FixAspectRatio", self.fix_aspect_ratio)
            fs.write("Calibrate_AssumeZeroTangentialDistortion",
                     int(self.zero_tangent_dist))
            fs.write("Calibrate_FixPrincipalPointAtTheCenter",
                     int(self.fix_principal_point))
            fs.write("Write_DetectedFeaturePoints", int(self.write_points))
            fs.write("Write_extrinsicParameters", int(self.write_extrinsics))
            fs.write("Write_gridPoints", int(self.write_grid))
            fs.write("Write_outputFileName", self.output_file)
            fs.write("Show_UndistortedImage", int(self.show_undistorted))
            fs.write("Calibrate_UseFisheyeModel", int(self.use_fisheye))
            fs.write("Input_FlipAroundHorizontalAxis",
                     int(self.flip_vertical))
            fs.write("Input_Delay", self.delay_ms)
            fs.write("Input", self.input)
            for i, fk in enumerate(self.fix_k, start=1):
                fs.write(f"Fix_K{i}", int(fk))
            fs.endWriteStruct()
        finally:
            fs.release()


def write_camera_params(path: str, cam: Camera, rms: float,
                        settings: Optional[CalibrationSettings] = None,
                        image_points: Optional[np.ndarray] = None,
                        object_points: Optional[np.ndarray] = None,
                        n_views: int = 0,
                        extrinsics: Optional[np.ndarray] = None) -> None:
    """Persist calibration results as FileStorage XML/YAML.

    Field names follow the reference's ``saveCameraParams``
    (``camera_calibration.cpp:613-700``): camera_matrix,
    distortion_coefficients, image/board geometry, the RMS, and (per the
    Write_* settings flags) the detected points and refined grid.
    """
    import cv2

    k = np.array(
        [[float(cam.fx), 0.0, float(cam.cx)],
         [0.0, float(cam.fy), float(cam.cy)],
         [0.0, 0.0, 1.0]], np.float64)
    d = np.asarray(cam.dist, np.float64).ravel()
    if cam.model == CameraModel.RECTILINEAR:
        # Internally the rectilinear fit stores (k1, k2, k3, unused); the
        # OpenCV plumb-bob convention for a non-fisheye vector is
        # (k1, k2, p1, p2, k3), so remap before writing or any downstream
        # cv2.undistort would read the fitted k3 as tangential p1.
        dist = np.asarray([d[0], d[1], 0.0, 0.0, d[2]],
                          np.float64).reshape(-1, 1)
    else:
        dist = d[:4].reshape(-1, 1)  # fisheye: (k1..k4) theta-polynomial
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    try:
        fs.write("calibration_time", "")
        if n_views:
            fs.write("nr_of_frames", int(n_views))
        fs.write("image_width", int(cam.width))
        fs.write("image_height", int(cam.height))
        if settings is not None:
            fs.write("board_width", settings.board_width)
            fs.write("board_height", settings.board_height)
            fs.write("square_size", settings.square_size)
            if settings.fix_aspect_ratio > 0:
                fs.write("fix_aspect_ratio", settings.fix_aspect_ratio)
        fs.write("camera_matrix", k)
        fs.write("distortion_coefficients", dist)
        fs.write("avg_reprojection_error", float(rms))
        if settings is not None and settings.write_extrinsics \
                and extrinsics is not None:
            # (V, 6) rows of [rvec | tvec], the reference's
            # extrinsic_parameters layout (camera_calibration.cpp:640-668).
            fs.write("extrinsic_parameters",
                     np.asarray(extrinsics, np.float64))
        if settings is not None and settings.write_grid \
                and object_points is not None:
            # NOTE: this is the *unrefined* ideal board grid — this
            # implementation has no calibrateCameraRO object-point
            # refinement, so unlike the reference's newObjPoints the
            # grid written here equals the input pattern coordinates.
            fs.write("grid_points",
                     np.asarray(object_points, np.float64))
        if settings is not None and settings.write_points \
                and image_points is not None:
            # (V, N, 2) float32 -> a V x N CV_32FC2 Mat, the reference's
            # image_points layout (camera_calibration.cpp:670-685).
            fs.write("image_points",
                     np.ascontiguousarray(image_points, np.float32))
    finally:
        fs.release()


def run_from_settings(settings_path: str,
                      output: Optional[str] = None,
                      show_undistorted_dir: Optional[str] = None,
                      ) -> Tuple[Camera, float]:
    """The reference tool's whole workflow from one settings file: read
    settings, detect `nr_frames` pattern views in `Input`, calibrate with
    the configured model/flags, write the output FileStorage."""
    s = CalibrationSettings.read(settings_path)
    if not s.input:
        raise ValueError(f"settings file {settings_path} has no Input")
    src = s.input
    if not os.path.isabs(src) and not os.path.exists(src):
        rel = os.path.join(os.path.dirname(os.path.abspath(settings_path)),
                           src)
        if os.path.exists(rel):
            src = rel
    obj, img, (w, h) = detect_board_views(
        src, (s.board_width, s.board_height), s.square_size,
        max_views=s.nr_frames, pattern_type=s.pattern,
        flip_vertical=s.flip_vertical,
        # The reference spaces captured views by Input_Delay ms
        # (camera_calibration.cpp:384-386); same knob here for video.
        interval_s=max(s.delay_ms, 1) / 1000.0,
    )
    cam, rms, extr = calibrate(
        obj, img, (w, h),
        CameraModel.FISHEYE if s.use_fisheye else CameraModel.RECTILINEAR,
        # The reference *overwrites* its flag word for fisheye
        # (camera_calibration.cpp:138-146) — CALIB_FIX_ASPECT_RATIO only
        # applies to the non-fisheye model, so the stock in_VID5.xml
        # (FixAspectRatio=1, fisheye default) still fits fx/fy freely.
        fix_aspect_ratio=(s.fix_aspect_ratio
                          if s.fix_aspect_ratio > 0 and not s.use_fisheye
                          else None),
        fix_principal_point=s.fix_principal_point,
        fix_k=s.fix_k[:4],
        full_output=True,
    )
    out = output or s.output_file
    if not os.path.isabs(out):
        out = os.path.join(os.path.dirname(os.path.abspath(settings_path)),
                           out)
    write_camera_params(out, cam, rms, settings=s, image_points=img,
                        object_points=obj, n_views=img.shape[0],
                        extrinsics=extr)
    print(f"calibrated {img.shape[0]} views: rms {rms:.3f} px -> {out}")
    if show_undistorted_dir is None and s.show_undistorted:
        # Show_UndistortedImage=1 in the settings file: the reference
        # pops a window per view (camera_calibration.cpp:707-720); the
        # headless analogue dumps PNGs next to the output FileStorage.
        show_undistorted_dir = out + ".undistorted"
    if show_undistorted_dir:
        n = show_undistorted(cam, src, show_undistorted_dir,
                             flip_vertical=s.flip_vertical,
                             interval_s=max(s.delay_ms, 1) / 1000.0)
        print(f"wrote {n} undistorted view(s) to {show_undistorted_dir}")
    return cam, rms


def show_undistorted(cam: Camera, source: str, directory: str,
                     max_frames: int = 5, interval_s: float = 1.0,
                     flip_vertical: bool = False) -> int:
    """The reference calibrator's post-fit undistorted view
    (``Show_UndistortedImage``, ``camera_calibration.cpp:707-720``),
    headless-safe: sampled input frames are undistorted through the
    FITTED camera using this framework's own warp (identity rotation →
    pure undistortion, the same code path renders use) and written as
    PNGs; when a GUI actually works here they are also shown in a
    window. Returns the number of views written."""
    import cv2

    from video_annotator_tpu.ops import warp_image_xla

    os.makedirs(directory, exist_ok=True)
    # Output intrinsics DELIBERATELY diverge from the reference here.
    # Its fisheye path (camera_calibration.cpp:417-427) undistorts
    # through estimateNewCameraMatrixForUndistortRectify(balance=1) — a
    # Knew rescaled to preserve the full captured FOV. That Knew
    # unprojects through the fitted theta polynomial, and an
    # under-constrained fit (few views) extrapolates wildly outside the
    # board's field — the render pipeline's equivalent auto-fit was
    # measured to size a terapixel canvas from a 3-view fit. Re-using
    # the fitted K on the input-sized canvas is bounded for ANY fit;
    # the price is a tighter view than the reference's balance=1 output
    # (edges crop instead of shrink). See docs/MIGRATION.md.
    out_cam = Camera.make(cam.fx, cam.fy, cam.cx, cam.cy,
                          cam.width, cam.height, CameraModel.RECTILINEAR)
    identity = so3.from_euler(0.0, 0.0, 0.0)
    gui = False
    try:  # optional live window, same gate as render --display
        from video_annotator_tpu.pipeline.render import gui_available

        gui = gui_available()
    except Exception:
        pass
    n = 0
    stride = None
    for i, (gray, _wh, fps) in enumerate(_iter_gray_frames(source)):
        if stride is None:
            stride = (1 if fps is None
                      else max(1, int(round(interval_s * fps))))
        if i % stride:
            continue
        if flip_vertical:
            gray = cv2.flip(gray, 0)
        und = np.clip(np.asarray(
            warp_image_xla(jnp.asarray(gray, jnp.float32), out_cam, cam,
                           identity)), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(directory, f"undistorted_{n:03d}.png"), und)
        if gui:
            try:
                cv2.imshow("undistorted", und)
                if cv2.waitKey(500) & 0xFF == 27:
                    gui = False
                    cv2.destroyWindow("undistorted")
            except cv2.error:
                gui = False
        n += 1
        if n >= max_frames:
            break
    if gui:
        try:
            cv2.destroyWindow("undistorted")
        except cv2.error:
            pass
    return n


def calibrate_cli(points_path: str, model: str, size: str | None,
                  output: str | None, board: str = "9x6",
                  square_size: float = 1.0, max_views: int = 25,
                  interval_s: float = 0.25,
                  pattern: str = "chessboard",
                  settings: str | None = None,
                  flip_vertical: bool = False,
                  show_undistorted_dir: str | None = None):
    if settings:
        run_from_settings(settings, output,
                          show_undistorted_dir=show_undistorted_dir)
        return
    pat = {
        "chessboard": PatternType.CHESSBOARD,
        "circles": PatternType.CIRCLES_GRID,
        "acircles": PatternType.ASYMMETRIC_CIRCLES_GRID,
    }[pattern]
    if points_path.endswith(".npz"):
        data = np.load(points_path)
        obj = data["object_points"]
        img = data["image_points"]
        detected = None
    else:
        cols, rows = (int(x) for x in board.lower().split("x"))
        obj, img, detected = detect_board_views(
            points_path, (cols, rows), square_size,
            max_views=max_views, interval_s=interval_s,
            pattern_type=pat, flip_vertical=flip_vertical,
        )
        print(f"detected {img.shape[0]} board views in {points_path}")
        data = {}
    if obj.ndim == 3:
        # cv2-style per-view board lists (V, N, 3): all views observe the
        # same board, so one copy suffices.
        obj = obj[0]
    if size:
        w, h = (int(x) for x in size.lower().split("x"))
    elif detected is not None:
        w, h = detected
    elif "image_size" in data:
        w, h = (int(x) for x in data["image_size"])
    else:
        w = int(np.ceil(img[..., 0].max())) + 1
        h = int(np.ceil(img[..., 1].max())) + 1
    cam, rms = calibrate(
        obj, img, (w, h),
        CameraModel.FISHEYE if model == "fisheye" else CameraModel.RECTILINEAR,
    )
    if show_undistorted_dir:
        if detected is None:
            print("--show-undistorted needs footage input (a .npz has no "
                  "frames to undistort); skipped", file=sys.stderr)
        else:
            n_shown = show_undistorted(cam, points_path,
                                       show_undistorted_dir,
                                       flip_vertical=flip_vertical,
                                       interval_s=interval_s)
            print(f"wrote {n_shown} undistorted view(s) to "
                  f"{show_undistorted_dir}")
    result = {
        "model": cam.model.value,
        "fx": float(cam.fx), "fy": float(cam.fy),
        "cx": float(cam.cx), "cy": float(cam.cy),
        "dist": [float(d) for d in np.asarray(cam.dist)],
        "width": w, "height": h,
        "views": int(img.shape[0]),
        "rms_reprojection_error_px": rms,
    }
    text = json.dumps(result, indent=2)
    print(text)
    if output:
        if output.split(".")[-1].lower() in ("xml", "yml", "yaml"):
            # The reference tool's output format (saveCameraParams schema)
            # so downstream OpenCV tooling reads it directly.
            write_camera_params(output, cam, rms, image_points=img,
                                object_points=obj, n_views=int(img.shape[0]))
        else:
            with open(output, "w") as f:
                f.write(text + "\n")
