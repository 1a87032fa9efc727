"""Camera models (rectilinear pinhole + equidistant fisheye) as JAX pytrees.

Rebuilds the reference's camera layer:

- ``Camera {model, matrix, distortion_coefficients, size}``
  (``opencv/FrameSourceWarp.hpp:23-34``).
- GoPro presets — published FOV and measured intrinsics for the Hero 4 Black
  (``get_preset_camera``, ``opencv/FrameSourceWarp.cpp:27-86``).
- Output-camera auto-fit: undistort the 8 extreme points, bound, scale by the
  diagonal ratio, optional border-crop and zoom (``get_output_camera``,
  ``opencv/FrameSourceWarp.cpp:88-165``).
- dfov-based construction for the CLI's ``--input-dfov``/``--output-dfov``
  options (``src/cli.ts:104-116``).

Projection math matches ``cv2.fisheye`` (equidistant model with theta
polynomial distortion k1..k4) so the OpenCV implementation can be used as a
test oracle, and matches ``opencv/createMap.cl:37-39`` in the zero-distortion
case (``r' = atan(r)``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import jax
import jax.numpy as jnp


class CameraModel(enum.Enum):
    RECTILINEAR = "rectilinear"
    FISHEYE = "fisheye"
    # Panoramic output models. The reference's --projection option is
    # forwarded verbatim to the v360 filter ("See v360 filter docs for
    # options", src/cli.ts:117-121; `output: projection`,
    # src/render.ts:523), so every v360 output projection is a legal
    # value; these cover v360's closed-form single-image family
    # (e/equirect, sg, mercator, ball, hammer, sinusoidal, cylindrical).
    EQUIRECT = "equirect"
    STEREOGRAPHIC = "stereographic"  # v360 "sg": r = 2 tan(theta/2)
    MERCATOR = "mercator"  # Gudermannian vertical, angular horizontal
    BALL = "ball"  # v360 "ball" mirror-sphere: r = sin(theta/2)
    HAMMER = "hammer"  # Hammer-Aitoff equal-area ellipse
    SINUSOIDAL = "sinusoidal"  # equal-area pseudocylindrical
    CYLINDRICAL = "cylindrical"  # angular horizontal, tan vertical
    PANNINI = "pannini"  # cylindrical stereographic, d = 1 (v360 pannini)


# Panoramic models whose image plane is a (possibly warped) lon/lat chart.
_LONLAT_MODELS = frozenset(
    {
        CameraModel.EQUIRECT,
        CameraModel.MERCATOR,
        CameraModel.SINUSOIDAL,
        CameraModel.CYLINDRICAL,
        CameraModel.HAMMER,
        CameraModel.PANNINI,
    }
)

# Pannini distance parameter (projection center d behind the cylinder
# center, in cylinder radii). d=1 is the classic painterly Pannini and
# v360's default-ish setting; the chart is r = 2 tan(theta/2) on the
# equator (stereographic horizontally, straight verticals).
_PANNINI_D = 1.0


class CameraPreset(enum.Enum):
    """GoPro Hero 4 Black presets (``opencv/FrameSourceWarp.hpp:14-21``)."""

    GOPRO_H4B_WIDE43_PUBLISHED = "gopro_h4b_wide43_published"
    GOPRO_H4B_WIDE43_MEASURED = "gopro_h4b_wide43_measured"
    GOPRO_H4B_WIDE43_MEASURED_STABILISATION = "gopro_h4b_wide43_measured_stabilisation"
    GOPRO_H4B_WIDE169_PUBLISHED = "gopro_h4b_wide169_published"
    GOPRO_H4B_WIDE169_MEASURED = "gopro_h4b_wide169_measured"
    GOPRO_H4B_WIDE169_MEASURED_STABILISATION = "gopro_h4b_wide169_measured_stabilisation"


# Published GoPro FOV values, degrees
# (https://community.gopro.com/... via opencv/FrameSourceWarp.cpp:20-25).
# The reference truncates these to int (they are declared `const int`).
_GOPRO_FOV_H_43W = int(122.6)
_GOPRO_FOV_V_43W = int(94.4)
_GOPRO_FOV_H_169W = int(118.2)
_GOPRO_FOV_V_169W = int(69.5)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """A camera: intrinsics + lens model + sensor size.

    ``fx, fy, cx, cy`` are the entries of the reference's 3x3 camera matrix;
    ``dist`` holds the 4 fisheye distortion coefficients (k1..k4, theta
    polynomial, all zero for the presets — ``opencv/FrameSourceWarp.cpp:35``);
    ``width``/``height`` are static ints so they can participate in shapes.
    """

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    dist: jax.Array  # (4,)
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    model: CameraModel = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def make(
        fx, fy, cx, cy, width: int, height: int, model: CameraModel, dist=None
    ) -> "Camera":
        if dist is None:
            dist = jnp.zeros((4,), jnp.float32)
        return Camera(
            fx=jnp.asarray(fx, jnp.float32),
            fy=jnp.asarray(fy, jnp.float32),
            cx=jnp.asarray(cx, jnp.float32),
            cy=jnp.asarray(cy, jnp.float32),
            dist=jnp.asarray(dist, jnp.float32),
            width=int(width),
            height=int(height),
            model=model,
        )

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def matrix(self) -> jax.Array:
        """3x3 camera matrix (the reference's ``Camera::matrix``)."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx]),
                jnp.stack([z, self.fy, self.cy]),
                jnp.stack([z, z, o]),
            ]
        )

    # --- projection -------------------------------------------------------

    def project(self, rays: jax.Array) -> jax.Array:
        """Project (..., 3) camera-frame rays to (..., 2) pixel coordinates.

        Fisheye: equidistant model with theta-polynomial distortion, matching
        ``cv2.fisheye.projectPoints`` and (with zero coefficients) the map
        written by ``opencv/createMap.cl:37-48``:
        ``p = c + f * (atan(r)/r) * xy``.
        Rectilinear: standard pinhole ``p = c + f * xy / z``.
        """
        x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
        if self.model in _LONLAT_MODELS:
            # Panoramic family: work in (lon, lat) with lat positive
            # DOWNWARD (image y grows down), like the equirect model.
            lon = jnp.arctan2(x, z)
            lat = jnp.arctan2(y, jnp.sqrt(x * x + z * z))
            if self.model == CameraModel.EQUIRECT:
                mx, my = lon, lat
            elif self.model == CameraModel.MERCATOR:
                # Gudermannian: my = asinh(tan lat); poles go to +-inf,
                # clamp so projected points stay finite.
                t = jnp.tan(jnp.clip(lat, -1.55, 1.55))
                mx, my = lon, jnp.arcsinh(t)
            elif self.model == CameraModel.SINUSOIDAL:
                mx, my = lon * jnp.cos(lat), lat
            elif self.model == CameraModel.CYLINDRICAL:
                mx, my = lon, jnp.tan(jnp.clip(lat, -1.55, 1.55))
            elif self.model == CameraModel.PANNINI:
                d = _PANNINI_D
                S = (d + 1.0) / (d + jnp.maximum(jnp.cos(lon), -0.999))
                mx = S * jnp.sin(lon)
                my = S * jnp.tan(jnp.clip(lat, -1.55, 1.55))
            else:  # HAMMER
                d = jnp.sqrt(1.0 + jnp.cos(lat) * jnp.cos(lon / 2.0))
                mx = 2.0 * math.sqrt(2.0) * jnp.cos(lat) * jnp.sin(lon / 2.0) / d
                my = math.sqrt(2.0) * jnp.sin(lat) / d
            u = self.fx * mx + self.cx
            v = self.fy * my + self.cy
            return jnp.stack([u, v], axis=-1)
        if self.model in (CameraModel.STEREOGRAPHIC, CameraModel.BALL):
            # Radial full-sphere models: r is a function of the angle
            # theta from the forward axis (like fisheye's r = theta_d,
            # but covering the whole sphere).
            rho = jnp.sqrt(x * x + y * y)
            theta = jnp.arctan2(rho, z)
            if self.model == CameraModel.STEREOGRAPHIC:
                r = 2.0 * jnp.tan(jnp.minimum(theta, 3.1) / 2.0)
            else:  # BALL
                r = jnp.sin(theta / 2.0)
            scale = jnp.where(rho > 1e-8, r / jnp.maximum(rho, 1e-8), 0.0)
            u = self.fx * x * scale + self.cx
            v = self.fy * y * scale + self.cy
            return jnp.stack([u, v], axis=-1)
        inv_z = 1.0 / z
        a = x * inv_z
        b = y * inv_z
        if self.model == CameraModel.RECTILINEAR:
            u = self.fx * a + self.cx
            v = self.fy * b + self.cy
            return jnp.stack([u, v], axis=-1)
        r2 = a * a + b * b
        r = jnp.sqrt(r2)
        theta = jnp.arctan(r)
        theta_d = _distort_theta(theta, self.dist)
        scale = jnp.where(r > 1e-8, theta_d / jnp.maximum(r, 1e-8), 1.0)
        u = self.fx * a * scale + self.cx
        v = self.fy * b * scale + self.cy
        return jnp.stack([u, v], axis=-1)

    def unproject(self, pixels: jax.Array) -> jax.Array:
        """Unproject (..., 2) pixels to (..., 3) rays with z == 1.

        The fisheye inverse solves ``theta_d = theta * (1 + k1 th^2 + ...)``
        for theta by fixed-point iteration (10 steps, like
        ``cv2.fisheye.undistortPoints``), then applies ``r = tan(theta)``.
        Used by the output-camera auto-fit (``opencv/FrameSourceWarp.cpp:93``)
        and by rotation estimation (``opencv/FrameSourceWarp.cpp:322-338``).
        """
        xd = (pixels[..., 0] - self.cx) / self.fx
        yd = (pixels[..., 1] - self.cy) / self.fy
        if self.model in _LONLAT_MODELS:
            # Direction vectors (not z=1 rays): valid over the full
            # sphere. Pixels outside the model's valid region unproject
            # to the backward direction (0, 0, -1) so the warp's
            # behind-camera mask renders them as border.
            if self.model == CameraModel.EQUIRECT:
                lon, lat, bad = xd, yd, jnp.zeros_like(xd, bool)
            elif self.model == CameraModel.MERCATOR:
                lon = xd
                lat = jnp.arctan(jnp.sinh(yd))
                bad = jnp.zeros_like(xd, bool)
            elif self.model == CameraModel.SINUSOIDAL:
                lat = jnp.clip(yd, -math.pi / 2, math.pi / 2)
                cl = jnp.maximum(jnp.cos(lat), 1e-8)
                lon = xd / cl
                bad = (jnp.abs(yd) > math.pi / 2) | (jnp.abs(lon) > math.pi)
            elif self.model == CameraModel.CYLINDRICAL:
                lon = xd
                lat = jnp.arctan(yd)
                bad = jnp.zeros_like(xd, bool)
            elif self.model == CameraModel.PANNINI:
                # Invert x = (d+1) sin(lon) / (d + cos(lon)): quadratic
                # in cos(lon); for d = 1 the discriminant is exactly 1.
                d = _PANNINI_D
                k = xd * xd / ((d + 1.0) * (d + 1.0))
                disc = jnp.sqrt(
                    jnp.maximum(
                        k * k * d * d - (k + 1.0) * (k * d * d - 1.0), 0.0
                    )
                )
                cl_ = (-k * d + disc) / (k + 1.0)
                sl_ = xd * (d + cl_) / (d + 1.0)
                lon = jnp.arctan2(sl_, cl_)
                lat = jnp.arctan(yd * (d + cl_) / (d + 1.0))
                bad = jnp.zeros_like(xd, bool)
            else:  # HAMMER (inverse Hammer-Aitoff)
                z2 = 1.0 - 0.0625 * xd * xd - 0.25 * yd * yd
                bad = z2 < 0.5  # outside the full-sphere ellipse
                zz = jnp.sqrt(jnp.maximum(z2, 0.5))
                lon = 2.0 * jnp.arctan2(zz * xd / 2.0, 2.0 * z2 - 1.0)
                lat = jnp.arcsin(jnp.clip(zz * yd, -1.0, 1.0))
            cl = jnp.cos(lat)
            dirs = jnp.stack(
                [cl * jnp.sin(lon), jnp.sin(lat), cl * jnp.cos(lon)], axis=-1
            )
            backward = jnp.asarray([0.0, 0.0, -1.0], dirs.dtype)
            return jnp.where(bad[..., None], backward, dirs)
        if self.model in (CameraModel.STEREOGRAPHIC, CameraModel.BALL):
            rd = jnp.sqrt(xd * xd + yd * yd)
            if self.model == CameraModel.STEREOGRAPHIC:
                theta = 2.0 * jnp.arctan(rd / 2.0)
                bad = jnp.zeros_like(xd, bool)
            else:  # BALL: r = sin(theta/2) covers the sphere at r == 1
                theta = 2.0 * jnp.arcsin(jnp.minimum(rd, 1.0))
                bad = rd > 1.0
            st = jnp.sin(theta)
            scale = jnp.where(rd > 1e-8, st / jnp.maximum(rd, 1e-8), 0.0)
            dirs = jnp.stack(
                [xd * scale, yd * scale, jnp.cos(theta)], axis=-1
            )
            backward = jnp.asarray([0.0, 0.0, -1.0], dirs.dtype)
            return jnp.where(bad[..., None], backward, dirs)
        if self.model == CameraModel.RECTILINEAR:
            return jnp.stack([xd, yd, jnp.ones_like(xd)], axis=-1)
        theta_d = jnp.sqrt(xd * xd + yd * yd)
        theta = _undistort_theta(theta_d, self.dist)
        r = jnp.tan(theta)
        scale = jnp.where(theta_d > 1e-8, r / jnp.maximum(theta_d, 1e-8), 1.0)
        return jnp.stack([xd * scale, yd * scale, jnp.ones_like(xd)], axis=-1)

    def unproject_unit(self, pixels: jax.Array) -> jax.Array:
        """Unproject to unit-norm rays (for rotation estimation)."""
        rays = self.unproject(pixels)
        return rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)


def _distort_theta(theta: jax.Array, dist: jax.Array) -> jax.Array:
    t2 = theta * theta
    poly = 1.0 + t2 * (dist[0] + t2 * (dist[1] + t2 * (dist[2] + t2 * dist[3])))
    return theta * poly


def _undistort_theta(theta_d: jax.Array, dist: jax.Array) -> jax.Array:
    # Unrolled fixed-point iteration (10 steps, like cv2.fisheye): a Python
    # loop keeps this usable both under jit and eagerly (an eager
    # lax.fori_loop compiles on every call).
    theta = theta_d
    for _ in range(10):
        t2 = theta * theta
        poly = 1.0 + t2 * (dist[0] + t2 * (dist[1] + t2 * (dist[2] + t2 * dist[3])))
        theta = theta_d / poly
    return theta


def unproject_np(camera: "Camera", ys, xs):
    """NumPy (f64) twin of :meth:`Camera.unproject` over pixel grids.

    The host-side reference map (``ops/warp_ref.warp_map_np``: the
    prefilter level choice and the test and chip oracles) needs exact
    output-model unprojection without a device round trip. Must stay in
    lock-step with :meth:`Camera.unproject` for every model.
    """
    import numpy as np

    xd = (np.asarray(xs, np.float64) - float(camera.cx)) / float(camera.fx)
    yd = (np.asarray(ys, np.float64) - float(camera.cy)) / float(camera.fy)
    model = camera.model
    if model in _LONLAT_MODELS:
        if model == CameraModel.EQUIRECT:
            lon, lat, bad = xd, yd, np.zeros(xd.shape, bool)
        elif model == CameraModel.MERCATOR:
            lon = xd
            lat = np.arctan(np.sinh(yd))
            bad = np.zeros(xd.shape, bool)
        elif model == CameraModel.SINUSOIDAL:
            lat = np.clip(yd, -math.pi / 2, math.pi / 2)
            lon = xd / np.maximum(np.cos(lat), 1e-8)
            bad = (np.abs(yd) > math.pi / 2) | (np.abs(lon) > math.pi)
        elif model == CameraModel.CYLINDRICAL:
            lon = xd
            lat = np.arctan(yd)
            bad = np.zeros(xd.shape, bool)
        elif model == CameraModel.PANNINI:
            d = _PANNINI_D
            k = xd * xd / ((d + 1.0) * (d + 1.0))
            disc = np.sqrt(
                np.maximum(k * k * d * d - (k + 1.0) * (k * d * d - 1.0), 0.0)
            )
            cl_ = (-k * d + disc) / (k + 1.0)
            sl_ = xd * (d + cl_) / (d + 1.0)
            lon = np.arctan2(sl_, cl_)
            lat = np.arctan(yd * (d + cl_) / (d + 1.0))
            bad = np.zeros(xd.shape, bool)
        else:  # HAMMER
            z2 = 1.0 - 0.0625 * xd * xd - 0.25 * yd * yd
            bad = z2 < 0.5
            zz = np.sqrt(np.maximum(z2, 0.5))
            lon = 2.0 * np.arctan2(zz * xd / 2.0, 2.0 * z2 - 1.0)
            lat = np.arcsin(np.clip(zz * yd, -1.0, 1.0))
        cl = np.cos(lat)
        dirs = np.stack(
            [cl * np.sin(lon), np.sin(lat), cl * np.cos(lon)], axis=-1
        )
        dirs[bad] = (0.0, 0.0, -1.0)
        return dirs
    if model in (CameraModel.STEREOGRAPHIC, CameraModel.BALL):
        rd = np.sqrt(xd * xd + yd * yd)
        if model == CameraModel.STEREOGRAPHIC:
            theta = 2.0 * np.arctan(rd / 2.0)
            bad = np.zeros(xd.shape, bool)
        else:
            theta = 2.0 * np.arcsin(np.minimum(rd, 1.0))
            bad = rd > 1.0
        st = np.sin(theta)
        scale = np.where(rd > 1e-8, st / np.maximum(rd, 1e-8), 0.0)
        dirs = np.stack([xd * scale, yd * scale, np.cos(theta)], axis=-1)
        dirs[bad] = (0.0, 0.0, -1.0)
        return dirs
    if model == CameraModel.RECTILINEAR:
        return np.stack([xd, yd, np.ones_like(xd)], axis=-1)
    # Equidistant fisheye: solve theta_d = theta * (1 + k.theta^2...) by
    # fixed point (_undistort_theta), then r = tan(theta).
    theta_d = np.sqrt(xd * xd + yd * yd)
    k = np.asarray(camera.dist, np.float64)
    theta = theta_d.copy()
    if np.any(np.abs(k) > 0):
        for _ in range(10):
            t2 = theta * theta
            theta = theta_d / (
                1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))
            )
    r = np.tan(np.clip(theta, 0.0, math.pi / 2 - 1e-3))
    scale = np.where(theta_d > 1e-8, r / np.maximum(theta_d, 1e-8), 1.0)
    return np.stack([xd * scale, yd * scale, np.ones_like(xd)], axis=-1)


# --- presets ---------------------------------------------------------------


def get_preset_camera(preset: CameraPreset, size: Tuple[int, int]) -> Camera:
    """GoPro preset intrinsics, scaled to ``size = (width, height)``.

    Port of ``get_preset_camera`` (``opencv/FrameSourceWarp.cpp:27-86``): the
    principal point defaults to the image centre; measured presets override
    both focal lengths and the principal point, scaled from the calibration
    resolution (1920x1440 for 4:3, 2704x1520 for 16:9).
    """
    w, h = size
    cx = (w - 1.0) / 2.0
    cy = (h - 1.0) / 2.0

    if preset == CameraPreset.GOPRO_H4B_WIDE43_PUBLISHED:
        fx = w / math.radians(_GOPRO_FOV_H_43W)
        fy = h / math.radians(_GOPRO_FOV_V_43W)
    elif preset == CameraPreset.GOPRO_H4B_WIDE169_PUBLISHED:
        fx = w / math.radians(_GOPRO_FOV_H_169W)
        fy = h / math.radians(_GOPRO_FOV_V_169W)
    elif preset == CameraPreset.GOPRO_H4B_WIDE43_MEASURED:
        cx = 967.37 * w / 1920
        cy = 711.07 * h / 1440
        fx = 942.96 * h / 1440
        fy = 942.53 * h / 1440
    elif preset == CameraPreset.GOPRO_H4B_WIDE43_MEASURED_STABILISATION:
        cx = 965.90 * w / 1920
        cy = 712.94 * h / 1440
        fx = 1045.58 * h / 1440
        fy = 1045.64 * h / 1440
    elif preset == CameraPreset.GOPRO_H4B_WIDE169_MEASURED:
        cx = 1361.80 * w / 2704
        cy = 745.19 * h / 1520
        fx = 1392.49 * h / 1520
        fy = 1383.47 * h / 1520
    elif preset == CameraPreset.GOPRO_H4B_WIDE169_MEASURED_STABILISATION:
        cx = 1357.49 * w / 2704
        cy = 736.74 * h / 1520
        fx = 1626.67 * h / 1520
        fy = 1619.46 * h / 1520
    else:
        raise ValueError(f"unknown preset {preset}")

    return Camera.make(fx, fy, cx, cy, w, h, CameraModel.FISHEYE)


def camera_from_dfov(
    dfov_degrees: float, size: Tuple[int, int], model: CameraModel
) -> Camera:
    """Build a camera from a diagonal field of view.

    This is how the TS planner parameterizes cameras for the dewobble filter
    (``--input-dfov`` default 145.8, ``src/cli.ts:104-109``; focal derivation
    in ``getDewobbleProjectionPipeline``, ``src/render.ts:587-628``): for a
    fisheye (equidistant) lens ``f = (diag/2) / (dfov/2)``; for a rectilinear
    lens ``f = (diag/2) / tan(dfov/2)``.
    """
    w, h = size
    half_diag = math.hypot(w - 1.0, h - 1.0) / 2.0
    half_fov = math.radians(dfov_degrees) / 2.0
    if model == CameraModel.PANNINI:
        # On-equator radial r(theta) = 2 tan(theta/2) for d = 1 — same
        # as stereographic.
        hf = min(half_fov, math.radians(330.0) / 2.0)
        f = half_diag / (2.0 * math.tan(hf / 2.0))
    elif model == CameraModel.STEREOGRAPHIC:
        # r(theta) = 2 tan(theta/2); the chart is unbounded toward the
        # antipode, so clamp at a 330-degree diagonal — dfov >= 360
        # degrades gracefully instead of producing a ~0 or negative
        # focal length.
        hf = min(half_fov, math.radians(330.0) / 2.0)
        f = half_diag / (2.0 * math.tan(hf / 2.0))
    elif model == CameraModel.BALL:
        # r(theta) = sin(theta/2); dfov 360 fills the unit disk
        f = half_diag / math.sin(min(half_fov, math.pi) / 2.0)
    elif model == CameraModel.HAMMER:
        # exact on-equator radial distance of the Hammer chart at half_fov
        hf = min(half_fov, math.pi)
        r = (
            2.0
            * math.sqrt(2.0)
            * math.sin(hf / 2.0)
            / math.sqrt(1.0 + math.cos(hf / 2.0))
        )
        f = half_diag / r
    elif model == CameraModel.FISHEYE or model in _LONLAT_MODELS:
        # angular models: pixels per radian
        f = half_diag / half_fov
    else:
        f = half_diag / math.tan(half_fov)
    return Camera.make(f, f, (w - 1.0) / 2.0, (h - 1.0) / 2.0, w, h, model)


# --- output-camera auto-fit ------------------------------------------------


def get_output_camera(
    input_camera: Camera,
    scale: float = 1.0,
    crop_borders: bool = False,
    zoom: float = 1.0,
) -> Camera:
    """Fit a rectilinear output camera around the undistorted input frame.

    Port of ``get_output_camera`` (``opencv/FrameSourceWarp.cpp:88-165``):

    1. Unproject the 4 corners and 4 edge midpoints of the input frame into
       the identity camera (z == 1 plane).
    2. Bound them (corners excluded when ``crop_borders``).
    3. Scale so the output diagonal matches the input diagonal length (then
       multiply by ``scale``).
    4. Apply ``zoom`` to the output size and principal point.

    Runs in plain Python/NumPy at setup time (shapes must be static).
    """
    w, h = input_camera.width, input_camera.height
    cx = float(input_camera.cx)
    cy = float(input_camera.cy)
    points = jnp.array(
        [
            # corners (opencv/FrameSourceWarp.cpp:96-99)
            [0.0, 0.0],
            [0.0, h - 1.0],
            [w - 1.0, 0.0],
            [w - 1.0, h - 1.0],
            # midpoints of edges (opencv/FrameSourceWarp.cpp:102-105)
            [cx, 0.0],
            [w - 1.0, cy],
            [cx, h - 1.0],
            [0.0, cy],
        ],
        jnp.float32,
    )
    extreme = jax.device_get(input_camera.unproject(points))[:, :2]

    start = 4 if crop_borders else 0
    max_x = float(extreme[start:, 0].max())
    min_x = float(extreme[start:, 0].min())
    max_y = float(extreme[start:, 1].max())
    min_y = float(extreme[start:, 1].min())

    # Average scale on the diagonal (opencv/FrameSourceWarp.cpp:141-150).
    input_diag = math.hypot(w - 1.0, h - 1.0)
    output_diag = math.hypot(
        float(extreme[3, 0] - extreme[0, 0]), float(extreme[3, 1] - extreme[0, 1])
    )
    scale = scale * input_diag / output_diag

    out_w = int(scale * (max_x - min_x) / zoom)
    out_h = int(scale * (max_y - min_y) / zoom)
    return Camera.make(
        fx=scale,
        fy=scale,
        cx=scale * -min_x / zoom,
        cy=scale * -min_y / zoom,
        width=out_w,
        height=out_h,
        model=CameraModel.RECTILINEAR,
    )
