"""Warp map generation + remap in plain XLA: the one device warp path.

This is the reference's per-frame hot path — the ``createMap`` OpenCL kernel
(``opencv/createMap.cl:1-51``) followed by ``cv::remap`` INTER_LINEAR
(``opencv/FrameSourceWarp.cpp:306-312``) — expressed as vectorized jnp ops
that XLA fuses into one map+gather+blend loop per plane. The float64
NumPy twin (``ops/warp_ref.py``) is the host-side reference.

Map semantics (``opencv/createMap.cl:15-49``): for every *output* pixel,
unproject through the rectilinear output camera, rotate the ray by the
(stabilization + attitude) rotation, perspective-divide, push through the
input camera's fisheye forward model, and emit the *source* pixel position.
The remap then gathers with bilinear interpolation, zero outside the frame
(cv::remap's default BORDER_CONSTANT).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu.camera import Camera, CameraModel

# Rolling-shutter granularity: a (n_bands, 3, 3) rotation stack applies
# one scanline pose per band of this many output rows.
RS_BAND_ROWS = 8


def compute_warp_map(
    out_camera: Camera,
    in_camera: Camera,
    rotation: jax.Array,
    out_size: Tuple[int, int] | None = None,
) -> jax.Array:
    """Compute the (H_out, W_out, 2) source-coordinate map (x, y order).

    ``rotation`` is the 3x3 matrix applied to output-camera rays, i.e. the
    18-scalar-arg rotation handed to the kernel at
    ``opencv/FrameSourceWarp.cpp:291-299`` (the inverse of the stabilization
    correction, ``opencv/FrameSourceWarp.cpp:475``). A (n_tile_rows, 3, 3)
    stack applies rotation ``r // 8`` to output row ``r`` — the
    rolling-shutter form (per-scanline camera pose, quantized to
    8-row bands, :data:`RS_BAND_ROWS`).
    """
    if out_size is None:
        out_size = (out_camera.height, out_camera.width)
    h, w = out_size
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    pixels = jnp.stack([xs, ys], axis=-1)
    rays = out_camera.unproject(pixels)  # (h, w, 3)
    rotation = jnp.asarray(rotation, jnp.float32)
    if rotation.ndim == 3:
        idx = jnp.clip(jnp.arange(h) // RS_BAND_ROWS, 0,
                       rotation.shape[0] - 1)
        rotated = jnp.einsum(
            "hij,hwj->hwi",
            rotation[idx],
            rays,
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        rotated = jnp.einsum(
            "ij,hwj->hwi",
            rotation,
            rays,
            precision=jax.lax.Precision.HIGHEST,
        )
    src = in_camera.project(rotated)  # (h, w, 2)
    if in_camera.model != CameraModel.EQUIRECT:
        # Behind-camera rays (possible when an equirect OUTPUT looks past
        # 90 deg) would mirror through the perspective divide into
        # in-frame coordinates; pin them far outside so the sampler
        # renders border.
        behind = (rotated[..., 2] <= 1e-6)[..., None]
        src = jnp.where(behind, -1e6, src)
    return src


def bilinear_sample(image: jax.Array, coords: jax.Array) -> jax.Array:
    """Bilinear-sample ``image`` (H, W) at ``coords`` (..., 2) in (x, y) order.

    Out-of-bounds reads contribute zero, matching ``cv::remap``'s default
    BORDER_CONSTANT border (``opencv/FrameSourceWarp.cpp:306-312``).
    """
    h, w = image.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    img = image.astype(jnp.float32)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        return jnp.where(valid, img[yc, xc], 0.0)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def keys_weight(t, a: float = -0.75):
    """Keys cubic kernel weight at offset ``t`` (cv2 INTER_CUBIC's kernel).

    |t| <= 1: (a+2)|t|^3 - (a+3)|t|^2 + 1;  1 < |t| < 2: a(|t|^3 - 5|t|^2
    + 8|t| - 4). The single source of truth for bicubic weights.
    """
    t = jnp.abs(t)
    near = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    far = a * (((t - 5.0) * t + 8.0) * t - 4.0)
    return jnp.where(t <= 1.0, near, jnp.where(t < 2.0, far, 0.0))


def lanczos_weight(t, a: float = 2.0):
    """Lanczos windowed-sinc weight ``sinc(t) * sinc(t/a)`` at offset ``t``.

    Single source of truth for lanczos weights, pre-normalization.
    """
    t = jnp.abs(t)
    pt = jnp.pi * jnp.maximum(t, 1e-6)
    win = jnp.sin(pt) * jnp.sin(pt / a) * (a / (pt * pt))
    return jnp.where(t < 1e-6, 1.0, jnp.where(t < a, win, 0.0))


def bicubic_sample(image: jax.Array, coords: jax.Array,
                   a: float = -0.75) -> jax.Array:
    """Bicubic-sample ``image`` (H, W) at ``coords`` (..., 2), (x, y) order.

    Keys cubic with ``a = -0.75`` — ``cv::remap INTER_CUBIC``'s kernel, the
    interpolation the reference's vidstab encode requests
    (``interpol: "bicubic"``, ``src/render.ts:571``; its v360 path asks for
    lanczos, ``:533`` — same intent: a higher-order resampler). 4x4 taps;
    out-of-bounds taps contribute zero (BORDER_CONSTANT), like
    :func:`bilinear_sample`.
    """
    h, w = image.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    img = image.astype(jnp.float32)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        return jnp.where(valid, img[yc, xc], 0.0)

    out = jnp.zeros(x.shape, jnp.float32)
    wxs = [keys_weight(fx - k, a) for k in (-1, 0, 1, 2)]
    for j in (-1, 0, 1, 2):
        wy = keys_weight(fy - j, a)
        row = jnp.zeros(x.shape, jnp.float32)
        for k, wx in zip((-1, 0, 1, 2), wxs):
            row = row + wx * tap(y0i + j, x0i + k)
        out = out + wy * row
    return out


def lanczos_sample(image: jax.Array, coords: jax.Array,
                   a: int = 2) -> jax.Array:
    """Lanczos-sample ``image`` (H, W) at ``coords`` (..., 2), (x, y) order.

    Windowed-sinc kernel ``sinc(t) * sinc(t/a)`` over ``2a x 2a`` taps with
    the tap weights normalized to unit sum (both ffmpeg's v360 and
    ``cv::remap`` normalize). ``a=2`` (4x4 taps) is ffmpeg v360's
    ``interp=lanczos`` — the resampler the reference's v360 reprojection
    stage requests (``src/render.ts:533``); ``a=4`` (8x8) is cv2's
    INTER_LANCZOS4, used by the test oracle. Out-of-bounds taps contribute
    zero (BORDER_CONSTANT), like :func:`bilinear_sample`.
    """
    h, w = image.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    img = image.astype(jnp.float32)

    def lanczos_w(t):
        return lanczos_weight(t, float(a))

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        return jnp.where(valid, img[yc, xc], 0.0)

    offsets = range(1 - a, a + 1)  # e.g. a=2 -> -1, 0, 1, 2
    wxs = [lanczos_w(fx - k) for k in offsets]
    wys = [lanczos_w(fy - j) for j in offsets]
    # Separable normalization == normalizing the full 2a x 2a stencil.
    sum_wx = functools.reduce(jnp.add, wxs)
    sum_wy = functools.reduce(jnp.add, wys)
    out = jnp.zeros(x.shape, jnp.float32)
    for j, wy in zip(offsets, wys):
        row = jnp.zeros(x.shape, jnp.float32)
        for k, wx in zip(offsets, wxs):
            row = row + wx * tap(y0i + j, x0i + k)
        out = out + wy * row
    return out / (sum_wx * sum_wy)


_SAMPLERS = {
    "bilinear": bilinear_sample,
    "bicubic": bicubic_sample,
    "lanczos": lanczos_sample,
}


@functools.partial(jax.jit, static_argnames=("out_size", "interp"))
def warp_image_xla(
    image: jax.Array,
    out_camera: Camera,
    in_camera: Camera,
    rotation: jax.Array,
    out_size: Tuple[int, int] | None = None,
    interp: str = "bilinear",
) -> jax.Array:
    """Warp a single-channel (H, W) or multi-channel (H, W, C) image.

    Fuses map computation and the gather; equivalent to running ``createMap``
    then ``cv::remap`` for one frame. ``interp`` picks the resampler:
    ``bilinear`` (the reference native engine's INTER_LINEAR), ``bicubic``
    (vidstab's ``interpol=bicubic``), or ``lanczos`` (v360's
    ``interp=lanczos``, 4x4).
    """
    sample = _SAMPLERS[interp]
    coords = compute_warp_map(out_camera, in_camera, rotation, out_size)
    if image.ndim == 2:
        return sample(image, coords)
    return jnp.stack(
        [sample(image[..., c], coords) for c in range(image.shape[-1])],
        axis=-1,
    )


def _scaled_camera(camera: Camera, factor: float) -> Camera:
    """Camera for a plane downscaled by ``factor`` (chroma planes = 0.5).

    Pixel centres: a chroma sample (i, j) sits at luma position
    (2i + 0.5, 2j + 0.5); mapping intrinsics as f' = f*s, c' = (c + 0.5)*s - 0.5
    keeps projections consistent under that siting.
    """
    return Camera(
        fx=camera.fx * factor,
        fy=camera.fy * factor,
        cx=(camera.cx + 0.5) * factor - 0.5,
        cy=(camera.cy + 0.5) * factor - 0.5,
        dist=camera.dist,
        width=int(round(camera.width * factor)),
        height=int(round(camera.height * factor)),
        model=camera.model,
    )


def chroma_row_rotations(rot_y: jax.Array, nyc: int) -> jax.Array:
    """Chroma band rotations from a luma rolling-shutter stack.

    Chroma band j (``RS_BAND_ROWS`` chroma rows) covers luma bands
    2j..2j+1; using band 2j quantizes the scanline pose by 16 luma rows
    (~0.5% of the readout window at 4K — invisible)."""
    nyy = rot_y.shape[-3]
    idx = jnp.clip(2 * jnp.arange(nyc), 0, nyy - 1)
    return rot_y[..., idx, :, :]


@functools.partial(jax.jit, static_argnames=("out_size", "interp"))
def warp_yuv420_xla(
    y: jax.Array,
    u: jax.Array,
    v: jax.Array,
    out_camera: Camera,
    in_camera: Camera,
    rotation: jax.Array,
    out_size: Tuple[int, int] | None = None,
    interp: str = "bilinear",
):
    """Warp a planar YUV 4:2:0 frame; chroma warped at half resolution.

    The reference converts NV12 to BGR before warping
    (``opencv/FrameSourceWarp.cpp:401``) and warps 3 full-res channels; we warp
    Y at full res and U/V at half res instead — 1.5 bytes/px of gather traffic
    instead of 3 — using half-scaled cameras for the chroma map. Chroma is
    sampled centred on 128, so out-of-image chroma comes out neutral (black
    video), not green. ``rotation`` is (3, 3) or a luma rolling-shutter
    stack (n_bands, 3, 3). Returns float32 planes.
    """
    if out_size is None:
        out_size = (out_camera.height, out_camera.width)
    oh, ow = out_size
    y_out = warp_image_xla(y, out_camera, in_camera, rotation, (oh, ow),
                           interp=interp)
    out_c = _scaled_camera(out_camera, 0.5)
    in_c = _scaled_camera(in_camera, 0.5)
    rot_c = rotation
    if jnp.ndim(rotation) == 3:
        rot_c = chroma_row_rotations(rotation,
                                     -(-(oh // 2) // RS_BAND_ROWS))
    u_out, v_out = (
        warp_image_xla(p.astype(jnp.float32) - 128.0, out_c, in_c, rot_c,
                       (oh // 2, ow // 2), interp=interp) + 128.0
        for p in (u, v)
    )
    return y_out, u_out, v_out


def to_uint8(plane: jax.Array) -> jax.Array:
    """Round and saturate a float plane to video bytes."""
    return jnp.clip(jnp.round(plane), 0, 255).astype(jnp.uint8)


def camera_key(cam: Camera) -> tuple:
    """Hashable value of a camera (a cache key for compiled warps)."""
    return (
        float(cam.fx),
        float(cam.fy),
        float(cam.cx),
        float(cam.cy),
        tuple(float(v) for v in np.asarray(cam.dist)),
        cam.width,
        cam.height,
        cam.model,
    )


def camera_from_key(key) -> Camera:
    """Camera with NumPy leaf fields rebuilt from :func:`camera_key`: its
    intrinsics stay trace-time constants when a jitted or ``shard_map``ped
    function closes over it."""
    fx, fy, cx, cy, dist, w, h, model = key
    return Camera(
        fx=np.float32(fx), fy=np.float32(fy),
        cx=np.float32(cx), cy=np.float32(cy),
        dist=np.asarray(dist, np.float32),
        width=w, height=h, model=model,
    )
