"""Float64 NumPy reference of the warps: map, samplers, YUV 4:2:0 frame
for the rotation, similarity (vidstab) and deshake families.

A straightforward host implementation of what ``ops/warp_xla.py`` computes
on the device — the ``createMap`` map (``opencv/createMap.cl:15-49``) and
``cv::remap`` with a zero (BORDER_CONSTANT) border — written independently
of the device code: NumPy, float64, the tap weights spelled out from their
formulas. It is the oracle of the warp tests and of ``chip_smoke.py``, and
:func:`warp_map_np` also feeds the prefilter level choice
(``ops/mip.py``).
"""

from __future__ import annotations

import numpy as np

from video_annotator_tpu.camera import Camera, CameraModel, unproject_np

# Output rows per rolling-shutter band (``ops/warp_xla.RS_BAND_ROWS``).
BAND_ROWS = 8


def warp_map_np(out_camera: Camera, in_camera: Camera, rot, out_size):
    """(h, w, 2) float64 source coordinates (x, y) of every output pixel.

    ``rot`` is one (3, 3) rotation or a (n_bands, 3, 3) rolling-shutter
    stack (band ``r // 8`` for output row ``r``). Fisheye and pinhole
    input models; behind-camera rays map far outside the frame."""
    h, w = out_size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = unproject_np(out_camera, ys, xs)
    rot = np.asarray(rot, np.float64)
    if rot.ndim == 3:
        band = np.clip(np.arange(h) // BAND_ROWS, 0, rot.shape[0] - 1)
        v = np.einsum("hij,hwj->hwi", rot[band], rays)
    else:
        v = rays @ rot.T
    behind = v[..., 2] <= 1e-9
    vz = np.where(behind, 1.0, v[..., 2])
    a = np.where(behind, -1e6, v[..., 0] / vz)
    b = np.where(behind, -1e6, v[..., 1] / vz)
    if in_camera.model == CameraModel.FISHEYE:
        r = np.sqrt(a * a + b * b)
        theta = np.arctan(r)
        k = np.asarray(in_camera.dist, np.float64)
        t2 = theta * theta
        theta = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
        scale = np.where(r > 1e-8, theta / np.maximum(r, 1e-8), 1.0)
        a, b = a * scale, b * scale
    sx = float(in_camera.fx) * a + float(in_camera.cx)
    sy = float(in_camera.fy) * b + float(in_camera.cy)
    return np.stack([sx, sy], axis=-1)


def _weights(interp: str, f):
    """(tap offsets, per-offset weights) along one axis at fraction ``f``."""
    if interp == "bilinear":
        return (0, 1), [1.0 - f, f]
    offsets = (-1, 0, 1, 2)
    ts = [np.abs(f - k) for k in offsets]
    if interp == "bicubic":  # Keys, a = -0.75 (cv2 INTER_CUBIC)
        a = -0.75
        ws = [np.where(t <= 1.0, (a + 2) * t**3 - (a + 3) * t**2 + 1,
                       np.where(t < 2.0, a * (t**3 - 5 * t**2 + 8 * t - 4),
                                0.0)) for t in ts]
        return offsets, ws
    if interp == "lanczos":  # sinc(t) sinc(t/2), normalized to unit sum
        ws = [np.sinc(t) * np.sinc(t / 2.0) * (t < 2.0) for t in ts]
        total = sum(ws)
        return offsets, [w_ / total for w_ in ws]
    raise ValueError(f"unknown interp {interp!r}")


def sample_np(image, coords, interp: str = "bilinear"):
    """Sample ``image`` (H, W) at float ``coords`` (..., 2), zero border."""
    img = np.asarray(image, np.float64)
    h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = np.floor(x), np.floor(y)
    offs_x, wx = _weights(interp, x - x0)
    offs_y, wy = _weights(interp, y - y0)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    out = np.zeros(x.shape, np.float64)
    for j, wj in zip(offs_y, wy):
        yi = y0 + j
        yok = (yi >= 0) & (yi < h)
        yc = np.clip(yi, 0, h - 1)
        for k, wk in zip(offs_x, wx):
            xi = x0 + k
            ok = yok & (xi >= 0) & (xi < w)
            out += wj * wk * np.where(ok, img[yc, np.clip(xi, 0, w - 1)], 0.0)
    return out


def _half(camera: Camera) -> Camera:
    """Chroma-plane camera (4:2:0 siting: c' = (c + 0.5) / 2 - 0.5)."""
    return Camera(
        fx=float(camera.fx) * 0.5, fy=float(camera.fy) * 0.5,
        cx=(float(camera.cx) + 0.5) * 0.5 - 0.5,
        cy=(float(camera.cy) + 0.5) * 0.5 - 0.5,
        dist=np.asarray(camera.dist), width=round(camera.width * 0.5),
        height=round(camera.height * 0.5), model=camera.model,
    )


def warp_yuv420_np(y, u, v, out_camera: Camera, in_camera: Camera, rot,
                   out_size, interp: str = "bilinear"):
    """Reference YUV 4:2:0 warp to uint8 planes: luma at ``out_size``,
    chroma at half size sampled around 128 (neutral border). A luma
    rolling-shutter stack gives chroma band ``j`` the luma band ``2j``."""
    oh, ow = out_size
    rot = np.asarray(rot, np.float64)
    rot_c = rot
    if rot.ndim == 3:
        nyc = -(-(oh // 2) // BAND_ROWS)
        rot_c = rot[np.clip(2 * np.arange(nyc), 0, rot.shape[0] - 1)]
    wy = sample_np(y, warp_map_np(out_camera, in_camera, rot, out_size),
                   interp)
    cmap = warp_map_np(_half(out_camera), _half(in_camera), rot_c,
                       (oh // 2, ow // 2))
    wu, wv = (sample_np(np.asarray(p, np.float64) - 128.0, cmap, interp)
              + 128.0 for p in (u, v))
    return _to_u8(wy), _to_u8(wu), _to_u8(wv)


def _to_u8(p):
    return np.clip(np.round(p), 0, 255).astype(np.uint8)


def similarity_map_np(params, out_size):
    """(h, w, 2) float64 source coordinates of a similarity sampling
    transform ``params`` = (dx, dy, angle, log_scale):
    x_src = s (cos a x - sin a y) + dx, y_src = s (sin a x + cos a y) + dy."""
    dx, dy, ang, ls = (float(p) for p in params)
    s = np.exp(ls)
    ys, xs = np.mgrid[0:out_size[0], 0:out_size[1]].astype(np.float64)
    return np.stack([s * (np.cos(ang) * xs - np.sin(ang) * ys) + dx,
                     s * (np.sin(ang) * xs + np.cos(ang) * ys) + dy], -1)


def similarity_yuv420_np(y, u, v, params, out_size=None,
                         interp: str = "bilinear"):
    """Reference vidstab-family warp to uint8 planes: luma through
    ``params``, chroma through the same transform on the half-size grid
    ((dx/2, dy/2, angle, log_scale)) around 128."""
    oh, ow = np.shape(y) if out_size is None else out_size
    p = np.asarray(params, np.float64)
    wy = sample_np(y, similarity_map_np(p, (oh, ow)), interp)
    cmap = similarity_map_np(p * [0.5, 0.5, 1.0, 1.0], (oh // 2, ow // 2))
    wu, wv = (sample_np(np.asarray(c, np.float64) - 128.0, cmap, interp)
              + 128.0 for c in (u, v))
    return _to_u8(wy), _to_u8(wu), _to_u8(wv)


def gauss_blur_np(image, sigma: float):
    """Separable Gaussian blur, replicate edges, taps to 3 sigma."""
    img = np.asarray(image, np.float64)
    h, w = img.shape
    r = int(3 * sigma)
    d = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (d / sigma) ** 2)
    k /= k.sum()
    p = np.pad(img, r, mode="edge")
    cols = sum(k[i] * p[i:i + h] for i in range(2 * r + 1))
    return sum(k[i] * cols[:, i:i + w] for i in range(2 * r + 1))


def deshake_yuv420_np(y, u, v, offset, blur_sigma: float = 8.0):
    """Reference deshake warp to uint8 planes: every plane sampled
    bilinearly at (x + dx, y + dy) (half the offset for chroma, around
    128, zero border); luma pixels whose source falls outside the frame
    take the blurred frame (:func:`gauss_blur_np`) at the clamped source
    position instead (the blurred-edge fill; ``blur_sigma=None`` off)."""
    dx, dy = (float(o) for o in offset)

    def shifted(shape, ox, oy):
        ys, xs = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
        return np.stack([xs + ox, ys + oy], -1)

    h, w = np.shape(y)
    m = shifted((h, w), dx, dy)
    wy = sample_np(y, m)
    if blur_sigma:
        inside = ((m[..., 0] >= 0) & (m[..., 0] <= w - 1)
                  & (m[..., 1] >= 0) & (m[..., 1] <= h - 1))
        clamped = np.stack([np.clip(m[..., 0], 0, w - 1),
                            np.clip(m[..., 1], 0, h - 1)], -1)
        bg = sample_np(gauss_blur_np(y, blur_sigma), clamped)
        wy = np.where(inside, wy, bg)
    cm = shifted(np.shape(u), dx / 2, dy / 2)
    wu, wv = (sample_np(np.asarray(c, np.float64) - 128.0, cm) + 128.0
              for c in (u, v))
    return _to_u8(wy), _to_u8(wu), _to_u8(wv)
