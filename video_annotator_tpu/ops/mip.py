"""Box-filter mip levels: the analysis pyramid and the warp prefilter.

``box_downsample`` makes the tracking resolution of every stabilizer
family (``--analysis-scale``) and the minification prefilter of the warp
(``--prefilter auto``); ``mip_camera`` is the camera of such a level and
``mip_prefilter_level`` picks the prefilter level from the warp map.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu.camera import Camera


def box_downsample(frame: jax.Array, level: int) -> jax.Array:
    """``level`` rounds of 2x2 box averaging (the mip prefilter).

    Odd trailing rows/columns are edge-replicated so averages never pull
    toward a pad constant. Returns float32 for ``level > 0``; passes the
    input through untouched for level 0.
    """
    if level <= 0:
        return frame
    f = frame.astype(jnp.float32)
    for _ in range(level):
        h, w = f.shape
        if h % 2 or w % 2:
            f = jnp.pad(f, ((0, h % 2), (0, w % 2)), mode="edge")
        f = jax.lax.reduce_window(
            f, 0.0, jax.lax.add, (2, 2), (2, 2), "VALID"
        ) * 0.25
    return f


def mip_camera(cam: Camera, level: int) -> Camera:
    """Camera of ``cam``'s plane after ``level`` rounds of 2x2 box
    downsampling (dims follow :func:`box_downsample`'s edge-padded ceil)."""
    if level <= 0:
        return cam
    w, h = cam.width, cam.height
    for _ in range(level):
        w = (w + 1) // 2
        h = (h + 1) // 2
    s = 0.5 ** level
    return Camera.make(
        float(cam.fx) * s,
        float(cam.fy) * s,
        (float(cam.cx) + 0.5) * s - 0.5,
        (float(cam.cy) + 0.5) * s - 0.5,
        w,
        h,
        cam.model,
        dist=cam.dist,
    )


def mip_prefilter_level(
    out_camera: Camera,
    in_camera: Camera,
    out_size: Tuple[int, int],
    max_levels: int = 2,
) -> int:
    """Highest mip level that cannot blur ANY output pixel.

    The warp map's Jacobian at each output pixel gives the local source
    stretch; sampling from mip level L is lossless wherever the smallest
    singular value stays >= 2^L (every output direction still spans at
    least one source pixel at that level). The level is chosen from the
    MINIMUM over in-image pixels, so mixed fields (fisheye centres that
    magnify while edges minify) never prefilter — only genuinely
    minifying configurations (e.g. 4K input rendered to 1080p) do, where
    plain bilinear aliases. The reference's ``cv::remap INTER_LINEAR``
    (and ffmpeg's scalers at default flags) alias in that regime; this
    is why the prefilter is opt-in (``--prefilter auto``) — the
    PSNR-vs-oracle gate compares against the aliasing reference.
    """
    from video_annotator_tpu.ops.warp_ref import warp_map_np

    cmap = warp_map_np(out_camera, in_camera, np.eye(3), out_size)
    sx, sy = cmap[..., 0], cmap[..., 1]
    valid = (
        (sx >= 0) & (sx < in_camera.width)
        & (sy >= 0) & (sy < in_camera.height)
    )
    if not valid.any():
        return 0
    a = np.gradient(sx, axis=1)
    b = np.gradient(sx, axis=0)
    c = np.gradient(sy, axis=1)
    d = np.gradient(sy, axis=0)
    e = a * a + b * b + c * c + d * d
    det = a * d - b * c
    disc = np.sqrt(np.maximum(e * e - 4.0 * det * det, 0.0))
    smin = np.sqrt(np.maximum((e - disc) * 0.5, 0.0))
    s = float(smin[valid].min())
    level = 0
    while level < max_levels and s >= 2.0:
        s /= 2.0
        level += 1
    return level
