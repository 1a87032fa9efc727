"""The vidstab-family stabilizer: 2D similarity trajectory.

Equivalent of the reference's vidstab pipeline (two-pass: ``vidstabdetect``
writes motion data, ``vidstabtransform`` applies smoothed transforms with
``optzoom: 0``, ``zoom: -buffer``, ``interpol: bicubic``, ``smoothing:
radius`` — ``src/render.ts:546-585``). Analysis tracks corners with LK and
fits robust per-frame similarities; encoding smooths the accumulated
(dx, dy, angle, log_scale) trajectory with the same SG kernel the rotation
family uses, and warps with the inverse correction.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu.ops.affine import (
    compose_similarity,
    fit_similarity,
    invert_similarity,
    warp_similarity,
)
from video_annotator_tpu.ops.corners import detect_corners
from video_annotator_tpu.ops.lk import pyramidal_lk
from video_annotator_tpu.ops.mip import box_downsample
from video_annotator_tpu.pipeline.profiler import StageProfiler
from video_annotator_tpu.pipeline.trajectory import Trajectory
from video_annotator_tpu.smoothing.savgol import savgol_weights, sg_conv


def analyse_similarity(
    source: str,
    options,  # RenderOptions
    profiler: Optional[StageProfiler] = None,
) -> Trajectory:
    """Track the accumulated 2D similarity trajectory (vidstabdetect)."""
    from video_annotator_tpu.pipeline.render import (
        KEY_FRAME_MAX_AGE,
        MAX_CORNERS,
        open_trimmed,
        tracking_border,
        tracking_gates,
    )

    prof = profiler or StageProfiler()
    reader, meta, first, last = open_trimmed(source, options)
    # --analysis-scale: track on a box-downsampled level; similarities
    # conjugate through scaling (translation x 2^level, angle/log-scale
    # unchanged), applied once at collect time.
    from video_annotator_tpu.pipeline.render import analysis_level

    level = analysis_level(options, meta)
    track_w = meta.width >> level
    min_distance, min_inliers, min_refresh = tracking_gates(track_w)
    border = tracking_border(track_w, meta.height >> level)

    import functools as _ft

    def _track_res(gray):
        return box_downsample(gray, level) if level else gray

    @_ft.partial(jax.jit, static_argnames=("refresh_age",))
    def track_step(prev_gray, gray, pts, valid, prev_params, acc, refresh_age):
        """Fully-device analyse step (same shape as the rotation family's,
        ``pipeline/render.py``): track + fit + accumulate + conditional
        corner refresh, with no per-frame host read — this loop syncs
        once, at the end of the clip."""
        gray = _track_res(gray)
        new_pts, status = pyramidal_lk(prev_gray, gray, pts, valid)
        params, inliers = fit_similarity(pts, new_pts, status)
        params = jnp.where(inliers >= min_inliers, params, prev_params)
        acc = compose_similarity(params, acc)
        if refresh_age:
            out_pts, out_valid = detect_corners(
                gray, max_corners=MAX_CORNERS, min_distance=min_distance,
                border=border,
            )
        else:
            # NOTE: the count-based refresh runs on device, so the host's
            # age counter does not reset on it (same cadence as the
            # rotation family's fully-device step) — the worst case is one
            # redundant detect at the age limit.
            out_pts, out_valid = jax.lax.cond(
                jnp.sum(status) < min_refresh,
                lambda: detect_corners(
                    gray, max_corners=MAX_CORNERS, min_distance=min_distance,
                    border=border,
                ),
                lambda: (new_pts, status),
            )
        return out_pts, out_valid, params, acc, gray

    @jax.jit
    def detect_step(gray):
        gray = _track_res(gray)
        return detect_corners(
            gray, max_corners=MAX_CORNERS, min_distance=min_distance,
            border=border,
        ) + (gray,)

    acc = jnp.zeros(4, jnp.float32)
    prev_params = jnp.zeros(4, jnp.float32)
    out = []
    prev_gray = None
    pts = valid = None
    age = 0
    idx = reader.start_frame - 1
    from video_annotator_tpu.io.prefetch import DevicePrefetcher

    pre = DevicePrefetcher(prof.wrap_iter("decode", iter(reader)),
                           depth=getattr(options, "prefetch_depth", 3))
    try:
        for y, _, _ in pre:
            idx += 1
            if idx < first:
                continue
            if idx >= last:
                break
            if prev_gray is None:
                with prof.stage("detect"):
                    pts, valid, prev_gray = detect_step(y)
                out.append(acc)
            else:
                with prof.stage("track"):
                    pts, valid, prev_params, acc, prev_gray = track_step(
                        prev_gray, y, pts, valid, prev_params, acc,
                        refresh_age=age >= KEY_FRAME_MAX_AGE,
                    )
                    out.append(acc)
                age = 0 if age >= KEY_FRAME_MAX_AGE else age + 1
    finally:
        # Like analyse() (pipeline/render.py): an exception mid-loop must
        # still join the prefetch thread and close the native reader.
        pre.close()
        reader.close()
    # One device->host sync for the whole trajectory; translations
    # scale back to full-resolution pixels.
    with prof.stage("collect"):
        params_np = (
            np.asarray(jnp.stack(out), np.float64)
            if out else np.zeros((0, 4))
        )
        params_np[:, :2] *= float(1 << level)
    return Trajectory(
        params=params_np,
        kind="similarity",
        fps=meta.fps,
        width=meta.width,
        height=meta.height,
        source=source,
    )


def similarity_corrections(traj: Trajectory, options) -> np.ndarray:
    """Per-frame sampling transforms (output px -> source px), (T, 4)."""
    t = traj.num_frames
    acc = jnp.asarray(traj.params, jnp.float32)  # (T, 4) accumulated
    if t == 0 or options.stabilise == "none":
        return np.zeros((t, 4), np.float32)
    if options.stabilise == "fixed":
        smooth = jnp.zeros_like(acc)
    else:
        radius = min(options.stabilise_radius, max(t - 1, 1))
        w = jnp.asarray(savgol_weights(radius, 2))
        padded = jnp.concatenate(
            [
                jnp.broadcast_to(acc[:1], (radius, 4)),
                acc,
                jnp.broadcast_to(acc[-1:], (radius, 4)),
            ],
            axis=0,
        )
        smooth = sg_conv(padded, w)
    # Display correction = smooth o acc^-1 (take the frame to its smoothed
    # pose); the sampler needs the inverse map (output px -> source px):
    # sample = corr^-1 = acc o smooth^-1.
    corr = jax.vmap(lambda a, s: compose_similarity(s, invert_similarity(a)))(
        acc, smooth
    )
    sample = jax.vmap(invert_similarity)(corr)
    # vidstabtransform's ``zoom: -stabiliseBuffer`` (src/render.ts:569-570):
    # zoom OUT by buffer percent around the frame centre while stabilising,
    # so corrections reveal borders instead of cropping content. Sampling
    # scale is the display scale's inverse.
    if options.stabilise_buffer:
        z = 1.0 - options.stabilise_buffer / 100.0
        k = 1.0 / max(z, 1e-3)
        cx = (traj.width - 1) / 2.0
        cy = (traj.height - 1) / 2.0
        zoom = jnp.asarray(
            [cx * (1.0 - k), cy * (1.0 - k), 0.0, float(np.log(k))],
            jnp.float32,
        )
        sample = jax.vmap(lambda p: compose_similarity(p, zoom))(sample)
    return np.asarray(sample)


def warp_frame_similarity(y, u, v, sample_params, interp="bilinear",
                          out_size=None):
    """Warp YUV planes by a similarity sampling transform.

    The reference's vidstabtransform asks for bicubic interpolation
    (``src/render.ts:571``) — pass ``interp='bicubic'`` (CLI
    ``--filter vidstab --interp bicubic``) for that exact behavior.
    ``out_size`` (h, w) grows the canvas (the --upsample fold:
    ``pipeline/render.py:encode_2d`` shrinks the sampling log-scale by
    log(upsample/100) to match).
    """
    half = sample_params * jnp.asarray([0.5, 0.5, 1.0, 1.0])
    half_size = (
        None if out_size is None else (out_size[0] // 2, out_size[1] // 2)
    )
    wy = warp_similarity(y, sample_params, interp=interp, out_size=out_size)
    wu = warp_similarity(u - 128.0, half, interp=interp,
                         out_size=half_size) + 128.0
    wv = warp_similarity(v - 128.0, half, interp=interp,
                         out_size=half_size) + 128.0
    return wy, wu, wv
