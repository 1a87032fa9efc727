"""The deshake-family stabilizer: global translation + blurred-edge fill.

Equivalent of ffmpeg's ``deshake`` (block-matching global motion,
``src/render.ts:730-771``) and ``deshake_opencl`` (same model with a
``smooth_window_multiplier`` and the edge-blur treatment the reference
builds from a ``geq`` alpha ramp + blur, ``getBlurEdgesPipeline``,
``src/render.ts:773-855``). Motion comes from FFT phase correlation
(branch-free, dense on device); borders revealed by the correction are filled
with a blurred copy instead of black.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu.ops.mip import box_downsample
from video_annotator_tpu.ops.phasecorr import phase_correlate
from video_annotator_tpu.pipeline.profiler import StageProfiler
from video_annotator_tpu.pipeline.trajectory import Trajectory
from video_annotator_tpu.smoothing.savgol import savgol_weights, sg_conv


def analyse_deshake(
    source: str,
    options,
    profiler: Optional[StageProfiler] = None,
) -> Trajectory:
    """Accumulated global translation per frame via phase correlation."""
    from video_annotator_tpu.pipeline.render import open_trimmed

    prof = profiler or StageProfiler()
    reader, meta, first, last = open_trimmed(source, options)
    # --analysis-scale: phase-correlate a box-downsampled level
    # (translations scale back by 2^level at collect time).
    from video_annotator_tpu.pipeline.render import analysis_level

    level = analysis_level(options, meta)

    # Measurement-quality gate: normalized confidence below 1.5 means
    # the correlation surface has no trustworthy peak (scene cut, flat
    # frame — thresholds measured in ops/phasecorr.py); fall back to
    # the previous frame's motion, the deshake-family analogue of the
    # reference's inliers<40 => reuse-previous-rotation gate
    # (opencv/FrameSourceWarp.cpp:432-438). Accepted deltas are also
    # clamped to 1/8 frame per axis — consecutive-frame camera shake is
    # small (ffmpeg deshake searches +-16 px, rx/ry defaults), and the
    # clamp bounds the damage of the one degenerate class the
    # confidence can't see: an adversarial cut that mimics a periodic
    # genuine pair.
    conf_min = 1.5

    @jax.jit
    def track_step(prev_small, gray, acc, prev_d):
        # d such that curr(x) ~= prev(x - d): camera moved by +d. Runs
        # and accumulates on device — no per-frame host sync.
        small = box_downsample(gray, level).astype(jnp.float32) \
            if level else gray.astype(jnp.float32)
        d, conf = phase_correlate(small, prev_small)
        d_max = jnp.asarray(
            [small.shape[1] / 8.0, small.shape[0] / 8.0], jnp.float32
        )
        d = jnp.clip(d, -d_max, d_max)
        d = jnp.where(conf >= conf_min, d, prev_d)
        return acc + d, small, d

    @jax.jit
    def first_step(gray):
        return (box_downsample(gray, level) if level else gray).astype(
            jnp.float32
        )

    acc = jnp.zeros(2, jnp.float32)
    prev_d = jnp.zeros(2, jnp.float32)
    out = []
    prev_gray = None
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
                prev_gray = first_step(y)
                out.append(acc)
            else:
                with prof.stage("track"):
                    acc, prev_gray, prev_d = track_step(
                        prev_gray, y, acc, prev_d
                    )
                    out.append(acc)
    finally:
        # Like analyse() (pipeline/render.py): an exception mid-loop must
        # still join the prefetch thread and close the native reader.
        pre.close()
        reader.close()
    with prof.stage("collect"):
        params_np = (
            np.asarray(jnp.stack(out), np.float64)
            if out else np.zeros((0, 2))
        )
        params_np *= float(1 << level)
    return Trajectory(
        params=params_np,
        kind="translation",
        fps=meta.fps,
        width=meta.width,
        height=meta.height,
        source=source,
    )


def deshake_corrections(traj: Trajectory, options) -> np.ndarray:
    """Per-frame sampling offsets (output px -> source px), (T, 2)."""
    t = traj.num_frames
    acc = jnp.asarray(traj.params, jnp.float32)
    if t == 0 or options.stabilise == "none":
        return np.zeros((t, 2), np.float32)
    if options.stabilise == "fixed":
        smooth = jnp.zeros_like(acc)
    else:
        radius = min(options.stabilise_radius, max(t - 1, 1))
        w = jnp.asarray(savgol_weights(radius, 2))
        padded = jnp.concatenate(
            [
                jnp.broadcast_to(acc[:1], (radius, 2)),
                acc,
                jnp.broadcast_to(acc[-1:], (radius, 2)),
            ],
            axis=0,
        )
        smooth = sg_conv(padded, w)
    # sample at x_out + (acc - smooth): remove the jitter component.
    return np.asarray(acc - smooth)


import functools as _ft


@_ft.lru_cache(maxsize=8)
def _blur_band(n: int, sigma: float) -> np.ndarray:
    """(n, n) replicate-edge Gaussian blur operator along one axis.

    Row i accumulates the kernel weight of tap i+d onto clip(i+d, 0, n-1)
    — exactly a mode="edge"-padded 1D convolution, as a dense banded
    matrix. Two of these matmuls ARE the separable blur (a 49-tap
    depthwise conv would lower to ~49 shifted passes over the frame).
    At 4K this is ~0.19 TFLOP per YUV frame in f32 HIGHEST precision;
    ``chip_smoke.py`` times it on the card.
    """
    radius = int(3 * sigma)
    d = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (d / sigma) ** 2)
    k = k / k.sum()
    band = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), d.size)
    cols = np.clip(np.arange(n)[:, None] + d[None, :], 0, n - 1).ravel()
    np.add.at(band, (rows, cols), np.tile(k, n))
    return band


def _gauss_blur(img: jax.Array, sigma: float = 8.0) -> jax.Array:
    h, w = img.shape
    bv = jnp.asarray(_blur_band(h, sigma))
    bh = jnp.asarray(_blur_band(w, sigma))
    v = jnp.matmul(bv, img, precision=jax.lax.Precision.HIGHEST)
    return jnp.matmul(v, bh.T, precision=jax.lax.Precision.HIGHEST)


@_ft.partial(jax.jit, static_argnames=("blur_edges",))
def warp_frame_deshake(y, u, v, offset, blur_edges: bool = True):
    """Translate YUV planes by ``offset`` (x, y), blurred-edge fill."""

    def shift(img, off, fill_blur):
        # A pure translation needs no 2D gather: each bilinear tap is the
        # image advanced by an integer offset, i.e. two AXIS-WISE takes
        # with 1-D clamped index vectors (row permutation + lane
        # permutation) — XLA lowers these at near-copy speed. Out-of-
        # image taps are masked to zero (exactly bilinear_sample's
        # BORDER_CONSTANT) or, for the blur background, left clamped
        # (exactly the replicate-edge sample of the blurred frame).
        h, w = img.shape
        j0 = jnp.floor(off[0])
        i0 = jnp.floor(off[1])
        fx = off[0] - j0
        fy = off[1] - i0
        i0 = i0.astype(jnp.int32)
        j0 = j0.astype(jnp.int32)
        rows = jnp.arange(h, dtype=jnp.int32) + i0
        cols = jnp.arange(w, dtype=jnp.int32) + j0

        def tap(base, di, dj, clamp):
            r = rows + di
            c = cols + dj
            v = jnp.take(base, jnp.clip(r, 0, h - 1), axis=0)
            v = jnp.take(v, jnp.clip(c, 0, w - 1), axis=1)
            if clamp:
                return v
            rv = ((r >= 0) & (r < h)).astype(jnp.float32)[:, None]
            cv = ((c >= 0) & (c < w)).astype(jnp.float32)[None, :]
            return v * rv * cv

        def sample(base, clamp):
            top = (1.0 - fx) * tap(base, 0, 0, clamp) + fx * tap(base, 0, 1, clamp)
            bot = (1.0 - fx) * tap(base, 1, 0, clamp) + fx * tap(base, 1, 1, clamp)
            return (1.0 - fy) * top + fy * bot

        out = sample(img, clamp=False)
        if fill_blur:
            ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + off[1]
            xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + off[0]
            inside = (
                (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
            ).astype(jnp.float32)
            bg_s = sample(_gauss_blur(img), clamp=True)
            out = inside * out + (1.0 - inside) * bg_s
        return out

    half = offset * 0.5
    wy = shift(y, offset, blur_edges)
    wu = shift(u - 128.0, half, False) + 128.0
    wv = shift(v - 128.0, half, False) + 128.0
    return wy, wu, wv
