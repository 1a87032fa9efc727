"""Pyramidal Lucas-Kanade sparse optical flow, batched over points.

Replaces ``cv::calcOpticalFlowPyrLK`` (``opencv/FrameSourceWarp.cpp:252-259``,
default parameters: 21x21 window, 3 pyramid levels, iterative refinement).
Device shape discipline: a fixed number of points (mask for validity), a
fixed iteration count per level (``lax.fori_loop``), and everything batched
over the point axis with ``vmap`` so the patch work vectorizes.

The per-iteration patch resample exploits that LK flow is a pure translation
per point: the 2x2 fractional shift is four dynamically-sliced copies of the
point's local window, not a scattered gather.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# cv2 calcOpticalFlowPyrLK defaults: winSize=21, maxLevel=2 (3 levels),
# 30 iterations / eps 0.01. We use a fixed 10 iterations (converges in <5
# for typical video) to keep the loop bound static.
WIN = 21
DEF_LEVELS = 3
DEF_ITERS = 10
MIN_EIG_THRESHOLD = 1e-4


@functools.lru_cache(maxsize=32)
def _decim_matrix(n: int):
    """(n//2, n) banded blur+decimate matrix: row r holds the [1,4,6,4,1]/16
    taps at columns 2r-2..2r+2, edge-clamped."""
    import numpy as np

    n2 = n // 2
    d = np.zeros((n2, n), np.float32)
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    for i in range(5):
        cols = np.clip(2 * np.arange(n2) + i - 2, 0, n - 1)
        d[np.arange(n2), cols] += k[i]
    return d


def _pyr_down(img: jax.Array) -> jax.Array:
    """cv2.pyrDown-style 5-tap Gaussian blur + 2x decimation.

    Two banded-matrix matmuls: separable blur+decimate is a (H/2, H) and a
    (W, W/2) structured matrix product (~2 GFLOP at 1440p, float32
    HIGHEST); ``chip_smoke.py`` times the analyse phase that runs it.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    dy = jnp.asarray(_decim_matrix(h))
    dx = jnp.asarray(_decim_matrix(w))
    tmp = jax.lax.dot(dy, img, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.dot(tmp, dx.T, precision=jax.lax.Precision.HIGHEST)


def build_pyramid(img: jax.Array, levels: int = DEF_LEVELS):
    """List of (H/2^l, W/2^l) float32 images, level 0 = full resolution."""
    pyr = [img.astype(jnp.float32)]
    for _ in range(levels - 1):
        pyr.append(_pyr_down(pyr[-1]))
    return pyr


def _extract_window(img: jax.Array, center: jax.Array, size: int) -> jax.Array:
    """(size, size) window around integer part of ``center`` (x, y).

    Returns the window plus the center's position inside it; clamped at
    image borders (caller masks points too close to the edge).
    """
    h, w = img.shape
    cx = jnp.floor(center[0]).astype(jnp.int32)
    cy = jnp.floor(center[1]).astype(jnp.int32)
    half = size // 2
    x0 = jnp.clip(cx - half, 0, w - size)
    y0 = jnp.clip(cy - half, 0, h - size)
    win = jax.lax.dynamic_slice(img, (y0, x0), (size, size))
    return win, x0, y0


def _bilinear_patch(win: jax.Array, off_x: jax.Array, off_y: jax.Array, size: int):
    """(size, size) patch of ``win`` at fractional offset (off_x, off_y).

    Pure translation: 4 dynamically-sliced taps blended by the fractional
    part. ``off`` must satisfy 0 <= off <= win_size - size - 1.
    """
    ix = jnp.floor(off_x)
    iy = jnp.floor(off_y)
    fx = (off_x - ix).astype(jnp.float32)
    fy = (off_y - iy).astype(jnp.float32)
    ix = ix.astype(jnp.int32)
    iy = iy.astype(jnp.int32)

    def tap(dy, dx):
        return jax.lax.dynamic_slice(win, (iy + dy, ix + dx), (size, size))

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    return top * (1 - fy) + bot * fy


def _lk_level(
    prev_img: jax.Array,
    next_img: jax.Array,
    point: jax.Array,  # (2,) position in this level's coords
    guess: jax.Array,  # (2,) flow guess in this level's coords
    iters: int,
) -> Tuple[jax.Array, jax.Array]:
    """Refine flow for one point at one pyramid level. Returns (flow, ok)."""
    h, w = prev_img.shape
    half = WIN // 2
    thalo = WIN + 2  # template + 1-px gradient halo
    wsize_t = thalo + 4  # prev window: halo patch + fractional slack
    wsize_n = WIN + 4  # per-iteration next window (re-fetched, see body)
    if h < wsize_t or w < wsize_t:
        # Pyramid level smaller than the tracking window (tiny inputs):
        # pass the guess through unchanged.
        return guess, jnp.bool_(True)

    # Template with a 1-px halo so the Scharr gradients below use REAL
    # neighbors (a SAME-padded conv fabricates huge border gradients —
    # ~0.5*intensity at the patch ring — that dominate G and bias the
    # Newton step; cv2 samples a real halo too).
    win_prev, px0, py0 = _extract_window(prev_img, point, wsize_t)
    tx = jnp.clip(point[0] - px0.astype(jnp.float32) - (half + 1),
                  0.0, wsize_t - thalo - 1.0)
    ty = jnp.clip(point[1] - py0.astype(jnp.float32) - (half + 1),
                  0.0, wsize_t - thalo - 1.0)
    tpl_halo = _bilinear_patch(win_prev, tx, ty, thalo)
    tpl = tpl_halo[1:-1, 1:-1]

    # Scharr gradients of the template (cv2 uses Scharr for LK
    # derivatives), VALID over the halo patch -> (WIN, WIN).
    gx_k = jnp.array([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]], jnp.float32) / 32.0
    # HIGHEST: a TF32 convolution (the GPU default for float32) would
    # round the gradients that the Newton step divides by.
    ix = jax.lax.conv_general_dilated(
        tpl_halo[None, None], gx_k[None, None], (1, 1), "VALID",
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )[0, 0]
    iy = jax.lax.conv_general_dilated(
        tpl_halo[None, None], gx_k.T[None, None], (1, 1), "VALID",
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )[0, 0]

    gxx = jnp.sum(ix * ix)
    gxy = jnp.sum(ix * iy)
    gyy = jnp.sum(iy * iy)
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0))) * 0.5
    ok_g = min_eig / (WIN * WIN) > MIN_EIG_THRESHOLD
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)

    def body(_, v):
        # Re-fetch the window around the CURRENT estimate each iteration
        # (cv2 semantics): a once-fetched window bounds the recoverable
        # drift to its padding, and under large coherent motion every
        # point clamps the same way — the flow saturates while status
        # stays True and RANSAC happily accepts the shared wrong answer.
        win_next, nx0, ny0 = _extract_window(next_img, point + v, wsize_n)
        ox = jnp.clip(point[0] + v[0] - nx0.astype(jnp.float32) - half,
                      0.0, wsize_n - WIN - 1.0)
        oy = jnp.clip(point[1] + v[1] - ny0.astype(jnp.float32) - half,
                      0.0, wsize_n - WIN - 1.0)
        cur = _bilinear_patch(win_next, ox, oy, WIN)
        r = cur - tpl
        bx = jnp.sum(r * ix)
        by = jnp.sum(r * iy)
        dv = jnp.stack([gyy * bx - gxy * by, gxx * by - gxy * bx]) * inv
        return v - dv

    flow = jax.lax.fori_loop(0, iters, body, guess)

    # In-bounds check at full precision position.
    tgt = point + flow
    ok_b = (
        (point[0] >= half) & (point[0] < w - half)
        & (point[1] >= half) & (point[1] < h - half)
        & (tgt[0] >= half) & (tgt[0] < w - half)
        & (tgt[1] >= half) & (tgt[1] < h - half)
    )
    return flow, ok_g & ok_b


@functools.partial(jax.jit, static_argnames=("levels", "iters"))
def pyramidal_lk(
    prev_img: jax.Array,
    next_img: jax.Array,
    points: jax.Array,  # (N, 2) float32 (x, y)
    valid: jax.Array,  # (N,) bool
    levels: int = DEF_LEVELS,
    iters: int = DEF_ITERS,
):
    """Track ``points`` from ``prev_img`` to ``next_img``.

    Returns ``(new_points, status)`` with fixed shapes; ``status`` combines
    the input mask, the gradient-conditioning gate, and bounds checks —
    the moral equivalent of the reference's status filtering
    (``opencv/FrameSourceWarp.cpp:262-268``).
    """
    # cv2-style level reduction (buildOpticalFlowPyramid): drop pyramid
    # levels that can't fit the tracking window comfortably — at a small
    # tracking resolution the coarsest level's border margin would
    # otherwise exclude nearly the whole frame.
    h, w = prev_img.shape
    max_lv = 1
    while max_lv < levels and (min(h, w) >> max_lv) >= 2 * WIN:
        max_lv += 1
    levels = max_lv

    pyr_prev = build_pyramid(prev_img, levels)
    pyr_next = build_pyramid(next_img, levels)

    # Derive the zero init from the input so sharding metadata (shard_map
    # varying-axes tracking) follows the data.
    flow = points * 0.0
    status = valid

    for lvl in range(levels - 1, -1, -1):
        scale = 2.0**lvl
        pts_l = points / scale
        flow_l = flow / scale
        f, ok = jax.vmap(
            lambda p, g: _lk_level(pyr_prev[lvl], pyr_next[lvl], p, g, iters)
        )(pts_l, flow_l)
        flow = f * scale
        status = status & ok

    return points + flow, status
