"""Shi-Tomasi (min-eigenvalue) corner detection, vectorized for a device.

Replaces ``cv::goodFeaturesToTrack(image, corners, 200, 0.01, 30)``
(``opencv/FrameSourceWarp.cpp:228-240``). The reference's greedy
min-distance suppression is inherently sequential; this formulation gets
the same spatial spread with a fixed-shape algorithm:

1. Sobel gradients + 3x3 box-filtered structure tensor (separable
   shift-and-add), min-eigenvalue response, like cv2's ``blockSize=3``
   default.
2. Quality threshold at ``quality_level * max(response)``.
3. Spatial spread: partition the image into ``min_distance``-sized cells,
   keep each cell's argmax (one corner per cell ~= pairwise distance >=
   min_distance), then take the global top-``max_corners`` cells.

Outputs are fixed-shape: ``(max_corners, 2)`` float32 (x, y) positions plus a
validity mask, so the whole pipeline stays jit-compatible.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _sep3(img: jax.Array, ky, kx) -> jax.Array:
    """Separable 3-tap convolution via shift-and-add.

    A single-channel (C=1) 2D conv is a poor fit for a matrix unit;
    shift-and-add is plain elementwise work that XLA fuses into one
    pass.
    """
    h, w = img.shape
    pad = jnp.pad(img, ((1, 1), (1, 1)))
    v = ky[0] * pad[:-2, 1:-1] + ky[1] * pad[1:-1, 1:-1] + ky[2] * pad[2:, 1:-1]
    pad = jnp.pad(v, ((0, 0), (1, 1)))
    return kx[0] * pad[:, :-2] + kx[1] * pad[:, 1:-1] + kx[2] * pad[:, 2:]


def _box(img: jax.Array, b: int) -> jax.Array:
    """Separable b x b box sum (same-size, zero-padded edges)."""
    if b == 3:
        return _sep3(img, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    if b < 1 or b % 2 == 0:
        raise ValueError(f"block_size must be odd and positive, got {b}")
    r = b // 2
    p = jnp.pad(img, ((r + 1, r), (0, 0)))
    s = jnp.cumsum(p, axis=0)
    v = s[b:, :] - s[:-b, :]
    p = jnp.pad(v, ((0, 0), (r + 1, r)))
    s = jnp.cumsum(p, axis=1)
    return s[:, b:] - s[:, :-b]


def shi_tomasi_response(img: jax.Array, block_size: int = 3) -> jax.Array:
    """Min-eigenvalue corner response map (cv2 ``cornerMinEigenVal``-like).

    ``img`` is (H, W) float32. Uses Sobel gradients and a ``block_size``
    box window for the structure tensor (separable shift-and-add convs).
    """
    img = img.astype(jnp.float32)
    # Sobel: smoothing [1,2,1] x derivative [-1,0,1].
    ix = _sep3(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
    iy = _sep3(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))
    inv_area = 1.0 / (block_size * block_size)
    a = _box(ix * ix, block_size) * inv_area
    b = _box(ix * iy, block_size) * inv_area
    c = _box(iy * iy, block_size) * inv_area
    # min eigenvalue of [[a, b], [b, c]]
    return (a + c) * 0.5 - jnp.sqrt(jnp.maximum(((a - c) * 0.5) ** 2 + b * b, 0.0))


@functools.partial(
    jax.jit, static_argnames=("max_corners", "min_distance", "border")
)
def detect_corners(
    img: jax.Array,
    max_corners: int = 256,
    quality_level: float = 0.01,
    min_distance: int = 30,
    border: int = 8,
):
    """Detect up to ``max_corners`` well-spread corners.

    Returns ``(points, valid)``: points (max_corners, 2) float32 in (x, y)
    order; valid (max_corners,) bool. Defaults mirror the reference's
    ``goodFeaturesToTrack`` call (quality 0.01, min distance 30 —
    ``opencv/FrameSourceWarp.cpp:230``), with a fixed output count.
    """
    h, w = img.shape
    resp = shi_tomasi_response(img)

    # Suppress the border (gradient/window edge effects + LK window room).
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    resp = jnp.where(inside, resp, 0.0)

    threshold = jnp.max(resp) * quality_level

    # One corner per min_distance cell. Cell maxima via reduce_window (a
    # reshape/transpose formulation relayouts the whole response map);
    # the winner's position comes from a second reduce_window over
    # (value, flat-index) packed comparisons. Windows are capped at 32px
    # per stage, so larger cells reduce hierarchically — stage one at
    # <= 32 px, stage two over the already-tiny grid. Cells round up to
    # a*b, which only spreads corners slightly wider.
    cell = max(int(min_distance), 1)
    nsub = -(-cell // 32)
    sub = -(-cell // nsub)  # stage-1 window, <= 32
    cell = sub * nsub
    ny = -(-h // cell)
    nx = -(-w // cell)

    def cell_reduce(arr, op, init):
        # Separable 1-D passes (columns, then rows): max over a k x k
        # cell decomposes exactly, and each strided 1-D reduce_window
        # lowers to a k-element reduction instead of k^2.
        r = jax.lax.reduce_window(
            arr, init, op,
            window_dimensions=(1, sub),
            window_strides=(1, sub),
            padding=((0, 0), (0, nx * cell - w)),
        )
        r = jax.lax.reduce_window(
            r, init, op,
            window_dimensions=(sub, 1),
            window_strides=(sub, 1),
            padding=((0, ny * cell - h), (0, 0)),
        )
        if nsub > 1:
            r = jax.lax.reduce_window(
                r, init, op,
                window_dimensions=(1, nsub),
                window_strides=(1, nsub),
                padding="VALID",
            )
            r = jax.lax.reduce_window(
                r, init, op,
                window_dimensions=(nsub, 1),
                window_strides=(nsub, 1),
                padding="VALID",
            )
        return r

    cell_best = cell_reduce(resp, jax.lax.max, -jnp.inf)
    # Winner position: argmax via a second pass — keep the CELL-LOCAL index
    # where the response equals its cell max (ties -> smallest local
    # index). Local indices stay < cell^2 <= ~2^12, exactly representable
    # in float32 at any image size (a global flat index overflows f32's
    # 24-bit mantissa above 16.7M pixels — 8K frames).
    local_idx = ((ys % cell) * cell + (xs % cell)).astype(jnp.float32)
    up_best = jnp.repeat(
        jnp.repeat(cell_best, cell, axis=0), cell, axis=1
    )[:h, :w]
    cand = jnp.where(resp >= up_best, -local_idx, -jnp.inf)
    winner = (-cell_reduce(cand, jax.lax.max, -jnp.inf)).astype(jnp.int32)
    cell_y = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0) * cell
    cell_x = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1) * cell
    py_g = cell_y + winner // cell
    px_g = cell_x + winner % cell

    # Cells are disjoint, but winners of adjacent cells can still sit closer
    # than min_distance across the boundary. Suppress a cell when a stronger
    # 8-neighbor's winner is within min_distance (ties broken by scan order),
    # which guarantees the pairwise distance like cv2's greedy suppression.
    def shift(arr, dy, dx, fill):
        return jnp.roll(
            jnp.pad(arr, 1, constant_values=fill), (dy, dx), axis=(0, 1)
        )[1:-1, 1:-1]

    keep = jnp.ones((ny, nx), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n_score = shift(cell_best, dy, dx, -jnp.inf)
            n_py = shift(py_g, dy, dx, -(10 * cell))
            n_px = shift(px_g, dy, dx, -(10 * cell))
            d2 = (py_g - n_py) ** 2 + (px_g - n_px) ** 2
            stronger = (n_score > cell_best) | (
                (n_score == cell_best) & ((dy < 0) | ((dy == 0) & (dx < 0)))
            )
            keep &= ~((d2 < min_distance * min_distance) & stronger)

    py = py_g.reshape(-1)
    px = px_g.reshape(-1)
    scores = jnp.where(keep, cell_best, -1.0).reshape(-1)

    k = min(max_corners, scores.shape[0])
    top_scores, top_idx = jax.lax.top_k(scores, k)
    points = jnp.stack(
        [px[top_idx].astype(jnp.float32), py[top_idx].astype(jnp.float32)], axis=-1
    )
    valid = top_scores > jnp.maximum(threshold, 0.0)
    if k < max_corners:
        points = jnp.pad(points, ((0, max_corners - k), (0, 0)))
        valid = jnp.pad(valid, (0, max_corners - k))
    return points, valid
