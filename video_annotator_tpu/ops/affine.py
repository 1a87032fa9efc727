"""2D similarity/affine estimation and warping.

Support ops for the vidstab-family stabilizer (``src/render.ts:546-585``
drives ffmpeg's vidstabdetect/vidstabtransform, which model inter-frame
motion as 2D transforms rather than camera rotations). Estimation is a
robust weighted least-squares similarity fit over tracked point pairs
(IRLS — fixed iteration count, jit-friendly); warping reuses the bilinear
sampler with an affine source map.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from video_annotator_tpu.ops.warp_xla import _SAMPLERS


def fit_similarity(
    pts_prev: jax.Array,  # (N, 2)
    pts_curr: jax.Array,  # (N, 2)
    valid: jax.Array,  # (N,)
    irls_iters: int = 4,
    inlier_px: float = 4.0,
) -> Tuple[jax.Array, jax.Array]:
    """Robust similarity p_curr ~= s R p_prev + t.

    Returns ``(params, num_inliers)`` with params (4,) =
    (dx, dy, angle, log_scale). IRLS with a hard residual cutoff plays the
    role of vidstab's RANSAC-ish local-motion consensus.
    """
    w = valid.astype(jnp.float32)

    def solve(w):
        wsum = jnp.sum(w) + 1e-6
        mp = jnp.sum(pts_prev * w[:, None], axis=0) / wsum
        mc = jnp.sum(pts_curr * w[:, None], axis=0) / wsum
        p = pts_prev - mp
        c = pts_curr - mc
        # complex-number form of the 2D similarity LS solution
        num_re = jnp.sum(w * (p[:, 0] * c[:, 0] + p[:, 1] * c[:, 1]))
        num_im = jnp.sum(w * (p[:, 0] * c[:, 1] - p[:, 1] * c[:, 0]))
        den = jnp.sum(w * (p[:, 0] ** 2 + p[:, 1] ** 2)) + 1e-9
        a = num_re / den  # s cos
        b = num_im / den  # s sin
        s = jnp.sqrt(a * a + b * b)
        ang = jnp.arctan2(b, a)
        t = mc - s * jnp.stack(
            [
                jnp.cos(ang) * mp[0] - jnp.sin(ang) * mp[1],
                jnp.sin(ang) * mp[0] + jnp.cos(ang) * mp[1],
            ]
        )
        return t[0], t[1], ang, jnp.log(jnp.maximum(s, 1e-6))

    def residuals(params):
        dx, dy, ang, ls = params
        s = jnp.exp(ls)
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        px = s * (ca * pts_prev[:, 0] - sa * pts_prev[:, 1]) + dx
        py = s * (sa * pts_prev[:, 0] + ca * pts_prev[:, 1]) + dy
        return jnp.sqrt(
            (px - pts_curr[:, 0]) ** 2 + (py - pts_curr[:, 1]) ** 2 + 1e-12
        )

    params = solve(w)
    for _ in range(irls_iters):
        r = residuals(params)
        w = valid.astype(jnp.float32) * (r < inlier_px).astype(jnp.float32)
        params = solve(w)
    r = residuals(params)
    inliers = jnp.sum(valid & (r < inlier_px)).astype(jnp.int32)
    return jnp.stack(params), inliers


def compose_similarity(a: jax.Array, b: jax.Array) -> jax.Array:
    """Parameters of transform A after B (A o B), both (dx, dy, ang, ls)."""
    dxa, dya, anga, lsa = a[0], a[1], a[2], a[3]
    dxb, dyb, angb, lsb = b[0], b[1], b[2], b[3]
    s = jnp.exp(lsa)
    ca, sa = jnp.cos(anga), jnp.sin(anga)
    dx = s * (ca * dxb - sa * dyb) + dxa
    dy = s * (sa * dxb + ca * dyb) + dya
    return jnp.stack([dx, dy, anga + angb, lsa + lsb])


def invert_similarity(p: jax.Array) -> jax.Array:
    dx, dy, ang, ls = p[0], p[1], p[2], p[3]
    si = jnp.exp(-ls)
    ca, sa = jnp.cos(-ang), jnp.sin(-ang)
    ndx = -si * (ca * dx - sa * dy)
    ndy = -si * (sa * dx + ca * dy)
    return jnp.stack([ndx, ndy, -ang, -ls])


def similarity_matrix(params: jax.Array) -> jax.Array:
    """(4,) (dx, dy, angle, log_scale) -> 3x3 homogeneous pixel matrix.

    ``M @ (x, y, 1)`` equals the source coordinates
    :func:`warp_similarity` samples (the cv2 ``warpAffine`` oracle's
    inverse map).
    """
    dx, dy, ang, ls = params[0], params[1], params[2], params[3]
    s = jnp.exp(ls)
    ca, sa = s * jnp.cos(ang), s * jnp.sin(ang)
    z = jnp.zeros_like(dx)
    o = jnp.ones_like(dx)
    return jnp.stack([
        jnp.stack([ca, -sa, dx]),
        jnp.stack([sa, ca, dy]),
        jnp.stack([z, z, o]),
    ])


@functools.partial(jax.jit, static_argnames=("out_size", "interp"))
def warp_similarity(
    image: jax.Array,  # (H, W)
    params: jax.Array,  # (4,) SAMPLING transform: output px -> source px
    out_size: Tuple[int, int] | None = None,
    interp: str = "bilinear",
) -> jax.Array:
    """Resample ``image`` through the similarity ``params``.

    ``params`` is the SAMPLING transform (maps output pixels to source
    pixels) — to stabilize, callers pass the INVERSE of the estimated
    prev->curr motion (``models/similarity.py`` composes and inverts
    before calling; ``invert_similarity`` does the algebra). Passing a
    forward motion here warps the frame the wrong way, doubling the
    shake instead of cancelling it.

    ``interp='bicubic'`` matches the reference's vidstabtransform
    invocation (``interpol: "bicubic"``, ``src/render.ts:571``).
    """
    h, w = image.shape if out_size is None else out_size
    inv = params
    dx, dy, ang, ls = inv[0], inv[1], inv[2], inv[3]
    s = jnp.exp(ls)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    sx = s * (ca * xs - sa * ys) + dx
    sy = s * (sa * xs + ca * ys) + dy
    return _SAMPLERS[interp](image, jnp.stack([sx, sy], axis=-1))
