"""Robust camera-rotation estimation from tracked point pairs.

Replaces the reference's ``guess_camera_rotation``
(``opencv/FrameSourceWarp.cpp:316-375``), which undistorts both point sets,
randomizes point depths so translation can't be detected, and runs
``solvePnPRansac`` (100 iterations, 8 px reprojection threshold, 0.99
confidence) followed by a fallback when inliers < 40
(``opencv/FrameSourceWarp.cpp:432-438``).

This formulation estimates the rotation *directly on the unit
sphere* (no depth-randomization hack needed — rays factor translation out by
construction for distant scenes, which is the same approximation the
reference makes):

- hypotheses: a fixed batch of 2-point minimal samples solved in closed form
  (TRIAD: align two orthonormal frames built from each ray pair);
- scoring: angular reprojection error of *all* pairs against each
  hypothesis, masked by validity — one ``vmap`` over hypotheses;
- refinement: weighted Wahba/Kabsch (SVD of the inlier correlation matrix)
  on the best hypothesis's inliers, iterated twice.

Everything is fixed-shape and jit-friendly: no data-dependent loops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from video_annotator_tpu import so3

# Reference RANSAC parameters (opencv/FrameSourceWarp.cpp:354-366,432).
NUM_HYPOTHESES = 100  # reference: solvePnPRansac iterationsCount=100 (FrameSourceWarp.cpp:354-366)
DEFAULT_REPROJ_PX = 8.0
MIN_INLIERS = 40


class RotationEstimate(NamedTuple):
    rotation: jax.Array  # (3, 3) R with q ~= R p
    num_inliers: jax.Array  # int32
    inliers: jax.Array  # (N,) bool


def _triad(p1, p2, q1, q2):
    """Closed-form rotation taking ray pair (p1, p2) to (q1, q2)."""

    def frame(a, b):
        e1 = a / (jnp.linalg.norm(a) + 1e-9)
        c = jnp.cross(a, b)
        e2 = c / (jnp.linalg.norm(c) + 1e-9)
        e3 = jnp.cross(e1, e2)
        return jnp.stack([e1, e2, e3], axis=-1)  # columns

    fp = frame(p1, p2)
    fq = frame(q1, q2)
    return so3.matmul(fq, fp.T)


def _kabsch(p, q, w):
    """Weighted least-squares rotation R minimizing sum w |q - R p|^2.

    Solved via the q-method (fixed-iteration, no SVD) so the whole estimator
    is shard_map/vmap-safe.
    """
    B = jnp.einsum("ni,nj,n->ij", q, p, w, precision=jax.lax.Precision.HIGHEST)
    return so3.rotation_from_correlation(B)


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def estimate_rotation(
    rays_prev: jax.Array,  # (N, 3) unit rays in the previous frame
    rays_curr: jax.Array,  # (N, 3) unit rays in the current frame
    valid: jax.Array,  # (N,) bool
    key: jax.Array,  # PRNG key (vary per frame)
    threshold_rad: float | jax.Array = 0.01,
    num_hypotheses: int = NUM_HYPOTHESES,
) -> RotationEstimate:
    """RANSAC + Kabsch rotation between two ray bundles.

    ``threshold_rad`` is the angular inlier gate; callers convert the
    reference's 8 px reprojection threshold via ``px / focal_length``.
    """
    n = rays_prev.shape[0]
    p = rays_prev / (jnp.linalg.norm(rays_prev, axis=-1, keepdims=True) + 1e-9)
    q = rays_curr / (jnp.linalg.norm(rays_curr, axis=-1, keepdims=True) + 1e-9)

    # Sample hypothesis pairs among VALID points with fixed shapes: one
    # stable argsort puts valid indices first, then each hypothesis draws
    # two distinct uniform indices into that prefix (the j >= i shift
    # guarantees distinctness). Replaces a masked-Gumbel top-2 PER
    # hypothesis — 100 top_k passes over the point set per frame were a
    # measurable slice of the analyse scan; same uniform-over-valid-pairs
    # distribution.
    order = jnp.argsort(~valid, stable=True)  # valid-first index order
    v = jnp.maximum(jnp.sum(valid), 2)

    def sample(k):
        k1, k2 = jax.random.split(k)
        i = jax.random.randint(k1, (), 0, v)
        j = jax.random.randint(k2, (), 0, v - 1)
        j = jnp.where(j >= i, j + 1, j)
        return jnp.stack([order[i], order[j]])

    keys = jax.random.split(key, num_hypotheses)
    pairs = jax.vmap(sample)(keys)  # (H, 2)

    def hypothesis(pair):
        i, j = pair[0], pair[1]
        return _triad(p[i], p[j], q[i], q[j])

    Rs = jax.vmap(hypothesis)(pairs)  # (H, 3, 3)

    # Score: angular error |q - R p| ~= angle for small errors.
    def score(R):
        pred = jnp.einsum("ij,nj->ni", R, p, precision=jax.lax.Precision.HIGHEST)
        err = jnp.linalg.norm(q - pred, axis=-1)
        inl = (err < threshold_rad) & valid
        return jnp.sum(inl), inl

    counts, inliers = jax.vmap(score)(Rs)
    best = jnp.argmax(counts)
    R = Rs[best]
    inl = inliers[best]

    # Two rounds of weighted Kabsch refinement on the running inlier set.
    for _ in range(2):
        w = inl.astype(jnp.float32)
        # Guard: Kabsch needs >= 2 points; keep the hypothesis otherwise.
        R_ref = _kabsch(p, q, w)
        R = jnp.where(jnp.sum(w) >= 2, R_ref, R)
        pred = jnp.einsum("ij,nj->ni", R, p, precision=jax.lax.Precision.HIGHEST)
        err = jnp.linalg.norm(q - pred, axis=-1)
        inl = (err < threshold_rad) & valid

    return RotationEstimate(
        rotation=R, num_inliers=jnp.sum(inl).astype(jnp.int32), inliers=inl
    )


def rotation_with_fallback(
    estimate: RotationEstimate,
    previous_rotation: jax.Array,
    min_inliers: int = MIN_INLIERS,
) -> jax.Array:
    """Reference's quality gate: distrust estimates with < 40 inliers and
    reuse the previous frame-to-frame rotation instead
    (``opencv/FrameSourceWarp.cpp:432-438``)."""
    return jnp.where(
        estimate.num_inliers >= min_inliers, estimate.rotation, previous_rotation
    )
