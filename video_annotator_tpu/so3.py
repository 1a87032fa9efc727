"""SO(3) utilities in pure JAX.

The reference accumulates camera rotations as 3x3 matrices
(``opencv/FrameSourceWarp.cpp:441-442``), converts RANSAC rotation vectors via
``cv::Rodrigues`` (``opencv/FrameSourceWarp.cpp:373``), and smooths rotation
trajectories on the SO(3) manifold with a Gram/Savitzky-Golay filter
(``opencv/FrameSourceWarp.cpp:212,444,471``).  These helpers provide the same
primitives as batched, jit-friendly functions: exp/log maps, Rodrigues,
orthonormal projection (for re-orthonormalizing long accumulated products,
which the reference implicitly gets from float64 CPU math), and Euler
composition for the CLI's ``--roll/--pitch/--yaw`` options (``src/cli.ts:46-63``).

All functions operate on float32 by default and support arbitrary leading
batch dimensions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Small 3x3 products must run at full float32 precision: a backend's default
# matmul precision may round inputs (TF32 on NVIDIA GPUs), which is
# catastrophic for accumulated rotation products.
matmul = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a (..., 3) vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat` for a (..., 3, 3) skew-symmetric matrix."""
    return jnp.stack(
        [W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1
    )


def exp(w: jax.Array) -> jax.Array:
    """SO(3) exponential map: rotation vector (..., 3) -> matrix (..., 3, 3).

    Equivalent to ``cv::Rodrigues`` vector->matrix
    (``opencv/FrameSourceWarp.cpp:373``). Uses the Taylor expansion of the
    coefficients near zero so it is differentiable and stable at the identity.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with stable small-angle forms.
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS), 0.5 - theta2 / 24.0
    )
    W = hat(w)
    # W^2 computed analytically (w w^T - theta^2 I): exact elementwise math,
    # immune to low default matmul precision on any backend.
    outer = w[..., :, None] * w[..., None, :]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    W2 = outer - theta2[..., None, None] * eye
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def to_quaternion(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z).

    Shepperd's method: compute all four candidate quaternions (one per
    largest diagonal/trace element) and select the numerically largest pivot —
    branch-free and stable over all of SO(3).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by its pivot 4*q_i^2 = 1 + 2*d_i - tr etc.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
        axis=-1,
    )
    k = jnp.argmax(pivots, axis=-1)
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cand, k[..., None, None], axis=-2)[..., 0, :]
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    # Canonical sign: w >= 0 (angle in [0, pi]).
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def log(R: jax.Array) -> jax.Array:
    """SO(3) logarithm map: matrix (..., 3, 3) -> rotation vector (..., 3).

    Equivalent to ``cv::Rodrigues`` matrix->vector. Goes through the
    quaternion representation, which is stable at the identity and near pi.
    """
    q = to_quaternion(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    sin_half = jnp.linalg.norm(qv, axis=-1)
    theta = 2.0 * jnp.arctan2(sin_half, qw)
    scale = jnp.where(sin_half > 1e-6, theta / jnp.maximum(sin_half, 1e-6), 2.0 / jnp.maximum(qw, _EPS))
    return qv * scale[..., None]


def orthonormalize(M: jax.Array) -> jax.Array:
    """One Newton-Schulz step toward the nearest rotation: R(3I - R^T R)/2.

    For inputs already within ~1e-3 of SO(3) — the accumulated products
    ``R_t = dR . R_{t-1}`` whose factors are rotations up to float32
    rounding — one step lands within squared error of the true polar
    projection at the cost of two small matmuls instead of a per-frame
    3x3 SVD (scalar-iterative, and the analyse scan runs it per frame). NOT a substitute for :func:`project` on general
    matrices (elementwise-averaged rotation windows etc.).
    """
    eye = jnp.broadcast_to(jnp.eye(3, dtype=M.dtype), M.shape)
    return matmul(M, (3.0 * eye - matmul(jnp.swapaxes(M, -1, -2), M))) * 0.5


def project(M: jax.Array) -> jax.Array:
    """Project a (..., 3, 3) matrix onto SO(3) (nearest rotation, polar/SVD).

    Used to re-orthonormalize accumulated rotation products
    (``R_t = dR . R_{t-1}``, ``opencv/FrameSourceWarp.cpp:441``) in float32,
    and to map elementwise-filtered rotation windows back to the manifold
    (the gram_sg RotationFilter's reprojection step).
    """
    u, _, vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(matmul(u, vt))
    d = jnp.concatenate(
        [jnp.ones(M.shape[:-2] + (2,), M.dtype), det[..., None]], axis=-1
    )
    return matmul(u * d[..., None, :], vt)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) as (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotation_from_correlation(B: jax.Array, iters: int = 120) -> jax.Array:
    """Wahba solution from correlation B = sum_i w_i q_i p_i^T: the proper
    rotation R maximizing tr(R B^T) — i.e. nearest rotation in the weighted
    least-squares sense, like :func:`project` of B but guaranteed det=+1 and
    free of data-dependent while loops (Davenport q-method; the dominant
    eigenvector of the 4x4 K matrix found with a fixed-iteration shifted
    power method). Safe inside ``shard_map``/``vmap`` where SVD's internal
    while_loop is problematic.
    """
    b00, b01, b02 = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    b10, b11, b12 = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    b20, b21, b22 = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    tr = b00 + b11 + b22
    z1 = b21 - b12
    z2 = b02 - b20
    z3 = b10 - b01
    K = jnp.stack(
        [
            jnp.stack([tr, z1, z2, z3], axis=-1),
            jnp.stack([z1, b00 - b11 - b22, b01 + b10, b02 + b20], axis=-1),
            jnp.stack([z2, b01 + b10, b11 - b00 - b22, b12 + b21], axis=-1),
            jnp.stack([z3, b02 + b20, b12 + b21, b22 - b00 - b11], axis=-1),
        ],
        axis=-2,
    )
    # Shift so the maximum eigenvalue dominates in magnitude.
    shift = 2.0 * jnp.linalg.norm(B, axis=(-2, -1), keepdims=True) + 1e-6
    Ks = K + shift * jnp.broadcast_to(jnp.eye(4, dtype=B.dtype), K.shape)

    def _power(v):
        for _ in range(iters):
            v = jnp.einsum(
                "...ij,...j->...i", Ks, v,
                precision=jax.lax.Precision.HIGHEST,
            )
            v = v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + _EPS)
        return v

    # Two independent starts, keep the higher Rayleigh quotient: the
    # fixed all-ones start is EXACTLY orthogonal to the optimum whenever
    # its quaternion satisfies w+x+y+z == 0 (e.g. the 180-degree
    # rotation about (1,-1,0)/sqrt(2)), and orthogonality survives every
    # iteration. The one-hot start at the largest K diagonal is the
    # Shepperd pivot — the optimum's largest component for near-rotation
    # B — which is nonzero precisely where ones can fail.
    ones = jnp.ones(K.shape[:-1], B.dtype)
    diag = jnp.diagonal(K, axis1=-2, axis2=-1)
    pivot = jax.nn.one_hot(jnp.argmax(diag, axis=-1), 4, dtype=B.dtype)
    va = _power(ones)
    vb = _power(pivot)
    ra = jnp.einsum("...i,...ij,...j->...", va, K, va,
                    precision=jax.lax.Precision.HIGHEST)
    rb = jnp.einsum("...i,...ij,...j->...", vb, K, vb,
                    precision=jax.lax.Precision.HIGHEST)
    v = jnp.where((ra >= rb)[..., None], va, vb)
    return quat_to_matrix(v)


def from_euler(roll: jax.Array, pitch: jax.Array, yaw: jax.Array) -> jax.Array:
    """Rotation from the CLI's camera-attitude angles, in radians.

    ``--roll`` turns the camera clockwise, ``--pitch`` turns it up, ``--yaw``
    turns it left (``src/cli.ts:46-63``). Composition order: yaw * pitch * roll
    applied to camera rays (Rz(roll) then Rx(pitch) then Ry(yaw)).
    """
    roll = jnp.asarray(roll, jnp.float32)
    pitch = jnp.asarray(pitch, jnp.float32)
    yaw = jnp.asarray(yaw, jnp.float32)
    cz, sz = jnp.cos(roll), jnp.sin(roll)
    cx, sx = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    rz = jnp.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]], jnp.float32)
    rx = jnp.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]], jnp.float32)
    ry = jnp.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]], jnp.float32)
    return matmul(ry, matmul(rx, rz))


def slerp(R0: jax.Array, R1: jax.Array, t: jax.Array) -> jax.Array:
    """Geodesic interpolation between rotations: R0 * exp(t * log(R0^T R1))."""
    rel = matmul(jnp.swapaxes(R0, -1, -2), R1)
    return matmul(R0, exp(t[..., None] * log(rel)))
