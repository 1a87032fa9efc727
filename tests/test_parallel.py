"""Multi-device sharding paths on the virtual 8-device CPU mesh.

Each sharded collective pattern must be numerically identical (or equal
within float tolerance) to its single-device counterpart — the sharding
is an execution detail, never a semantics change.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.camera import (
    CameraPreset,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu.parallel.mesh import make_mesh
from video_annotator_tpu.parallel.streams import warp_streams_sharded
from video_annotator_tpu.parallel.temporal import (
    distributed_accumulate_rotations,
    smooth_rotations_sharded,
)
from video_annotator_tpu.smoothing.savgol import smooth_rotations


def _random_rotations(t, scale=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return so3.exp(jnp.asarray(rng.normal(size=(t, 3)) * scale, jnp.float32))


def test_make_mesh_factors_devices():
    mesh = make_mesh()
    assert int(np.prod(list(mesh.shape.values()))) == len(jax.devices())
    mesh2 = make_mesh(4, axis_names=("time",))
    assert mesh2.shape["time"] == 4


def test_sharded_smoothing_matches_global():
    mesh = make_mesh(4, axis_names=("time",))
    t, radius = 64, 8  # 16 frames/shard >= radius
    rots = _random_rotations(t)
    got = np.asarray(smooth_rotations_sharded(rots, radius, mesh))
    want = np.asarray(smooth_rotations(rots, radius))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sharded_smoothing_single_shard_degenerate():
    mesh = make_mesh(1, axis_names=("time",))
    rots = _random_rotations(32, seed=2)
    got = np.asarray(smooth_rotations_sharded(rots, 6, mesh))
    want = np.asarray(smooth_rotations(rots, 6))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_distributed_prefix_product_matches_sequential():
    mesh = make_mesh(8, axis_names=("time",))
    t = 64
    deltas = _random_rotations(t, seed=3)
    got = np.asarray(distributed_accumulate_rotations(deltas, mesh))
    acc = np.eye(3, dtype=np.float32)
    want = []
    for i in range(t):
        acc = np.asarray(deltas[i]) @ acc
        want.append(acc.copy())
    np.testing.assert_allclose(got, np.stack(want), atol=1e-4)


def test_warp_streams_sharded_matches_single():
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (128, 96))
    out_cam = get_output_camera(in_cam, scale=1.0, crop_borders=True)
    mesh = make_mesh(8, axis_names=("data", "space"))
    rng = np.random.default_rng(5)
    frames = jnp.asarray(rng.uniform(0, 255, (8, 96, 128)).astype(np.float32))
    rots = _random_rotations(8, seed=6)
    from video_annotator_tpu.ops.warp_xla import (
        bilinear_sample,
        compute_warp_map,
    )

    # Odd heights pad the row grid to the space axis and crop back
    # — (41, 64) exercises that; (40, 64) is the
    # aligned 2D (data, space) sharding; None is the auto-fit camera.
    for out_size in (None, (40, 64), (41, 64)):
        size = out_size or (out_cam.height, out_cam.width)
        out = warp_streams_sharded(
            frames, rots, out_cam, in_cam, mesh, out_size=out_size
        )
        for b in range(8):
            coords = compute_warp_map(out_cam, in_cam, rots[b], size)
            want = np.asarray(bilinear_sample(frames[b], coords))
            # map math runs at a different matmul precision under pjit;
            # coords differing by ~1e-4 px move bilinear values by ~2e-2
            np.testing.assert_allclose(np.asarray(out[b]), want, atol=5e-2)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "lanczos"])
def test_warp_yuv_streams_sharded_rotation_matches_unsharded(interp):
    """The rotation family's batched uint8 YUV warp
    (``FrameWarper.warp_frames``, the encode hot path) inside the DP
    shard_map wrapper equals the unsharded batched warp per stream, up to
    float32 rounding."""
    from video_annotator_tpu.parallel.streams import warp_yuv_streams_sharded
    from video_annotator_tpu.pipeline.render import FrameWarper

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (128, 96))
    out_cam = get_output_camera(in_cam, scale=1.0, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam, interp=interp)
    rng = np.random.default_rng(7)
    b, h, w = 4, 96, 128
    ys = jnp.asarray(rng.integers(0, 256, (b, h, w), dtype=np.uint8))
    us = jnp.asarray(rng.integers(0, 256, (b, h // 2, w // 2), dtype=np.uint8))
    vs = jnp.asarray(rng.integers(0, 256, (b, h // 2, w // 2), dtype=np.uint8))
    rots = _random_rotations(b, scale=0.02, seed=8)

    mesh = make_mesh(4, axis_names=("data",))
    got = warp_yuv_streams_sharded(warper.warp_frames, ys, us, vs, rots, mesh)
    want = warper.warp_frames(ys, us, vs, rots)
    for g, w_ in zip(got, want):
        assert g.dtype == jnp.uint8 and g.shape == w_.shape
        # Two compilations of the same float32 map may differ in the last
        # bit, which flips the rounding of an odd pixel by one level.
        d = np.abs(np.asarray(g).astype(int) - np.asarray(w_).astype(int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999


def _yuv_batch(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    ys = jnp.asarray(rng.uniform(0, 255, (b, h, w)).astype(np.float32))
    us = jnp.asarray(rng.uniform(0, 255, (b, h // 2, w // 2)).astype(np.float32))
    vs = jnp.asarray(rng.uniform(0, 255, (b, h // 2, w // 2)).astype(np.float32))
    return ys, us, vs


def test_warp_yuv_streams_sharded_similarity_matches_unsharded():
    """The similarity (vidstab) family's DP shard_map path equals the
    unsharded per-frame warp bit-for-bit — sharding the 2D families is
    an execution detail exactly like the rotation family
    (reference scope src/render.ts:913-989)."""
    from video_annotator_tpu.models.similarity import warp_frame_similarity
    from video_annotator_tpu.parallel.streams import warp_yuv_streams_sharded

    b, h, w = 4, 48, 64
    ys, us, vs = _yuv_batch(b, h, w, seed=11)
    params = jnp.asarray(
        np.stack([
            [2.0, -1.5, 0.02, 0.01],
            [-3.0, 1.0, -0.01, -0.02],
            [0.5, 0.5, 0.0, 0.03],
            [0.0, 0.0, 0.0, 0.0],
        ]).astype(np.float32)
    )
    mesh = make_mesh(4, axis_names=("data",))
    warp_batch = jax.vmap(warp_frame_similarity)
    wy, wu, wv = warp_yuv_streams_sharded(
        warp_batch, ys, us, vs, params, mesh
    )
    for i in range(b):
        ry, ru, rv = warp_frame_similarity(ys[i], us[i], vs[i], params[i])
        np.testing.assert_array_equal(np.asarray(wy[i]), np.asarray(ry))
        np.testing.assert_array_equal(np.asarray(wu[i]), np.asarray(ru))
        np.testing.assert_array_equal(np.asarray(wv[i]), np.asarray(rv))


def test_warp_yuv_streams_sharded_deshake_matches_unsharded():
    """The deshake family (translation + blurred-edge fill) under the
    same DP shard_map wrapper, including the Gaussian background blur."""
    from video_annotator_tpu.models.deshake import warp_frame_deshake
    from video_annotator_tpu.parallel.streams import warp_yuv_streams_sharded

    b, h, w = 4, 48, 64
    ys, us, vs = _yuv_batch(b, h, w, seed=12)
    offsets = jnp.asarray(
        np.stack([[3.5, -2.25], [-6.0, 1.5], [0.0, 0.0], [10.25, 7.75]])
        .astype(np.float32)
    )
    mesh = make_mesh(4, axis_names=("data",))
    warp_batch = jax.vmap(
        lambda y, u, v, off: warp_frame_deshake(y, u, v, off,
                                                blur_edges=True)
    )
    wy, wu, wv = warp_yuv_streams_sharded(
        warp_batch, ys, us, vs, offsets, mesh
    )
    for i in range(b):
        ry, ru, rv = warp_frame_deshake(ys[i], us[i], vs[i], offsets[i],
                                        blur_edges=True)
        np.testing.assert_allclose(np.asarray(wy[i]), np.asarray(ry),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(wu[i]), np.asarray(ru),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(wv[i]), np.asarray(rv),
                                   atol=1e-4)
