"""Data parallelism: a batch of independent streams across the mesh.

The reference gets throughput by running N ffmpeg processes over separate
clips (analyse queue 2 / encode queue 4, ``src/render.ts:21-22``; xargs -P
workers in ``concat.sh:197-251``). On a device mesh the same scaling is one
sharded program: frames batched over a ``data`` axis with per-stream
rotations, and XLA runs every stream's warp in parallel.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from video_annotator_tpu.camera import Camera
from video_annotator_tpu.ops.warp_xla import compute_warp_map, bilinear_sample


def warp_streams_sharded(
    frames: jax.Array,  # (B, H, W) float32, one frame per stream
    rotations: jax.Array,  # (B, 3, 3)
    out_camera: Camera,
    in_camera: Camera,
    mesh: Mesh,
    data_axis: str = "data",
    space_axis: str | None = "space",
    out_size=None,
) -> jax.Array:
    """Warp a batch of per-stream frames, sharded over streams (and
    optionally output rows). Inputs only need to live on the devices that
    read them."""
    if out_size is None:
        out_size = (out_camera.height, out_camera.width)
    if space_axis is not None and out_size[0] % mesh.shape[space_axis]:
        # Output rows not divisible by the space axis (odd auto-fit
        # heights): pad the row grid up to a multiple, warp sharded, crop.
        # The extra rows unproject below the output image and sample
        # clamped/zero like any out-of-frame pixel — pure crop fodder —
        # so TP stays available for EVERY auto-fit camera instead of
        # silently degrading to stream-only sharding.
        ns = mesh.shape[space_axis]
        pad_h = -(-out_size[0] // ns) * ns
        padded = warp_streams_sharded(
            frames, rotations, out_camera, in_camera, mesh,
            data_axis, space_axis, out_size=(pad_h, out_size[1]),
        )
        return padded[:, : out_size[0]]

    def one(frame, rot):
        coords = compute_warp_map(out_camera, in_camera, rot, out_size)
        return bilinear_sample(frame, coords)

    fn = jax.vmap(one)
    in_spec = P(data_axis, None, None)
    rot_spec = P(data_axis, None, None)
    out_spec = (
        P(data_axis, space_axis, None) if space_axis else P(data_axis, None, None)
    )
    jitted = jax.jit(
        fn,
        in_shardings=(NamedSharding(mesh, in_spec), NamedSharding(mesh, rot_spec)),
        out_shardings=NamedSharding(mesh, out_spec),
    )
    return jitted(frames, rotations)


def warp_yuv_streams_sharded(
    warp_batch,
    ys: jax.Array,  # (B, H, W) luma, one frame per stream
    us: jax.Array,  # (B, H/2, W/2)
    vs: jax.Array,  # (B, H/2, W/2)
    params: jax.Array,  # (B, ...) per-stream warp parameters
    mesh: Mesh,
    data_axis: str = "data",
):
    """Stream-parallel (DP) warp for ANY per-batch YUV warp function —
    the multi-device encode path of every stabilizer family.

    The rotation family passes ``FrameWarper.warp_frames`` with (B, 3, 3)
    rotations; the similarity/vidstab and deshake families
    (``models/similarity.py``, ``models/deshake.py`` — the reference's
    ``--filter vidstab``/``deshake`` pipelines, ``src/render.ts:913-989``)
    pass a vmapped per-frame warp with a (B, ...) parameter vector. The
    batched warp runs unchanged inside a ``shard_map`` DP shard.
    Per-stream math is independent — zero collectives, and the sharded
    output equals the unsharded call per stream
    (``tests/test_parallel.py::test_warp_yuv_streams_sharded_*``).

    ``warp_batch(ys, us, vs, params) -> (wy, wu, wv)`` must accept the
    local (B/n, ...) shard arrays.
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    nd = mesh.shape[data_axis]
    assert ys.shape[0] % nd == 0, (ys.shape, nd)
    p_spec = P(data_axis, *([None] * (params.ndim - 1)))
    plane = P(data_axis, None, None)

    import inspect

    flag = (
        "check_vma"
        if "check_vma" in inspect.signature(shard_map).parameters
        else "check_rep"
    )
    fn = shard_map(
        warp_batch,
        mesh=mesh,
        in_specs=(plane, plane, plane, p_spec),
        out_specs=(plane, plane, plane),
        **{flag: False},
    )
    return jax.jit(fn)(ys, us, vs, params)
