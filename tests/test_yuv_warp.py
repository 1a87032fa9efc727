"""The batched uint8 YUV 4:2:0 warp (``FrameWarper``), the encode hot path.

One jitted dispatch per batch: stacked uint8 planes in, uint8 planes out.
Checked against per-frame warps of the same code, against the float64
NumPy reference (``ops/warp_ref.py``) for every ``--projection`` model and
resampler, and for the rolling-shutter stack, the chroma neutral border,
the behind-camera guard and the global mip prefilter.
"""

from fractions import Fraction

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.camera import (
    CameraModel,
    CameraPreset,
    camera_from_dfov,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu.io.video import VideoMeta
from video_annotator_tpu.ops.warp_ref import sample_np, warp_map_np, warp_yuv420_np
from video_annotator_tpu.ops.warp_xla import to_uint8, warp_yuv420_xla
from video_annotator_tpu.pipeline.render import (
    PROJECTION_MODELS,
    FrameWarper,
    RenderOptions,
    build_cameras,
)

# One CLI name per output lens model (the 10 distinct --projection models).
PROJECTIONS = sorted({m: n for n, m in reversed(PROJECTION_MODELS.items())}
                     .values())
INTERPS = ["bilinear", "bicubic", "lanczos"]


def _planes(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ys = [np.clip(128 + 70 * np.sin(xx / (5.0 + i)) * np.cos(yy / 7.0)
                  + rng.normal(size=(h, w)) * 12, 0, 255).astype(np.uint8)
          for i in range(b)]
    us = [rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
          for _ in range(b)]
    vs = [rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
          for _ in range(b)]
    return ys, us, vs


def _rots(b, scale=0.02, seed=1):
    rng = np.random.default_rng(seed)
    return jnp.stack([so3.exp(jnp.asarray(x, jnp.float32))
                      for x in rng.normal(size=(b, 3)) * scale])


def _close(got, want, min_identical=0.99):
    """uint8 planes within 1 level everywhere, identical almost everywhere
    (float32 device map vs float64 reference: last-bit coordinate
    differences flip the rounding of a few pixels)."""
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= min_identical, (d == 0).mean()


def test_projection_names_cover_every_model():
    assert len(PROJECTIONS) == 10
    assert {PROJECTION_MODELS[n] for n in PROJECTIONS} == set(
        PROJECTION_MODELS.values())


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("projection", PROJECTIONS)
def test_warp_yuv_batch_matches_frames_and_oracle(projection, interp):
    """One batched dispatch == per-frame warps == the float64 reference."""
    w, h = 96, 72
    meta = VideoMeta(w, h, Fraction(30, 1), 2)
    in_cam, out_cam = build_cameras(
        meta, RenderOptions(projection=projection, width=80, height=60,
                            output_dfov=120.0))
    warper = FrameWarper(in_cam, out_cam, interp=interp)
    ys, us, vs = _planes(2, h, w, seed=3)
    rots = _rots(2)
    outs = warper.warp_yuv_batch(
        tuple(map(jnp.asarray, ys)), tuple(map(jnp.asarray, us)),
        tuple(map(jnp.asarray, vs)), rots)
    assert len(outs) == 2
    size = (warper.out_h, warper.out_w)
    for i, triple in enumerate(outs):
        assert [p.dtype for p in triple] == [jnp.uint8] * 3
        assert triple[0].shape == size
        assert triple[1].shape == triple[2].shape == (size[0] // 2,
                                                      size[1] // 2)
        solo = [to_uint8(p) for p in warp_yuv420_xla(
            jnp.asarray(ys[i]), jnp.asarray(us[i]), jnp.asarray(vs[i]),
            out_cam, in_cam, rots[i], size, interp=interp)]
        ref = warp_yuv420_np(ys[i], us[i], vs[i], out_cam, in_cam,
                             np.asarray(rots[i]), size, interp=interp)
        for got, one, want in zip(triple, solo, ref):
            _close(got, one, min_identical=0.999)
            _close(got, want)


def test_warp_yuv_is_a_batch_of_one():
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (96, 72))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)
    ys, us, vs = _planes(1, 72, 96)
    rot = _rots(1)[0]
    one = warper.warp_yuv(ys[0], us[0], vs[0], rot)
    batch = warper.warp_yuv_batch(ys, us, vs, rot[None])[0]
    for a, b in zip(one, batch):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Warpers of one geometry share the compiled batch function.
    assert FrameWarper(in_cam, out_cam)._warp_batch is warper._warp_batch


def test_rolling_shutter_stack_matches_oracle():
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (128, 96))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)
    n_bands = -(-warper.out_h // 8)
    stacks = jnp.stack([
        jnp.stack([so3.exp(jnp.asarray([0.0, 0.02 * j / n_bands, 0.01 * b],
                                       jnp.float32))
                   for j in range(n_bands)])
        for b in range(2)
    ])
    ys, us, vs = _planes(2, 96, 128, seed=5)
    outs = warper.warp_yuv_batch(ys, us, vs, stacks)
    size = (warper.out_h, warper.out_w)
    for i, triple in enumerate(outs):
        ref = warp_yuv420_np(ys[i], us[i], vs[i], out_cam, in_cam,
                             np.asarray(stacks[i]), size)
        for got, want in zip(triple, ref):
            _close(got, want)


def test_chroma_border_is_neutral_and_luma_border_black():
    """A large rotation reveals border: luma 0, chroma 128 (black video,
    not green)."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (96, 72))
    out_cam = camera_from_dfov(90.0, (96, 72), CameraModel.RECTILINEAR)
    warper = FrameWarper(in_cam, out_cam)
    y = np.full((72, 96), 200, np.uint8)
    u = np.full((36, 48), 30, np.uint8)
    v = np.full((36, 48), 220, np.uint8)
    rot = so3.exp(jnp.asarray([0.0, 1.2, 0.0], jnp.float32))
    wy, wu, wv = (np.asarray(p) for p in warper.warp_yuv(y, u, v, rot))
    assert (wy == 0).mean() > 0.2 and (wy == 200).mean() > 0.1
    assert (wu == 128).mean() > 0.2 and (wv == 128).mean() > 0.2
    border = wy[::2, ::2] == 0
    assert (wu[border] == 128).mean() > 0.95
    assert (wv[border] == 128).mean() > 0.95


def test_behind_camera_rays_render_border():
    """An equirect output looking past 90 deg off-axis from a pinhole
    input: rays behind the input camera must render border, not mirror
    through the perspective divide into the frame."""
    in_cam = camera_from_dfov(90.0, (96, 72), CameraModel.RECTILINEAR)
    out_cam = camera_from_dfov(300.0, (96, 48), CameraModel.EQUIRECT)
    warper = FrameWarper(in_cam, out_cam)
    y = np.full((72, 96), 255, np.uint8)
    c = np.full((36, 48), 128, np.uint8)
    wy, _, _ = warper.warp_yuv(y, c, c, jnp.eye(3))
    cmap = warp_map_np(out_cam, in_cam, np.eye(3), (48, 96))
    ys_, xs_ = np.mgrid[0:48, 0:96]
    rays_behind = np.abs((xs_ - float(out_cam.cx)) / float(out_cam.fx)) > (
        np.pi / 2 + 0.1)
    assert rays_behind.any()
    assert (np.asarray(wy)[rays_behind] == 0).all()
    assert (cmap[rays_behind] < -1e5).all()
    assert (np.asarray(wy) == 255).any()


def test_to_uint8_rounds_and_saturates():
    got = np.asarray(to_uint8(jnp.asarray([-3.0, 0.49, 0.5, 1.5, 254.6, 300.0])))
    np.testing.assert_array_equal(got, [0, 0, 0, 2, 255, 255])
    assert got.dtype == np.uint8


def test_reference_sampler_matches_xla_samplers():
    """The float64 reference samplers agree with the device samplers on
    float input at random subpixel coordinates, border included."""
    from video_annotator_tpu.ops.warp_xla import _SAMPLERS

    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (40, 56))
    coords = rng.uniform(-3, 59, (30, 20, 2))
    for interp, fn in _SAMPLERS.items():
        got = np.asarray(fn(jnp.asarray(img, jnp.float32),
                            jnp.asarray(coords, jnp.float32)))
        np.testing.assert_allclose(got, sample_np(img, coords, interp),
                                   atol=2e-2, err_msg=interp)


# --- global mip prefilter -------------------------------------------------


def test_box_downsample_and_mip_camera():
    from video_annotator_tpu.ops.mip import box_downsample, mip_camera
    from video_annotator_tpu.ops.warp_xla import _scaled_camera

    img = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    d = np.asarray(box_downsample(img, 1))
    # rows: [0 1 2 3; 4 5 6 7; 8 9 10 11]; odd height edge-replicates row 2.
    np.testing.assert_allclose(d, [[2.5, 4.5], [8.5, 10.5]])
    assert box_downsample(img, 0) is img

    cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    m1 = mip_camera(cam, 1)
    s1 = _scaled_camera(cam, 0.5)
    for f in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(float(getattr(m1, f)), float(getattr(s1, f)))
    assert (m1.width, m1.height) == (160, 120)
    # Two levels compose: scale factors multiply, dims ceil-halve twice.
    m2 = mip_camera(cam, 2)
    np.testing.assert_allclose(float(m2.fx), float(cam.fx) * 0.25)
    assert (m2.width, m2.height) == (80, 60)
    assert mip_camera(cam, 0) is cam


def test_mip_prefilter_level_selection():
    from video_annotator_tpu.ops.mip import mip_prefilter_level

    in_cam = get_preset_camera(
        CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (1280, 960)
    )
    # Same-scale output: no pixel minifies 2x -> level 0.
    out_full = get_output_camera(in_cam, scale=1.0, crop_borders=True)
    assert mip_prefilter_level(
        out_full, in_cam, (out_full.height, out_full.width)
    ) == 0
    # Quarter-res output: every pixel minifies >= 2x -> level >= 1.
    out_q = get_output_camera(in_cam, scale=0.25, crop_borders=True)
    assert mip_prefilter_level(out_q, in_cam, (out_q.height, out_q.width)) >= 1


def test_prefilter_warp_is_downsample_then_mip_camera_warp():
    """prefilter=True inside the dispatch == explicit box downsample and a
    warp from the mip level's camera."""
    from video_annotator_tpu.ops.mip import box_downsample, mip_camera

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    out_cam = get_output_camera(in_cam, scale=0.25, crop_borders=True)
    pre = FrameWarper(in_cam, out_cam, prefilter=True)
    assert pre.mip >= 1
    ys, us, vs = _planes(1, 240, 320, seed=4)
    rot = _rots(1)[0]
    got = pre.warp_yuv(ys[0], us[0], vs[0], rot)
    want = [to_uint8(p) for p in warp_yuv420_xla(
        *(box_downsample(jnp.asarray(p), pre.mip) for p in (ys[0], us[0],
                                                            vs[0])),
        out_cam, mip_camera(in_cam, pre.mip), rot,
        (pre.out_h, pre.out_w))]
    for g, w_ in zip(got, want):
        _close(g, w_, min_identical=0.999)


def test_frame_warper_prefilter_keeps_smooth_content():
    """The global prefilter is a real low-pass; on smooth content it
    still meets the repo-wide 45 dB fidelity standard."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (640, 480))
    out_cam = get_output_camera(in_cam, scale=0.25, crop_borders=True)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    y = (128 + 60 * np.sin(xx / 40.0) * np.cos(yy / 40.0)).astype(np.uint8)
    u = np.full((240, 320), 90, np.uint8)
    v = np.full((240, 320), 160, np.uint8)
    rot = so3.exp(jnp.array([0.01, 0.0, -0.01]))

    plain = FrameWarper(in_cam, out_cam)
    pre = FrameWarper(in_cam, out_cam, prefilter=True)
    assert plain.mip == 0 and pre.mip >= 1
    a = np.asarray(plain.warp_yuv(y, u, v, rot)[0]).astype(np.float64)
    b = np.asarray(pre.warp_yuv(y, u, v, rot)[0]).astype(np.float64)
    mask = (a > 1) & (b > 1)
    mse = float(np.mean((a[mask] - b[mask]) ** 2))
    assert 10 * np.log10(255.0**2 / max(mse, 1e-9)) > 45.0


# --- helpers that moved out of the retired kernel module ------------------


def test_camera_key_round_trip():
    from video_annotator_tpu.ops.warp_xla import camera_from_key, camera_key

    cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    key = camera_key(cam)
    hash(key)
    back = camera_from_key(key)
    assert camera_key(back) == key
    assert isinstance(back.fx, np.floating)  # trace-time constant
    assert (back.width, back.height, back.model) == (320, 240, cam.model)


def test_chroma_row_rotations_take_every_other_luma_band():
    from video_annotator_tpu.ops.warp_xla import chroma_row_rotations

    rot_y = jnp.arange(5 * 9, dtype=jnp.float32).reshape(5, 3, 3)
    got = np.asarray(chroma_row_rotations(rot_y, 3))
    np.testing.assert_array_equal(got, np.asarray(rot_y)[[0, 2, 4]])
    # Past the luma stack's end, the last band repeats.
    got4 = np.asarray(chroma_row_rotations(rot_y, 4))
    np.testing.assert_array_equal(got4[3], np.asarray(rot_y)[4])


def test_similarity_matrix_is_the_sampling_map():
    """``similarity_matrix(p) @ (x, y, 1)`` is where ``warp_similarity``
    samples (the cv2.warpAffine WARP_INVERSE_MAP matrix of the fidelity
    oracle)."""
    from video_annotator_tpu.ops.affine import similarity_matrix, warp_similarity

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    p = jnp.asarray([2.5, -1.25, 0.03, 0.02], jnp.float32)
    m = np.asarray(similarity_matrix(p), np.float64)
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float64)
    src = np.einsum("ij,hwj->hwi", m,
                    np.stack([xx, yy, np.ones_like(xx)], -1))[..., :2]
    got = np.asarray(warp_similarity(jnp.asarray(img), p))
    np.testing.assert_allclose(got, sample_np(img, src), atol=2e-2)


def test_warp_frames_is_one_jitted_dispatch():
    """The batch function traces once per batch shape: a second call with
    new data reuses the executable."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (64, 48))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam, interp="bicubic")
    ys, us, vs = _planes(2, 48, 64, seed=7)
    stack = [jnp.stack(list(map(jnp.asarray, p))) for p in (ys, us, vs)]
    warper.warp_frames(*stack, _rots(2))
    before = warper.warp_frames._cache_size()
    ys2, us2, vs2 = _planes(2, 48, 64, seed=8)
    stack2 = [jnp.stack(list(map(jnp.asarray, p))) for p in (ys2, us2, vs2)]
    out = warper.warp_frames(*stack2, _rots(2, seed=3))
    assert warper.warp_frames._cache_size() == before
    assert all(o.dtype == jnp.uint8 for o in jax.tree_util.tree_leaves(out))
