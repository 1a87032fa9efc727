"""End-to-end pipeline tests on synthetic ground-truth footage."""

import numpy as np
import pytest

import jax.numpy as jnp

from video_annotator_tpu import so3
from video_annotator_tpu.io.synthetic import SyntheticCamera, SyntheticSource
from video_annotator_tpu.io.video import open_reader
from video_annotator_tpu.pipeline.render import (
    RenderOptions,
    analyse,
    compute_corrections,
    render,
)
from video_annotator_tpu.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu.camera import CameraPreset

SRC = "synthetic://shaky?w=320&h=240&n=40&seed=3&shake=0.003&pan=0.001"
OPTS = dict(preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)


@pytest.fixture(scope="module")
def traj():
    return analyse(SRC, RenderOptions(**OPTS))


def test_analyse_recovers_ground_truth(traj):
    cfg = SyntheticSource.from_uri(SRC).config
    w_true = cfg.rotation_vectors()  # R_t applied to rays; camera C_t = R_t^-1
    R_true = np.asarray(so3.exp(jnp.asarray(w_true)))
    # estimated accumulated rotation ~= R_t^-1 R_0
    R_expect = R_true.transpose(0, 2, 1) @ R_true[0]
    R_est = traj.rotations()
    errs = []
    for t in range(traj.num_frames):
        errs.append(
            np.linalg.norm(np.asarray(so3.log(jnp.asarray(R_est[t] @ R_expect[t].T))))
        )
    errs = np.degrees(np.asarray(errs))
    assert errs.max() < 0.35, errs.max()  # < 0.35 degree drift over 40 frames


def test_analyse_chunked_matches_per_frame(traj):
    """The lax.scan chunked analyse (default) and per-frame dispatches
    (--analysis-chunk 1, the streaming path's shape) produce the SAME
    trajectory — chunking only amortizes dispatch overhead. The module
    fixture runs the default chunked path; re-run per-frame and compare,
    at a chunk size that forces a padded tail flush too."""
    per_frame = analyse(SRC, RenderOptions(analysis_chunk=1, **OPTS))
    odd_chunk = analyse(SRC, RenderOptions(analysis_chunk=7, **OPTS))
    np.testing.assert_allclose(
        traj.params, per_frame.params, atol=1e-5)
    np.testing.assert_allclose(
        traj.params, odd_chunk.params, atol=1e-5)


def test_analyse_half_scale_matches_full(traj):
    """--analysis-scale 0.5 (the reference demo's tracking scale,
    opencv/DisplayImage.cpp:49-57) estimates the same camera trajectory
    to sub-tenth-degree accuracy at a quarter of the tracking cost."""
    half = analyse(SRC, RenderOptions(analysis_scale=0.5, **OPTS))
    R_full = traj.rotations()
    R_half = half.rotations()
    assert half.num_frames == traj.num_frames
    errs = [
        np.degrees(np.linalg.norm(np.asarray(
            so3.log(jnp.asarray(R_half[t] @ R_full[t].T))
        )))
        for t in range(traj.num_frames)
    ]
    assert max(errs) < 0.2, max(errs)


def test_trajectory_roundtrip(tmp_path, traj):
    p = str(tmp_path / "x.npz")
    traj.save(p)
    back = Trajectory.load(p)
    np.testing.assert_allclose(back.rotvecs, traj.rotvecs)
    assert back.fps == traj.fps


def test_corrections_smooth_less_than_measured(traj):
    o = RenderOptions(stabilise="smooth", stabilise_radius=10, **OPTS)
    corr = compute_corrections(traj, o)
    ang = np.linalg.norm(np.asarray(so3.log(jnp.asarray(corr))), axis=-1)
    # corrections only cancel jitter: small angles
    assert np.degrees(ang.max()) < 2.0


def test_render_end_to_end_stabilizes(tmp_path):
    """Full render: the stabilized output should move less frame-to-frame
    than an unstabilized render of the same shaky clip."""
    src = "synthetic://shaky?w=256&h=192&n=24&seed=5&shake=0.004&pan=0.0"
    out_shaky = str(tmp_path / "shaky.y4m")
    out_smooth = str(tmp_path / "smooth.y4m")
    render(src, out_shaky, RenderOptions(stabilise="none", **OPTS))
    render(
        src,
        out_smooth,
        RenderOptions(stabilise="smooth", stabilise_radius=8, **OPTS),
    )

    def mean_abs_diff(path):
        r = open_reader(path)
        prev = None
        diffs = []
        for y, _, _ in r:
            cur = y.astype(np.float32)
            if prev is not None:
                # central crop to dodge border in/out effects
                h, w = cur.shape
                c = (slice(h // 4, 3 * h // 4), slice(w // 4, 3 * w // 4))
                diffs.append(np.abs(cur[c] - prev[c]).mean())
            prev = cur
        r.close()
        return np.mean(diffs)

    d_shaky = mean_abs_diff(out_shaky)
    d_smooth = mean_abs_diff(out_smooth)
    assert d_smooth < d_shaky * 0.55, (d_shaky, d_smooth)


def test_analyse_only_then_encode_only(tmp_path):
    src = "synthetic://shaky?w=256&h=192&n=12&seed=6"
    dest = str(tmp_path / "o.y4m")
    render(src, dest, RenderOptions(stabilise="smooth", analyse_only=True, **OPTS))
    import os

    assert os.path.exists(trajectory_path(dest))
    assert not os.path.exists(dest)
    render(src, dest, RenderOptions(stabilise="smooth", encode_only=True, **OPTS))
    assert os.path.exists(dest)
    r = open_reader(dest)
    assert len(list(r)) == 12


def test_encode_only_without_trajectory_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        render(
            "synthetic://shaky?w=128&h=96&n=4",
            str(tmp_path / "missing.y4m"),
            RenderOptions(stabilise="smooth", encode_only=True, **OPTS),
        )


def test_upsample_scales_output_canvas(tmp_path):
    """--upsample folds into the output camera scale (one fused resample);
    the input camera must keep matching the real decoded frames."""
    src = "synthetic://shaky?w=192&h=144&n=4&seed=1&shake=0.0"
    small = str(tmp_path / "s.y4m")
    big = str(tmp_path / "b.y4m")
    render(src, small, RenderOptions(stabilise="none", **OPTS))
    # 150 -> 1.5x: the value is an absolute percent (scale w=iw*u/100,
    # src/render.ts:227-231).
    render(src, big, RenderOptions(stabilise="none", upsample=150.0, **OPTS))
    rs, rb = open_reader(small), open_reader(big)
    try:
        assert rb.meta.width == pytest.approx(rs.meta.width * 1.5, abs=2)
        assert rb.meta.height == pytest.approx(rs.meta.height * 1.5, abs=2)
        ys = next(iter(rs))[0]
        yb = next(iter(rb))[0]
        assert ys.std() > 5 and yb.std() > 5
    finally:
        rs.close()
        rb.close()


def test_debug_overlay_hud(tmp_path):
    """--debug draws the HUD (the reference forwards debug into its
    filters' overlays, src/render.ts:677,891): text at top-left, darkened
    curve strip at the bottom, pixel content otherwise identical."""
    from video_annotator_tpu.io.video import open_reader
    from video_annotator_tpu.pipeline.render import RenderOptions, render

    src = "synthetic://shaky?w=160&h=128&n=8&seed=5"
    plain, dbg = str(tmp_path / "p.y4m"), str(tmp_path / "d.y4m")
    base = dict(stabilise="smooth", stabilise_radius=3, warp_batch=4)
    render(src, plain, RenderOptions(**base))
    render(src, dbg, RenderOptions(debug=True, **base))

    fp = list(open_reader(plain))
    fd = list(open_reader(dbg))
    assert len(fp) == len(fd) == 8
    yp, yd = fp[4][0].astype(int), fd[4][0].astype(int)
    h = yp.shape[0]
    strip = max(24, h // 8)
    # Bottom strip redrawn: darkened background (0.35x) under bright
    # curve/cursor pixels.
    assert (yd[h - strip:] > 200).any()
    assert (yd[h - strip:] != yp[h - strip:]).mean() > 0.2
    # Text region has bright pixels the plain render lacks.
    top = yd[:20, :120]
    assert (top > 200).sum() > (yp[:20, :120] > 200).sum()
    # The mid-frame body is untouched.
    mid = slice(h // 3, 2 * h // 3)
    np.testing.assert_array_equal(yp[mid], yd[mid])


def test_progress_reporting():
    """Progress prints CR status lines on TTY streams and stays silent on
    captured ones (the reference streams ffmpeg progress events,
    src/render.ts:1357-1359)."""
    import io

    from video_annotator_tpu.pipeline.profiler import Progress

    class Tty(io.StringIO):
        def isatty(self):
            return True

    s = Tty()
    p = Progress("encode", total=10, interval=0.0, stream=s)
    for _ in range(10):
        p.tick()
    p.close()
    out = s.getvalue()
    assert "encode:" in out and "fps" in out and out.endswith("\n")
    assert "10 frames" in out

    quiet = io.StringIO()  # isatty() False
    p2 = Progress("encode", total=5, interval=0.0, stream=quiet)
    p2.tick(5)
    p2.close()
    assert quiet.getvalue() == ""


def test_output_dfov_rect_without_size():
    """--output-dfov alone (rectilinear, no -w/-h) must set the output
    camera's field of view, not be silently dropped (reviewed regression:
    only the W+H+dfov and non-rect branches honored it)."""
    import math

    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import build_cameras

    meta = VideoMeta(width=640, height=480, fps=30.0, num_frames=8)
    _, cam = build_cameras(meta, RenderOptions(output_dfov=90.0))
    _, auto = build_cameras(meta, RenderOptions())
    assert abs(cam.fx - auto.fx) > 1e-3  # not the auto-fit intrinsics
    diag = math.hypot(cam.width, cam.height)
    dfov = 2.0 * math.degrees(math.atan(diag / 2.0 / cam.fx))
    assert abs(dfov - 90.0) < 1.0


def test_frame_rate_override(tmp_path):
    """--frame-rate retimes the output (same frames, new fps header) —
    the reference forwards it to the encoder as the output rate
    (``src/cli.ts:169-174``)."""
    from fractions import Fraction

    from video_annotator_tpu.io.y4m import Y4MReader

    src = "synthetic://shaky?w=96&h=64&n=6&fps=30&seed=1&shake=0.004"
    dest = str(tmp_path / "retimed.y4m")
    render(src, dest, RenderOptions(stabilise="smooth", stabilise_radius=2,
                                    preset=None, input_dfov=120.0,
                                    frame_rate=59.94))
    r = Y4MReader(dest)
    assert r.header.fps == Fraction(59.94).limit_denominator(1001)
    assert sum(1 for _ in r) == 6  # retimed, not resampled
    r.close()


def test_width_height_rescale_centers_vertically():
    """--width/--height without --output-dfov rescales the auto-fit
    camera; an aspect-changing height must CENTER the crop (cy shifts by
    half the cut), not anchor it at the top. The reference centers the
    output principal point too (out_fx/out_fy default to half the
    canvas, src/render.ts:680-681)."""
    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        build_cameras,
    )

    meta = VideoMeta(192, 144, 30, 10)
    o_auto = RenderOptions(preset=None, input_dfov=120.0)
    _, auto = build_cameras(meta, o_auto)
    # Same width (sx == 1), 2:1 height -> pure vertical center-crop.
    h = (auto.height // 2) - (auto.height // 2) % 2
    o = RenderOptions(preset=None, input_dfov=120.0,
                      width=auto.width, height=h)
    _, cam = build_cameras(meta, o)
    assert cam.width == auto.width and cam.height == h
    assert cam.cx == pytest.approx(auto.cx)
    assert cam.cy == pytest.approx(auto.cy - (auto.height - h) / 2.0)


def test_lone_height_fills_width_from_input():
    """A lone -h/-w sets that dimension, the other defaulting to the
    input's (x upsample) like the reference's ``out_w: outputWidth ||
    inputWidth`` (src/render.ts:678-679) and v360's ``w: width ||
    inputWidth*upsample`` (src/render.ts:526-527)."""
    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        build_cameras,
    )

    meta = VideoMeta(192, 144, 30, 10)
    _, cam = build_cameras(
        meta, RenderOptions(preset=None, input_dfov=120.0, height=100))
    assert (cam.width, cam.height) == (192, 100)
    _, cam = build_cameras(
        meta, RenderOptions(preset=None, input_dfov=120.0, width=160))
    assert (cam.width, cam.height) == (160, 144)
    _, cam = build_cameras(
        meta,
        RenderOptions(preset=None, input_dfov=120.0, height=100,
                      upsample=150.0))
    assert (cam.width, cam.height) == (288, 100)


def test_preview_sink_dumps_final_frames(tmp_path):
    """--preview DIR: the headless analogue of the reference demo's
    imshow loop (DisplayImage.cpp:60-72) — every Nth FINAL output frame
    lands as a PNG while rendering, identical to the written frame."""
    import cv2

    from video_annotator_tpu.io.video import open_reader, yuv420_to_bgr

    src = "synthetic://shaky?w=256&h=192&n=24&seed=5&shake=0.004&pan=0.0"
    dest = str(tmp_path / "out.y4m")
    pdir = str(tmp_path / "previews")
    render(src, dest, RenderOptions(
        **OPTS, stabilise="smooth", stabilise_radius=5,
        preview=pdir, preview_every=10,
    ))
    import os

    names = sorted(os.listdir(pdir))
    assert names == ["preview_000000.png", "preview_000010.png",
                     "preview_000020.png"], names
    # The preview is the FINAL output frame, pixel-exact.
    r = open_reader(dest)
    first = next(iter(r))
    r.close()
    png = cv2.imread(os.path.join(pdir, names[0]))
    want = yuv420_to_bgr(*[np.asarray(p).astype(np.uint8) for p in first])
    assert png.shape == want.shape
    np.testing.assert_array_equal(png, want)

    # With --crop the preview must show the CROPPED frame (the preview
    # wraps the raw writer, inside the crop/debug wrappers).
    dest2 = str(tmp_path / "out2.y4m")
    pdir2 = str(tmp_path / "previews2")
    render(src, dest2, RenderOptions(
        **OPTS, stabilise="smooth", stabilise_radius=5,
        crop_rect="128:96:0:0", preview=pdir2, preview_every=50,
    ))
    r = open_reader(dest2)
    first2 = next(iter(r))
    r.close()
    png2 = cv2.imread(os.path.join(pdir2, "preview_000000.png"))
    assert png2.shape[:2] == (96, 128), png2.shape
    want2 = yuv420_to_bgr(*[np.asarray(p).astype(np.uint8) for p in first2])
    np.testing.assert_array_equal(png2, want2)


def test_analyse_paired_recovers_ground_truth(traj):
    """--analysis-mode paired (fresh corners every frame, all pairs
    batched — _make_pair_tracker) estimates the same camera trajectory
    as the sequential tracker to ground truth tolerance, and is
    invariant to the chunk size (global-index RNG folding)."""
    paired = analyse(SRC, RenderOptions(analysis_mode="paired", **OPTS))
    assert paired.num_frames == traj.num_frames
    cfg = SyntheticSource.from_uri(SRC).config
    w_true = cfg.rotation_vectors()
    R_true = np.asarray(so3.exp(jnp.asarray(w_true)))
    R_expect = R_true.transpose(0, 2, 1) @ R_true[0]
    R_est = paired.rotations()
    errs = np.degrees(np.asarray([
        np.linalg.norm(np.asarray(
            so3.log(jnp.asarray(R_est[t] @ R_expect[t].T))))
        for t in range(paired.num_frames)
    ]))
    assert errs.max() < 0.35, errs.max()

    # vs the tracked mode: same trajectory to tracking noise.
    R_seq = traj.rotations()
    diffs = np.degrees(np.asarray([
        np.linalg.norm(np.asarray(
            so3.log(jnp.asarray(R_est[t] @ R_seq[t].T))))
        for t in range(paired.num_frames)
    ]))
    assert diffs.max() < 0.35, diffs.max()

    odd = analyse(SRC, RenderOptions(analysis_mode="paired",
                                     analysis_chunk=7, **OPTS))
    np.testing.assert_allclose(paired.params, odd.params, atol=1e-5)


def test_resolve_analysis_scale_auto_policy():
    """--analysis-scale auto: full resolution through ~1440p, 0.5 at
    4K-class (the reference demo's own scale, DisplayImage.cpp:42-57),
    0.25 at 8K; explicit scales win; junk rejected."""
    from fractions import Fraction

    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        analysis_level,
        resolve_analysis_scale,
    )

    def meta(w, h):
        return VideoMeta(w, h, Fraction(30, 1), 10)

    auto = RenderOptions()
    assert resolve_analysis_scale(auto, meta(640, 480)) == 1.0
    assert resolve_analysis_scale(auto, meta(1920, 1440)) == 1.0
    assert resolve_analysis_scale(auto, meta(2704, 2028)) == 0.5
    assert resolve_analysis_scale(auto, meta(3840, 2880)) == 0.5
    assert resolve_analysis_scale(auto, meta(7680, 4320)) == 0.25
    assert resolve_analysis_scale(auto, None) == 1.0  # unknowable input
    pinned = RenderOptions(analysis_scale=1.0)
    assert resolve_analysis_scale(pinned, meta(3840, 2880)) == 1.0
    assert analysis_level(RenderOptions(analysis_scale=0.25)) == 2
    assert analysis_level(auto, meta(3840, 2880)) == 1
    with pytest.raises(ValueError, match="analysis-scale"):
        resolve_analysis_scale(RenderOptions(analysis_scale=0.3), None)


def test_cli_analysis_scale_parsing():
    from video_annotator_tpu.cli import build_parser

    p = build_parser()
    a = p.parse_args(["render", "in.mp4", "out.mp4"])
    assert a.analysis_scale == "auto"
    a = p.parse_args(["render", "in.mp4", "out.mp4",
                      "--analysis-scale", "0.5"])
    assert a.analysis_scale == 0.5
    a = p.parse_args(["render", "in.mp4", "out.mp4",
                      "--analysis-scale", "auto"])
    assert a.analysis_scale == "auto"
    with pytest.raises(SystemExit):
        p.parse_args(["render", "in.mp4", "out.mp4",
                      "--analysis-scale", "0.3"])


def test_analyse_trackers_are_shared_per_geometry():
    """Analyses of one geometry reuse one set of jitted trackers (one
    trace and compile per process); any input that changes the tracking
    math gives a separate set."""
    from fractions import Fraction

    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        _make_pair_tracker,
        _make_tracker,
    )

    meta = VideoMeta(640, 480, Fraction(30, 1), 10)
    opts = RenderOptions(stabilise="smooth")
    assert _make_tracker(meta, opts) is _make_tracker(
        VideoMeta(640, 480, Fraction(60, 1), 99), RenderOptions())
    assert _make_pair_tracker(meta, opts) is _make_pair_tracker(meta, opts)
    for changed in (dict(analysis_iters=4), dict(input_dfov=120.0),
                    dict(analysis_scale=0.5)):
        other = RenderOptions(stabilise="smooth", **changed)
        assert _make_tracker(meta, other) is not _make_tracker(meta, opts)
    assert _make_pair_tracker(
        meta, RenderOptions(analysis_detect_level=0)
    ) is not _make_pair_tracker(meta, opts)
