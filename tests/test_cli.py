"""CLI surface: option parsing mirrors the reference's commander options
(``src/cli.ts:34-178``), including the time parser that fixes the
reference's ``=== NaN`` bug (``src/utils.ts:13-19``)."""

import dataclasses
import os

import numpy as np
import pytest

from video_annotator_tpu.cli import _parse_time, _render_options, build_parser


def test_parse_time_forms():
    assert _parse_time(None) is None
    assert _parse_time("90") == 90.0
    assert _parse_time("1:30") == 90.0
    assert _parse_time("0:01:30") == 90.0
    assert _parse_time("01:02:03") == 3723.0
    assert _parse_time(12.5) == 12.5


def test_render_options_mapping():
    p = build_parser()
    args = p.parse_args([
        "render", "in.mp4", "out.mp4",
        "-s", "10", "-e", "1:00", "-w", "1920", "-h2", "1080",
        "--roll", "2", "--pitch", "-1", "--yaw", "0.5",
        "--filter", "vidstab", "--stabilise", "smooth",
        "--stabilise-radius", "45", "--stabilise-buffer", "10",
        "--input-dfov", "120", "--projection", "fisheye",
        "--prefilter", "auto", "--encoder", "mp4v", "-v",
    ])
    o = _render_options(args)
    assert o.start == 10.0 and o.end == 60.0
    assert (o.width, o.height) == (1920, 1080)
    assert (o.roll, o.pitch, o.yaw) == (2.0, -1.0, 0.5)
    assert o.filter in ("vidstab", "similarity")  # alias normalization
    assert o.stabilise == "smooth" and o.stabilise_radius == 45
    assert o.stabilise_buffer == 10.0
    assert o.input_dfov == 120.0 and o.projection == "fisheye"
    assert o.prefilter == "auto" and o.verbose


def test_short_h_means_height():
    """``render -h <pixels>`` is the reference's height short flag
    (``src/cli.ts:45``); ``--help`` remains available, and the legacy
    ``-h2`` alias still parses."""
    p = build_parser()
    a = p.parse_args(["render", "in.mp4", "out.mp4", "-h", "1080"])
    assert a.height == 1080
    assert p.parse_args(["render", "in.mp4", "out.mp4", "-h2", "720"]).height == 720


def test_parser_has_reference_option_surface():
    """Every capability knob of the reference CLI exists here."""
    p = build_parser()
    help_text = p.format_help()
    sub = None
    for a in p._subparsers._group_actions[0].choices.items():  # noqa: SLF001
        if a[0] == "render":
            sub = a[1]
    text = sub.format_help()
    for opt in ("--start", "--duration", "--end", "--width", "--height",
                "--roll", "--pitch", "--yaw", "--upsample", "--crop",
                "--filter", "--stabilise", "--stabilise-radius",
                "--interpolate-radius", "--stabilise-buffer",
                "--input-dfov", "--output-dfov", "--projection",
                "--encode-only", "--analyse-only", "--no-output",
                "--encoder", "--frame-rate", "--compare", "--debug"):
        assert opt in text, opt
    for cmd in ("join", "render", "workflow", "calibrate", "compare"):
        assert cmd in help_text, cmd


def test_reference_hw_flags_accepted_as_inert_shims(capsys):
    """The reference's VAAPI/OpenCL plumbing flags (src/cli.ts:125-160)
    and the v1 --max-correction parse without error (drop-in script
    compatibility) and change no render option; --verbosity info implies
    the profiler report."""
    p = build_parser()
    args = p.parse_args([
        "render", "in.mp4", "out.mp4",
        "--hw-accel", "vaapi", "--vaapi-vendor", "intel",
        "--open-cl-platform", "0", "--no-map-open-cl-from-vaapi",
        "--copy-vaapi-frames", "--verbosity", "info",
        "--max-correction", "12",
    ])
    notes = capsys.readouterr().err
    assert notes.count("reference compatibility") == 6
    o = _render_options(args)
    assert o.verbose  # --verbosity info implies the report
    base = _render_options(p.parse_args(["render", "in.mp4", "out.mp4"]))
    assert dataclasses.replace(o, verbose=False) == base


def test_probe_video_and_telemetry(tmp_path):
    from video_annotator_tpu.cli import probe

    out = probe("synthetic://shaky?w=64&h=48&n=8")
    v = out["video"]
    assert (v["width"], v["height"], v["num_frames"]) == (64, 48, 8)
    assert v["fps"] == 30.0 and out["gpmf"] is None

    from test_gpmf import write_minimal_gpmf_mp4
    from video_annotator_tpu.io.gpmf import build_gpmf_payload

    rng = np.random.default_rng(0)
    path = str(tmp_path / "imu.mp4")
    write_minimal_gpmf_mp4(path, [
        build_gpmf_payload(rng.uniform(-1, 1, (40, 3)),
                           accl=rng.uniform(-9, 9, (20, 3)))
        for _ in range(4)
    ])
    out = probe(path)
    assert out["video"] is None
    assert out["tracks"][0]["name"] == "GoPro MET"
    assert out["gpmf"]["gyro"]["samples"] == 160
    assert out["gpmf"]["accl"]["samples"] == 80


def test_crop_rect_and_border_crop(tmp_path):
    """--crop takes BOTH forms: bare (auto border crop) and the
    reference's ffmpeg crop-filter rectangle W:H[:X:Y]
    (src/cli.ts:71-75, applied in the output configuration for every
    family, src/render.ts:288-292)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    dest = str(tmp_path / "c.y4m")
    r = subprocess.run(
        [sys.executable, "-m", "video_annotator_tpu", "render",
         "synthetic://shaky?w=192&h=144&n=3", dest,
         "--crop", "100:80:10:12", "--stabilise", "none"],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr[-1200:]
    hdr = open(dest, "rb").read(40).decode(errors="replace")
    assert "W100 H80" in hdr, hdr
    # centered default x/y + even rounding
    from video_annotator_tpu.pipeline.render import parse_crop_rect

    assert parse_crop_rect("100:80", 192, 144) == (80, 100, 32, 46)
    assert parse_crop_rect("101:81:3:5", 192, 144) == (80, 100, 4, 2)


def test_crop_ffmpeg_expressions():
    """The reference forwards --crop verbatim into ffmpeg's crop filter
    (src/render.ts:288-292), whose fields are av_expr expressions —
    in_w/iw, in_h/ih arithmetic, min/max, and x/y seeing out_w/out_h."""
    from video_annotator_tpu.pipeline.render import (
        eval_ffmpeg_expr,
        parse_crop_rect,
    )

    # plain arithmetic over input dims
    assert parse_crop_rect("in_w-100:in_h-44", 192, 144) == (100, 92, 22, 50)
    assert parse_crop_rect("iw/2:ih/2", 192, 144) == (72, 96, 36, 48)
    # functions; square crop of the short edge
    assert parse_crop_rect("min(iw,ih):min(iw,ih)", 192, 144) == (144, 144, 0, 24)
    # x/y expressions referencing out_w/out_h (ffmpeg's documented
    # centered form) match the implicit centered default
    assert (parse_crop_rect("100:80:(in_w-out_w)/2:(in_h-out_h)/2", 192, 144)
            == parse_crop_rect("100:80", 192, 144))
    # w may reference oh (two-round evaluation like vf_crop.c)
    assert parse_crop_rect("oh:ih/2", 192, 144) == (72, 72, 36, 60)
    # evaluator details
    assert eval_ffmpeg_expr("2+3*4", {}) == 14
    assert eval_ffmpeg_expr("-(2+1)*4", {}) == -12
    assert eval_ffmpeg_expr("if(gt(iw,100),10,20)", {"iw": 192}) == 10
    for bad in ("1+", "foo(2)", "(1", "1)2", "nope", "1;2"):
        try:
            eval_ffmpeg_expr(bad, {})
        except ValueError:
            pass
        else:
            raise AssertionError(f"{bad!r} should not parse")

    # the CLI validator accepts expression crops
    from video_annotator_tpu.cli import _validated_crop

    assert _validated_crop("in_w-100:in_h-100") == "in_w-100:in_h-100"
    try:
        _validated_crop("not:an expr")
    except SystemExit:
        pass
    else:
        raise AssertionError("invalid crop should SystemExit")


def test_crop_expression_edge_semantics():
    """Review-hardened av_expr behaviors: C-double arithmetic (no
    exceptions), '^' and scientific notation, x<->y cross-references,
    strict empty fields, keep_aspect/exact fields, and a syntax-only
    CLI validator that can't spuriously reject dimension-dependent
    expressions."""
    import pytest

    from video_annotator_tpu.cli import _validated_crop
    from video_annotator_tpu.pipeline.render import (
        eval_ffmpeg_expr,
        parse_crop_rect,
        validate_crop_spec,
    )

    # division by zero / overflow follow C doubles (ffmpeg av_expr):
    # non-finite, not a traceback — and a clean ValueError at parse.
    import math

    assert math.isinf(eval_ffmpeg_expr("1/0", {}))
    assert math.isnan(eval_ffmpeg_expr("0/0", {}))
    assert math.isinf(eval_ffmpeg_expr("100*pow(10,400)", {}))
    with pytest.raises(ValueError, match="non-finite"):
        parse_crop_rect("100/(ih-144)+100:80", 192, 144)
    # ^ operator (LEFT-assoc like eval.c parse_factor, binds tighter
    # than *) + sci notation
    assert eval_ffmpeg_expr("2^3", {}) == 8
    assert eval_ffmpeg_expr("2^3^2", {}) == 64
    assert eval_ffmpeg_expr("2*3^2", {}) == 18
    assert eval_ffmpeg_expr("1e3+2.5E-1", {}) == 1000.25
    # x may reference y (vf_crop re-evaluates x after y)
    assert parse_crop_rect("100:80:y:10", 192, 144) == (80, 100, 10, 10)
    # empty fields error instead of silently shifting left
    with pytest.raises(ValueError, match="empty field"):
        parse_crop_rect("100:80::10", 192, 144)
    parse_crop_rect("100:80:", 192, 144)  # one trailing ':' tolerated
    # keep_aspect/exact fields parse; keep_aspect=1 notes, never shifts
    assert parse_crop_rect("100:80:0:0:0:0", 192, 144) == (80, 100, 0, 0)
    assert parse_crop_rect("100:80:0:0:1", 192, 144) == (80, 100, 0, 0)
    with pytest.raises(ValueError, match="at most"):
        parse_crop_rect("1:2:3:4:5:6:7", 192, 144)
    # syntax-only validation: dimension-dependent blowups at the dummy
    # probe dims must NOT reject the spec (the real video may differ)...
    assert _validated_crop("iw/(ih-1080)+100:100") == "iw/(ih-1080)+100:100"
    validate_crop_spec("iw/(ih-1080)+100:100")
    # ...while true syntax errors still do.
    for bad in ("100:80::10", "foo(1):2", "1:2:3:4:5:6:7"):
        with pytest.raises(SystemExit):
            _validated_crop(bad)


def test_numeric_verbosity_levels():
    """ffmpeg -loglevel takes numeric levels too (32=info, 40=verbose);
    both forms imply the profiler report at info or chattier."""
    from video_annotator_tpu.cli import build_parser, _render_options

    p = build_parser()
    for level, expect in (("32", True), ("40", True), ("24", False),
                          ("error", False), ("debug", True)):
        o = _render_options(p.parse_args(
            ["render", "a.mp4", "b.mp4", "--verbosity", level]))
        assert o.verbose is expect, (level, expect)


def test_crop_expr_av_expr_semantics():
    """Corner semantics pinned to ffmpeg's eval.c: floored mod, round
    half-away-from-zero, '^' left-associative with the leading sign
    applied AFTER the pow chain and exponent signs negating the
    exponent."""
    from video_annotator_tpu.pipeline.render import eval_ffmpeg_expr as E

    assert E("mod(-5,3)", {}) == 1          # floored, not C fmod (-2)
    assert E("mod(5,-3)", {}) == -1         # sign follows the divisor
    assert E("round(2.5)", {}) == 3         # not banker's (2)
    assert E("round(-2.5)", {}) == -3       # away from zero
    assert E("-3^2", {}) == -9              # sign after pow
    assert E("2^3^2", {}) == 64             # (2^3)^2, left-assoc
    assert E("2^-3", {}) == 0.125           # exponent sign negates exponent
    assert E("3^-2^2", {}) == (3 ** -2) ** 2
    import math

    assert math.isnan(E("mod(1,0)", {}))
    assert E("floor(1/0)", {}) == math.inf  # C doubles: floor(inf)=inf

    # One explicit sign (eval.c parse_dB) + one av_strtod literal sign:
    assert E("--3", {}) == 3                # -(-3)
    assert E("- -3", {}) == 3               # ffmpeg strips whitespace
    assert E("--3^2", {}) == -9             # -(pow(-3,2)): strtod takes
    assert E("2^--3", {}) == 8              # the INNER sign, parse_dB
    assert E("4*--3", {}) == 12             # the outer one
    for bad in ("---3", "--x", "--(1+2)"):
        with pytest.raises(ValueError):
            E(bad, {"x": 1.0})


def test_upsample_rejects_negative_percent():
    """--upsample is an absolute percent; a negative value (legal under
    the old relative semantics) must error, not build a negative-size
    output camera."""
    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        build_cameras,
        upsample_factor,
    )

    with pytest.raises(ValueError):
        upsample_factor(-50.0)
    with pytest.raises(ValueError):
        build_cameras(VideoMeta(192, 144, 30, 10),
                      RenderOptions(preset=None, input_dfov=120.0,
                                    upsample=-50.0))
    assert upsample_factor(50.0) == 0.5


def test_crop_keep_aspect_field_is_an_option_boolean():
    """vf_crop's keep_aspect/exact are AVOption booleans set by the
    shorthand parser, so ffmpeg evaluates them WITHOUT the frame
    variables — plain numeric expressions work, variable-bearing ones
    error (in real ffmpeg too), and the CLI validator agrees with the
    render-time parser."""
    from video_annotator_tpu.pipeline.render import (
        parse_crop_rect,
        validate_crop_spec,
    )

    assert (parse_crop_rect("100:80:0:0:gt(2,1)", 192, 144)
            == parse_crop_rect("100:80:0:0:1", 192, 144))
    with pytest.raises(ValueError):
        parse_crop_rect("100:80:0:0:gt(iw,0)", 192, 144)
    with pytest.raises(ValueError):
        validate_crop_spec("100:80:0:0:gt(iw,0)")
    validate_crop_spec("100:80:0:0:0:1")


def test_display_degrades_gracefully_headless(tmp_path, capsys):
    """``--display`` is the reference demo's real imshow window
    (``opencv/DisplayImage.cpp:60-72``). On a headless box (no GUI
    cv2 build / no display) the render must still complete, emitting
    the one-line fallback hint instead of crashing."""
    from video_annotator_tpu.cli import main

    out = str(tmp_path / "out.y4m")
    rc = main(["render", "synthetic://shaky?w=96&h=72&n=6", out,
               "--stabilise", "smooth", "--stabilise-radius", "2",
               "--display"])
    assert rc == 0 and os.path.getsize(out) > 0


def test_make_display_sink_headless_returns_sink_unchanged():
    """The GUI probe must not wrap the sink when no window can open
    (this suite runs headless); if a GUI genuinely exists, a
    DisplaySink wrapper is the correct result instead."""
    import importlib

    # `video_annotator_tpu.pipeline.render` the ATTRIBUTE is the render()
    # function re-exported by the pipeline package; fetch the module.
    R = importlib.import_module("video_annotator_tpu.pipeline.render")

    sentinel = object()
    wrapped = R.make_display_sink(sentinel)
    assert wrapped is sentinel or isinstance(wrapped, R.DisplaySink)
