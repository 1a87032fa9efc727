"""Two-phase render orchestration: analyse (motion) then encode (warp).

The unification of the reference's two engines: the TS planner's
two-phase ``analyse()``/``encode()`` flow with persisted motion data and
``--analyse-only``/``--encode-only`` gating (``src/render.ts:1225-1399``),
executing the C++ engine's actual math (``opencv/FrameSourceWarp.cpp``)
natively on device instead of delegating to FFmpeg filters.

Phase 1 (analyse) is the ``consume_frame`` loop — corner tracking with
key-frame refresh (age > 20 or < 150 corners,
``opencv/FrameSourceWarp.cpp:415-419``), rotation RANSAC with the
low-inlier fallback, rotation accumulation — producing a persisted
trajectory (the ``.trf`` analogue). Phase 2 (encode) smooths the trajectory
(whole-sequence SG/Kalman instead of a streaming lookahead buffer: the
two-phase design makes the reference's ``smooth_radius`` frame buffering
unnecessary) and warps every frame with the batched XLA warp.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
from fractions import Fraction
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu import so3
from video_annotator_tpu.camera import (
    Camera,
    CameraModel,
    CameraPreset,
    camera_from_dfov,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu.io.video import VideoMeta, open_reader, open_writer
from video_annotator_tpu.ops.corners import detect_corners
from video_annotator_tpu.ops.lk import pyramidal_lk
from video_annotator_tpu.ops.mip import (
    box_downsample,
    mip_camera,
    mip_prefilter_level,
)
from video_annotator_tpu.ops.ransac import estimate_rotation, rotation_with_fallback
from video_annotator_tpu.ops.warp_xla import (
    RS_BAND_ROWS,
    camera_from_key,
    camera_key,
    to_uint8,
    warp_yuv420_xla,
)
from video_annotator_tpu.pipeline.profiler import Progress, StageProfiler
from video_annotator_tpu.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu.smoothing.kalman import smooth_rotations_kalman

# Key-frame refresh policy (opencv/FrameSourceWarp.cpp:415).
KEY_FRAME_MAX_AGE = 20
KEY_FRAME_MIN_CORNERS = 150
# The reference tracks 200 corners (FrameSourceWarp.cpp:230).
MAX_CORNERS = 200
MIN_INLIERS_FULL = 40  # reference gate at full resolution (cpp:432)

# --projection values. The reference forwards the option verbatim to the
# v360 filter ("See v360 filter docs for options", src/cli.ts:117-121), so
# v360's names — and its aliases — are accepted alongside the long forms.
PROJECTION_MODELS = {
    "rect": CameraModel.RECTILINEAR,
    "flat": CameraModel.RECTILINEAR,
    "gnomonic": CameraModel.RECTILINEAR,
    "fisheye": CameraModel.FISHEYE,
    "fish": CameraModel.FISHEYE,
    "equirect": CameraModel.EQUIRECT,
    "equirectangular": CameraModel.EQUIRECT,
    "e": CameraModel.EQUIRECT,
    "stereographic": CameraModel.STEREOGRAPHIC,
    "sg": CameraModel.STEREOGRAPHIC,
    "mercator": CameraModel.MERCATOR,
    "ball": CameraModel.BALL,
    "hammer": CameraModel.HAMMER,
    "sinusoidal": CameraModel.SINUSOIDAL,
    "sinusoid": CameraModel.SINUSOIDAL,
    "cylindrical": CameraModel.CYLINDRICAL,
    "pannini": CameraModel.PANNINI,
}


@dataclasses.dataclass
class RenderOptions:
    """Mirror of the CLI's render options (``src/cli.ts:34-178``)."""

    # trim (seconds)
    start: Optional[float] = None
    duration: Optional[float] = None
    end: Optional[float] = None
    # output geometry
    width: Optional[int] = None
    height: Optional[int] = None
    scale: float = 1.0
    crop_borders: bool = False
    # --crop W:H[:X:Y] — output crop rectangle (ffmpeg crop-filter
    # syntax; the reference forwards it to `crop=`, src/cli.ts:71-75).
    crop_rect: Optional[str] = None
    upsample: float = 0.0  # percent
    # camera attitude (degrees; src/cli.ts:46-63)
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    # stabilizer family (--filter, src/cli.ts:74-78; aliases: dewobble ->
    # rotation, vidstab -> similarity, deshake_opencl -> deshake)
    filter: str = "rotation"
    # stabilization
    stabilise: str = "none"  # none | fixed | smooth
    smoother: str = "savgol"  # savgol | kalman
    stabilise_radius: int = 90
    interpolate_radius: int = 30
    stabilise_buffer: float = 20.0  # percent extra canvas while stabilising
    # lens
    input_dfov: float = 145.8
    output_dfov: Optional[float] = None
    projection: str = "rect"  # any PROJECTION_MODELS key (v360 family)
    preset: Optional[CameraPreset] = None
    # gyro-assisted analysis (GPMF telemetry instead of visual tracking)
    gyro: bool = False
    # Single-pass streaming render (the native engine's shape,
    # opencv/FrameSourceWarp.cpp:452-464): decode once, smooth through a
    # lookahead window, identical output to the two-phase path. Rotation
    # family only; --gyro already decodes once (telemetry analysis) and
    # ignores this flag.
    streaming: bool = False
    # Gravity-referenced roll lock: pin the horizon using the GPMF ACCL
    # stream's up direction (falls back to "frame 0 was level" when the
    # source has no telemetry). Applies to any stabilise mode / family
    # with SO(3) trajectories.
    horizon_lock: bool = False
    # Rolling-shutter readout time as a fraction of the frame period
    # (GoPro HERO-era sensors ~0.75; 0 disables). Each 8-row output band
    # warps with its own scanline-time rotation (smoothing/rolling.py) —
    # per-scanline jello correction the reference cannot express.
    rolling_shutter: float = 0.0
    # phases
    analyse_only: bool = False
    encode_only: bool = False
    no_output: bool = False
    # Benchmark-internal (no CLI surface): streaming renders consume
    # outputs with an on-device checksum instead of reading frames back
    # (io/prefetch.py::DeviceReduceSink) — the readback-free overlap
    # proof of benchmarks/run.py::bench_e2e_decode_overlap.
    device_sink: bool = False
    # encoding
    encoder: str = "mp4v"
    frame_rate: Optional[float] = None
    # engine / "hardware configurator" analogues: the reference plans
    # VAAPI/OpenCL device wiring and frame-pool sizes
    # (src/render.ts:95-252); here device placement is jax, so the knobs
    # are the dispatch batch, the host->device prefetch depth, and
    # whether the native (C++/libav) IO paths are used at all (the
    # fallback switch mirroring --no-map-open-cl-from-vaapi /
    # --copy-vaapi-frames picking slower interop paths).
    warp_batch: Optional[int] = None  # None: env VAT_WARP_BATCH or 32
    prefetch_depth: int = 3
    native_io: bool = True
    # Track on a box-downsampled pyramid level ("auto", 1, 0.5 or 0.25):
    # the reference demo tracks at scale 0.5 (opencv/DisplayImage.cpp:
    # 49-57). Rotations are resolution-independent; tracking cost ~1/4
    # per level. "auto" resolves per input size (full resolution through
    # ~1440p, 0.5 for 4K-class, 0.25 for 8K — resolve_analysis_scale).
    analysis_scale: object = "auto"
    # Analyse-phase frames per device dispatch (lax.scan chunk). 1 =
    # per-frame dispatches (the streaming path's shape). Identical
    # trajectory either way; chunking only amortizes dispatch overhead.
    analysis_chunk: int = 16
    # Analyse formulation: "tracked" is the reference-faithful sequential
    # tracker (point carryover + key-frame refresh); "paired" detects
    # fresh corners every frame and tracks/estimates all adjacent pairs
    # in batched launches (same estimator math and gates — see
    # _make_pair_tracker). Trajectories agree to tracking noise; quality
    # scored side by side in benchmarks/quality.py. "auto" (the default)
    # resolves to paired on an accelerator backend — the stock
    # `render in.mp4 out.mp4 --stabilise smooth` invocation — and to
    # tracked on CPU, where the sequential scan is the right shape
    # (resolve_analysis_mode).
    analysis_mode: str = "auto"  # auto | tracked | paired
    # Paired mode only: detect corners this many pyramid levels BELOW
    # the tracking resolution (detection cost scales with pixels; LK
    # re-validates every patch at track resolution — see
    # _make_pair_tracker). 0 = detect at track resolution.
    analysis_detect_level: int = 1
    # LK Newton iterations per pyramid level. cv2's default criteria
    # (30, eps 0.01) terminates in a handful of iterations on real
    # footage; 8 fixed iterations measure identical trajectory accuracy
    # to 10 on the ground-truth suite (tests/test_pipeline.py,
    # benchmarks/quality.py traj_rms) at ~2/10 less LK kernel time.
    analysis_iters: int = 8
    # Live preview (the reference demo's imshow loop,
    # opencv/DisplayImage.cpp:60-72, headless): dump every Nth final
    # output frame as a PNG into this directory while rendering.
    preview: Optional[str] = None
    preview_every: int = 30
    # Live window (the reference demo's actual imshow loop,
    # opencv/DisplayImage.cpp:60-72): show final output frames in a GUI
    # window while rendering. Requires a cv2 build with GUI support and
    # a display; degrades to a one-line warning (pointing at --preview)
    # when either is absent, so the flag is safe in headless runs.
    display: bool = False
    # "auto": box-downsample minifying inputs to the matching mip level
    # before warping (antialias + smaller kernel windows). "off" keeps
    # exact bilinear-on-full-res semantics (the reference's behavior).
    prefilter: str = "off"  # off | auto
    # Resampler: bilinear (the native engine's INTER_LINEAR), bicubic
    # (vidstab's interpol=bicubic, src/render.ts:571) or lanczos (v360's
    # interp=lanczos, src/render.ts:533).
    interp: str = "bilinear"
    # Draw stabilization diagnostics into the output (the reference's
    # --debug reaches its filters' debug overlays, src/render.ts:677,891).
    debug: bool = False
    # Burn each --compare cell's mode name into its corner (the
    # reference's grids are unlabeled and rely on remembering cell
    # order, dewobble_test.sh:47-62); --no-cell-labels restores that.
    cell_labels: bool = True
    verbose: bool = False


def resolve_analysis_mode(options) -> str:
    """Concrete analyse formulation for ``--analysis-mode`` (see
    :class:`RenderOptions`): "auto" picks the batched paired analyse on
    an accelerator backend (the sequential scan issues ~15 small launches
    per frame) and the sequential tracker on CPU (no launch latency to
    amortize; the scan shape wins). Explicit
    "tracked"/"paired" always win. The trajectory-accuracy tradeoff of
    the paired default is documented at ``docs/PIPELINE.md`` and scored
    in ``benchmarks/quality.py``."""
    mode = getattr(options, "analysis_mode", "auto")
    if mode == "auto":
        import jax

        return "tracked" if jax.default_backend() == "cpu" else "paired"
    if mode not in ("tracked", "paired"):
        raise ValueError(
            f"--analysis-mode must be auto, tracked or paired (got {mode})"
        )
    return mode


def resolve_analysis_scale(o, meta=None) -> float:
    """Concrete tracking scale for ``--analysis-scale`` (default "auto").

    "auto" picks the largest scale in {1, 0.5, 0.25} whose tracked frame
    fits the ~1440p class (h <= 1536, w <= 2048): <=1440p inputs track at
    full resolution; 4K-class inputs track at 0.5 — the reference demo's
    own tracking scale (``opencv/DisplayImage.cpp:42-57``) and the
    headline-benchmark configuration (a stock ``render --stabilise
    smooth`` takes the measured 4K path with no extra flags, VERDICT r4
    item 3); 8K-class inputs track at 0.25. Camera-frame rotations are
    resolution-independent, so the trajectory's meaning is unchanged;
    the accuracy cost at each scale is scored in benchmarks/quality.json.
    Explicit scales always win. ``meta=None`` (scale unknowable — no
    probed input) resolves "auto" conservatively to full resolution.
    """
    scale = getattr(o, "analysis_scale", "auto")
    if scale in ("auto", None):
        if meta is None:
            return 1.0
        for s in (1.0, 0.5, 0.25):
            if meta.height * s <= 1536 and meta.width * s <= 2048:
                return s
        return 0.25
    try:
        scale = float(scale)
    except (TypeError, ValueError):
        scale = None
    if scale not in (1.0, 0.5, 0.25):
        raise ValueError(
            f"--analysis-scale must be auto, 1, 0.5 or 0.25 "
            f"(got {getattr(o, 'analysis_scale', None)!r})"
        )
    return scale


def analysis_level(o, meta=None) -> int:
    """Validated --analysis-scale as a box-downsample level (shared by
    every stabilizer family)."""
    return {1.0: 0, 0.5: 1, 0.25: 2}[resolve_analysis_scale(o, meta)]


def _passthrough_kwargs(source: str, meta: VideoMeta, o: RenderOptions):
    """Audio/GPMF stream-copy window for the native writer.

    The reference's render keeps the source's audio alongside the encoded
    video and its joiner maps the GPMF track explicitly
    (``src/join.ts:56-82``); here any container source gets its non-video
    streams copied into the output, restricted to the trim window."""
    if source.startswith("synthetic://") or source.endswith(".y4m"):
        return {"allow_native": o.native_io}
    start = o.start or 0.0
    if o.end is not None:
        end = float(o.end)
    elif o.duration is not None:
        end = start + float(o.duration)
    else:
        end = -1.0
    return {
        "copy_streams_from": source,
        "trim_start": start,
        "trim_end": end,
        "allow_native": o.native_io,
    }


def tracking_gates(track_w: int) -> tuple:
    """(min_distance, min_inliers, min_refresh) for a tracking width.

    The reference's corner parameters (200 corners, 30 px min distance,
    inlier gate 40 — ``opencv/FrameSourceWarp.cpp:230,432``) are tuned for
    1920-wide footage; scale with resolution so smaller inputs keep a
    comparable corner density, but CAP the inlier gate at the reference's
    40 — frames with 40+ inliers are trustworthy at any resolution.
    Shared by the rotation and similarity analysers so the gates can't
    drift apart.
    """
    res_scale = max(track_w / 1920.0, 0.15)
    min_distance = max(6, int(round(30 * res_scale)))
    min_inliers = max(10, min(MIN_INLIERS_FULL, int(round(40 * res_scale))))
    min_refresh = max(20, int(round(KEY_FRAME_MIN_CORNERS * res_scale)))
    return min_distance, min_inliers, min_refresh


def tracking_border(track_w: int, track_h: int) -> int:
    """Corner-seeding border for the trackers' detect_corners calls.

    Corners closer to an edge than the deepest pyramid level's tracking
    window can never be tracked — pyramidal LK needs ~(WIN//2 + 1) px of
    margin per level, i.e. 2**(levels-1) times that at tracking
    resolution — so seeding them burns max_corners slots on guaranteed
    status=False points, displacing trackable interior cells. Capped by
    the frame size so detection never goes empty on tiny inputs.
    """
    from video_annotator_tpu.ops.lk import DEF_LEVELS, WIN

    margin = 2 ** (DEF_LEVELS - 1) * (WIN // 2 + 1)
    return max(8, min(margin, min(track_w, track_h) // 6))


def _frame_range(meta: VideoMeta, o: RenderOptions):
    fps = float(meta.fps)
    first = int(round((o.start or 0.0) * fps))
    last = meta.num_frames if meta.num_frames else 1 << 30
    if o.end is not None:
        last = min(last, int(round(o.end * fps)))
    if o.duration is not None:
        last = min(last, first + int(round(o.duration * fps)))
    return first, last


def open_trimmed(source: str, o) -> tuple:
    """(reader, meta, first, last) with the reader seeked to the trim start.

    The seek target depends on the source fps, so the source is probed
    first and reopened with a demuxer seek when ``--start`` lands past
    frame 0 (the ffmpeg ``-ss`` the reference's trimmed renders rely on —
    without it every ``render -s N`` decodes the whole prefix, quadratic
    over a ``workflow split``). Callers must still iterate with
    ``enumerate(reader, start=reader.start_frame)`` and skip
    ``idx < first``: sources that cannot seek report ``start_frame == 0``.
    """
    native = getattr(o, "native_io", True)
    reader = open_reader(source, prefer_native=native)
    meta = reader.meta
    first, last = _frame_range(meta, o)
    if first > 0:
        try:
            seeked = open_reader(source, prefer_native=native,
                                 start_frame=first)
        except Exception:
            seeked = None
        if seeked is not None:
            reader.close()
            reader = seeked
    if not hasattr(reader, "start_frame"):
        reader.start_frame = 0
    return reader, meta, first, last


def eval_ffmpeg_expr(expr: str, env: dict) -> float:
    """Evaluate an ffmpeg filter expression (the ``av_expr`` subset the
    crop filter documents): numbers (incl. scientific notation), names
    from ``env``, ``+ - * / ^``, unary minus, parentheses, and the
    functions ``min max abs floor ceil trunc round mod pow if gt gte lt
    lte eq``. The reference forwards ``--crop`` verbatim into
    ``crop=${crop}`` (``src/render.ts:288-292``) where ffmpeg evaluates
    exactly this language, so values like ``in_w-200`` or ``min(iw,ih)``
    must work here too. Safe recursive descent — no Python ``eval``.

    Syntax errors (unknown names, unbalanced parens, trailing garbage)
    raise ``ValueError``. Arithmetic follows C doubles like av_expr —
    division by zero and overflow yield ±inf/NaN rather than raising —
    so callers can distinguish "bad expression" from "bad value at
    these dimensions".
    """
    import math

    def _div(a, b):
        try:
            return a / b
        except ZeroDivisionError:
            return math.nan if a == 0 else math.copysign(math.inf, a) * (
                math.copysign(1.0, b)
            )

    def _pow(a, b):
        try:
            return float(a) ** float(b)
        except OverflowError:
            return math.inf
        except (ValueError, ZeroDivisionError):  # (-x)**frac, 0**-1
            return math.nan

    def _cdouble(f):
        # C's floor/ceil/trunc/round pass +-inf/NaN through; Python's
        # math.floor raises OverflowError on inf.
        def g(d):
            return d if (math.isinf(d) or math.isnan(d)) else float(f(d))
        return g

    def _round(d):
        # av_expr rounds half AWAY FROM ZERO (eval.c e_round), not
        # Python's banker's rounding: round(2.5) = 3, round(-2.5) = -3.
        return math.floor(d + 0.5) if d >= 0 else math.ceil(d - 0.5)

    def _mod(a, b):
        # av_expr's mod is FLOORED (eval.c e_mod: d - floor(d/d2)*d2),
        # not C fmod: mod(-5, 3) = 1, and the result's sign follows b.
        if not b:
            return math.nan
        try:
            return a - math.floor(a / b) * b
        except (OverflowError, ValueError):
            return math.nan

    funcs = {
        "min": min, "max": max, "abs": abs, "floor": _cdouble(math.floor),
        "ceil": _cdouble(math.ceil), "trunc": _cdouble(math.trunc),
        "round": _cdouble(_round),
        "mod": _mod, "pow": _pow,
        "if": lambda c, a, b=0.0: a if c != 0 else b,
        "gt": lambda a, b: 1.0 if a > b else 0.0,
        "gte": lambda a, b: 1.0 if a >= b else 0.0,
        "lt": lambda a, b: 1.0 if a < b else 0.0,
        "lte": lambda a, b: 1.0 if a <= b else 0.0,
        "eq": lambda a, b: 1.0 if a == b else 0.0,
    }
    s = str(expr)
    pos = [0]

    def peek():
        while pos[0] < len(s) and s[pos[0]].isspace():
            pos[0] += 1
        return s[pos[0]] if pos[0] < len(s) else ""

    def parse_sum():
        v = parse_prod()
        while peek() in ("+", "-"):
            op = s[pos[0]]; pos[0] += 1
            r = parse_prod()
            v = v + r if op == "+" else v - r
        return v

    def parse_prod():
        v = parse_pow()
        while peek() in ("*", "/"):
            op = s[pos[0]]; pos[0] += 1
            r = parse_pow()
            v = v * r if op == "*" else _div(v, r)
        return v

    def parse_sign():
        # eval.c's parse_dB consumes at most ONE leading sign; a second
        # sign is absorbed into a numeric literal by av_strtod (handled
        # in parse_atom), and a third is a parse error.
        c = peek()
        if c in ("+", "-"):
            pos[0] += 1
            return -1.0 if c == "-" else 1.0
        return 1.0

    def parse_pow():
        # av_expr's '^' (eval.c parse_factor): binds tighter than * /,
        # LEFT-associative (2^3^2 = (2^3)^2 = 64); a leading sign
        # multiplies the result of the whole chain (-3^2 = -9, and
        # --3^2 = -(pow(-3,2)) = -9); an exponent's own sign negates
        # the exponent (2^-3 = 0.125).
        sign = parse_sign()
        v = parse_atom()
        while peek() == "^":
            pos[0] += 1
            v = _pow(v, parse_sign() * parse_atom())
        return sign * v

    def parse_number(start):
        while pos[0] < len(s) and (s[pos[0]].isdigit() or s[pos[0]] == "."):
            pos[0] += 1
        # scientific notation: 1e3, 2.5E-2 (only when 'e' is followed by
        # a digit or a signed digit — otherwise it's a name boundary)
        if pos[0] < len(s) and s[pos[0]] in "eE":
            j = pos[0] + 1
            if j < len(s) and s[j] in "+-":
                j += 1
            if j < len(s) and s[j].isdigit():
                pos[0] = j
                while pos[0] < len(s) and s[pos[0]].isdigit():
                    pos[0] += 1
        return float(s[start:pos[0]])

    def parse_atom():
        c = peek()
        if c in ("-", "+"):
            # The sign before this one was consumed by parse_sign
            # (eval.c parse_dB); av_strtod absorbs exactly one further
            # sign into a NUMERIC literal ('--3' = -(-3)), and anything
            # else ('--x', '---3') is a parse error in ffmpeg too.
            pos[0] += 1
            nxt = peek()
            if nxt.isdigit() or nxt == ".":
                v = parse_number(pos[0])
                return -v if c == "-" else v
            raise ValueError(
                f"cannot parse expression {expr!r} at {s[pos[0]:]!r}")
        if c == "(":
            pos[0] += 1
            v = parse_sum()
            if peek() != ")":
                raise ValueError(f"unbalanced parens in expression {expr!r}")
            pos[0] += 1
            return v
        start = pos[0]
        if c.isdigit() or c == ".":
            return parse_number(start)
        if c.isalpha() or c == "_":
            while pos[0] < len(s) and (s[pos[0]].isalnum() or s[pos[0]] == "_"):
                pos[0] += 1
            name = s[start:pos[0]]
            if peek() == "(":
                if name not in funcs:
                    raise ValueError(f"unknown function {name!r} in {expr!r}")
                pos[0] += 1
                a = [parse_sum()]
                while peek() == ",":
                    pos[0] += 1
                    a.append(parse_sum())
                if peek() != ")":
                    raise ValueError(f"unbalanced parens in expression {expr!r}")
                pos[0] += 1
                return float(funcs[name](*a))
            if name not in env:
                raise ValueError(f"unknown variable {name!r} in {expr!r}")
            return float(env[name])
        raise ValueError(f"cannot parse expression {expr!r} at {s[pos[0]:]!r}")

    v = parse_sum()
    if peek() != "":
        raise ValueError(f"trailing garbage in expression {expr!r}: {s[pos[0]:]!r}")
    return v


def _crop_fields(spec: str) -> list:
    parts = str(spec).split(":")
    if parts and parts[-1] == "":  # tolerate one trailing ':'
        parts.pop()
    if not parts or any(p == "" for p in parts):
        # ffmpeg's av_expr errors on an empty field; silently shifting
        # the remaining fields left would crop the wrong region.
        raise ValueError(f"empty field in --crop value {spec!r}")
    if len(parts) > 6:
        raise ValueError(f"--crop takes at most w:h:x:y:keep_aspect:exact "
                         f"(got {spec!r})")
    return parts


def validate_crop_spec(spec: str) -> None:
    """Syntax-only validation of a ``--crop`` value: field structure and
    expression parseability. Evaluated VALUES are not judged — whether
    an expression lands finite/inside the frame depends on the actual
    video's dimensions, which the CLI doesn't know yet; those are
    checked by :func:`parse_crop_rect` at render time. Raises
    ``ValueError`` on malformed specs."""
    parts = _crop_fields(spec)
    env = {
        "in_w": 1920.0, "iw": 1920.0, "in_h": 1080.0, "ih": 1080.0,
        "out_w": 1920.0, "ow": 1920.0, "out_h": 1080.0, "oh": 1080.0,
        "a": 16 / 9, "sar": 1.0, "dar": 16 / 9, "hsub": 2, "vsub": 2,
        "n": 0, "t": 0.0, "x": 0.0, "y": 0.0,
    }
    for i, p in enumerate(parts):
        # keep_aspect/exact (fields 5/6) are AVOption booleans: ffmpeg
        # evaluates them without the frame variables (see
        # parse_crop_rect), so validate them the same way.
        eval_ffmpeg_expr(p, env if i < 4 else {})


def parse_crop_rect(spec: str, width: int, height: int):
    """Parse the reference's ``--crop`` value — ffmpeg crop-filter syntax
    ``w:h[:x:y]`` (``src/cli.ts:71-75``; applied as ``crop=${crop}`` in
    its output configuration for every family,
    ``src/render.ts:288-292``). Each field is an ffmpeg expression over
    ``in_w``/``iw``/``in_h``/``ih`` (and ``out_w``/``ow``/``out_h``/``oh``
    — cross-references resolved with the crop filter's two-round
    evaluation; ``x`` is visible to the ``y`` expression). x/y default to
    centered like the crop filter; values clamp inside the frame and
    round to even for 4:2:0.
    """
    import math

    parts = _crop_fields(spec)
    # Fields 5/6 are vf_crop's keep_aspect/exact. exact=0 (round to the
    # subsampling grid) is already this parser's only behavior;
    # keep_aspect only rewrites the output SAR metadata, which the YUV
    # writers here don't carry — note it instead of silently dropping.
    # Unlike w/h/x/y, these are AVOption BOOLEANS set by the shorthand
    # parser, so ffmpeg evaluates them WITHOUT the frame variables
    # (libavutil/opt.c's set_string_number env, not vf_crop's) — plain
    # numeric expressions only; 'crop=...:gt(iw,0)' errors there too.
    if len(parts) >= 5 and eval_ffmpeg_expr(parts[4], {}) != 0:
        import sys

        print("note: --crop keep_aspect adjusts SAR metadata only; "
              "this pipeline writes square pixels — ignored",
              file=sys.stderr)
    base = {
        "in_w": width, "iw": width, "in_h": height, "ih": height,
        "a": width / height, "sar": 1.0, "dar": width / height,
        "hsub": 2, "vsub": 2, "n": 0, "t": 0.0,
        # x/y are NaN while sizing, like vf_crop's config_input — a w/h
        # expression using them fails the finite check below.
        "x": math.nan, "y": math.nan,
    }
    # ffmpeg evaluates w and h twice so each may reference the other
    # (libavfilter/vf_crop.c's config_input): seed out_* with in_*.
    env = dict(base, out_w=width, ow=width, out_h=height, oh=height)
    for _ in range(2):
        cw = eval_ffmpeg_expr(parts[0], env) if len(parts) > 0 else width
        env.update(out_w=cw, ow=cw)
        ch = eval_ffmpeg_expr(parts[1], env) if len(parts) > 1 else height
        env.update(out_h=ch, oh=ch)
    if not (math.isfinite(cw) and math.isfinite(ch)):
        raise ValueError(
            f"--crop {spec!r} evaluates to a non-finite size "
            f"({cw}x{ch}) at {width}x{height}")
    cw, ch = int(cw), int(ch)
    cw = max(2, min(cw, width))
    ch = max(2, min(ch, height))
    cw -= cw % 2
    ch -= ch % 2
    # vf_crop evaluates x, then y, then x again, so each may reference
    # the other; seed both with the centered defaults.
    env.update(out_w=cw, ow=cw, out_h=ch, oh=ch,
               x=(width - cw) / 2, y=(height - ch) / 2)
    for _ in range(2):
        cx = (eval_ffmpeg_expr(parts[2], env) if len(parts) > 2
              else (width - cw) / 2)
        env["x"] = cx
        cy = (eval_ffmpeg_expr(parts[3], env) if len(parts) > 3
              else (height - ch) / 2)
        env["y"] = cy
    if not (math.isfinite(cx) and math.isfinite(cy)):
        raise ValueError(
            f"--crop {spec!r} evaluates to a non-finite offset at "
            f"{width}x{height}")
    cx, cy = int(cx), int(cy)
    cx = max(0, min(cx, width - cw))
    cy = max(0, min(cy, height - ch))
    cx -= cx % 2
    cy -= cy % 2
    return ch, cw, cy, cx


class CropSink:
    """Output-rect crop applied at the frame sink (the reference's
    ``crop=`` output filter) — slices every written YUV triple."""

    def __init__(self, sink, rect):
        self._sink = sink
        self._ch, self._cw, self._cy, self._cx = rect

    def write(self, planes):
        y, u, v = (np.asarray(p) for p in planes)
        ch, cw, cy, cx = self._ch, self._cw, self._cy, self._cx
        self._sink.write((
            y[cy:cy + ch, cx:cx + cw],
            u[cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2],
            v[cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2],
        ))

    def close(self):
        self._sink.close()


class PreviewSink:
    """Headless analogue of the reference demo's live view: the C++
    driver imshows every warped frame as it streams
    (``opencv/DisplayImage.cpp:60-72``); with no display this dumps
    every Nth FINAL output frame as a PNG into a directory, inspectable
    while the render runs (``--preview DIR [--preview-every N]``)."""

    def __init__(self, sink, directory: str, every: int = 30):
        os.makedirs(directory, exist_ok=True)
        self._sink = sink
        self._dir = directory
        self._every = max(1, int(every))
        self._i = 0

    def write(self, planes):
        if self._i % self._every == 0:
            import cv2

            from video_annotator_tpu.io.video import yuv420_to_bgr

            y, u, v = (np.asarray(p) for p in planes)
            cv2.imwrite(
                os.path.join(self._dir, f"preview_{self._i:06d}.png"),
                yuv420_to_bgr(y.astype(np.uint8), u.astype(np.uint8),
                              v.astype(np.uint8)),
            )
        self._i += 1
        self._sink.write(planes)

    def close(self):
        self._sink.close()


class DisplaySink:
    """The reference demo's live view, for real: ``imshow`` each final
    output frame in a GUI window as the render streams
    (``opencv/DisplayImage.cpp:60-72``). Construct via
    :func:`make_display_sink`, which probes for an actually-working GUI
    first — a cv2 built without highgui, or no reachable display,
    degrades to the headless ``--preview`` path instead of crashing the
    render. ESC closes the window (display stops; the render
    continues)."""

    _WINDOW = "video_annotator_tpu"

    def __init__(self, sink):
        self._sink = sink
        self._open = True

    def write(self, planes):
        self._sink.write(planes)
        if not self._open:
            return
        import cv2

        from video_annotator_tpu.io.video import yuv420_to_bgr

        y, u, v = (np.asarray(p).astype(np.uint8) for p in planes)
        try:
            cv2.imshow(self._WINDOW, yuv420_to_bgr(y, u, v))
            # The reference loop's 1 ms waitKey pump (DisplayImage.cpp:70);
            # ESC closes the window without aborting the render.
            if cv2.waitKey(1) & 0xFF == 27:
                cv2.destroyWindow(self._WINDOW)
                self._open = False
        except cv2.error:
            # The display went away mid-render (X server died, SSH
            # forward dropped): stop displaying, keep rendering.
            self._open = False

    def close(self):
        if self._open:
            import cv2

            try:
                cv2.destroyWindow(self._WINDOW)
            except cv2.error:
                pass
        self._sink.close()


def gui_available() -> bool:
    """True when cv2 highgui can actually open a window on this host.

    Probed in a CHILD process: headless cv2 builds ``abort()`` inside
    ``namedWindow`` (uncatchable in-process), and GUI builds without a
    reachable display fail on the first event-loop pump. A dead child
    of any kind means "no GUI"."""
    import subprocess

    try:
        probe = subprocess.run(
            [sys.executable, "-c",
             "import cv2; cv2.namedWindow('__vat_probe__'); "
             "cv2.waitKey(1); cv2.destroyWindow('__vat_probe__')"],
            capture_output=True, timeout=20,
        )
        return probe.returncode == 0
    except Exception:
        return False


def make_display_sink(sink):
    """Wrap ``sink`` in a live :class:`DisplaySink` if a GUI actually
    works here; otherwise warn once and return ``sink`` unchanged.

    The probe opens (and immediately destroys) a real window IN A CHILD
    PROCESS — the only reliable test: headless cv2 builds ``abort()``
    inside ``namedWindow`` (uncatchable in-process), and GUI builds
    without a reachable display fail on the first event-loop pump. A
    dead child of any kind means "no GUI"; only a clean rc=0 lets the
    render's own process touch highgui."""
    if not gui_available():
        print("[render] --display: no usable GUI on this host; "
              "use --preview DIR for the headless live view",
              file=sys.stderr)
        return sink
    try:
        import cv2

        cv2.namedWindow(DisplaySink._WINDOW, cv2.WINDOW_AUTOSIZE)
        cv2.waitKey(1)
    except Exception as e:  # display vanished between probe and open
        print(f"[render] --display: GUI probe passed but the window "
              f"failed to open ({e!s:.120}); continuing headless",
              file=sys.stderr)
        return sink
    return DisplaySink(sink)


def wrap_preview(sink, options):
    """Wrap the RAW file sink (innermost): writes flow through the
    crop/HUD wrappers first, so the preview/display captures exactly the
    frame the container receives."""
    if getattr(options, "preview", None):
        sink = PreviewSink(sink, options.preview,
                           getattr(options, "preview_every", 30))
    if getattr(options, "display", False):
        sink = make_display_sink(sink)
    return sink


def apply_crop_rect(out_meta: VideoMeta, options):
    """(cropped VideoMeta, rect-or-None) for the --crop W:H[:X:Y] form."""
    spec = getattr(options, "crop_rect", None)
    if not spec:
        return out_meta, None
    rect = parse_crop_rect(spec, out_meta.width, out_meta.height)
    ch, cw, _, _ = rect
    return (
        VideoMeta(cw, ch, out_meta.fps, out_meta.num_frames),
        rect,
    )


def upsample_factor(upsample: float | None) -> float:
    """--upsample's scale factor. The reference inserts ``scale
    w=iw*upsample/100`` (``src/render.ts:227-231``), so the value is an
    ABSOLUTE percent: 150 -> 1.5x, 50 -> 0.5x, 0/unset -> off. A
    negative percent would silently build a negative output camera
    (scripts written against the old relative semantics might pass
    ``-50``), so reject it with a clear error instead."""
    if upsample and upsample < 0:
        raise ValueError(
            f"--upsample is an absolute percent of the input size "
            f"(150 = 1.5x, 50 = 0.5x); got {upsample}")
    return (upsample / 100.0) if upsample else 1.0


def output_fps(options, meta) -> Fraction:
    """The output frame rate: ``--frame-rate`` retimes the output (a
    header override, the reference's ffmpeg ``-r`` output option via
    ``outputOptions``; frame count unchanged), else the source's rate.
    Shared by encode/encode_2d/streaming/compare so the retime policy
    (e.g. the NTSC 1001 denominator) lives in one place."""
    return (Fraction(options.frame_rate).limit_denominator(1001)
            if options.frame_rate else meta.fps)


def build_cameras(meta: VideoMeta, o: RenderOptions):
    """Input camera from preset/dfov; output camera auto-fit or explicit.

    Follows the dewobble parameterization (``src/render.ts:630-692``): input
    is a fisheye camera with ``--input-dfov`` (or a GoPro preset); output is
    ``--projection`` with ``--output-dfov`` (default: auto-fit). The
    stabilise-buffer expands the canvas while stabilising so corrections
    don't crop (``src/cli.ts:98-103``).
    """
    # The input camera always matches the REAL decoded frames. The
    # reference's --upsample scales the video before its filter chain
    # (two resamples); here the fused warp resamples arbitrarily in one
    # pass, so upsampling folds into the OUTPUT camera scale instead —
    # same larger-canvas semantics, one resample, and the warp's source
    # intrinsics stay truthful.
    size = (meta.width, meta.height)
    if o.preset is not None:
        in_cam = get_preset_camera(o.preset, size)
    else:
        in_cam = camera_from_dfov(o.input_dfov, size, CameraModel.FISHEYE)

    out_scale = o.scale * upsample_factor(o.upsample)

    zoom = 1.0
    if o.stabilise != "none" and o.stabilise_buffer:
        zoom = 1.0 / (1.0 + o.stabilise_buffer / 100.0)

    out_model = PROJECTION_MODELS.get(o.projection, CameraModel.RECTILINEAR)
    if o.width and o.height and o.output_dfov:
        out_cam = camera_from_dfov(o.output_dfov, (o.width, o.height), out_model)
    elif out_model != CameraModel.RECTILINEAR:
        # Non-rectilinear output without an explicit camera: the
        # reference's v360 path applies the projection unconditionally
        # (`output: projection`, src/render.ts:523), so honor it here
        # too — canvas from the auto-fit, dfov defaulting to the input's
        # (the whole captured field, like v360's default fov passthrough).
        base = get_output_camera(
            in_cam, scale=out_scale, crop_borders=o.crop_borders, zoom=zoom
        )
        size = (o.width or base.width, o.height or base.height)
        out_cam = camera_from_dfov(o.output_dfov or o.input_dfov, size, out_model)
    elif o.output_dfov:
        # Rectilinear output with an explicit dfov but no full WxH:
        # canvas from the auto-fit (or the one given dimension),
        # intrinsics from the requested field of view — otherwise
        # `--output-dfov` alone would be silently ignored.
        base = get_output_camera(
            in_cam, scale=out_scale, crop_borders=o.crop_borders, zoom=zoom
        )
        size = (o.width or base.width, o.height or base.height)
        out_cam = camera_from_dfov(o.output_dfov, size, out_model)
    else:
        out_cam = get_output_camera(
            in_cam, scale=out_scale, crop_borders=o.crop_borders, zoom=zoom
        )
        if o.width or o.height:
            # A lone -w/-h fills the other dimension from the input
            # (x upsample), like the reference's `out_w: outputWidth ||
            # inputWidth` (src/render.ts:678-679) and v360's
            # `w: width || inputWidth*upsample` (src/render.ts:526-527).
            up = upsample_factor(o.upsample)
            tw = o.width or round(meta.width * up)
            th = o.height or round(meta.height * up)
            # Rescale the auto-fit camera onto the requested canvas:
            # match the horizontal field, and CENTER any vertical
            # aspect-change crop/pad — cy*sx alone would anchor the
            # crop at the top (scene center 180 px low for 4:3 -> 16:9).
            # The reference centers the output principal point too
            # (out_fx/out_fy default to half the canvas,
            # src/render.ts:680-681).
            sx = tw / out_cam.width
            out_cam = Camera.make(
                out_cam.fx * sx, out_cam.fy * sx, out_cam.cx * sx,
                out_cam.cy * sx - (out_cam.height * sx - th) / 2.0,
                tw, th, out_cam.model,
            )
    return in_cam, out_cam


# --- phase 1: analyse ------------------------------------------------------


def _tracker_key(meta: VideoMeta, options: RenderOptions) -> tuple:
    """Everything the analyse trackers depend on, as a hashable key:
    (width, height, preset, input dfov, analysis level, LK iterations).
    Renders of one geometry share one set of jitted trackers, so a process
    that analyses many clips (``workflow stabilise``, compare grids, the
    benchmarks) traces and compiles them once."""
    return (meta.width, meta.height, options.preset,
            float(options.input_dfov), analysis_level(options, meta),
            int(getattr(options, "analysis_iters", 8)))


def _analysis_cameras(width, height, preset, input_dfov, level):
    """(native input camera, camera of the tracking level)."""
    in_cam_native = (
        get_preset_camera(preset, (width, height))
        if preset is not None
        else camera_from_dfov(input_dfov, (width, height), CameraModel.FISHEYE)
    )
    return in_cam_native, mip_camera(in_cam_native, level)


def _make_tracker(meta: VideoMeta, options: RenderOptions):
    """Jitted (detect_step, track_step, track_chunk) shared by
    :func:`analyse` and the single-pass streaming renderer
    (``pipeline/streaming.py``)."""
    return _tracker(*_tracker_key(meta, options))


@functools.lru_cache(maxsize=8)
def _tracker(width, height, preset, input_dfov, level, lk_iters):
    # --analysis-scale: track on a box-downsampled luma pyramid level (the
    # reference's demo tracks at scale 0.5, opencv/DisplayImage.cpp:49-57).
    # Camera-frame rotations are resolution-independent, so the estimated
    # trajectory is unchanged in meaning; tracking cost drops ~4x/level.
    in_cam_native, in_cam_full = _analysis_cameras(
        width, height, preset, input_dfov, level)
    track_w = in_cam_full.width
    threshold = 8.0 / float(in_cam_native.fx)  # reference's 8 px gate, in rays
    min_distance, min_inliers, min_refresh = tracking_gates(track_w)
    border = tracking_border(track_w, in_cam_full.height)

    def _track_res(gray):
        return box_downsample(gray, level) if level else gray

    @functools.partial(jax.jit, static_argnames=("refresh_age",))
    def track_step(prev_gray, gray, pts, valid, prev_delta, r_acc, key,
                   refresh_age):
        """One fully-device analyse step: track + estimate + accumulate +
        (conditionally) refresh corners.

        The host never reads a device value per frame: a blocked round
        trip would stall the dispatch queue every frame. The key-frame
        low-corner refresh runs as a lax.cond on device; the age-based
        refresh is host-side bookkeeping (a static arg). Accumulation
        happens on device in f32 with an SO(3) re-projection per step
        (drift ~1e-7/step, invisible under the smoothing radius).
        """
        key, sub = jax.random.split(key)
        # Downsample the CURRENT frame only (the previous frame arrives
        # already small as the loop's carry).
        gray = _track_res(gray)
        new_pts, status = pyramidal_lk(prev_gray, gray, pts, valid,
                                       iters=lk_iters)
        rays_p = in_cam_full.unproject_unit(pts)
        rays_c = in_cam_full.unproject_unit(new_pts)
        est = estimate_rotation(
            rays_p, rays_c, status, sub, threshold_rad=threshold
        )
        delta = rotation_with_fallback(est, prev_delta, min_inliers=min_inliers)
        # R_t = dR . R_{t-1} (opencv/FrameSourceWarp.cpp:441); one
        # Newton-Schulz step keeps the product on SO(3) (both factors are
        # rotations to f32 rounding) without a per-frame scalar SVD.
        r_new = so3.orthonormalize(
            jnp.matmul(delta, r_acc, precision=jax.lax.Precision.HIGHEST)
        )
        if refresh_age:
            out_pts, out_valid = detect_corners(
                gray, max_corners=MAX_CORNERS, min_distance=min_distance,
                border=border,
            )
        else:
            out_pts, out_valid = jax.lax.cond(
                jnp.sum(status) < min_refresh,
                lambda: detect_corners(
                    gray, max_corners=MAX_CORNERS, min_distance=min_distance,
                    border=border,
                ),
                lambda: (new_pts, status),
            )
        return out_pts, out_valid, delta, r_new, key, gray

    @jax.jit
    def detect_step(gray):
        gray = _track_res(gray)
        return detect_corners(
            gray, max_corners=MAX_CORNERS, min_distance=min_distance,
            border=border,
        ) + (gray,)

    @jax.jit
    def track_chunk(pts, valid, prev_gray, prev_delta, r_acc, key, age,
                    frames):
        """Analyse a CHUNK of frames in one dispatch (``lax.scan``).

        Scanning G frames amortizes the per-dispatch host cost G-fold and
        is the natural two-phase shape (the decode prefetcher stacks the
        chunk). Math
        and RNG-split order are IDENTICAL to ``track_step`` — the
        chunked and per-frame paths produce the same trajectory
        (tested) — with the age-based key-frame refresh moved in-graph
        (carried as an int32, same reset rule as the host loop).
        """
        def step(carry, fr):
            pts, valid, prev_gray, pd, ra, k, age = carry
            k, sub = jax.random.split(k)
            gray = _track_res(fr)
            new_pts, status = pyramidal_lk(
                prev_gray, gray, pts, valid, iters=lk_iters)
            rays_p = in_cam_full.unproject_unit(pts)
            rays_c = in_cam_full.unproject_unit(new_pts)
            est = estimate_rotation(
                rays_p, rays_c, status, sub, threshold_rad=threshold
            )
            delta = rotation_with_fallback(est, pd,
                                           min_inliers=min_inliers)
            r_new = so3.orthonormalize(
                jnp.matmul(delta, ra,
                           precision=jax.lax.Precision.HIGHEST)
            )
            refresh_age = age >= KEY_FRAME_MAX_AGE
            out_pts, out_valid = jax.lax.cond(
                refresh_age | (jnp.sum(status) < min_refresh),
                lambda: detect_corners(
                    gray, max_corners=MAX_CORNERS,
                    min_distance=min_distance, border=border,
                ),
                lambda: (new_pts, status),
            )
            age = jnp.where(refresh_age, 0, age + 1)
            return (out_pts, out_valid, gray, delta, r_new, k, age), r_new

        carry, ras = jax.lax.scan(
            step, (pts, valid, prev_gray, prev_delta, r_acc, key, age),
            frames)
        return carry, ras

    return detect_step, track_step, track_chunk


def _make_pair_tracker(meta: VideoMeta, options: RenderOptions):
    """Jitted batched-pairs analyse chunk (``--analysis-mode paired``);
    see :func:`_pair_tracker`."""
    detect_level = max(0, int(getattr(options, "analysis_detect_level", 1)))
    return _pair_tracker(*_tracker_key(meta, options), detect_level)


@functools.lru_cache(maxsize=8)
def _pair_tracker(width, height, preset, input_dfov, level, lk_iters,
                  detect_level):
    """Jitted batched-pairs analyse chunk (``--analysis-mode paired``).

    The sequential tracker above is reference-faithful (point carryover +
    key-frame refresh, ``opencv/FrameSourceWarp.cpp:214-268``) but its
    lax.scan serializes ~15 small kernels per frame. This mode is the
    batched formulation of the same estimation: detect fresh corners on
    EVERY frame (batched vmap), LK-track all adjacent pairs at once
    (``jax.vmap`` of :func:`pyramidal_lk`), RANSAC every pair
    concurrently, and chain the deltas with an associative prefix
    product — the exact estimator math of the reference's per-frame
    loop, restructured so a chunk of G frames is a handful of launches
    instead of ~15 G.

    Identical gates to the sequential path: the 8 px/f reprojection
    threshold, the <40-inlier fallback to the previous delta
    (``FrameSourceWarp.cpp:432-438``; here an associative last-valid
    scan), and LK's drift/conditioning status bits. Per-pair RNG keys are
    folded from the GLOBAL frame index, so the trajectory is independent
    of the chunk size (and matches the multichip pipeline's convention,
    ``parallel/pipeline.py``).
    """
    in_cam_native, in_cam_full = _analysis_cameras(
        width, height, preset, input_dfov, level)
    track_w = in_cam_full.width
    threshold = 8.0 / float(in_cam_native.fx)
    min_distance, min_inliers, _ = tracking_gates(track_w)
    border = tracking_border(track_w, in_cam_full.height)
    # Corner DETECTION runs one extra pyramid level down (default):
    # response + NMS cost scale with pixels, while corner POSITIONS only
    # seed LK, whose 21x21 window and min-eig gate re-validate the patch
    # at track resolution. Ground truth and
    # quality.py score the combination; --analysis-detect-level 0
    # restores track-resolution detection.
    det_md = max(1, min_distance >> detect_level)
    det_border = max(4, -(-border // (1 << detect_level)))
    det_scale = float(1 << detect_level)

    def _track_res(gray):
        return box_downsample(gray, level) if level else gray

    @jax.jit
    def pair_chunk(r_base, prev_delta, key, offset, frames):
        """(G+1, H, W) frames (element 0 = previous chunk's last frame)
        -> (r_base', prev_delta', (G, 3, 3) accumulated rotations)."""
        grays = jax.vmap(_track_res)(frames.astype(jnp.float32))
        g = frames.shape[0] - 1
        det_in = (
            jax.vmap(lambda im: box_downsample(im, detect_level))(grays[:-1])
            if detect_level else grays[:-1]
        )
        pts, valid = jax.vmap(
            lambda im: detect_corners(
                im, max_corners=MAX_CORNERS, min_distance=det_md,
                border=det_border,
            )
        )(det_in)
        if detect_level:
            # box_downsample pixel centers: track coord = s*x + (s-1)/2.
            pts = pts * det_scale + (det_scale - 1.0) * 0.5
        new_pts, status = jax.vmap(
            lambda a, b, p, v: pyramidal_lk(a, b, p, v, iters=lk_iters)
        )(grays[:-1], grays[1:], pts, valid)
        rays_p = in_cam_full.unproject_unit(pts)
        rays_c = in_cam_full.unproject_unit(new_pts)
        keys = jax.vmap(
            lambda i: jax.random.fold_in(key, i)
        )(offset + jnp.arange(g))
        ests = jax.vmap(
            lambda rp, rc, st, k: estimate_rotation(
                rp, rc, st, k, threshold_rad=threshold
            )
        )(rays_p, rays_c, status, keys)

        # Inlier-gated fallback as an associative last-valid scan: a
        # failed pair inherits the nearest preceding good delta (seeded
        # with the carry), exactly the sequential rotation_with_fallback
        # chain.
        ok = jnp.concatenate(
            [jnp.ones((1,), bool), ests.num_inliers >= min_inliers]
        )
        rots = jnp.concatenate([prev_delta[None], ests.rotation])

        def last_ok(a, b):
            ok_a, r_a = a
            ok_b, r_b = b
            return ok_a | ok_b, jnp.where(ok_b[..., None, None], r_b, r_a)

        _, deltas_all = jax.lax.associative_scan(last_ok, (ok, rots), axis=0)
        deltas = deltas_all[1:]

        # R_t = delta_t . delta_{t-1} ... delta_1 . r_base (the
        # reference's R_t = dR . R_{t-1}), as a prefix product.
        prods = jax.lax.associative_scan(
            lambda a, b: so3.matmul(b, a), deltas, axis=0
        )
        rs = jax.vmap(so3.orthonormalize)(so3.matmul(prods, r_base))
        return rs[-1], deltas[-1], rs

    return pair_chunk


def analyse(
    source: str,
    options: RenderOptions,
    profiler: Optional[StageProfiler] = None,
) -> Trajectory:
    """Estimate the per-frame accumulated camera rotation trajectory."""
    prof = profiler or StageProfiler()
    reader, meta, first, last = open_trimmed(source, options)
    if resolve_analysis_mode(options) == "paired":
        return _analyse_paired(source, options, prof, reader, meta,
                               first, last)
    detect_step, track_step, track_chunk = _make_tracker(meta, options)

    chunk_n = max(1, int(options.analysis_chunk))
    r_list = []
    r_acc = jnp.eye(3, dtype=jnp.float32)
    prev_delta = jnp.eye(3, dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    prev_gray = None
    pts = valid = None
    age = 0
    age_dev = jnp.int32(0)
    pending: list = []
    idx = reader.start_frame - 1
    from video_annotator_tpu.io.prefetch import DevicePrefetcher

    def flush_chunk():
        """One lax.scan dispatch over the buffered frames (pad the tail
        by repeating its last frame; padded outputs are dropped and the
        polluted carry only matters after EOF)."""
        nonlocal pts, valid, prev_gray, prev_delta, r_acc, key, age_dev
        k = len(pending)
        if not k:
            return
        frames = pending + [pending[-1]] * (chunk_n - k)
        stacked = jnp.stack(frames)
        pending.clear()
        (pts, valid, prev_gray, prev_delta, r_acc, key, age_dev), ras = (
            track_chunk(pts, valid, prev_gray, prev_delta, r_acc, key,
                        age_dev, stacked))
        r_list.append(ras[:k])

    # Uploads happen uint8 on the prefetch thread (the jitted steps
    # convert); an in-loop host-side device_put serializes the loop on
    # transfer bandwidth.
    pre = DevicePrefetcher(prof.wrap_iter("decode", iter(reader)),
                           depth=options.prefetch_depth)
    prog = Progress("analyse", total=(last - first) if meta.num_frames else None)
    try:
        for y, _, _ in pre:
            idx += 1
            if idx < first:
                continue
            if idx >= last:
                break
            if prev_gray is None:
                with prof.stage("detect"):
                    pts, valid, prev_gray = detect_step(y)
                r_list.append(r_acc[None])
            elif chunk_n > 1:
                with prof.stage("track"):
                    pending.append(y)
                    if len(pending) >= chunk_n:
                        flush_chunk()
            else:
                with prof.stage("track"):
                    pts, valid, prev_delta, r_acc, key, prev_gray = track_step(
                        prev_gray, y, pts, valid, prev_delta, r_acc, key,
                        refresh_age=age >= KEY_FRAME_MAX_AGE,
                    )
                    r_list.append(r_acc[None])
                age = 0 if age >= KEY_FRAME_MAX_AGE else age + 1
            prog.tick()
        with prof.stage("track"):
            flush_chunk()
    finally:
        prog.close()
        pre.close()
        reader.close()

    # One device->host sync for the whole trajectory.
    with prof.stage("collect"):
        if r_list:
            rs = jnp.concatenate(r_list, axis=0)
            rotvecs = np.asarray(jax.jit(jax.vmap(so3.log))(rs), np.float64)
        else:
            rotvecs = np.zeros((0, 3))

    return Trajectory(
        params=rotvecs,
        kind="so3",
        fps=meta.fps,
        width=meta.width,
        height=meta.height,
        source=source,
        # Telemetry extraction + gravity integration are pure cost unless
        # the horizon lock consumes the result.
        up0=_estimate_up0(source, float(first) / float(meta.fps))
        if options.horizon_lock
        else None,
    )


def _analyse_paired(source, options, prof, reader, meta, first, last):
    """Analyse loop for ``--analysis-mode paired`` (see
    :func:`_make_pair_tracker`): chunks of G+1 frames (one-frame overlap
    carries the pair chain across chunks) feed one batched dispatch each.
    Output schema is identical to the sequential path."""
    pair_chunk = _make_pair_tracker(meta, options)
    chunk_n = max(1, int(options.analysis_chunk))
    r_list = []
    r_base = jnp.eye(3, dtype=jnp.float32)
    prev_delta = jnp.eye(3, dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    prev_frame = None
    pending: list = []
    emitted = 0
    idx = reader.start_frame - 1
    from video_annotator_tpu.io.prefetch import DevicePrefetcher

    def flush_chunk():
        """Pad the tail by repeating its last frame (only possible at
        EOF); padded outputs are dropped and the polluted carry only
        matters after EOF — the same contract as the sequential path."""
        nonlocal prev_frame, r_base, prev_delta, emitted
        k = len(pending)
        if not k:
            return
        frames = [prev_frame] + pending + [pending[-1]] * (chunk_n - k)
        prev_frame = pending[-1]
        pending.clear()
        r_base, prev_delta, rs = pair_chunk(
            r_base, prev_delta, key, jnp.int32(emitted), jnp.stack(frames)
        )
        emitted += k
        r_list.append(rs[:k])

    pre = DevicePrefetcher(prof.wrap_iter("decode", iter(reader)),
                           depth=options.prefetch_depth)
    prog = Progress("analyse",
                    total=(last - first) if meta.num_frames else None)
    try:
        for y, _, _ in pre:
            idx += 1
            if idx < first:
                continue
            if idx >= last:
                break
            if prev_frame is None:
                prev_frame = y
                r_list.append(r_base[None])
            else:
                with prof.stage("track"):
                    pending.append(y)
                    if len(pending) >= chunk_n:
                        flush_chunk()
            prog.tick()
        with prof.stage("track"):
            flush_chunk()
    finally:
        prog.close()
        pre.close()
        reader.close()

    with prof.stage("collect"):
        if r_list:
            rs = jnp.concatenate(r_list, axis=0)
            rotvecs = np.asarray(jax.jit(jax.vmap(so3.log))(rs), np.float64)
        else:
            rotvecs = np.zeros((0, 3))

    return Trajectory(
        params=rotvecs,
        kind="so3",
        fps=meta.fps,
        width=meta.width,
        height=meta.height,
        source=source,
        up0=_estimate_up0(source, float(first) / float(meta.fps))
        if options.horizon_lock
        else None,
    )


def _estimate_up0(source: str, t0: float) -> Optional[np.ndarray]:
    """World-up in frame-0 camera coords from GPMF GYRO+ACCL, or None.

    Silently absent for sources without telemetry — --horizon-lock then
    falls back to assuming the first frame was level.
    """
    try:
        from video_annotator_tpu.io.gpmf import extract_imu
        from video_annotator_tpu.smoothing.horizon import estimate_up_direction

        imu = extract_imu(source)
        if imu[b"GYRO"] is None or imu[b"ACCL"] is None:
            return None
        omega, ts = imu[b"GYRO"]
        accl, accl_ts = imu[b"ACCL"]
        return estimate_up_direction(omega, ts, accl, accl_ts, t0=t0)
    except Exception:
        return None


def _gyro_frame_times(source: str, gyro_ts):
    """(frame_ts, fps, width, height): video frame timestamps, from the
    container's video track when available, else a synthetic grid."""
    from video_annotator_tpu.io.mp4 import parse_tracks

    frame_ts = None
    meta_w = meta_h = 0
    fps = Fraction(30, 1)
    try:
        for track in parse_tracks(source):
            if track.handler_type == b"vide" and track.sample_times:
                frame_ts = np.asarray(track.sample_times)
                if len(frame_ts) > 1:
                    fps = Fraction(
                        1.0 / float(np.median(np.diff(frame_ts)))
                    ).limit_denominator(1001)
                break
    except Exception:
        pass
    if frame_ts is None:
        try:
            reader = open_reader(source)
            meta = reader.meta
            reader.close()
            fps = meta.fps
            meta_w, meta_h = meta.width, meta.height
            n = meta.num_frames or int(
                (gyro_ts[-1] - gyro_ts[0]) * float(fps)
            ) + 1
        except Exception:
            # telemetry-only file: frame grid from the gyro span at 30 fps
            n = int((gyro_ts[-1] - gyro_ts[0]) * 30.0) + 1
        frame_ts = gyro_ts[0] + np.arange(n) / float(fps)
    return frame_ts, fps, meta_w, meta_h


def analyse_gyro(
    source: str,
    options: RenderOptions,
    profiler: Optional[StageProfiler] = None,
) -> Trajectory:
    """Trajectory from the GPMF gyro track instead of visual tracking.

    The design the reference sketched but never wired up
    (``opencv/gpmf.cpp:82-105``; demux hook TODO at
    ``opencv/AvFrameSourceFileVaapi.cpp:121-125``): integrate angular-rate
    samples on SO(3) and resample at frame timestamps. Massively cheaper
    than vision (no decode needed for analysis at all) and immune to
    texture-poor footage.
    """
    prof = profiler or StageProfiler()
    from video_annotator_tpu.io.gpmf import extract_gyro
    from video_annotator_tpu.smoothing.gyro import integrate_gyro

    with prof.stage("gyro-parse"):
        omega, ts = extract_gyro(source)

    frame_ts, fps, meta_w, meta_h = _gyro_frame_times(source, ts)
    # Honor the trim window like the visual analyser: encode() indexes
    # corrections from the trimmed range's first frame, and the trajectory
    # rebases there (integrate_gyro's first resample time is identity).
    meta_stub = VideoMeta(meta_w, meta_h, fps, len(frame_ts))
    first, last = _frame_range(meta_stub, options)
    frame_ts = frame_ts[first:min(last, len(frame_ts))]
    if len(frame_ts) == 0:
        raise ValueError("trim window selects no frames")

    with prof.stage("gyro-integrate"):
        import jax.numpy as jnp_

        R = integrate_gyro(
            jnp_.asarray(omega, jnp_.float32),
            jnp_.asarray(ts, jnp_.float32),
            jnp_.asarray(frame_ts, jnp_.float32),
        )
        # integrate_gyro returns attitude R_t (world-from-camera increments);
        # the measured trajectory convention is C_t C_0^-1 = R_t^-1.
        rotvecs = -np.asarray(so3.log(R), np.float64)

    up0 = None
    if options.horizon_lock:
        try:
            from video_annotator_tpu.io.gpmf import extract_accl
            from video_annotator_tpu.smoothing.horizon import (
                estimate_up_direction,
            )

            accl, accl_ts = extract_accl(source)
            up0 = estimate_up_direction(
                omega, ts, accl, accl_ts, t0=float(frame_ts[0])
            )
        except Exception:
            pass

    return Trajectory(
        params=rotvecs,
        kind="so3",
        fps=fps,
        width=meta_w,
        height=meta_h,
        source=source,
        up0=up0,
    )


# --- phase 2: encode -------------------------------------------------------


def _lock_and_attitude(measured, virtual, options: RenderOptions, up):
    """corr = measured . virtual^T, with optional horizon lock + attitude.

    Shared tail of every corrections path (two-phase, streaming, kalman).
    """
    if options.horizon_lock:
        from video_annotator_tpu.smoothing.horizon import level_horizon

        virtual = level_horizon(virtual, up)
        corr = so3.matmul(measured, jnp.swapaxes(virtual, -1, -2))
    elif options.stabilise == "none":
        corr = jnp.broadcast_to(
            jnp.eye(3, dtype=measured.dtype), measured.shape
        )
    else:
        corr = so3.matmul(measured, jnp.swapaxes(virtual, -1, -2))
    attitude = so3.from_euler(
        np.radians(options.roll), np.radians(options.pitch),
        np.radians(options.yaw),
    )
    return so3.matmul(corr, attitude[None].astype(measured.dtype))


def make_window_corrections(radius: int, options: RenderOptions,
                            up0: Optional[np.ndarray]):
    """Jitted (B + 2*radius, 3, 3) measured window -> (B, 3, 3) corrections.

    THE corrections math — the two-phase path calls it with the whole
    replicate-padded trajectory as one window; the streaming path calls it
    per emitted batch (with clamp-replicated neighbors), so the two paths
    cannot diverge. ``radius`` is the savgol window radius (0 for
    none/fixed modes; savgol_weights(0) is the identity kernel).

    ``--smoother kalman`` gets a FIXED-LAG window form here (the hook the
    reference placed in its streaming engine,
    ``opencv/FrameSourceWarp.cpp:167-175``): the constant-velocity filter
    runs forward over the whole window — the ``radius`` past frames are
    its burn-in — and the RTS pass runs backward from the window end, so
    each emitted frame is smoothed with exactly ``radius`` frames of
    future (lag = the lookahead the streaming ring already holds). The
    filter's memory is ~(r_noise/q_noise)^(1/4) ~= 10 frames, far under
    the default radius, so the truncation-vs-global-RTS divergence is
    tiny away from clip edges (pinned by
    ``tests/test_streaming.py::test_streaming_kalman_fixed_lag`` and the
    ``rotation_smooth_kalman_streaming`` row of benchmarks/quality.json).
    """
    if options.stabilise not in ("none", "fixed", "smooth"):
        raise ValueError(f"unknown stabilise mode {options.stabilise!r}")
    if getattr(options, "smoother", "savgol") not in ("savgol", "kalman"):
        # Validated here (not just argparse choices) so programmatic
        # callers fail like the streaming path instead of silently
        # smoothing with savgol.
        raise ValueError(f"unknown smoother {options.smoother!r}")
    from video_annotator_tpu.smoothing.kalman import smooth_rotations_kalman
    from video_annotator_tpu.smoothing.savgol import savgol_weights, sg_conv

    w = jnp.asarray(savgol_weights(radius, order=2))
    up = jnp.asarray(
        up0 if up0 is not None else np.asarray([0.0, -1.0, 0.0]), jnp.float32
    )

    @jax.jit
    def window_corr(window):  # (B + 2*radius, 3, 3) f32
        measured = window[radius : window.shape[0] - radius]
        if options.stabilise == "none":
            virtual = measured
        elif options.stabilise == "fixed":
            virtual = jnp.broadcast_to(
                jnp.eye(3, dtype=window.dtype), measured.shape
            )
        elif options.smoother == "kalman":
            virtual = smooth_rotations_kalman(window)[
                radius : window.shape[0] - radius]
        else:
            sm = sg_conv(window.reshape(-1, 9), w)
            virtual = so3.project(sm.reshape(-1, 3, 3))
        return _lock_and_attitude(measured, virtual, options, up)

    return window_corr


def compute_corrections(traj: Trajectory, options: RenderOptions) -> np.ndarray:
    """Per-frame warp rotations: stabilization correction + attitude."""
    measured = jnp.asarray(traj.rotations())
    t = measured.shape[0]
    if t == 0:
        return np.zeros((0, 3, 3), np.float32)

    if options.stabilise == "smooth" and options.smoother == "kalman":
        # Global (whole-trajectory) smoother; no window form exists.
        virtual = smooth_rotations_kalman(measured)
        up0 = traj.up0 if traj.up0 is not None else None
        up = jnp.asarray(
            up0 if up0 is not None else np.asarray([0.0, -1.0, 0.0]),
            measured.dtype,
        )
        return np.asarray(_lock_and_attitude(measured, virtual, options, up))

    radius = (
        min(options.stabilise_radius, max(t - 1, 1))
        if options.stabilise == "smooth"
        else 0
    )
    fn = make_window_corrections(radius, options, traj.up0)
    window = measured
    if radius:
        window = jnp.concatenate(
            [
                jnp.broadcast_to(measured[:1], (radius, 3, 3)),
                measured,
                jnp.broadcast_to(measured[-1:], (radius, 3, 3)),
            ]
        )
    return np.asarray(fn(window))


@functools.lru_cache(maxsize=16)
def _yuv_batch_fns(out_key, in_key, out_size, interp: str, mip: int):
    """(warp_frames, warp_batch) jitted for one warp geometry.

    ``warp_frames(ys, us, vs, rotations)`` maps stacked (B, H, W) planes
    to stacked uint8 planes; ``warp_batch`` takes per-frame plane tuples
    and returns a list of uint8 triples — both ONE dispatch per batch.
    Cached by geometry, so every warper of one clip geometry shares one
    executable."""
    out_cam = camera_from_key(out_key)
    in_cam = camera_from_key(in_key)

    def one(y, u, v, rotation):
        if mip:
            y, u, v = (box_downsample(p, mip) for p in (y, u, v))
        return tuple(to_uint8(p) for p in warp_yuv420_xla(
            y, u, v, out_cam, in_cam, rotation, out_size, interp=interp))

    def warp_frames(ys, us, vs, rotations):
        return jax.vmap(one)(ys, us, vs, rotations.astype(jnp.float32))

    @jax.jit
    def warp_batch(ys, us, vs, rotations):
        wy, wu, wv = warp_frames(jnp.stack(ys), jnp.stack(us), jnp.stack(vs),
                                 rotations)
        return [(wy[i], wu[i], wv[i]) for i in range(len(ys))]

    return jax.jit(warp_frames), warp_batch


@functools.lru_cache(maxsize=16)
def warp_2d_batch_fn(kind: str, in_size, out_size, interp: str):
    """Batched uint8 warp of a 2D family, jitted for one geometry.

    ``kind`` is a trajectory kind: "similarity" (params (B, 4), any
    ``interp``, output ``out_size``) or "translation" (deshake offsets
    (B, 2), bilinear with the blurred-edge fill, output = input size).
    ``warp_batch(ys, us, vs, params)`` takes per-frame plane tuples of
    any dtype, cuts them to the even ``in_size`` (h, w), and returns a
    list of uint8 triples in ONE dispatch, as ``FrameWarper`` does."""
    from video_annotator_tpu.models.deshake import warp_frame_deshake
    from video_annotator_tpu.models.similarity import warp_frame_similarity

    if kind == "similarity":
        fn = functools.partial(warp_frame_similarity, interp=interp,
                               out_size=tuple(out_size))
    elif kind == "translation":
        fn = warp_frame_deshake
    else:
        raise ValueError(f"no 2D warp for trajectory kind {kind!r}")
    h, w = in_size

    def one(y, u, v, params):
        planes = (y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2])
        return tuple(to_uint8(p) for p in fn(
            *(p.astype(jnp.float32) for p in planes), params))

    @jax.jit
    def warp_batch(ys, us, vs, params):
        wy, wu, wv = jax.vmap(one)(jnp.stack(ys), jnp.stack(us),
                                   jnp.stack(vs), params.astype(jnp.float32))
        return [(wy[i], wu[i], wv[i]) for i in range(len(ys))]

    return warp_batch


class FrameWarper:
    """Batched YUV 4:2:0 warp of the rotation family (plain XLA)."""

    def __init__(self, in_cam: Camera, out_cam: Camera,
                 prefilter: bool = False, interp: str = "bilinear"):
        self.in_cam = in_cam
        self.out_cam = out_cam
        # Even output dims for 4:2:0 chroma.
        self.out_w = out_cam.width - out_cam.width % 2
        self.out_h = out_cam.height - out_cam.height % 2
        if interp not in ("bilinear", "bicubic", "lanczos"):
            raise ValueError(
                f"--interp must be bilinear, bicubic or lanczos, got {interp!r}"
            )
        self.interp = interp
        # Opt-in minification prefilter: sample a box-downsampled mip
        # level, antialiased. One global level, the minimum over the field
        # (often 0), so no output pixel ever blurs; prefilter=False is
        # bit-identical to the unfiltered path.
        self.mip = (
            mip_prefilter_level(out_cam, in_cam, (self.out_h, self.out_w))
            if prefilter else 0
        )
        self.in_eff = mip_camera(in_cam, self.mip)
        self.warp_frames, self._warp_batch = _yuv_batch_fns(
            camera_key(out_cam), camera_key(self.in_eff),
            (self.out_h, self.out_w), interp, self.mip,
        )

    def warp_yuv_batch(self, ys, us, vs, rotations):
        """Warp a batch of frames in ONE dispatch; list of uint8 triples.

        ``ys``/``us``/``vs`` are per-frame planes of any dtype;
        ``rotations`` is (B, 3, 3), or (B, n_bands, 3, 3) rolling-shutter
        stacks."""
        return self._warp_batch(tuple(ys), tuple(us), tuple(vs), rotations)

    def warp_yuv(self, y, u, v, rotation):
        """Warp one frame to uint8 planes (a batch of one)."""
        return self.warp_yuv_batch(
            (y,), (u,), (v,), jnp.asarray(rotation)[None])[0]


def encode(
    source: str,
    dest: Optional[str],
    traj: Trajectory,
    options: RenderOptions,
    profiler: Optional[StageProfiler] = None,
) -> VideoMeta:
    """Smooth + warp + write. Returns the output metadata."""
    prof = profiler or StageProfiler()
    reader, meta, first, last = open_trimmed(source, options)
    in_cam, out_cam = build_cameras(meta, options)
    corrections = compute_corrections(traj, options)

    # Rolling-shutter mode: per-frame corrections become per-BAND
    # rotations (scanline-time poses, one per RS_BAND_ROWS output rows).
    if options.rolling_shutter:
        from video_annotator_tpu.smoothing.rolling import (
            rs_row_rotations,
            rs_row_rotations_gyro,
            scan_fractions,
        )

        n_bands = -(-(
            out_cam.height - out_cam.height % 2
        ) // RS_BAND_ROWS)
        fractions = scan_fractions(out_cam, in_cam, n_bands)
        rows = None
        if options.gyro:
            # Exact scanline poses from the ~400 Hz telemetry (captures
            # intra-frame acceleration the velocity model cannot).
            try:
                from video_annotator_tpu.io.gpmf import extract_gyro

                omega, gts = extract_gyro(source)
                all_ts, _, _, _ = _gyro_frame_times(source, gts)
                first_f, last_f = _frame_range(
                    VideoMeta(meta.width, meta.height, meta.fps,
                              len(all_ts)),
                    options,
                )
                f_ts = all_ts[first_f:min(last_f, len(all_ts))]
                f_ts = f_ts[: traj.num_frames]
                if len(f_ts) == traj.num_frames:
                    rows = np.asarray(rs_row_rotations_gyro(
                        jnp.asarray(corrections),
                        jnp.asarray(omega, jnp.float32),
                        jnp.asarray(gts, jnp.float32),
                        jnp.asarray(f_ts, jnp.float32),
                        options.rolling_shutter / float(meta.fps),
                        fractions,
                    ))
            except Exception:
                rows = None  # no telemetry: velocity model below
        if rows is None:
            rows = np.asarray(rs_row_rotations(
                jnp.asarray(corrections), jnp.asarray(traj.rotations()),
                options.rolling_shutter, fractions,
            ))
        corrections = rows

    warper = FrameWarper(in_cam, out_cam,
                         prefilter=options.prefilter == "auto",
                         interp=options.interp)
    out_meta = VideoMeta(
        width=warper.out_w,
        height=warper.out_h,
        fps=output_fps(options, meta),
        num_frames=traj.num_frames,
    )
    write_meta, crop_r = apply_crop_rect(out_meta, options)
    sink = wrap_preview(
        open_writer(None if options.no_output else dest, write_meta,
                    encoder=options.encoder,
                    **_passthrough_kwargs(source, meta, options)),
        options,
    )
    if options.debug:
        from video_annotator_tpu.pipeline.debug import (
            DebugOverlayWriter,
            rotation_angles_deg,
        )

        corr_np = np.asarray(corrections, np.float32)
        # Rolling-shutter rows: HUD the center scanline's correction.
        corr_mats = (
            corr_np if corr_np.ndim == 3 else corr_np[:, corr_np.shape[1] // 2]
        )
        corr_deg = rotation_angles_deg(corr_mats)
        meas_deg = rotation_angles_deg(
            np.asarray(traj.rotations(), np.float32)[: len(corr_deg)]
        )
        sink = DebugOverlayWriter(
            sink, total=traj.num_frames,
            curves={"measured deg": meas_deg, "correction deg": corr_deg},
        )
        sink.text = {
            t: f"frame {t}  correction {corr_deg[t]:.2f} deg"
            for t in range(len(corr_deg))
        }
    if crop_r:
        # Crop BEFORE the debug overlay draws (outermost wrapper): the
        # HUD lands on the final cropped frame instead of being sliced
        # away with the discarded region.
        sink = CropSink(sink, crop_r)
    _batched_encode_loop(reader, sink, corrections, warper.warp_yuv_batch,
                         options, prof, first, last, traj.num_frames)
    return out_meta


def _batched_encode_loop(reader, sink, corrections, warp_yuv_batch, options,
                         prof, first, last, total):
    """Shared device-batched encode loop: async writer thread, device
    prefetch, per-batch pre-uploaded correction stacks, padded tail flush.

    Used by every family: corrections are (T, 3, 3) rotation matrices,
    (T, ny, 3, 3) rolling-shutter stacks, or (T, k) 2D sampling
    parameters (``warp_2d_batch_fn``).
    """
    from video_annotator_tpu.io.prefetch import (
        AsyncFrameWriter,
        DevicePrefetcher,
    )

    writer = AsyncFrameWriter(sink)

    # Pre-upload per-BATCH rotation stacks: an eager host->device transfer
    # (or a device-array slice) inside the frame loop would be one more
    # dispatch per frame.
    corr = np.asarray(corrections, np.float32)
    # 32 frames per dispatch amortize the per-dispatch host cost; 32
    # frames of 4K YUV in + out, twice in flight, is ~2 GB of device
    # memory.
    batch = options.warp_batch or max(
        1, int(os.environ.get("VAT_WARP_BATCH", "32")))
    rots_dev = [
        jax.device_put(
            np.concatenate([corr[i : i + batch]]
                           + [corr[-1:]] * max(0, i + batch - len(corr)))
        )
        for i in range(0, len(corr), batch)
    ]

    pre = DevicePrefetcher(prof.wrap_iter("decode", iter(reader)),
                           depth=options.prefetch_depth)
    idx = reader.start_frame - 1
    t = 0
    pending = []
    prog = Progress("encode", total=total)

    def flush():
        # Pad short tails by repeating the last frame (same compiled
        # batch size for every dispatch); padded outputs are dropped.
        n = len(pending)
        if not n:
            return
        ys, us, vs = zip(*(pending + [pending[-1]] * (batch - n)))
        rots = rots_dev[(t - n) // batch]
        with prof.stage("warp"):
            outs = warp_yuv_batch(ys, us, vs, rots)
        with prof.stage("encode"):
            # Device arrays go straight to the writer thread; readback
            # overlaps with the next batches' dispatches.
            for triple in outs[:n]:
                writer.write(triple)
        pending.clear()
        prog.tick(n)

    try:
        for y, u, v in pre:
            idx += 1
            if idx < first:
                continue
            if idx >= last or t >= corr.shape[0]:
                break
            pending.append((y, u, v))
            t += 1
            if len(pending) == batch:
                flush()
        flush()
    except BaseException:
        # Best-effort cleanup so the output container is finalized (a
        # valid truncated file, not a corrupt one) and the decode thread
        # stops; the original error stays the one that surfaces.
        pre.close()
        try:
            writer.close()
        except Exception:
            pass
        reader.close()
        raise
    prog.close()
    pre.close()
    with prof.stage("encode"):
        writer.close()
    reader.close()


def encode_2d(
    source: str,
    dest: Optional[str],
    traj: Trajectory,
    options: RenderOptions,
    profiler: Optional[StageProfiler] = None,
) -> VideoMeta:
    """Encode phase for the 2D families (similarity / deshake)."""
    from video_annotator_tpu.models.deshake import deshake_corrections
    from video_annotator_tpu.models.similarity import similarity_corrections

    prof = profiler or StageProfiler()
    # --upsample: the reference scales the video BEFORE its 2D filter
    # chain (``src/cli.ts:46-51``). A similarity absorbs the scale
    # EXACTLY — M @ diag(1/s, 1/s, 1) is still a similarity (same
    # dx/dy/angle, log_scale - log s) — so the canvas grows and content
    # upscales in the same single resample. Translation-only deshake
    # cannot express scale; reject rather than silently ignore (checked
    # BEFORE opening the decoder; render() rejects it before analyse).
    up = upsample_factor(options.upsample)
    if up != 1.0 and traj.kind != "similarity":
        raise ValueError(
            "--upsample with --filter deshake is not supported (a "
            "translation-only warp cannot scale); use the similarity or "
            "rotation family"
        )
    reader, meta, first, last = open_trimmed(source, options)
    out_w = int(meta.width * up) // 2 * 2
    out_h = int(meta.height * up) // 2 * 2
    if traj.kind == "similarity":
        corrections = similarity_corrections(traj, options)
        if up != 1.0:
            # Compose with the pixel-center-correct upscale sampler
            # x_src = (x + 0.5)/s - 0.5 (ffmpeg's scale-filter siting):
            # a pure similarity (translation c, log-scale -log s).
            from video_annotator_tpu.ops.affine import compose_similarity

            c = 0.5 * (1.0 / up - 1.0)
            t_up = jnp.asarray([c, c, 0.0, -np.log(up)], jnp.float32)
            corrections = np.asarray(
                jax.vmap(lambda p: compose_similarity(p, t_up))(
                    jnp.asarray(corrections, jnp.float32)
                )
            )
    elif traj.kind == "translation":
        corrections = deshake_corrections(traj, options)
    else:
        raise ValueError(f"encode_2d cannot handle kind {traj.kind!r}")

    out_meta = VideoMeta(
        width=out_w,
        height=out_h,
        fps=output_fps(options, meta),
        num_frames=traj.num_frames,
    )
    write_meta, crop_r = apply_crop_rect(out_meta, options)
    writer = wrap_preview(open_writer(
        None if options.no_output else dest, write_meta,
        encoder=options.encoder,
        **_passthrough_kwargs(source, meta, options)), options)
    if options.debug:
        from video_annotator_tpu.pipeline.debug import DebugOverlayWriter

        corr_np = np.asarray(corrections, np.float32)
        meas_np = np.asarray(traj.params, np.float32)[: len(corr_np)]
        unit = "px"
        curves = {
            "measured px": np.linalg.norm(meas_np[:, :2], axis=1),
            "correction px": np.linalg.norm(corr_np[:, :2], axis=1),
        }
        if corr_np.shape[1] >= 3:  # similarity: (dx, dy, angle, log_scale)
            curves["correction deg"] = np.degrees(np.abs(corr_np[:, 2]))
        writer = DebugOverlayWriter(writer, total=traj.num_frames,
                                    curves=curves)
        writer.text = {
            k: f"frame {k}  correction "
               f"{np.linalg.norm(corr_np[k, :2]):.1f} {unit}"
            for k in range(len(corr_np))
        }
    if crop_r:
        # Crop before the overlay draws (see encode): the HUD stays on
        # the cropped output.
        writer = CropSink(writer, crop_r)
    in_size = (meta.height - meta.height % 2, meta.width - meta.width % 2)
    warp = warp_2d_batch_fn(traj.kind, in_size, (out_h, out_w),
                            options.interp)
    _batched_encode_loop(reader, writer, corrections, warp, options, prof,
                         first, last, traj.num_frames)
    return out_meta


def render(
    source: str,
    dest: Optional[str],
    options: RenderOptions | None = None,
    profiler: Optional[StageProfiler] = None,
) -> None:
    """Two-phase render with trajectory checkpoint/resume
    (``src/render.ts:1387-1399``)."""
    from video_annotator_tpu.models import FILTER_ALIASES

    options = options or RenderOptions()
    prof = profiler or StageProfiler()
    family = FILTER_ALIASES.get(options.filter)
    if family is None:
        raise ValueError(
            f"unknown --filter {options.filter!r}; choose from "
            f"{sorted(FILTER_ALIASES)}"
        )
    if upsample_factor(options.upsample) != 1.0 and family == "deshake":
        # Checked again in encode_2d; rejecting here avoids running a
        # whole analyse phase before the error surfaces.
        raise ValueError(
            "--upsample with --filter deshake is not supported (a "
            "translation-only warp cannot scale); use the similarity or "
            "rotation family"
        )
    if options.horizon_lock and family != "rotation":
        raise ValueError(
            "--horizon-lock needs the rotation family "
            "(--filter rotation/dewobble); 2D families have no camera "
            "attitude to level"
        )
    if options.rolling_shutter:
        if family != "rotation":
            raise ValueError(
                "--rolling-shutter needs the rotation family (per-scanline "
                "camera poses)"
            )
        if options.streaming:
            raise ValueError(
                "--rolling-shutter uses the two-phase path (scanline "
                "velocities need the frame after each frame)"
            )
    # Horizon lock needs the measured attitude even when not stabilising.
    needs_motion = options.stabilise != "none" or options.horizon_lock
    tpath = trajectory_path(dest) if dest else None

    if options.streaming and not options.gyro:
        if family != "rotation":
            raise ValueError(
                "--streaming is the rotation family's single-pass mode; "
                "2D families use the two-phase path"
            )
        from video_annotator_tpu.pipeline.streaming import render_streaming

        render_streaming(source, dest, options, prof)
        if options.verbose:
            print(prof.report())
        return

    if needs_motion and not options.encode_only:
        if family == "similarity":
            from video_annotator_tpu.models.similarity import analyse_similarity

            traj = analyse_similarity(source, options, prof)
        elif family == "deshake":
            from video_annotator_tpu.models.deshake import analyse_deshake

            traj = analyse_deshake(source, options, prof)
        elif options.gyro:
            traj = analyse_gyro(source, options, prof)
        else:
            traj = analyse(source, options, prof)
        if tpath:
            traj.save(tpath)
    elif needs_motion and options.encode_only:
        if not (tpath and os.path.exists(tpath)):
            raise FileNotFoundError(
                f"--encode-only but no trajectory at {tpath}; run analyse first"
            )
        traj = Trajectory.load(tpath)
    else:
        # No stabilization: identity trajectory sized to the clip.
        reader = open_reader(source)
        meta = reader.meta
        first, last = _frame_range(meta, options)
        n = (last - first) if meta.num_frames else 0
        if not meta.num_frames:
            # Count to EOF, then still honor the trim end (--end/--duration
            # cap `last` even when the container reports no frame count).
            n = min(last, sum(1 for _ in reader)) - first
        reader.close()
        kind = {"rotation": "so3", "similarity": "similarity",
                "deshake": "translation"}[family]
        from video_annotator_tpu.pipeline.trajectory import KIND_DIMS

        traj = Trajectory(
            params=np.zeros((max(n, 0), KIND_DIMS[kind])), kind=kind,
            fps=meta.fps, width=meta.width, height=meta.height, source=source,
        )

    if not options.analyse_only:
        if traj.kind == "so3":
            encode(source, dest, traj, options, prof)
        else:
            encode_2d(source, dest, traj, options, prof)
    if options.verbose:
        print(prof.report())
