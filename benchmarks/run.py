"""Benchmark suite covering BASELINE.json's five configs.

The headline 4K warp number lives in ``bench.py`` (the driver runs it);
this suite measures every named config so the framework's performance
story is complete:

1. ``720p_undistort_cpu``   — 720p30 fisheye->rectilinear undistort of a
   10 s clip with a PRECOMPUTED remap table, CPU, interpolation-only.
2. ``1080p_sparse_flow``    — Shi-Tomasi + pyramidal LK + per-frame
   robust similarity fit, identity lens model.
3. ``1080p_full_pipeline``  — fisheye undistort + LK stabilization +
   Kalman trajectory smoothing, end to end on device.
4. ``4k_gyro_fused``        — 4K GoPro fisheye with GPMF gyro-integrated
   trajectory + the batched map+warp.
4b. ``4k_visual_full_pipeline`` — the north-star loop with VISUAL
   tracking included: Shi-Tomasi + LK + RANSAC at analysis-scale
   0.5 (the reference demo's scale) -> SG smoothing -> batched warp.
4c. ``e2e_decode_overlap_720p`` — decode INCLUDED: native h264 decode ->
   prefetch -> paired analyse -> batched warp in one streaming pass, plus
   each stage's solo rate; proves the prefetcher hides decode
   (overlap_ratio = e2e / min(stage rates)).
5. ``8x4k60_multistream``   — 8x 4K60 streams batched through the warp
   on one device (the sharded path is exercised by
   ``__graft_entry__.dryrun_multichip``); reports aggregate fps and the
   host->device feed bandwidth seen by the prefetcher.

Run all (each config in its own process, one at a time, so device state
is fresh and only one process holds the device; the parent never
initializes JAX):

    python benchmarks/run.py [--out FILE]   # one JSON list on stdout

One config, one JSON line on stdout:

    python benchmarks/run.py --one 4k_gyro_fused

Timing protocol: jit-compile warmup excluded; the median of several
trials is reported. Device work is timed with two dispatches in flight,
the same depth the encode loop's bounded writer queue enforces.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import functools

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRIALS = 5


def _median_of(fn, trials=TRIALS):
    """Median wall-clock of ``fn()`` (seconds) over several trials."""
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _result(name, fps, frames, realtime_fps, extra=None):
    out = {
        "config": name,
        "metric": "frames_per_second",
        "value": round(fps, 2),
        "unit": "fps",
        "frames_timed": frames,
        "realtime_factor": round(fps / realtime_fps, 2),
    }
    if extra:
        out.update(extra)
    return out


# --------------------------------------------------------------------------
# 1. 720p30 undistort, precomputed remap table, CPU, interpolation-only
# --------------------------------------------------------------------------

def bench_720p_undistort_cpu():
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu.camera import CameraModel, camera_from_dfov
    from video_annotator_tpu.camera import get_output_camera
    from video_annotator_tpu.ops.warp_xla import bilinear_sample, compute_warp_map

    w, h = 1280, 720
    n = 300  # 10 s @ 30 fps
    in_cam = camera_from_dfov(145.8, (w, h), CameraModel.FISHEYE)
    out_cam = get_output_camera(in_cam, crop_borders=True)
    oh = out_cam.height - out_cam.height % 2
    ow = out_cam.width - out_cam.width % 2

    # The remap table is computed ONCE (the config's "precomputed" remap);
    # the timed loop is pure interpolation, the reference's cv::remap
    # equivalent (opencv/FrameSourceWarp.cpp:306-312).
    coords = jax.jit(
        lambda: compute_warp_map(out_cam, in_cam, jnp.eye(3), (oh, ow))
    )()
    coords.block_until_ready()

    rng = np.random.default_rng(0)
    frames = [
        jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
        for _ in range(8)
    ]
    sample = jax.jit(bilinear_sample)
    sample(frames[0], coords).block_until_ready()

    def run():
        outs = [sample(frames[i % 8], coords) for i in range(n)]
        jax.block_until_ready(outs)

    dt = _median_of(run, trials=3)
    return _result("720p_undistort_cpu", n / dt, n, 30.0,
                   {"backend": jax.default_backend()})


# --------------------------------------------------------------------------
# 2. 1080p sparse-flow stabilization, identity lens
# --------------------------------------------------------------------------

def _synthetic_lumas(w, h, n, shake=0.006):
    """n textured luma frames under a synthetic shaky camera, on device."""
    import jax
    import jax.numpy as jnp

    from video_annotator_tpu.io.synthetic import SyntheticCamera, render_frame

    cfg = SyntheticCamera(width=w, height=h, num_frames=n, shake=shake)
    cam = cfg.camera()
    rots = cfg.rotations()
    render = jax.jit(lambda r: render_frame(cam, r)[0])
    frames = [render(jnp.asarray(r)) for r in rots]
    jax.block_until_ready(frames)
    return frames


def bench_1080p_sparse_flow():
    import jax
    import jax.numpy as jnp

    from video_annotator_tpu.ops.affine import fit_similarity
    from video_annotator_tpu.ops.corners import detect_corners
    from video_annotator_tpu.ops.lk import pyramidal_lk

    w, h, n = 1920, 1080, 120
    frames = _synthetic_lumas(w, h, n)

    @jax.jit
    def step(prev, curr, pts, valid, acc):
        new_pts, status = pyramidal_lk(prev, curr, pts, valid)
        params, _inliers = fit_similarity(pts, new_pts, status)
        return new_pts, status, acc + params

    detect = jax.jit(
        lambda g: detect_corners(g, max_corners=200, min_distance=30)
    )
    pts, valid = detect(frames[0])
    acc = jnp.zeros(4, jnp.float32)
    step(frames[0], frames[1], pts, valid, acc)[2].block_until_ready()

    def run():
        p, v, a = pts, valid, acc
        for i in range(1, n):
            p, v, a = step(frames[i - 1], frames[i], p, v, a)
        a.block_until_ready()

    dt = _median_of(run)
    return _result("1080p_sparse_flow", (n - 1) / dt, n - 1, 30.0)


# --------------------------------------------------------------------------
# 3. 1080p full pipeline: undistort + LK stabilization + Kalman smoothing
# --------------------------------------------------------------------------

def bench_1080p_full_pipeline():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraModel,
        camera_from_dfov,
        get_output_camera,
    )
    from video_annotator_tpu.ops.corners import detect_corners
    from video_annotator_tpu.ops.lk import pyramidal_lk
    from video_annotator_tpu.ops.ransac import (
        estimate_rotation,
        rotation_with_fallback,
    )
    from video_annotator_tpu.pipeline.render import FrameWarper
    from video_annotator_tpu.smoothing.kalman import smooth_rotations_kalman

    w, h, n = 1920, 1080, 96
    in_cam = camera_from_dfov(145.8, (w, h), CameraModel.FISHEYE)
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)
    threshold = 8.0 / float(in_cam.fx)

    frames = _synthetic_lumas(w, h, n)
    frames8 = [f.astype(jnp.uint8) for f in frames]
    uu = jnp.full((h // 2, w // 2), 128, jnp.uint8)
    vv = jnp.full((h // 2, w // 2), 128, jnp.uint8)
    jax.block_until_ready(frames8)

    @jax.jit
    def track(prev, curr, pts, valid, prev_delta, r_acc, key):
        key, sub = jax.random.split(key)
        new_pts, status = pyramidal_lk(prev, curr, pts, valid)
        est = estimate_rotation(
            in_cam.unproject_unit(pts), in_cam.unproject_unit(new_pts),
            status, sub, threshold_rad=threshold,
        )
        delta = rotation_with_fallback(est, prev_delta, min_inliers=40)
        r_new = so3.orthonormalize(
            jnp.matmul(delta, r_acc, precision=jax.lax.Precision.HIGHEST)
        )
        return new_pts, status, delta, r_new, key

    detect = jax.jit(
        lambda g: detect_corners(g, max_corners=200, min_distance=30)
    )
    smooth = jax.jit(smooth_rotations_kalman)

    batch = 32

    def full_run(sync):
        pts, valid = detect(frames[0])
        r_acc = jnp.eye(3, dtype=jnp.float32)
        prev_delta = jnp.eye(3, dtype=jnp.float32)
        key = jax.random.PRNGKey(0)
        rs = [r_acc]
        for i in range(1, n):
            pts, valid, prev_delta, r_acc, key = track(
                frames[i - 1], frames[i], pts, valid, prev_delta, r_acc, key
            )
            rs.append(r_acc)
        measured = jnp.stack(rs)
        smoothed = smooth(measured)
        corr = so3.matmul(measured, jnp.swapaxes(smoothed, -1, -2))
        outs = []
        for i in range(0, n, batch):
            idx = list(range(i, min(i + batch, n)))
            outs.append(warper.warp_yuv_batch(
                tuple(frames8[j] for j in idx),
                (uu,) * len(idx), (vv,) * len(idx),
                corr[i:i + len(idx)],
            ))
            if len(outs) > 2:
                jax.block_until_ready(outs.pop(0))
        if sync:
            jax.block_until_ready(outs)

    full_run(sync=True)  # warmup/compile
    dt = _median_of(lambda: full_run(sync=True))
    return _result("1080p_full_pipeline", n / dt, n, 30.0)


# --------------------------------------------------------------------------
# 4. 4K gyro-assisted trajectory + batched map+warp
# --------------------------------------------------------------------------

def bench_4k_gyro_fused():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.pipeline.render import FrameWarper
    from video_annotator_tpu.smoothing.gyro import integrate_gyro
    from video_annotator_tpu.smoothing.savgol import smooth_rotations

    w, h = 3840, 2880
    n = 64
    fps = 60.0
    gyro_hz = 400.0  # GoPro GPMF GYRO stream rate

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)

    rng = np.random.default_rng(0)
    s = int(n / fps * gyro_hz) + 1
    omega = jnp.asarray(rng.normal(size=(s, 3)) * 0.3, jnp.float32)
    sample_ts = jnp.asarray(np.arange(s) / gyro_hz, jnp.float32)
    frame_ts = jnp.asarray(np.arange(n) / fps, jnp.float32)

    @jax.jit
    def trajectory(om):
        measured = integrate_gyro(om, sample_ts, frame_ts)
        smoothed = smooth_rotations(measured, radius=30)
        return so3.matmul(measured, jnp.swapaxes(smoothed, -1, -2))

    corr = trajectory(omega)
    corr.block_until_ready()

    y = jnp.asarray(rng.integers(0, 255, (h, w), dtype=np.uint8))
    u = jnp.asarray(rng.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
    v = jnp.asarray(rng.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
    batch = 32
    ys, us, vs = (y,) * batch, (u,) * batch, (v,) * batch

    def run():
        corr = trajectory(omega)
        inflight = []
        for i in range(0, n, batch):
            inflight.append(
                warper.warp_yuv_batch(ys, us, vs, corr[i:i + batch])
            )
            if len(inflight) > 1:
                jax.block_until_ready(inflight.pop(0))
        jax.block_until_ready(inflight)

    run()  # warmup
    dt = _median_of(run)
    return _result("4k_gyro_fused", n / dt, n, 60.0)


# --------------------------------------------------------------------------
# 4b. 4K visual-tracking full pipeline (the north-star loop, analyse
#     INCLUDED: Shi-Tomasi + LK + RANSAC -> SG -> batched warp)
# --------------------------------------------------------------------------

def bench_4k_visual_full_pipeline(detect_level=None, tag=""):
    """The reference's per-frame loop (``FrameSourceWarp.cpp:397-446``) at
    4K with the motion analysis measured IN: corner tracking at the stock
    ``--analysis-scale auto`` resolution (0.5 at 4K — the reference
    demo's own tracking scale, ``DisplayImage.cpp:48``; quality delta
    recorded in ``benchmarks/quality.py``) — RANSAC rotation estimation,
    SG smoothing (radius 30), and the batched map+warp on full-res
    YUV. ``detect_level=0`` is the ``4k_visual_detect0`` config:
    the measured fps cost of track-resolution corner detection (the
    trajectory-accuracy remedy; quality side in quality.json).

    Frames are synthetic shaken footage rendered once on device (this
    config measures the compute loop, not decode; config #5 and
    ``docs/PIPELINE.md`` cover the host feed). Analyse dispatches run
    back-to-back with no per-frame host sync, exactly like
    ``pipeline/render.py::analyse``. Override the tracking scale with
    ``VAT_BENCH_ANALYSIS_SCALE`` (1, 0.5 or 0.25).
    """
    from fractions import Fraction

    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.io.synthetic import SyntheticCamera, render_frame
    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        FrameWarper,
        RenderOptions,
        _make_pair_tracker,
        _make_tracker,
    )
    from video_annotator_tpu.smoothing.savgol import smooth_rotations

    # Default geometry is the GoPro 4:3 sensor (3840x2880 — 33% MORE
    # pixels than 16:9 "4K"); VAT_BENCH_GEOM=uhd measures standard
    # 3840x2160 UHD (the 16:9 measured preset) for comparison with
    # generic 4K60 targets.
    uhd = os.environ.get("VAT_BENCH_GEOM") == "uhd"
    w, h = (3840, 2160) if uhd else (3840, 2880)
    preset = (CameraPreset.GOPRO_H4B_WIDE169_MEASURED if uhd
              else CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    # 192 frames (~2 GB of device-resident uint8 luma): long enough that
    # the one-off costs a 60 fps stream never sees per frame (first
    # dispatch in flight, smooth radius fill, final sync) stay < 2% of
    # the window; VAT_BENCH_FRAMES overrides.
    n = int(os.environ.get("VAT_BENCH_FRAMES", "192"))
    # Default is the CLI's stock resolution of --analysis-scale auto at
    # this geometry (resolve_analysis_scale: 0.5 for 4K-class inputs),
    # so this row measures the path a flagless render takes.
    scale_env = os.environ.get("VAT_BENCH_ANALYSIS_SCALE", "auto")
    scale = None if scale_env == "auto" else float(scale_env)

    in_cam = get_preset_camera(preset, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)

    cfg = SyntheticCamera(width=w, height=h, num_frames=n, shake=0.004)
    render = jax.jit(
        lambda r: jnp.clip(render_frame(in_cam, r)[0], 0, 255)
        .astype(jnp.uint8)
    )
    frames8 = [render(jnp.asarray(r)) for r in cfg.rotations()]
    uu = jnp.full((h // 2, w // 2), 128, jnp.uint8)
    vv = jnp.full((h // 2, w // 2), 128, jnp.uint8)
    jax.block_until_ready(frames8)

    meta = VideoMeta(w, h, Fraction(60, 1))
    chunk = int(os.environ.get("VAT_BENCH_ANALYSIS_CHUNK", "16"))
    # Analyse formulation: "paired" (default) is the batched mode —
    # fresh corners every frame, all adjacent pairs tracked at once
    # (render.py::_make_pair_tracker; quality scored side by side with
    # the sequential tracker in benchmarks/quality.py).
    # VAT_BENCH_ANALYSIS_MODE=tracked measures the reference-faithful
    # sequential tracker instead.
    mode = os.environ.get("VAT_BENCH_ANALYSIS_MODE", "paired")
    if detect_level is None:
        detect_level = int(os.environ.get("VAT_BENCH_DETECT_LEVEL", "1"))
    opts = RenderOptions(
        preset=preset, analysis_scale="auto" if scale is None else scale,
        analysis_chunk=chunk, analysis_mode=mode,
        analysis_detect_level=detect_level,
    )
    from video_annotator_tpu.pipeline.render import resolve_analysis_scale

    scale = resolve_analysis_scale(opts, VideoMeta(w, h, Fraction(60, 1)))
    # Chunked frame stacks, pre-stacked once (the analyse loop's decode
    # prefetcher stacks them on the fly; stacking is not what this
    # config measures). Paired chunks carry a one-frame overlap (the
    # pair chain crosses chunk boundaries).
    if mode == "paired":
        pair_chunk = _make_pair_tracker(meta, opts)
        pstacks = []
        for i in range(1, n, chunk):
            s = jnp.stack(frames8[i - 1:i + chunk])
            if s.shape[0] < chunk + 1:
                s = jnp.concatenate(
                    [s, jnp.repeat(s[-1:], chunk + 1 - s.shape[0], axis=0)])
            pstacks.append(s)
        jax.block_until_ready(pstacks)

        def analyse_run(sync=False):
            r_base = jnp.eye(3, dtype=jnp.float32)
            prev_delta = jnp.eye(3, dtype=jnp.float32)
            key = jax.random.PRNGKey(7)
            rs = [r_base[None]]
            off = 0
            for s in pstacks:
                r_base, prev_delta, ras = pair_chunk(
                    r_base, prev_delta, key, jnp.int32(off), s)
                rs.append(ras)
                off += s.shape[0] - 1
            out = jnp.concatenate(rs)[:n]
            if sync:
                out.block_until_ready()
            return out
    else:
        detect_step, track_step, track_chunk = _make_tracker(meta, opts)
        stacks = [
            jnp.stack(frames8[i:i + chunk])
            for i in range(1, n, chunk)
        ]
        stacks = [
            s if s.shape[0] == chunk else jnp.concatenate(
                [s, jnp.repeat(s[-1:], chunk - s.shape[0], axis=0)])
            for s in stacks
        ]
        jax.block_until_ready(stacks)

        def analyse_run(sync=False):
            pts, valid, prev_gray = detect_step(frames8[0])
            r_acc = jnp.eye(3, dtype=jnp.float32)
            prev_delta = jnp.eye(3, dtype=jnp.float32)
            key = jax.random.PRNGKey(7)
            age = jnp.int32(0)
            rs = [r_acc[None]]
            for s in stacks:
                (pts, valid, prev_gray, prev_delta, r_acc, key, age), ras = (
                    track_chunk(pts, valid, prev_gray, prev_delta, r_acc,
                                key, age, s))
                rs.append(ras)
            out = jnp.concatenate(rs)[:n]
            if sync:
                out.block_until_ready()
            return out

    smooth = jax.jit(
        lambda m: so3.matmul(
            m, jnp.swapaxes(smooth_rotations(m, radius=30), -1, -2)
        )
    )

    batch = 32

    def warp_run(corr, sync=True):
        inflight = []
        for i in range(0, n, batch):
            k = min(batch, n - i)
            inflight.append(warper.warp_yuv_batch(
                tuple(frames8[i:i + k]), (uu,) * k, (vv,) * k,
                corr[i:i + k],
            ))
            if len(inflight) > 1:
                jax.block_until_ready(inflight.pop(0))
        if sync:
            jax.block_until_ready(inflight)

    def full_run():
        corr = smooth(analyse_run())
        warp_run(corr)

    full_run()  # warmup/compile (both phases, both tracker variants)
    dt = _median_of(full_run)

    # Informational phase split (each synced, so they add up to >= dt).
    dt_analyse = _median_of(lambda: analyse_run(sync=True), trials=2)
    corr = smooth(analyse_run())
    corr.block_until_ready()
    dt_warp = _median_of(lambda: warp_run(corr), trials=2)

    return _result(
        "4k_visual_full_pipeline" + ("_uhd" if uhd else "") + tag,
        n / dt, n, 60.0,
        {
            "geometry": f"{w}x{h}",
            "analysis_scale": scale,
            "analysis_mode": mode,
            "analysis_detect_level": detect_level,
            "analyse_fps": round(n / dt_analyse, 2),
            "warp_fps": round(n / dt_warp, 2),
        },
    )


# --------------------------------------------------------------------------
# 4c. decode-INCLUDED end-to-end with overlap proof (720p-class)
# --------------------------------------------------------------------------

def bench_e2e_decode_overlap():
    """Native h264 decode -> DevicePrefetcher -> paired analyse -> batched
    warp, end to end in ONE pass (the ``--streaming`` production path),
    at a geometry one host can feed — evidence that the prefetcher hides
    decode behind the transfer+compute stream (the reference's zero-copy
    feed analogue is ``opencv/hw_init.cpp:54-69``).

    The acceptance row is readback-free: the same streaming pipeline with
    a DEVICE-RESIDENT consumer (``DeviceReduceSink``: outputs fold into an
    on-device checksum; 4 bytes fetched at close), so the link carries
    uploads only and the host->device feed is the wall. Then

    - ``upload_overlap_ratio`` = e2e_device_fps / feed_only_fps. A
      pipeline that serializes decode+feed+compute scores
      ``serial_model_fps / feed``; >= 0.8 AND beating the serial model
      means decode AND compute hide behind the feed
      (``upload_overlap_ok``).
    - ``decode_hiding_ratio`` = e2e over the h264 source / e2e over a
      RAW y4m twin (decode cost ~0, every other byte and dispatch
      identical), both with the device sink, trials INTERLEAVED
      back-to-back; the median and range are reported. ~1 = codec work
      absorbed into device waits, which a decode-serialized loop cannot
      score.

    The ``--no-output`` readback variant (the reference's ``-f null``
    also runs its full download path) stays for context.
    """
    import jax
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from soak import make_input

    from video_annotator_tpu.io.prefetch import DevicePrefetcher
    from video_annotator_tpu.io.video import open_reader
    from video_annotator_tpu.pipeline.render import RenderOptions, render

    w, h = 960, 720
    n = int(os.environ.get("VAT_E2E_FRAMES", "240"))
    import tempfile

    tmp = tempfile.mkdtemp(prefix="vat_e2e_")
    src = os.path.join(tmp, f"e2e_overlap_{w}x{h}_{n}.mp4")
    make_input(src, n, w, h)

    # Stage rate 1: host decode alone (native threaded loader drain).
    def decode_all():
        r = open_reader(src)
        frames = [(y.copy(), u.copy(), v.copy()) for y, u, v in r]
        r.close()
        return frames

    t0 = time.perf_counter()
    host_frames = decode_all()
    decode_fps = len(host_frames) / (time.perf_counter() - t0)

    # Stage rate 2: host->device feed alone, through the same prefetcher
    # the pipeline uses. A dependent on-device reduction consumes every
    # plane and ONE scalar fetch syncs at the end, so the time covers the
    # bytes actually moving.
    import jax.numpy as jnp

    @jax.jit
    def _consume(acc, y, u, v):
        return (acc + y.sum(dtype=jnp.int32) + u.sum(dtype=jnp.int32)
                + v.sum(dtype=jnp.int32))

    def feed_all():
        pre = DevicePrefetcher(iter(host_frames), depth=3)
        acc = jnp.int32(0)
        for y, u, v in pre:
            acc = _consume(acc, y, u, v)
        int(acc)

    feed_all()  # warm the transfer path
    dt = _median_of(feed_all, trials=2)
    feed_fps = n / dt

    # Stage rate 3: device-resident analyse+warp at the same geometry
    # (the compute the e2e loop runs per frame), via the same jitted
    # pieces the streaming render dispatches.
    from video_annotator_tpu import so3
    from video_annotator_tpu.io.video import VideoMeta
    from video_annotator_tpu.pipeline.render import (
        FrameWarper,
        _make_pair_tracker,
        build_cameras,
    )
    from video_annotator_tpu.smoothing.savgol import smooth_rotations

    from fractions import Fraction

    meta = VideoMeta(w, h, Fraction(30, 1), n)
    opts = RenderOptions(stabilise="smooth", stabilise_radius=30,
                         analysis_mode="paired")
    in_cam, out_cam = build_cameras(meta, opts)
    warper = FrameWarper(in_cam, out_cam)
    dev_frames = [tuple(jnp.asarray(p) for p in f) for f in host_frames]
    jax.block_until_ready(dev_frames)
    pair_chunk = _make_pair_tracker(meta, opts)
    chunk = opts.analysis_chunk
    pstacks = []
    for i in range(1, n, chunk):
        s = jnp.stack([dev_frames[j][0] for j in range(i - 1,
                                                       min(i + chunk, n))])
        if s.shape[0] < chunk + 1:
            s = jnp.concatenate(
                [s, jnp.repeat(s[-1:], chunk + 1 - s.shape[0], axis=0)])
        pstacks.append(s)
    jax.block_until_ready(pstacks)
    smooth = jax.jit(
        lambda m: so3.matmul(
            m, jnp.swapaxes(smooth_rotations(m, radius=30), -1, -2)
        )
    )
    batch = 32

    def compute_all():
        r_base = jnp.eye(3, dtype=jnp.float32)
        prev_delta = jnp.eye(3, dtype=jnp.float32)
        key = jax.random.PRNGKey(7)
        rs = [r_base[None]]
        off = 0
        for s in pstacks:
            r_base, prev_delta, ras = pair_chunk(
                r_base, prev_delta, key, jnp.int32(off), s)
            rs.append(ras)
            off += s.shape[0] - 1
        corr = smooth(jnp.concatenate(rs)[:n])
        inflight = []
        for i in range(0, n, batch):
            k = min(batch, n - i)
            inflight.append(warper.warp_yuv_batch(
                tuple(dev_frames[j][0] for j in range(i, i + k)),
                tuple(dev_frames[j][1] for j in range(i, i + k)),
                tuple(dev_frames[j][2] for j in range(i, i + k)),
                corr[i:i + k],
            ))
            if len(inflight) > 1:
                jax.block_until_ready(inflight.pop(0))
        jax.block_until_ready(inflight)

    compute_all()  # warmup/compile
    dt = _median_of(compute_all, trials=2)
    compute_fps = n / dt

    def _trial_fps(fn, trials):
        """Per-trial fps list (median AND spread are reported)."""
        out = []
        for _ in range(trials):
            t0 = time.perf_counter()
            fn()
            out.append(n / (time.perf_counter() - t0))
        return out

    trials = int(os.environ.get("VAT_E2E_TRIALS", "5"))

    # THE acceptance row: the full single-pass pipeline with the
    # readback-free device sink — decode -> prefetch -> paired analyse
    # in the lookahead ring -> batched warp -> on-device checksum. The
    # link carries uploads only; the feed is the wall a serialized
    # pipeline would fall well under.
    dev_opts = RenderOptions(stabilise="smooth", stabilise_radius=30,
                             analysis_mode="paired", streaming=True,
                             no_output=True, device_sink=True)
    render(src, None, dev_opts)  # warm (compile cache + page cache)

    # Decode-EXCLUDED twin of the device-sink run: the identical
    # pipeline and OPTIONS over a raw y4m of the same content (h264
    # codec work replaced by a sequential file read). Trials INTERLEAVE
    # h264/y4m back-to-back so each ratio pairs runs under the same host
    # load. The h264 legs double as the e2e_device_sink trials (one set of
    # renders serves both figures).
    from video_annotator_tpu.io.video import VideoMeta as _VM, open_writer

    y4m = src.replace(".mp4", ".y4m")
    if not os.path.exists(y4m):
        sink = open_writer(y4m, _VM(w, h, Fraction(30, 1), n))
        for f in host_frames:
            sink.write(f)
        sink.close()
    import dataclasses

    render(y4m, None, dev_opts)  # warm
    ratios = []
    dev_fps = []
    y4m_fps = []
    for t in range(trials):
        t0 = time.perf_counter()
        render(src, None, dev_opts)
        fh = n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        render(y4m, None, dev_opts)
        fy = n / (time.perf_counter() - t0)
        ratios.append(fh / fy)
        dev_fps.append(fh)
        y4m_fps.append(fy)
    ratios.sort()
    e2e_device_fps = statistics.median(dev_fps)
    e2e_y4m_fps = statistics.median(y4m_fps)

    # Context row: the honest --no-output null sink (reads every output
    # frame back, like -f null).
    e2e_opts = RenderOptions(stabilise="smooth", stabilise_radius=30,
                             analysis_mode="paired", streaming=True,
                             no_output=True)
    render(src, None, e2e_opts)  # warm
    rb_fps = _trial_fps(lambda: render(src, None, e2e_opts), 2)
    e2e_fps = statistics.median(rb_fps)

    # The two-phase render of the SAME job (decodes the source twice,
    # same paired analyse dispatches): streaming >= two-phase shows the
    # in-ring batched analyse costs nothing vs the checkpointed path.
    two_opts = dataclasses.replace(e2e_opts, streaming=False)
    render(src, None, two_opts)  # warm
    dt = _median_of(lambda: render(src, None, two_opts), trials=2)
    two_phase_fps = n / dt

    bottleneck_fps = min(decode_fps, feed_fps, compute_fps)
    # What a fully SERIALIZED decode->feed->compute loop would run at:
    # the null model the overlap gate must beat (when feed dominates,
    # serial alone can reach ~0.8x feed — hence the two-sided gate).
    serial_model_fps = 1.0 / (1.0 / decode_fps + 1.0 / feed_fps
                              + 1.0 / compute_fps)
    upload_overlap_ratio = e2e_device_fps / feed_fps
    upload_overlap_ok = bool(
        upload_overlap_ratio >= 0.8
        and e2e_device_fps > 1.05 * serial_model_fps)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return _result(
        "e2e_decode_overlap_720p", e2e_device_fps, n, 30.0,
        {
            "geometry": f"{w}x{h}",
            "trials": trials,
            "decode_only_fps": round(decode_fps, 2),
            "feed_only_fps": round(feed_fps, 2),
            "compute_only_fps": round(compute_fps, 2),
            # THE acceptance numbers (readback-free, uploads only):
            "e2e_device_sink_fps": round(e2e_device_fps, 2),
            "e2e_device_sink_fps_spread": round(
                max(dev_fps) / min(dev_fps), 3),
            "serial_model_fps": round(serial_model_fps, 2),
            "upload_overlap_ratio": round(upload_overlap_ratio, 3),
            "upload_overlap_ok": upload_overlap_ok,
            # Context: readback-bound and raw-feed variants.
            "e2e_readback_fps": round(e2e_fps, 2),
            "e2e_readback_fps_spread": round(max(rb_fps) / min(rb_fps), 3),
            "e2e_rawfeed_fps": round(e2e_y4m_fps, 2),
            "e2e_rawfeed_fps_spread": round(
                max(y4m_fps) / min(y4m_fps), 3),
            "two_phase_fps": round(two_phase_fps, 2),
            "bottleneck_stage": (
                "feed" if bottleneck_fps == feed_fps else
                "decode" if bottleneck_fps == decode_fps else "compute"),
            "bottleneck_fps": round(bottleneck_fps, 2),
            # Decode-specific check: decode-included vs decode-excluded
            # at identical bytes/dispatches, median of PAIRED
            # per-trial ratios (h264/y4m interleaved back-to-back);
            # ~1 = the codec work is hidden behind device waits.
            "decode_hiding_ratio": round(
                ratios[len(ratios) // 2], 3),
            "decode_hiding_ratio_range": [
                round(ratios[0], 3), round(ratios[-1], 3)],
        },
    )


# --------------------------------------------------------------------------
# 5. 8x 4K60 multi-stream batched warp
# --------------------------------------------------------------------------

def bench_8x4k60_multistream():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.pipeline.render import FrameWarper

    w, h = 3840, 2880
    streams = 8
    per_stream = 4  # frames per stream per dispatch group
    groups = 4

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)

    rng = np.random.default_rng(0)
    # One resident frame per stream (content does not affect warp cost);
    # per-stream, per-frame rotations.
    ys = tuple(
        jnp.asarray(rng.integers(0, 255, (h, w), dtype=np.uint8))
        for _ in range(streams)
    )
    us = tuple(
        jnp.asarray(rng.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
        for _ in range(streams)
    )
    vs = tuple(
        jnp.asarray(rng.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
        for _ in range(streams)
    )
    rots = [
        jnp.stack([
            so3.exp(jnp.asarray(x, jnp.float32))
            for x in rng.normal(size=(streams * per_stream, 3)) * 0.01
        ])
        for _ in range(groups)
    ]
    jax.block_until_ready((ys, us, vs, rots))

    yb = ys * per_stream
    ub = us * per_stream
    vb = vs * per_stream

    def run():
        inflight = []
        for g in range(groups):
            inflight.append(warper.warp_yuv_batch(yb, ub, vb, rots[g]))
            if len(inflight) > 1:
                jax.block_until_ready(inflight.pop(0))
        jax.block_until_ready(inflight)

    jax.block_until_ready(warper.warp_yuv_batch(yb, ub, vb, rots[0]))
    n = streams * per_stream * groups
    dt = _median_of(run)

    # Host->device feed bandwidth (informational): the prefetcher's
    # device_put path for one 4K YUV 4:2:0 frame set.
    frame = {
        "y": np.zeros((h, w), np.uint8),
        "u": np.zeros((h // 2, w // 2), np.uint8),
        "v": np.zeros((h // 2, w // 2), np.uint8),
    }
    t0 = time.perf_counter()
    reps = 4
    for _ in range(reps):
        jax.block_until_ready(jax.device_put(frame))
    feed_bw = (h * w * 3 // 2) * reps / (time.perf_counter() - t0) / 1e9

    agg_fps = n / dt
    return _result(
        "8x4k60_multistream", agg_fps, n, 60.0 * streams,
        {
            "streams": streams,
            "per_stream_fps": round(agg_fps / streams, 2),
            # h2d transfer bandwidth (jax.device_put) — distinct from
            # host_feed.json's host DECODE throughput, which shares no
            # bus with this.
            "h2d_GBps": round(feed_bw, 3),
        },
    )


CONFIGS = {
    "720p_undistort_cpu": bench_720p_undistort_cpu,
    "1080p_sparse_flow": bench_1080p_sparse_flow,
    "1080p_full_pipeline": bench_1080p_full_pipeline,
    "4k_gyro_fused": bench_4k_gyro_fused,
    "4k_visual_full_pipeline": bench_4k_visual_full_pipeline,
    "4k_visual_full_pipeline_detect0": functools.partial(
        bench_4k_visual_full_pipeline, detect_level=0, tag="_detect0"),
    "e2e_decode_overlap_720p": bench_e2e_decode_overlap,
    "8x4k60_multistream": bench_8x4k60_multistream,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--one", choices=sorted(CONFIGS), default=None,
                    help="run a single config in-process, print one JSON line")
    ap.add_argument("--out", default="",
                    help="also write the results list here (device "
                         "timings stay out of the repository)")
    args = ap.parse_args(argv)

    if args.one:
        from provenance import stamp

        print(json.dumps(stamp(CONFIGS[args.one]())))
        return 0

    results = []
    for name in CONFIGS:
        print(f"=== {name}", file=sys.stderr)
        env = dict(os.environ)
        if name.endswith("_cpu"):
            env["JAX_PLATFORMS"] = "cpu"
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", name],
            capture_output=True, text=True, timeout=3600, env=env,
        )
        line = next(
            (ln for ln in reversed(proc.stdout.splitlines())
             if ln.startswith("{")),
            None,
        )
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            results.append({"config": name, "error": proc.returncode})
            continue
        res = json.loads(line)
        results.append(res)
        print(json.dumps(res), file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    print(json.dumps(results))
    # A config that failed fails the run (after the others have run).
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
