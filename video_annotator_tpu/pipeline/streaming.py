"""Single-pass streaming render: decode once, bounded-lookahead smoothing.

The reference's native engine is a streaming pipeline: frames and measured
rotations queue in a lookahead buffer until ``smooth_radius`` future frames
exist, then each frame is smoothed and warped as it leaves the window
(``opencv/FrameSourceWarp.cpp:452-464``; EOF replays the last rotation so
the tail still gets smoothed, ``:456-461``). The two-phase analyse/encode
design (``pipeline/render.py``) checkpoints the whole trajectory like the
TS side's ``.trf`` flow but decodes the source twice; this module is the
native engine's single-pass shape: track, smooth with a sliding window,
and warp in one decode pass — output identical to the two-phase path
(same Savitzky-Golay weights, same replicate-clamp end semantics), with
latency bounded by the lookahead radius instead of the clip length.

The lookahead ring holds ``radius + warp_batch`` decoded YUV frames in
device memory (at 4K: ~17 MB/frame — the default radius 90 + batch 32 is
~2 GB), the device analogue of the reference's ``-extra_hw_frames``
VAAPI pool sizing (``src/render.ts:220-223``).

``--analysis-mode paired`` (the accelerator default via "auto") runs the
batched pair analyse INSIDE the ring: arriving frames buffer into groups of
``--analysis-chunk`` and each group's adjacent pairs track in one
batched dispatch (``render.py:_make_pair_tracker`` — per-pair RNG keys
fold from the GLOBAL frame index, so the trajectory is bit-identical to
the two-phase paired analyse). The cost is up to ``analysis_chunk``
extra frames of latency on top of the lookahead radius — frames only
become emittable once their rotation exists. The sequential tracker
(``tracked``; CPU default) keeps per-frame latency at exactly the
radius, the reference's shape (``FrameSourceWarp.cpp:452-464``).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_annotator_tpu import so3
from video_annotator_tpu.io.video import VideoMeta, open_writer
from video_annotator_tpu.pipeline.profiler import Progress, StageProfiler
from video_annotator_tpu.pipeline.render import (
    FrameWarper,
    RenderOptions,
    _estimate_up0,
    _make_pair_tracker,
    _make_tracker,
    open_trimmed,
    _passthrough_kwargs,
    build_cameras,
    make_window_corrections,
    output_fps,
    resolve_analysis_mode,
)
from video_annotator_tpu.pipeline.trajectory import Trajectory, trajectory_path


def render_streaming(
    source: str,
    dest: Optional[str],
    options: Optional[RenderOptions] = None,
    profiler: Optional[StageProfiler] = None,
) -> VideoMeta:
    """One-pass track+smooth+warp+encode with a lookahead window."""
    options = options or RenderOptions()
    prof = profiler or StageProfiler()
    if options.analyse_only or options.encode_only:
        raise ValueError("--streaming is single-pass; drop -a/-c")
    if options.stabilise == "smooth" and options.smoother not in (
            "savgol", "kalman"):
        raise ValueError(
            f"unknown smoother {options.smoother!r} for --streaming"
        )
    # --smoother kalman streams as a FIXED-LAG smoother: the window form
    # of make_window_corrections runs the filter forward over the ring's
    # `radius` past frames (burn-in) and RTS backward from its `radius`
    # future frames, so latency stays = stabilise-radius. Divergence vs
    # the two-phase global RTS is bounded by the filter's ~10-frame
    # memory (tests/test_streaming.py::test_streaming_kalman_fixed_lag)
    # — PROVIDED the lag covers that memory. Below it, each emitted
    # batch filters nearly independently and the output would seam at
    # warp-batch boundaries (and change with the performance-only
    # --warp-batch knob), so short radii are rejected rather than
    # rendered wrong.
    if (options.stabilise == "smooth" and options.smoother == "kalman"
            and options.stabilise_radius < 10):
        raise ValueError(
            "--streaming --smoother kalman needs --stabilise-radius >= 10 "
            "(the fixed-lag window must cover the constant-velocity "
            "filter's ~10-frame memory; below it the smoother would seam "
            "at batch boundaries) — use --smoother savgol for shorter "
            "lookahead or the two-phase path for the global RTS"
        )
    analysis_mode = resolve_analysis_mode(options)

    reader, meta, first, last = open_trimmed(source, options)
    # stabilise=none without a horizon lock needs no measured attitude at
    # all: skip the per-frame tracker entirely (corrections are identity).
    needs_motion = options.stabilise != "none" or options.horizon_lock
    detect_step = track_step = pair_chunk = None
    if needs_motion:
        if analysis_mode == "paired":
            pair_chunk = _make_pair_tracker(meta, options)
        else:
            detect_step, track_step, _ = _make_tracker(meta, options)
    in_cam, out_cam = build_cameras(meta, options)

    up0 = (
        _estimate_up0(source, float(first) / float(meta.fps))
        if options.horizon_lock
        else None
    )
    warper = FrameWarper(in_cam, out_cam,
                         prefilter=options.prefilter == "auto",
                         interp=options.interp)

    n_expect = (last - first) if meta.num_frames else 0
    out_meta = VideoMeta(
        width=warper.out_w,
        height=warper.out_h,
        fps=output_fps(options, meta),
        num_frames=n_expect,
    )
    from video_annotator_tpu.io.prefetch import (
        AsyncFrameWriter,
        DevicePrefetcher,
        DeviceReduceSink,
    )

    from video_annotator_tpu.pipeline.render import CropSink, apply_crop_rect

    write_meta, crop_r = apply_crop_rect(out_meta, options)
    from video_annotator_tpu.pipeline.render import wrap_preview

    overlay = None
    if getattr(options, "device_sink", False):
        # Benchmark-internal readback-free consumer (see DeviceReduceSink):
        # outputs fold into an on-device checksum; no host transfer, no
        # writer thread, no host-frame wrappers.
        writer = DeviceReduceSink()
    else:
        sink = wrap_preview(
            open_writer(None if options.no_output else dest, write_meta,
                        encoder=options.encoder,
                        **_passthrough_kwargs(source, meta, options)),
            options,
        )
        if options.debug:
            # Single-pass mode discovers corrections per batch, so the HUD
            # is text-only (no whole-trajectory curves to plot up front).
            from video_annotator_tpu.pipeline.debug import DebugOverlayWriter

            overlay = DebugOverlayWriter(sink)
            sink = overlay
        if crop_r:
            # Crop before the overlay draws (outermost wrapper) so the HUD
            # stays on the cropped output (see pipeline/render.py:encode).
            sink = CropSink(sink, crop_r)
        writer = AsyncFrameWriter(sink)

    batch = options.warp_batch or max(
        1, int(os.environ.get("VAT_WARP_BATCH", "32")))

    # Lookahead only matters for windowed smoothing; fixed/none emit
    # immediately. The EFFECTIVE radius shrinks for clips shorter than the
    # window, exactly like compute_corrections — decided lazily at first
    # emission (pre-EOF emission implies the clip outlasts the window).
    want_radius = (
        options.stabilise_radius if options.stabilise == "smooth" else 0
    )

    # --- state ---------------------------------------------------------
    from video_annotator_tpu.pipeline.render import KEY_FRAME_MAX_AGE

    frames = deque()  # (y, u, v) device triples awaiting emission
    rots = []  # device (3, 3) measured rotations, one per tracked frame
    emitted = 0
    batch_corr = None
    radius_eff = None

    r_acc = jnp.eye(3, dtype=jnp.float32)
    prev_delta = jnp.eye(3, dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    prev_gray = None
    pts = valid = None
    age = 0
    # Paired-analyse ring state: frames buffer into groups of chunk_n
    # and each group's pairs track in ONE batched dispatch. prev_pair
    # carries the last frame across groups (the pair chain is unbroken);
    # the chunk dispatch is keyed by the GLOBAL pair index (len(rots)-1),
    # so the rotations match the two-phase paired analyse bit-for-bit.
    chunk_n = max(1, int(getattr(options, "analysis_chunk", 16)))
    pend_pairs: list = []
    prev_pair = None

    def flush_pairs():
        """One batched pair dispatch over the buffered group (the tail
        pads by repeating its last frame — only reachable at EOF; padded
        rotations are dropped)."""
        nonlocal prev_pair, r_acc, prev_delta
        k = len(pend_pairs)
        if not k:
            return
        stack = [prev_pair] + pend_pairs + [pend_pairs[-1]] * (chunk_n - k)
        prev_pair = pend_pairs[-1]
        pend_pairs.clear()
        r_acc, prev_delta, rs = pair_chunk(
            r_acc, prev_delta, key, jnp.int32(len(rots) - 1),
            jnp.stack(stack),
        )
        for i in range(k):
            rots.append(rs[i])

    def emit(n: int, at_eof: bool):
        """Warp+write frames [emitted, emitted+n) (n <= batch)."""
        nonlocal emitted, batch_corr, radius_eff
        if n <= 0:
            return
        if batch_corr is None:
            total = len(rots) if at_eof else None
            radius_eff = (
                min(want_radius, max((total or len(rots)) - 1, 1))
                if options.stabilise == "smooth"
                else 0
            )
            batch_corr = make_window_corrections(radius_eff, options, up0)
        t0 = emitted
        last_i = len(rots) - 1
        window = jnp.stack(
            [
                rots[min(max(k, 0), last_i)]
                for k in range(t0 - radius_eff, t0 + batch + radius_eff)
            ]
        )
        with prof.stage("smooth"):
            corr = batch_corr(window)
        if overlay is not None:
            from video_annotator_tpu.pipeline.debug import (
                rotation_angles_deg,
            )

            degs = rotation_angles_deg(np.asarray(corr, np.float32))
            for i in range(n):
                overlay.text[t0 + i] = (
                    f"frame {t0 + i}  correction {degs[i]:.2f} deg"
                )
        ys, us, vs = zip(*(
            [frames[i] for i in range(n)] + [frames[n - 1]] * (batch - n)
        ))
        with prof.stage("warp"):
            outs = warper.warp_yuv_batch(ys, us, vs, corr)
        with prof.stage("encode"):
            for triple in outs[:n]:
                writer.write(triple)
        for _ in range(n):
            frames.popleft()
        emitted += n
        prog.tick(n)

    pre = DevicePrefetcher(prof.wrap_iter("decode", iter(reader)),
                           depth=options.prefetch_depth)
    idx = reader.start_frame - 1
    prog = Progress("render", total=n_expect or None)
    try:
        for y, u, v in pre:
            idx += 1
            if idx < first:
                continue
            if idx >= last:
                break
            frames.append((y, u, v))
            if pair_chunk is not None:
                with prof.stage("track"):
                    if prev_pair is None:
                        prev_pair = y
                        rots.append(r_acc)
                    else:
                        pend_pairs.append(y)
                        if len(pend_pairs) >= chunk_n:
                            flush_pairs()
            elif needs_motion:
                with prof.stage("track"):
                    if prev_gray is None:
                        pts, valid, prev_gray = detect_step(y)
                    else:
                        (pts, valid, prev_delta, r_acc, key,
                         prev_gray) = track_step(
                            prev_gray, y, pts, valid, prev_delta, r_acc, key,
                            refresh_age=age >= KEY_FRAME_MAX_AGE,
                        )
                        age = 0 if age >= KEY_FRAME_MAX_AGE else age + 1
                    rots.append(r_acc)
            else:
                rots.append(r_acc)
            # Emit every frame whose full lookahead window is present.
            while len(rots) - want_radius - emitted >= batch:
                emit(batch, at_eof=False)
        pre.close()
        # EOF: finish the pair chain, then the remaining window smooths
        # against clamp-replicated ends (the reference's
        # trajectory-extrapolation EOF semantics).
        if pair_chunk is not None:
            with prof.stage("track"):
                flush_pairs()
        while emitted < len(rots):
            emit(min(batch, len(rots) - emitted), at_eof=True)
    except BaseException:
        # Finalize the container (valid truncated output, not corrupt)
        # and stop the decode thread; the original error surfaces.
        pre.close()
        try:
            writer.close()
        except Exception:
            pass
        reader.close()
        raise
    prog.close()
    with prof.stage("encode"):
        writer.close()
    reader.close()

    # Persist the trajectory checkpoint (one device->host sync), so later
    # --encode-only reruns can reuse this pass's analysis. Identity
    # trajectories (stabilise=none, no lock) carry no information.
    if dest and rots and needs_motion:
        rotvecs = np.asarray(
            jax.jit(jax.vmap(so3.log))(jnp.stack(rots)), np.float64
        )
        Trajectory(
            params=rotvecs, kind="so3", fps=meta.fps, width=meta.width,
            height=meta.height, source=source, up0=up0,
        ).save(trajectory_path(dest))
    return out_meta
