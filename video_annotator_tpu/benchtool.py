"""Device op micro-benchmarks — the ``OpenClTest`` analogue.

The reference ships a micro-benchmark comparing core image ops across
execution paths with mean±stddev over repeated runs
(``opencv/OpenClTest.cpp:65-427``: cvtColor / GaussianBlur / Canny x
{Mat, UMat} x {OpenCL on/off}, 50 reps). This tool does the same for the
framework's hot ops on whatever backend jax resolves.

Run: ``python -m video_annotator_tpu.benchtool [--size WxH] [--reps N]``
"""

from __future__ import annotations

import argparse
import statistics
import time


def _time(fn, reps: int):
    """(throughput ms, latency ms±sd): pipelined issue vs blocked round trips.

    Streaming pipelines see throughput; the blocked number includes the
    host round trip.
    """
    _block(fn())  # warm up / compile
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    _block(out)
    thru = (time.perf_counter() - t0) / reps * 1000.0

    times = []
    for _ in range(max(reps // 3, 2)):
        t0 = time.perf_counter()
        _block(fn())
        times.append((time.perf_counter() - t0) * 1000.0)
    lat = statistics.fmean(times)
    sd = statistics.stdev(times) if len(times) > 1 else 0.0
    return thru, lat, sd


def _block(out):
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", default="1920x1440")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))

    import numpy as np
    import jax
    import jax.numpy as jnp

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset, get_output_camera, get_preset_camera,
    )
    from video_annotator_tpu.ops.corners import detect_corners
    from video_annotator_tpu.ops.lk import pyramidal_lk
    from video_annotator_tpu.ops.warp_xla import warp_image_xla
    from video_annotator_tpu.smoothing.savgol import smooth_rotations

    backend = jax.default_backend()
    print(f"backend: {backend} ({jax.devices()[0]}), {args.reps} reps, {w}x{h}")

    rng = np.random.default_rng(0)
    img = jnp.asarray(np.round(rng.uniform(0, 255, (h, w))).astype(np.float32))
    img2 = jnp.asarray(np.round(rng.uniform(0, 255, (h, w))).astype(np.float32))
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    rot = so3.exp(jnp.asarray([0.02, -0.01, 0.03], jnp.float32))

    rows = []
    rows.append((
        "warp (XLA gather)",
        lambda: warp_image_xla(img, out_cam, in_cam, rot),
    ))
    rows.append((
        "detect_corners", lambda: detect_corners(img)
    ))
    pts, valid = detect_corners(img)
    rows.append((
        "pyramidal_lk (256 pts)", lambda: pyramidal_lk(img, img2, pts, valid)
    ))
    traj = so3.exp(jnp.asarray(rng.normal(size=(600, 3)) * 0.01, jnp.float32))
    rows.append((
        "sg smooth (600 frames, r=90)",
        lambda: smooth_rotations(traj, radius=90),
    ))

    print(f"{'op':32s} {'throughput':>12s} {'latency':>18s}")
    for name, fn in rows:
        thru, lat, sd = _time(fn, args.reps)
        print(f"{name:32s} {thru:9.3f} ms {lat:11.3f} ± {sd:5.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
