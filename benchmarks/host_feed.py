"""Host decode-feed benchmark: can the box feed N x 4K60 streams?

BASELINE config #5 (8x 4K60 streams) needs the HOST to decode
~8 x 60 x 16.6 MB/s ~= 1.9 GB/s of NV12/I420 pixels (SURVEY.md §7 "hard
parts") before the device ever sees a frame. The device-side warp cost is
measured in ``benchmarks/run.py::bench_8x4k60_multistream``; this
benchmark measures the other half honestly on THIS host:

- encode a synthetic 4K clip with the native writer (libx264, the
  pipeline's own encode path);
- decode it with K parallel ``native/loader.cpp`` instances (each a
  demux+decode thread plus libavcodec frame threads, exactly the
  production feed path), measuring per-instance and aggregate
  frames/s and GB/s;
- scale K over 1/2/4 to expose how decode throughput shares the
  available cores (on a 1-core host the aggregate stays flat — the
  point of the table is the per-core number, which multiplies out on a
  many-core host; see docs/PIPELINE.md for the capacity math).

Writes one JSON line per K to stdout and benchmarks/host_feed.json.

Usage: python benchmarks/host_feed.py [--w 3840 --h 2880 --frames 96]
       (defaults are the 4K GoPro 4:3 geometry the pipeline targets)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_clip(path: str, w: int, h: int, frames: int) -> None:
    """Encode a textured synthetic clip via the native writer (libx264).

    Texture matters: flat frames compress to nothing and decode
    unrealistically fast. A per-frame-shifted sinusoid field plus noise
    approximates camera footage entropy at a fraction of the render cost.
    """
    from fractions import Fraction

    from video_annotator_tpu.io.native import NativeVideoWriter
    from video_annotator_tpu.io.video import VideoMeta

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        96.0
        + 48.0 * np.sin(xx / 17.0)
        + 32.0 * np.cos(yy / 23.0 + xx / 41.0)
    )
    noise = rng.normal(0.0, 12.0, size=(h, w)).astype(np.float32)
    wr = NativeVideoWriter(path, VideoMeta(w, h, Fraction(60, 1)))
    try:
        for i in range(frames):
            y = np.clip(np.roll(base, 3 * i, axis=1) + noise, 0, 255)
            y = y.astype(np.uint8)
            u = np.full((h // 2, w // 2), 110 + (i % 16), np.uint8)
            v = np.full((h // 2, w // 2), 140, np.uint8)
            wr.write((y, u, v))
    finally:
        wr.close()


def decode_all(path: str, counter: list, idx: int) -> None:
    from video_annotator_tpu.io.native import NativeVideoSource

    src = NativeVideoSource(path, ring_frames=8)
    n = 0
    try:
        for _ in iter(src):
            n += 1
    finally:
        src.close()
    counter[idx] = n


def bench_parallel(path: str, k: int, w: int, h: int) -> dict:
    counts = [0] * k
    threads = [
        threading.Thread(target=decode_all, args=(path, counts, i))
        for i in range(k)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    frames = sum(counts)
    bytes_total = frames * (w * h * 3 // 2)
    return {
        "config": f"host_feed_x{k}",
        "loaders": k,
        "frames": frames,
        "metric": "aggregate_decode_fps",
        "value": round(frames / dt, 2),
        "unit": "fps",
        "per_loader_fps": round(frames / dt / k, 2),
        "aggregate_GBps": round(bytes_total / dt / 1e9, 3),
        "streams_4k60_per_core_equiv": round(frames / dt / k / 60.0, 3),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--h", type=int, default=2880)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--loaders", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "host_feed.json"))
    args = ap.parse_args()

    from video_annotator_tpu.io.native import native_available

    if not native_available():
        print("native loader not built (make -C native)", file=sys.stderr)
        raise SystemExit(1)

    results = []
    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "feed.mp4")
        t0 = time.perf_counter()
        make_clip(clip, args.w, args.h, args.frames)
        enc_dt = time.perf_counter() - t0
        size = os.path.getsize(clip)
        meta = {
            "config": "host_feed_clip",
            "w": args.w, "h": args.h, "frames": args.frames,
            "encode_fps": round(args.frames / enc_dt, 2),
            "clip_MB": round(size / 1e6, 1),
            "cpus": os.cpu_count(),
        }
        results.append(meta)
        print(json.dumps(meta), flush=True)
        for k in args.loaders:
            row = bench_parallel(clip, k, args.w, args.h)
            results.append(row)
            print(json.dumps(row), flush=True)

    from provenance import stamp

    for row in results:
        # Host-only benchmark: decode/feed runs never touch jax.
        stamp(row, backend="host")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")


if __name__ == "__main__":
    main()
