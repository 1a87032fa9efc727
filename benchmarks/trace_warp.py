"""Device-kernel breakdown of the 4K warp from a profiler trace.

    python benchmarks/trace_warp.py [--interp bilinear] [--batches 4] [--out DIR]

Traces ``--batches`` dispatches of ``bench.py``'s warp (32 full-YUV
3840x2880 frames each, two in flight), reads the trace back through
``jax.profiler.ProfileData`` and prints, for each device plane: the
wall time of the traced loop, the summed and the merged (busy) kernel
time, the busy share of the wall, and the kernels by total time. The
trace stays in ``--out`` (default: a temporary directory, removed).
Needs an accelerator.
"""

import argparse
import glob
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_ns(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_table(xplane_path, top):
    """Per device plane: (kernel events, {kernel name: (count, ns)})."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        events = []
        for line in plane.lines:
            # Kernel launches sit on the per-stream lines; the "XLA Ops" /
            # "XLA Modules" lines repeat the same time per HLO op / module.
            if line.name.startswith("Stream"):
                events += [(e.name, e.start_ns, e.start_ns + e.duration_ns)
                           for e in line.events]
        by_name = defaultdict(lambda: [0, 0])
        for name, s, e in events:
            by_name[name][0] += 1
            by_name[name][1] += e - s
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
        out.append((plane.name, [ln.name for ln in plane.lines], events, rows))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--interp", default="bilinear",
                    choices=["bilinear", "bicubic", "lanczos"])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() == "cpu":
        raise SystemExit("trace_warp.py traces the accelerator; JAX found none")
    import bench

    out = args.out or tempfile.mkdtemp(prefix="trace_warp_")
    try:
        state = bench.setup(args.interp)
        with jax.profiler.trace(out):
            t0 = time.perf_counter()
            bench.run_batches(*state, args.batches)
            wall = time.perf_counter() - t0
        frames = args.batches * bench.BATCH
        print(f"{args.interp} warp, {args.batches} x {bench.BATCH} frames: "
              f"wall {wall * 1e3:.3f} ms ({wall / frames * 1e3:.4f} ms/frame)")
        (path,) = glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                            recursive=True)
        for plane, lines, events, rows in kernel_table(path, args.top):
            total = sum(e - s for _, s, e in events)
            busy = busy_ns([(s, e) for _, s, e in events])
            print(f"{plane}: lines {lines}")
            print(f"  {len(events)} kernels, summed {total / 1e6:.3f} ms, "
                  f"busy {busy / 1e6:.3f} ms = {busy / 1e9 / wall * 100:.1f} % "
                  "of the wall")
            for name, (count, ns) in rows:
                print(f"  {ns / 1e6:10.3f} ms  x{count:<4d} {name[:110]}")
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main()
