"""Headline benchmark: 4K stabilized-warp throughput per device.

Measures the encode-phase hot loop — per-frame map+warp of a full YUV
4:2:0 4K GoPro frame (luma + both chroma planes) with a per-frame
stabilization rotation, one batched dispatch per 32 frames — on the
accelerator, and prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N}

``value`` is the median over the timed trials. Baseline: BASELINE.json
north star = 4x real-time 4K60 per device (240 fps). Refuses to run
without an accelerator: a CPU number is not this metric.
"""

import json
import statistics
import sys
import time

sys.path.insert(0, ".")


BATCH = 32


def setup(interp="bilinear"):
    """The 4K warper, one batch of uint8 planes, and four per-batch
    rotation stacks, compiled and warm."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.pipeline.render import FrameWarper

    w, h = 3840, 2880  # 4K GoPro 4:3
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, scale=1.0, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam, interp=interp)

    rng = np.random.default_rng(0)
    # uint8 planes — the pipeline's actual end-to-end dtype.
    y = jnp.asarray(rng.integers(0, 255, (h, w), dtype=np.uint8))
    u = jnp.asarray(rng.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))
    v = jnp.asarray(rng.integers(0, 255, (h // 2, w // 2), dtype=np.uint8))

    # Per-batch rotation stacks (small stabilization corrections),
    # pre-uploaded like the encode loop's.
    rots = [
        jnp.stack([
            so3.exp(jnp.asarray(x, jnp.float32))
            for x in rng.normal(size=(BATCH, 3)) * 0.01
        ])
        for _ in range(4)
    ]
    jax.block_until_ready(rots)

    ys, us, vs = (y,) * BATCH, (u,) * BATCH, (v,) * BATCH

    # Warm up / compile: one dispatch of map + gather + blend + byte
    # rounding over BATCH frames with per-frame rotations.
    jax.block_until_ready(warper.warp_yuv_batch(ys, us, vs, rots[0]))
    return warper, ys, us, vs, rots


def run_batches(warper, ys, us, vs, rots, n):
    """``n`` batch dispatches, two in flight: the encode loop's shape
    (AsyncFrameWriter's bounded queue supplies the same backpressure)."""
    import jax

    inflight = []
    for i in range(n):
        inflight.append(warper.warp_yuv_batch(ys, us, vs, rots[i % 4]))
        if len(inflight) > 1:
            jax.block_until_ready(inflight.pop(0))
    jax.block_until_ready(inflight)


def main():
    import jax

    if jax.default_backend() == "cpu":
        raise SystemExit("bench.py measures the accelerator; JAX found none")

    warper, ys, us, vs, rots = setup()
    n = 4  # batches per trial = 128 frames
    per_frame = []
    for _ in range(7):
        t0 = time.perf_counter()
        run_batches(warper, ys, us, vs, rots, n)
        per_frame.append((time.perf_counter() - t0) / (n * BATCH))
    fps = 1.0 / statistics.median(per_frame)

    baseline_fps = 240.0  # 4x real-time 4K60 per device (BASELINE.json)
    print(
        json.dumps(
            {
                "metric": "4k_stabilized_warp_fps_per_chip",
                "value": round(fps, 2),
                "unit": "fps",
                "vs_baseline": round(fps / baseline_fps, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
